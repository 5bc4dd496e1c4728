"""parallel — the fabric mesh (``mesh.py``); one card for now."""
