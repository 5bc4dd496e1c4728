"""parallel — the fabric mesh and the party axis (``mesh.py``), block
quantized collectives (``quantized.py``), and the collective session plane
(``mc_dispatch.py``, ``mc_collective.py``); one card for now."""
