"""transport — the device transport slot (``DeviceEndpoint``) and the
collective plane's integer test kernels (``mc_worker.py``)."""
