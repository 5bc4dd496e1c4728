"""rpc — device methods (``device_method.py``): kernels with a fixed row
geometry that the collective session plane (``parallel/mc_dispatch.py``)
resolves by (service, method). The host RPC plane is a later slice."""
