"""transport — host sockets (``sock.py``, ``acceptor.py``,
``socket_map.py``, ``messenger.py``, ``event_dispatcher.py``), the native
network plane over the C++ host runtime (``native_plane.py``), the device
transport slot (``DeviceEndpoint``) and the collective plane's integer test
kernels (``mc_worker.py``)."""
