"""The port's examples, each run as ``python -m
incubator_brpc_tpu_torch.examples.<name>``: the JAX package's
``examples/`` of the same name on the port's planes, printing the same
lines. The host examples touch no device (``rtmp_relay``, the RTMP
publish/play relay with its FLV dump, among them); ``echo`` (``demo tpu``),
``link_performance``, ``tensor_echo_tpu`` and the device halves of
``parallel_echo`` and ``partition_echo`` run on the card, or on the CPU
with ``--device cpu``; ``multi_protocol``, ``nshead_extension`` and
``ubrpc_compack`` (the legacy wires on one port) take ``--device`` for
their server's device."""
