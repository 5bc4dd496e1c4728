"""The port's runtime tools, each run as ``python -m
incubator_brpc_tpu_torch.tools.<name>``: ``rpc_press`` (load generator),
``rpc_view`` (portal relay, dump printer, metrics, rpcz and fleet traces),
``rpc_replay`` (re-issue dumped requests), ``parallel_http`` (many URLs
at once) and ``mcpack_gen`` (ahead-of-time mcpack codecs for Message
schemas). Each keeps the flags, functions and printed lines of the JAX
package's ``tools/`` file of the same name."""
