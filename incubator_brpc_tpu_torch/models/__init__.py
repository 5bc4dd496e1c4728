"""models — device-resident services and workloads: the tensor echo step,
ring attention and FabricNet."""
