"""Mesh parallelism over torch.distributed SPMD ranks: `context` (the
active mesh and the collectives), `mesh` (the mesh and the process start),
`sharding` (Megatron tp/dp rules) and `launch` (starting ranks)."""
