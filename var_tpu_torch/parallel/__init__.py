"""Multi-GPU runtime of the port over ``torch.distributed``: the (data,
model) mesh and tensor-parallel sharding (``mesh.py``), and the bridges
around the sharded matmuls (``shard_attn.py``)."""
