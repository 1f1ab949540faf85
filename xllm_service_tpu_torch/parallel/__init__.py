"""Parallelism: the mesh over a ``torch.distributed`` world
(``mesh.py``), the sharding rules and the slicing of parameters and KV
pools to a rank's shard (``sharding.py``), ring attention over the sp
axis (``ring.py``) and the MoE dispatch with its expert-parallel share
(``expert.py``)."""
