"""Rank meshes of the port (``ROADMAP.md`` Queue A items 9b-9e): tensor,
pipeline, sequence and expert parallelism.  The sharding rules as torch
slicing (``sharding.py``), the rank grid, its process groups and
collectives (``group.py``), the leader that mirrors rank 0's runner calls to
the followers (``leader.py``), the pipeline stages' hand-off
(``pp_serving.py``) and ring attention (``ring_attention.py``).  The
reference does this with GSPMD and ``shard_map`` in one process
(``smg_tpu/parallel/``); here every rank is a process with its own
device."""
