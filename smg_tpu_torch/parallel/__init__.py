"""Rank meshes of the port (``ROADMAP.md`` Queue A items 9b-9f): tensor,
pipeline, sequence and expert parallelism, serving and training.  The
sharding rules as torch slicing and the training leaves' table
(``sharding.py``), the rank grid, its process groups and collectives
(``group.py``), the leader that mirrors rank 0's runner calls to the
followers (``leader.py``), the pipeline stages' hand-off (``pp_serving.py``)
and the training pipeline's schedule (``pipeline.py``), ring attention and
its training ring (``ring_attention.py``), and the collectives' adjoints
for autograd (``autograd.py``).  The reference does this with GSPMD and
``shard_map`` in one process (``smg_tpu/parallel/``); here every rank is a
process with its own device."""
