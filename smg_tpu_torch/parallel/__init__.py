"""Tensor parallelism of the port (``ROADMAP.md`` Queue A item 9b): the
sharding rules as torch slicing (``sharding.py``), the rank processes, their
process groups and collectives (``group.py``) and the leader that mirrors
rank 0's runner calls to the followers (``leader.py``).  The reference does
this with GSPMD in one process (``smg_tpu/parallel/``); here every rank is a
process with its own device."""
