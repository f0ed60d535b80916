"""Hand-written CUDA kernels of the port and their Python wrappers.

Each wrapper launches its kernel for CUDA tensors (or raises) and computes
the plain PyTorch version only for CPU tensors; ``launches`` in each module
counts kernel launches.  Kernels are built at first use (``build.py``)."""
