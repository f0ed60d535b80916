"""PyTorch/CUDA port of the smg_tpu serving engine.

Mirrors ``smg_tpu``'s layout (``models/``, ``ops/``, ``engine/``) so each
module has an obvious counterpart.  Plain tensor code is PyTorch; the two
Pallas TPU kernels of the serving path are hand-written CUDA C++ kernels for
Hopper (``csrc/``), built with ``nvcc`` at first use (``ops/cuda/build.py``).

The package imports ``torch``, numpy and the standard library only: it keeps
its own copies of the JAX-free pieces it needs (configs, sampling params,
request state, radix cache) rather than importing the JAX package.
"""
