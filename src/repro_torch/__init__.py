"""PyTorch/CUDA port of the ``repro`` model zoo, for one NVIDIA H100.

Mirrors ``repro``'s layout (``configs/``, ``kernels/``, ``models/``,
``serve/``).  Plain tensor code is PyTorch; each Pallas kernel of ``repro``
becomes a hand-written Hopper kernel under ``csrc/``, built with ``nvcc`` on
first use.  The package imports neither ``jax`` nor anything of ``repro``.
"""
