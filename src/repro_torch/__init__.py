"""PerMFL on PyTorch and CUDA: the port of the JAX package ``repro``.

The package mirrors ``src/repro``'s layout and imports nothing from it.
Entry points run on the CUDA card by default (``device="cuda"``) and
raise without one; pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels on the CPU.
"""
