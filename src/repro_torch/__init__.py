"""repro_torch — the PyTorch/CUDA port of the GLISP system in ``repro``.

The port imports ``torch`` and numpy and nothing of the JAX package. Host
modules that are numpy-only in ``repro`` are copies; tensor code is
PyTorch; the kernels (GNN aggregation, flash attention, the Mamba-2 SSD
scan) are hand-written CUDA for Hopper (``kernels/``).
Entry points that allocate tensors take ``device=`` and default to
``"cuda"``.
"""
