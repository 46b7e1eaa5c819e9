"""Hopper kernels (``csrc/``: GNN aggregation, flash attention, the SSD scan),
their wrappers and plain versions.

Nothing is built at import: :mod:`repro_torch.kernels.build` compiles the
CUDA sources at the first launch."""
