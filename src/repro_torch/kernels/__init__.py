"""Hopper kernels of the GNN path (``csrc/``), their wrappers and plain versions.

Nothing is built at import: :mod:`repro_torch.kernels.build` compiles the
CUDA sources at the first launch."""
