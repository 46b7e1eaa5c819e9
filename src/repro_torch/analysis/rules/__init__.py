"""Rule modules; importing this package registers every rule in ``RULES``.

The port's rules: DET001-DET004 and PRJ001-PRJ006 as the reference's (ids
shared, so one pragma serves both linters; DET001 also covers PyTorch's
global generator), KRN001 for the port's kernel wrappers, and TRH001 /
TRH002 in place of the reference's JAX001 / JAX004. JAX002 (jit-in-loop)
and JAX003 (non-hashable static arg) have no counterpart: eager PyTorch
builds no compile cache per call, and ``kernels.build.library`` compiles
each CUDA source once per process.
"""
from repro_torch.analysis.rules import determinism, kernels, project, torch_hygiene  # noqa: F401
