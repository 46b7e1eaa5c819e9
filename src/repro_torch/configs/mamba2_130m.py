"""Mamba2-130M [arXiv:2405.21060]: 24L, d_model 768, attention-free SSD,
ssm_state 128, vocab 50280.  d_inner = 2*768 = 1536, 24 heads of P=64."""
from repro_torch.models.transformer.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    pattern=("ssm",),
    ssm=SSMConfig(state_dim=128, head_dim=64, num_groups=1, expand=2, chunk=128),
    long_context="native",  # O(1) state decode
    source="arXiv:2405.21060",
)

REDUCED = ArchConfig(
    name="mamba2-130m-reduced",
    family="ssm",
    num_layers=2,
    d_model=256,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    pattern=("ssm",),
    ssm=SSMConfig(state_dim=32, head_dim=32, num_groups=1, expand=2, chunk=32),
    dtype="float32",
    source="arXiv:2405.21060",
)
