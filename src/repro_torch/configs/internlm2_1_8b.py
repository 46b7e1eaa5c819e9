"""InternLM2-1.8B [arXiv:2403.17297]: 24L, d_model 2048, 16 heads GQA kv=8,
d_ff 8192, vocab 92544."""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    long_context="window",
    source="arXiv:2403.17297",
)

REDUCED = ArchConfig(
    name="internlm2-1.8b-reduced",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    dtype="float32",
    source="arXiv:2403.17297",
)
