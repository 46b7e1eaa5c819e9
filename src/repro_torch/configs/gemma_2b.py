"""Gemma-2B [arXiv:2403.08295]: 18L, d_model 2048, 8 heads with MQA (kv=1),
head_dim 256, GeGLU d_ff 16384, vocab 256000."""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    long_context="window",  # full attention: long_500k uses windowed-KV decode
    source="arXiv:2403.08295",
)

REDUCED = ArchConfig(
    name="gemma-2b-reduced",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=1,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    activation="geglu",
    dtype="float32",
    source="arXiv:2403.08295",
)
