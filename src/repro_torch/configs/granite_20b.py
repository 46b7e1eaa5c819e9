"""Granite-20B-Code [arXiv:2405.04324]: 52L, d_model 6144, 48 heads MQA
(kv=1), d_ff 24576, vocab 49152, llama-style."""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",
    long_context="window",
    source="arXiv:2405.04324",
)

REDUCED = ArchConfig(
    name="granite-20b-reduced",
    family="dense",
    num_layers=2,
    d_model=384,
    num_heads=6,
    num_kv_heads=1,
    d_ff=768,
    vocab_size=512,
    activation="gelu",
    dtype="float32",
    source="arXiv:2405.04324",
)
