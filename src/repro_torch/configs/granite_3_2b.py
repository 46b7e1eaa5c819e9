"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base]: 40L, d_model 2048,
32 heads GQA kv=8, d_ff 8192, vocab 49155."""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    long_context="window",
    source="hf:ibm-granite/granite-3.0-2b-base",
)

REDUCED = ArchConfig(
    name="granite-3-2b-reduced",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    dtype="float32",
    source="hf:ibm-granite/granite-3.0-2b-base",
)
