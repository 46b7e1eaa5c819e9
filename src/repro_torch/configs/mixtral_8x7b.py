"""Mixtral-8x7B [arXiv:2401.04088]: 32L, d_model 4096, 32 heads GQA kv=8,
MoE 8 experts top-2 with d_ff 14336, vocab 32000, sliding-window attention
(window 4096)."""
from repro_torch.models.transformer.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    window=4096,  # native SWA
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=14336,
                  capacity_factor=1.25),
    long_context="native",  # SWA bounds the KV cache
    source="arXiv:2401.04088",
)

REDUCED = ArchConfig(
    name="mixtral-8x7b-reduced",
    family="moe",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    window=64,
    moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=256, capacity_factor=2.0),
    dtype="float32",
    source="arXiv:2401.04088",
)
