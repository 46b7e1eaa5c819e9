"""DeepSeek-V2-Lite-16B [arXiv:2405.04434]: 27L, d_model 2048, 16 heads with
MLA (kv_lora 512, decoupled rope head 64), MoE: 64 routed experts top-6 +
2 shared, expert d_ff 1408, vocab 102400.  (The full V2 has 160 routed
experts; Lite has 64 — we follow the Lite assignment.  V2's dense first
layer is simplified to all-MoE, noted in DESIGN.md.)"""
from repro_torch.models.transformer.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    kv_lora_rank=512,
    rope_head_dim=64,
    moe=MoEConfig(
        num_experts=64, top_k=6, num_shared=2, expert_d_ff=1408,
        capacity_factor=1.25,
    ),
    long_context="window",
    source="arXiv:2405.04434",
)

REDUCED = ArchConfig(
    name="deepseek-v2-lite-reduced",
    family="moe",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=128,
    vocab_size=512,
    kv_lora_rank=64,
    rope_head_dim=32,
    moe=MoEConfig(num_experts=4, top_k=2, num_shared=1, expert_d_ff=128,
                  capacity_factor=2.0),
    dtype="float32",
    source="arXiv:2405.04434",
)
