"""RecurrentGemma-2B [arXiv:2402.19427]: 26L, d_model 2560, 10 heads MQA
(kv=1, head_dim 256), d_ff 7680, vocab 256000.  Griffin pattern: two RG-LRU
recurrent blocks then one local-attention block (1:2), window 2048."""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    activation="geglu",
    pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    long_context="native",  # RG-LRU state + bounded local window
    source="arXiv:2402.19427",
)

REDUCED = ArchConfig(
    name="recurrentgemma-2b-reduced",
    family="hybrid",
    num_layers=3,  # one full (rec, rec, attn) period
    d_model=256,
    num_heads=4,
    num_kv_heads=1,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    activation="geglu",
    pattern=("rglru", "rglru", "local_attn"),
    local_window=64,
    dtype="float32",
    source="arXiv:2402.19427",
)
