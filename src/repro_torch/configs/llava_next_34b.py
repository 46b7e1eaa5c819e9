"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6-mistral-7b-hf, 34B variant]: 60L,
d_model 7168, 56 heads GQA kv=8, d_ff 20480, vocab 64000.  VLM: the
ViT/SigLIP vision tower + projector is STUBBED — input_specs() feeds
precomputed anyres patch embeddings [B, S, d_model] (assignment carve-out)."""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    input_mode="embeddings",
    long_context="window",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

REDUCED = ArchConfig(
    name="llava-next-34b-reduced",
    family="vlm",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    input_mode="embeddings",
    dtype="float32",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
