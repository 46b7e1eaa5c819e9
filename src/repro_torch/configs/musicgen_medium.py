"""MusicGen-medium [arXiv:2306.05284]: 48L decoder-only over EnCodec tokens,
d_model 1536, 24 heads MHA (kv=24), d_ff 6144, vocab 2048 (codebook size).
Audio frontend (EnCodec conv codec) is STUBBED — input_specs() feeds
precomputed frame embeddings [B, S, d_model] (assignment carve-out)."""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    activation="gelu",
    input_mode="embeddings",
    long_context="window",
    source="arXiv:2306.05284",
)

REDUCED = ArchConfig(
    name="musicgen-medium-reduced",
    family="audio",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    activation="gelu",
    input_mode="embeddings",
    dtype="float32",
    source="arXiv:2306.05284",
)
