"""Unified architecture config for the assigned model pool.

One ``ArchConfig`` describes any of the 6 families (dense / moe / ssm /
hybrid / vlm / audio): a decoder backbone made of a repeating pattern of
layer *specs*.  ``pattern`` lists mixer kinds per layer position modulo its
length, e.g. ["ssm"] for mamba2, ["rglru", "rglru", "local_attn"] for
recurrentgemma, ["attn"] for dense.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig"]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    num_shared: int = 0  # DeepSeek shared experts (always active)
    expert_d_ff: int = 0  # per-expert hidden (0 -> use d_ff)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01  # GLISP-analogue load-balance loss


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128  # N
    head_dim: int = 64  # P
    num_heads: int = 0  # 0 -> d_inner // head_dim
    num_groups: int = 1  # B/C groups (G)
    expand: int = 2  # d_inner = expand * d_model
    chunk: int = 128
    conv_width: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    pattern: tuple = ("attn",)  # mixer kinds, cycled over layers
    activation: str = "swiglu"  # swiglu | geglu
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    window: int = 0  # sliding window for "attn" when >0 (SWA)
    local_window: int = 2048  # window for "local_attn" layers
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # MLA (DeepSeek): latent KV compression; 0 disables
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64  # decoupled rope dims under MLA
    # head padding for clean tensor-parallel tiling (set by the launcher per
    # mesh; dead heads are computed and sliced away before the out-projection
    # — same convention as vocab padding).  0 = no padding.
    q_head_pad: int = 0  # pad num_heads (via padded GQA groups) to this
    kv_head_pad: int = 0  # pad num_kv_heads to this
    tp_size: int = 0  # model-axis size the launcher resolved this config for
    # MoE dispatch groups (launcher sets = data-parallel shard count so the
    # dispatch buffers shard with the batch; 1 = single global dispatch)
    moe_dispatch_groups: int = 1
    # mesh axis name(s) the group axis shards over (launcher-set)
    data_axis_names: tuple = ()
    # input modality: "tokens" (LM) or "embeddings" (vlm/audio stubs feed
    # precomputed patch/frame embeddings of shape [B, S, d_model])
    input_mode: str = "tokens"
    tie_embeddings: bool = True
    # long-context decode strategy: "native" (ssm/hybrid/swa) or "window"
    # (dense archs get a windowed-KV decode variant for long_500k) or "skip"
    long_context: str = "window"
    long_context_window: int = 8192
    dtype: str = "bfloat16"
    # citation for the assigned-pool entry
    source: str = ""

    @property
    def padded_vocab_size(self) -> int:
        """Embedding-table size padded to a multiple of 512 so the vocab dim
        shards over any reasonable model axis (standard practice; the logits
        of padded rows are masked to -inf in forward())."""
        return -(-self.vocab_size // 512) * 512

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def padded_q_heads(self) -> int:
        return self.q_head_pad or self.num_heads

    @property
    def padded_kv_heads(self) -> int:
        return self.kv_head_pad or self.num_kv_heads

    def layer_kinds(self) -> list[str]:
        return [self.pattern[i % len(self.pattern)] for i in range(self.num_layers)]

    def num_params(self) -> int:
        """Analytic parameter count (embeddings + per-layer weights)."""
        d, dh = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d  # embedding (tied head)
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for kind in self.layer_kinds():
            total += self._mixer_params(kind)
            total += self._mlp_params(kind)
            total += 2 * d  # norms
        total += d  # final norm
        return total

    def _mixer_params(self, kind: str) -> int:
        d, dh = self.d_model, self.resolved_head_dim
        h, hkv = self.num_heads, self.num_kv_heads
        if kind in ("attn", "local_attn"):
            if self.kv_lora_rank:  # MLA
                r, rd = self.kv_lora_rank, self.rope_head_dim
                return (
                    d * h * (dh + rd)  # q proj (nope+rope parts)
                    + d * (r + rd)  # kv down + shared rope key
                    + r * h * (dh + dh)  # k/v up
                    + h * dh * d  # out
                )
            return d * h * dh + 2 * d * hkv * dh + h * dh * d
        if kind == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nh = s.num_heads or d_in // s.head_dim
            g, n = s.num_groups, s.state_dim
            return (
                d * (2 * d_in + 2 * g * n + nh)  # in_proj (x, z, B, C, dt)
                + s.conv_width * (d_in + 2 * g * n)
                + 2 * nh  # A, D
                + d_in * d  # out
            )
        if kind == "rglru":
            d_in = d  # RG-LRU width = d_model (simplified Griffin block)
            return d * 2 * d_in + 2 * d_in * d_in + d_in + d_in * d
        raise ValueError(kind)

    def _mlp_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "ssm":
            return 0  # mamba blocks carry no separate MLP
        if self.moe is not None and kind != "ssm":
            e = self.moe
            dff = e.expert_d_ff or self.d_ff
            routed = e.num_experts * 3 * d * dff
            shared = e.num_shared * 3 * d * dff
            router = d * e.num_experts
            return routed + shared + router
        if self.activation == "gelu":  # plain 2-proj MLP (gpt-style)
            return 2 * d * self.d_ff
        return 3 * d * self.d_ff  # gated mlp (swiglu/geglu)
