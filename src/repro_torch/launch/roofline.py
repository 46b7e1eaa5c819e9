"""The H100's roofline: the model-FLOPs and byte accounting of a step and
of each kernel, against the card's peaks. Port of
``repro/launch/roofline.py`` for one card.

    hw = hardware(torch.cuda.get_device_name())
    roofline(cfg, "prefill_32k", hw=hw, wall_s=...)["mfu"]
    kernel_roofline("ssd_scan", shape, wall_s, "bf16", hw)["bound_s"]

The analytic model (``analytic_flops``, ``analytic_hbm_bytes``) is the
reference's line for line: the standard MFU accounting (attention's S^2
terms, MoE capacity, SSD chunk terms) and a lower bound on device-memory
traffic. It differs in two places of interface only. ``shape`` is a name in
``SHAPES`` or a dict with ``seq``, ``batch`` and ``kind``. ``weight_bytes``
is new (4: float32 master weights, as the reference counts and
``LMTrainer`` keeps; 2: bf16 serving), and ``mesh_shape`` is optional (one
card by default). With ``weight_bytes=4`` the results equal the
reference's for the same ``mesh_shape`` (``{}`` without one).

The kernel formulas are the port's own: each counts every input the
kernel must read once and every output it writes once, at what this call's
data needs (valid edges, distinct rows gathered, unmasked attention pairs).
The reference's GNN formulas count a one-hot matmul on the MXU and row-block
re-reads, which are TPU tiling.

On a mesh, the dry run (``launch.dryrun``) traces a step over DTensors
and :class:`CollectiveRecorder` takes the place of the reference's
``parse_collectives`` (which reads XLA's HLO): it records each collective
the step issues on each device, with its result's bytes, by kind, and the
FLOPs of each device's own operations. :func:`mesh_roofline` turns them
into the reference's per-device roofline, the collectives charged at the
card's interconnect rates. :func:`roofline` is the one-card form, with no
collectives.
"""
from __future__ import annotations

import sys

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.specs import SHAPES
from repro_torch.models.transformer.config import ArchConfig

__all__ = [
    "HW",
    "CollectiveRecorder",
    "collective_seconds",
    "mesh_roofline",
    "KERNEL_OPS",
    "analytic_flops",
    "analytic_hbm_bytes",
    "hardware",
    "kernel_flops",
    "kernel_hbm_bytes",
    "kernel_roofline",
    "roofline",
]

# Published peaks, keyed by ``torch.cuda.get_device_name()``. The H100 SXM
# card at its 700 W limit; a card set below it runs slower under load, so a
# share against these peaks is stated beside the card's power limit. The
# interconnect figures are published ones too, not measured: NVLink 4 within
# a node of 8 cards, one 400 Gb/s NDR InfiniBand port per card between nodes.
HW = {
    "NVIDIA H100 80GB HBM3": {
        "peak_flops_bf16": 989e12,  # bf16 dense on the tensor cores
        "peak_flops_f32": 67e12,  # float32 outside the tensor cores
        "hbm_bw": 3.35e12,  # device memory, bytes/s
        "nvlink_bw": 450e9,  # bytes/s per direction, NVLink 4
        "nvlink_ranks": 8,  # cards of one node, joined by NVLink
        "ib_bw": 50e9,  # bytes/s, one 400 Gb/s NDR port per card
    },
}


def hardware(name: str) -> dict:
    """The peaks of the card named ``name``. An unknown card raises: a share
    against another card's peaks would be a wrong number, not a rough one."""
    if name not in HW:
        raise ValueError(f"no roofline for the card {name!r}; known: {sorted(HW)}")
    return dict(HW[name])


def _shape(shape: str | dict) -> tuple[int, int, str]:
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    return sh["batch"], sh["seq"], sh["kind"]


# ---------------------------------------------------------------------------
# analytic FLOPs
# ---------------------------------------------------------------------------


def _avg_context(S: int, window: int) -> float:
    """Mean causal context length over positions 0..S-1 (window-capped)."""
    if window <= 0 or window >= S:
        return S / 2
    # mean of min(t, w) over t in [0, S)
    return (window * (window - 1) / 2 + (S - window) * window) / S


def _mixer_flops_seq(cfg: ArchConfig, kind: str, S: int, decode_ctx: int | None):
    """FLOPs for one mixer layer over a sequence of S tokens (decode: S=1 and
    attention context = decode_ctx)."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    if kind in ("attn", "local_attn"):
        window = cfg.local_window if kind == "local_attn" else cfg.window
        if cfg.kv_lora_rank:
            r, rd = cfg.kv_lora_rank, cfg.rope_head_dim
            proj = S * 2 * d * (h * (dh + rd) + r + rd) + S * 2 * h * dh * d
            if decode_ctx is None:
                up = S * 2 * r * 2 * h * dh
                ctx = _avg_context(S, window)
            else:
                ctx = min(decode_ctx, window) if window else decode_ctx
                up = 2 * ctx * r * 2 * h * dh  # non-absorbed MLA decode
            attn = 2 * S * ctx * h * (dh + rd) + 2 * S * ctx * h * dh
            return proj + up + attn
        proj = S * (2 * d * h * dh + 4 * d * hkv * dh + 2 * h * dh * d)
        ctx = (
            _avg_context(S, window)
            if decode_ctx is None
            else (min(decode_ctx, window) if window else decode_ctx)
        )
        attn = 4 * S * ctx * h * dh
        return proj + attn
    if kind == "ssm":
        s = cfg.ssm
        d_in = s.expand * d
        nh = s.num_heads or d_in // s.head_dim
        g, n, p, L = s.num_groups, s.state_dim, s.head_dim, s.chunk
        proj = S * 2 * d * (2 * d_in + 2 * g * n + nh)
        conv = S * 2 * s.conv_width * (d_in + 2 * g * n)
        if decode_ctx is None:
            ssd = S * nh * (2 * L * n + 2 * L * p + 4 * n * p)
        else:
            ssd = S * nh * 6 * n * p  # single recurrence step
        out = S * 2 * d_in * d
        return proj + conv + ssd + out
    if kind == "rglru":
        return S * (2 * d * 2 * d + 4 * d * d + 2 * d * d + 12 * d)
    raise ValueError(kind)


def _mlp_flops_seq(cfg: ArchConfig, kind: str, S: int):
    d = cfg.d_model
    if kind == "ssm":
        return 0
    if cfg.moe is not None:
        e = cfg.moe
        dff = e.expert_d_ff or cfg.d_ff
        return S * (
            2 * d * e.num_experts
            + e.top_k * e.capacity_factor * 6 * d * dff
            + e.num_shared * 6 * d * dff
        )
    mats = 2 if cfg.activation == "gelu" else 3
    return S * mats * 2 * d * cfg.d_ff


def analytic_flops(cfg: ArchConfig, shape: str | dict) -> dict:
    """FLOPs for one step of this shape: ``total`` (a training step is 3x
    the forward), ``fwd`` and the 6ND (2ND outside training) convention."""
    B, S, kind = _shape(shape)
    decode = kind == "decode"
    s_tok = 1 if decode else S
    ctx = S if decode else None

    fwd = 0.0
    for lk in cfg.layer_kinds():
        fwd += _mixer_flops_seq(cfg, lk, s_tok, ctx)
        fwd += _mlp_flops_seq(cfg, lk, s_tok)
    head_tokens = s_tok if kind == "train" else 1
    fwd += head_tokens * 2 * cfg.d_model * cfg.vocab_size
    fwd *= B
    total = 3 * fwd if kind == "train" else fwd
    # 6·N·D convention for cross-checking (active params for MoE)
    n_active = cfg.num_params()
    if cfg.moe is not None:
        e = cfg.moe
        dff = e.expert_d_ff or cfg.d_ff
        n_active -= cfg.num_layers * (e.num_experts - e.top_k) * 3 * cfg.d_model * dff
    model_flops_6nd = (6 if kind == "train" else 2) * n_active * B * s_tok
    return {"total": total, "fwd": fwd, "6nd": model_flops_6nd}


# ---------------------------------------------------------------------------
# analytic device-memory traffic (documented lower-bound model)
# ---------------------------------------------------------------------------


def analytic_hbm_bytes(cfg: ArchConfig, shape: str | dict, mesh_shape: dict | None = None, *,
                       weight_bytes: int = 4) -> float:
    """Bytes one step must move through one device's memory, at
    ``weight_bytes`` a parameter: weights sharded over the ``model`` axis
    of ``mesh_shape``, the batch over ``data`` (and ``pod``); one card
    without a mesh."""
    B, S, kind = _shape(shape)
    mesh_shape = mesh_shape or {}
    msize = mesh_shape.get("model", 1)
    dsize = 1
    for a in ("data", "pod"):
        dsize *= mesh_shape.get(a, 1)
    n_params = cfg.num_params()
    p_dev = weight_bytes * n_params / msize  # master weights, model-sharded only
    b_dev = max(1, B // dsize)

    if kind == "train":
        # params: fwd read + remat read + bwd read; grads w+r; adam m,v r+w;
        # saved layer inputs (bf16) w+r; logits fp32 few passes
        act = cfg.num_layers * b_dev * S * cfg.d_model * 2 * 2
        logits = 3 * b_dev * S * (cfg.vocab_size / msize) * 4
        return 3 * p_dev + 2 * p_dev + 4 * p_dev + act + logits
    if kind == "prefill":
        act = cfg.num_layers * b_dev * S * cfg.d_model * 2 * 2
        cache = _cache_bytes_dev(cfg, S, b_dev, msize)
        return p_dev + act + cache
    # decode: weights once, cache read+write
    cache = _cache_bytes_dev(cfg, S, b_dev, msize)
    return p_dev + 2 * cache


def _cache_bytes_dev(cfg: ArchConfig, S: int, b_dev: int, msize: int) -> float:
    total = 0.0
    for lk in cfg.layer_kinds():
        if lk in ("attn", "local_attn"):
            L = S
            if lk == "local_attn":
                L = min(S, cfg.local_window)
            elif cfg.window:
                L = min(S, cfg.window)
            if cfg.kv_lora_rank:
                per_tok = (cfg.kv_lora_rank + cfg.rope_head_dim) * 2
            else:
                per_tok = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
            # kv-head (or sequence) dim is model-sharded when divisible
            total += b_dev * L * per_tok / msize
        elif lk == "ssm":
            s = cfg.ssm
            nh = s.num_heads or s.expand * cfg.d_model // s.head_dim
            total += b_dev * nh * s.head_dim * s.state_dim * 4
        elif lk == "rglru":
            total += b_dev * cfg.d_model * 4
    return total


# ---------------------------------------------------------------------------
# the step roofline
# ---------------------------------------------------------------------------


def roofline(cfg: ArchConfig, shape: str | dict, *, hw: dict, wall_s: float | None = None,
             weight_bytes: int = 4) -> dict:
    """The least time one step of ``shape`` could take on the card ``hw``
    (from :func:`hardware`): the analytic FLOPs at the bf16 peak, the
    analytic bytes at the memory rate, and no collectives on one card.
    Given a measured ``wall_s``, also ``mfu`` (analytic FLOPs over the wall
    times the bf16 peak) and ``hbm_share`` (analytic bytes over the wall
    times the memory rate)."""
    fl = analytic_flops(cfg, shape)
    by = analytic_hbm_bytes(cfg, shape, weight_bytes=weight_bytes)
    terms = {
        "compute_s": fl["total"] / hw["peak_flops_bf16"],
        "memory_s": by / hw["hbm_bw"],
        "collective_s": 0.0,
    }
    dominant = max(terms, key=terms.get)
    out = {
        **terms,
        "dominant": dominant,
        "step_time_bound_s": max(terms.values()),
        "analytic_flops_global": fl["total"],
        "model_flops_6nd_global": fl["6nd"],
        "useful_flops_ratio": fl["6nd"] / fl["total"] if fl["total"] else 0.0,
        "analytic_bytes_per_device": by,
    }
    if wall_s is not None:
        out["wall_s"] = wall_s
        out["mfu"] = fl["total"] / (wall_s * hw["peak_flops_bf16"])
        out["hbm_share"] = by / (wall_s * hw["hbm_bw"])
    return out


# ---------------------------------------------------------------------------
# the mesh roofline
# ---------------------------------------------------------------------------

_COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# ``torch.ops._c10d_functional`` op -> the reference's HLO kind
_FUNCOL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensor_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_tensor_bytes(o) for o in out)
    return 0


class CollectiveRecorder(TorchDispatchMode):
    """A dispatch mode that sees each device's own operations of a step
    traced over DTensors: it lets DTensor desugar each operation into
    local ones and collectives first, then records

    * each ``_c10d_functional`` collective: its kind, as the reference's
      ``parse_collectives`` names it, the bytes of its result (as
      ``parse_collectives`` counts them), and the ranks of its group;
    * the FLOPs of each local operation, by ``torch.utils.flop_counter``'s
      formulas (those of ``FlopCounterMode``).

    Eager tracing runs every layer, so there are no loop trip counts to
    multiply. Only operations on fake tensors of ``fake_mode`` count: not
    DTensor's own shape propagation (another fake mode) nor its
    bookkeeping on host tensors, which run outside the fake mode.
    ``on_output(result, held)`` is called with every counted operation's
    result; ``held`` is None, or the bytes it would hold on the card where
    PyTorch's CPU stand-in differs (an all-to-all's gathered buffer)."""

    def __init__(self, fake_mode, on_output=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.on_output = on_output
        self.bytes = {k: 0 for k in _COLL_OPS}
        self.counts = {k: 0 for k in _COLL_OPS}
        self.by_group: dict[int, int] = {}  # group size -> bytes
        self.flops = 0
        self._in_dtensor = False

    def _ours(self, args, out) -> bool:
        """Whether an operation is a device's own: it touches a fake tensor
        of ``fake_mode`` and none of another mode."""
        modes = [getattr(t, "fake_mode", None)
                 for t in pytree.tree_leaves((args, out)) if isinstance(t, torch.Tensor)]
        return self.fake_mode in modes and all(m in (None, self.fake_mode) for m in modes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor desugar the operation (NotImplemented), its own
            # bookkeeping on host tensors outside the fake mode, and see the
            # local operations it issues
            if self._in_dtensor:
                return NotImplemented
            self._in_dtensor = True
            try:
                with unset_fake_temporarily(), self:
                    return func(*args, **kwargs)
            finally:
                self._in_dtensor = False
        out = func(*args, **kwargs)
        if not self._ours((args, kwargs), out):
            return out
        held = None  # bytes the result holds on the card, where not its own
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        ns, _, name = getattr(packet, "_qualified_op_name", "").partition("::")
        if ns == "_c10d_functional" and name in _FUNCOL_KINDS:
            kind = _FUNCOL_KINDS[name]
            nbytes = _tensor_bytes(out)
            if kind == "all-gather" and _in_alltoall_fallback():
                # PyTorch's CPU stand-in for a Shard-to-Shard all-to-all: an
                # all-gather, then this rank's chunk; counted as the
                # all-to-all it stands for, whose result is that chunk
                kind, nbytes = "all-to-all", nbytes // _group_size(args, kwargs)
                held = nbytes
            self.bytes[kind] += nbytes
            self.counts[kind] += 1
            size = _group_size(args, kwargs)
            self.by_group[size] = self.by_group.get(size, 0) + nbytes
        if self.on_output is not None:
            self.on_output(out, held)
        return out

    def totals(self) -> dict:
        """The reference's ``parse_collectives`` keys, and the bytes by
        group size (``bytes_by_group_ranks``)."""
        return {"bytes": dict(self.bytes), "counts": dict(self.counts),
                "total_bytes": sum(self.bytes.values()),
                "bytes_by_group_ranks": dict(sorted(self.by_group.items()))}


def _in_alltoall_fallback() -> bool:
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code.co_name == "shard_dim_alltoall":
            return True
        frame = frame.f_back
    return False


def _group_size(args, kwargs) -> int:
    """Ranks of a functional collective's group: its ``group_size``
    argument, else its group's size by name."""
    import torch.distributed as dist

    for a in reversed(list(args) + list(kwargs.values())):  # the group name comes last
        if isinstance(a, str):
            from torch.distributed.distributed_c10d import _resolve_process_group

            return dist.get_world_size(_resolve_process_group(a))
    ints = [a for a in args[1:] if isinstance(a, int)]
    return ints[0] if ints else 1


def collective_seconds(coll: dict, hw: dict) -> float:
    """Seconds the recorded collectives take at the card's published
    interconnect rates: a group of at most ``nvlink_ranks`` ranks at the
    NVLink rate, a larger one (it spans nodes) at the InfiniBand rate."""
    return sum(b / (hw["nvlink_bw"] if ranks <= hw["nvlink_ranks"] else hw["ib_bw"])
               for ranks, b in coll["bytes_by_group_ranks"].items())


def mesh_roofline(cfg: ArchConfig, shape: str | dict, mesh_shape: dict, num_chips: int,
                  traced_flops: float, coll: dict, hw: dict) -> dict:
    """The reference's per-device roofline of one step on a mesh: the
    analytic FLOPs over the chips at the bf16 peak, the analytic bytes of
    one device at the memory rate, and the recorded collectives (``coll``,
    from :class:`CollectiveRecorder`) at the interconnect rates. The
    reference's raw HLO FLOPs become ``traced_flops_per_device``, what one
    device's traced operations count; it has no HLO bytes."""
    fl = analytic_flops(cfg, shape)
    flops_dev = fl["total"] / num_chips
    analytic_bytes = analytic_hbm_bytes(cfg, shape, mesh_shape)
    terms = {
        "compute_s": flops_dev / hw["peak_flops_bf16"],
        "memory_s": analytic_bytes / hw["hbm_bw"],
        "collective_s": collective_seconds(coll, hw),
    }
    dominant = max(terms, key=terms.get)
    return {
        **terms,
        "dominant": dominant,
        "step_time_bound_s": max(terms.values()),
        "analytic_flops_global": fl["total"],
        "model_flops_6nd_global": fl["6nd"],
        "useful_flops_ratio": fl["6nd"] / fl["total"] if fl["total"] else 0.0,
        "traced_flops_per_device": float(traced_flops),
        "analytic_bytes_per_device": analytic_bytes,
        "collective_bytes_per_device": coll["total_bytes"],
    }


# ---------------------------------------------------------------------------
# the kernel roofline
# ---------------------------------------------------------------------------
#
# Shape keys. GNN ops: ``edges`` E (ids given, padding included),
# ``segments`` N (output rows), ``dim`` D (a head's width for GAT), and
# optionally ``valid_edges`` Ev (default E), ``rows_read`` R (distinct rows
# a gather reads, default N), ``heads`` H (default 1). Attention: ``batch``,
# ``seq_q``, ``heads``, ``dim``, and optionally ``seq_kv`` (seq_q),
# ``kv_heads`` (heads), ``dim_v`` (dim), ``causal`` (True), ``window`` (0),
# ``kv_offset`` (0), ``o_bytes`` (the backward's saved output, dtype_bytes).
# SSD: ``batch``, ``seq``, ``heads``, ``head_dim`` P, ``groups`` G,
# ``state_dim`` N, and optionally ``init_state`` and ``final_state_grad``
# (False). Every op: ``dtype_bytes`` b (default 4). Ids are int32; the GAT
# logits and statistics, the SSD's a and dt and its states are float32.


def _gnn(shape: dict) -> tuple:
    e = shape["edges"]
    return (e, shape["segments"], shape["dim"], shape.get("valid_edges", e),
            shape.get("rows_read", shape["segments"]), shape.get("heads", 1),
            shape.get("dtype_bytes", 4))


def _segment_sum(shape: dict) -> tuple[float, float]:
    """Reads the valid edges' messages and every id; writes the output."""
    e, n, d, ev, _, _, b = _gnn(shape)
    return ev * d, ev * d * b + e * 4 + n * d * b


def _gather_sum(shape: dict) -> tuple[float, float]:
    """Reads the distinct gathered rows, idx and seg; writes the output."""
    e, n, d, ev, r, _, b = _gnn(shape)
    return ev * d, r * d * b + 2 * e * 4 + n * d * b


def _gather_sum_backward(shape: dict) -> tuple[float, float]:
    """Reads the distinct gradient rows, idx, seg and the order; writes
    the feature gradient (``segments`` = its rows)."""
    e, n, d, ev, r, _, b = _gnn(shape)
    return ev * d, r * d * b + 3 * e * 4 + n * d * b


def _unfused_gather_sum(shape: dict) -> tuple[float, float]:
    """A gather, then the sum: reads the rows and idx, writes the [Ev, D]
    messages, reads them back with seg, writes the output."""
    e, n, d, ev, r, _, b = _gnn(shape)
    return ev * d, r * d * b + 2 * ev * d * b + 2 * e * 4 + n * d * b


def _gat(shape: dict) -> tuple[float, float]:
    """Reads the valid edges' messages and float32 logits, every id; writes
    the output."""
    e, n, d, ev, _, h, b = _gnn(shape)
    return ev * h * (2 * d + 3), ev * h * d * b + ev * h * 4 + e * 4 + n * h * d * b


def _gat_backward(shape: dict) -> tuple[float, float]:
    """Reads the valid edges' messages and logits, the upstream gradient,
    the output, its float32 statistics and the ids; writes dmsg and dlogit."""
    e, n, d, ev, _, h, b = _gnn(shape)
    nbytes = (ev * h * (4 + d * b) + 2 * n * h * d * b + 2 * n * h * 4 + e * 4
              + e * h * (d * b + 4))
    return ev * h * (4 * d + 6), nbytes


def _segment_max(shape: dict) -> tuple[float, float]:
    """Reads every edge's value and id; writes the output (a compare an edge)."""
    e, n, b = shape["edges"], shape["segments"], shape.get("dtype_bytes", 4)
    return e, e * (4 + b) + n * b


def _segment_sort(shape: dict) -> tuple[float, float]:
    """Reads the ids; writes the permutation."""
    return 0.0, 8 * shape["edges"]


def _attn(shape: dict) -> tuple:
    """Sizes of q, k, v, o and the unmasked (query, key) pairs."""
    bz, sq, h, d = shape["batch"], shape["seq_q"], shape["heads"], shape["dim"]
    skv, hkv, dv = shape.get("seq_kv", sq), shape.get("kv_heads", h), shape.get("dim_v", d)
    window, offset = shape.get("window", 0), shape.get("kv_offset", 0)
    visible = 0
    for t in range(offset, offset + sq):
        lo = max(0, t - window + 1) if window > 0 else 0
        hi = min(skv, t + 1) if shape.get("causal", True) else skv
        visible += max(hi - lo, 0)
    sizes = (bz * sq * h * d, bz * skv * hkv * d, bz * skv * hkv * dv, bz * sq * h * dv)
    return sizes, bz * h * visible, 2 * (d + dv), shape.get("dtype_bytes", 4)


def _flash(shape: dict) -> tuple[float, float]:
    """Reads q, k, v; writes o (2 (D + Dv) flops an unmasked pair)."""
    (q, k, v, o), pairs, per_pair, b = _attn(shape)
    return per_pair * pairs, (q + k + v + o) * b


def _flash_backward(shape: dict) -> tuple[float, float]:
    """Reads q, k, v, o, dO and the float32 log-sum-exp; writes dq, dk, dv
    (2.5 times the forward's flops)."""
    (q, k, v, o), pairs, per_pair, b = _attn(shape)
    # dO is the size of o; dq, dk, dv of q, k, v
    nbytes = ((2 * (q + k + v) + o) * b + o * shape.get("o_bytes", b)
              + shape["batch"] * shape["heads"] * shape["seq_q"] * 4)
    return 2.5 * per_pair * pairs, nbytes


def _ssd(shape: dict) -> tuple:
    bz, s, h = shape["batch"], shape["seq"], shape["heads"]
    p, g, n = shape["head_dim"], shape["groups"], shape["state_dim"]
    state = bz * h * p * n * 4
    return (bz * s * h * p, bz * s * g * n, bz * s * h, state, bz * s * h * p * n,
            shape.get("dtype_bytes", 4))


def _ssd_scan(shape: dict) -> tuple[float, float]:
    """Reads x, B, C, the float32 a and dt and the initial state; writes y
    and the final state (the recurrence's 6 P N flops a step and head)."""
    x, bc, steps, state, work, b = _ssd(shape)
    init = state if shape.get("init_state", False) else 0
    return 6 * work, (2 * x + 2 * bc) * b + 2 * steps * 4 + init + state


def _ssd_scan_backward(shape: dict) -> tuple[float, float]:
    """Reads x, dy, B, C, a, dt, the initial state and the final state's
    gradient; writes dx, dB, dC, da, ddt and dinit (twice the forward's flops)."""
    x, bc, steps, state, work, b = _ssd(shape)
    states = 2 * state if shape.get("init_state", False) else 0
    final = state if shape.get("final_state_grad", False) else 0
    return 12 * work, (3 * x + 4 * bc) * b + 4 * steps * 4 + states + final


# op -> (flops, bytes); every op of the reference's ``KERNEL_OPS`` and the
# port's kernels it lacks
KERNEL_OPS = {
    "segment_spmm": _segment_sum,
    "segment_spmm_ragged": _segment_sum,
    "gather_spmm": _gather_sum,
    "gather_spmm_ragged": _gather_sum,
    "gather_spmm_ragged_backward": _gather_sum_backward,
    "gat_softmax_aggregate": _gat,
    "gat_softmax_aggregate_backward": _gat_backward,
    "segment_max": _segment_max,
    "unfused_gather_spmm": _unfused_gather_sum,  # gather -> segment sum, for comparison
    "segment_sort": _segment_sort,
    "flash_attention": _flash,
    "flash_attention_backward": _flash_backward,
    "ssd_scan": _ssd_scan,
    "ssd_scan_backward": _ssd_scan_backward,
}


def _formula(op: str):
    if op not in KERNEL_OPS:
        raise ValueError(f"unknown kernel op {op!r}")
    return KERNEL_OPS[op]


def kernel_flops(op: str, shape: dict) -> float:
    return _formula(op)(shape)[0]


def kernel_hbm_bytes(op: str, shape: dict) -> float:
    return _formula(op)(shape)[1]


_PEAK = {"f32": "peak_flops_f32", "float32": "peak_flops_f32",
         "bf16": "peak_flops_bf16", "bfloat16": "peak_flops_bf16"}


def kernel_roofline(op: str, shape: dict, wall_s: float, dtype: str, hw: dict) -> dict:
    """Achieved against peak for one measured kernel time on the card
    ``hw``. ``dtype`` names the type of the operations, and so the peak:
    float32 (the GNN kernels add in float32 whatever they read) outside the
    tensor cores, bf16 on them. ``bound_s`` is the least time the card
    could take; ``frac_of_bound`` is it over ``wall_s``."""
    if dtype not in _PEAK:
        raise ValueError(f"no peak for dtype {dtype!r}; known: {sorted(_PEAK)}")
    fl, by = _formula(op)(shape)
    peak = hw[_PEAK[dtype]]
    compute_s = fl / peak
    memory_s = by / hw["hbm_bw"]
    bound_s = max(compute_s, memory_s)
    achieved_flops = fl / wall_s if wall_s > 0 else 0.0
    achieved_bw = by / wall_s if wall_s > 0 else 0.0
    return {
        "op": op,
        "flops": fl,
        "hbm_bytes": by,
        "arithmetic_intensity": fl / by if by else 0.0,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "bound_s": bound_s,
        "bound": "compute" if compute_s >= memory_s else "memory",
        "wall_s": wall_s,
        "achieved_flops_per_s": achieved_flops,
        "frac_of_peak_flops": achieved_flops / peak if peak else 0.0,
        "achieved_bytes_per_s": achieved_bw,
        "frac_of_hbm_bw": achieved_bw / hw["hbm_bw"],
        "frac_of_bound": bound_s / wall_s if wall_s > 0 else 0.0,
    }
