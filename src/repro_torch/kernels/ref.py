"""Plain PyTorch versions of the kernels and of the GNN backwards.

Counterparts of ``repro/kernels/ref.py``; the attention and SSD versions
are at the bottom, with ``ssd_chunked_ref``, the chunked SSD of
``repro/models/transformer/ssm.py::ssd_chunked_jnp``, and the three phases
the SSD kernels split it into (``ssd_phases_ref``). The tests hold the CUDA
kernels and the JAX package against them, and the kernel wrappers use them
(with autograd through them) for tensors that lie on the CPU. Their gathers
are ``index_select``, whose CPU backward (``index_add_``) adds in index
order, so a CPU training run repeats bit for bit. ``seg == -1``
marks padding, and so does an id ``>= num_segments`` (dropped, as
``jax.ops.segment_sum`` drops it); ``idx == -1`` marks a padding gather.

The GNN ``*_backward_ref`` functions are the backwards written out from
their formulas, the twins of the backward kernels; the tests hold them
against ``torch.autograd`` of the plain forwards. The attention and SSD
backward kernels' twins are ``torch.autograd`` of the plain forwards
(``attention_backward_ref``, ``ssd_backward_ref``); ``ssd_chunk_grads_ref``
writes out the SSD backward kernels' algorithm, held against them.
"""
from __future__ import annotations

import torch

__all__ = [
    "SUM_CHUNK",
    "chunked_segment_sum_ref",
    "segment_spmm_ref",
    "segment_spmm_ragged_ref",
    "gather_spmm_ref",
    "gather_spmm_ragged_ref",
    "gather_spmm_ragged_backward_ref",
    "segment_max_ref",
    "segment_sort_ref",
    "table_rows_ref",
    "sorted_counts_ref",
    "gat_softmax_aggregate_ref",
    "gat_softmax_aggregate_backward_ref",
    "attention_ref",
    "attention_lse_ref",
    "attention_backward_ref",
    "bf16_operand",
    "attention_backward_bf16_ref",
    "flash_attention_ref",
    "ssd_scan_ref",
    "ssd_chunked_ref",
    "ssd_chunk_states_ref",
    "ssd_state_pass_ref",
    "ssd_chunk_out_ref",
    "ssd_phases_ref",
    "ssd_backward_ref",
    "ssd_chunk_grads_ref",
]


# The CSR sum kernel's chunk length: ``kSumChunk`` in ``csrc/common.cuh``
# (a CPU test pins the two together).
SUM_CHUNK = 64


def _valid(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (seg >= 0) & (seg < num_segments)


def chunked_segment_sum_ref(
    terms: torch.Tensor,
    seg: torch.Tensor,
    num_segments: int,
    keep: torch.Tensor | None = None,
    chunk: int = SUM_CHUNK,
) -> torch.Tensor:
    """The CSR sum kernel's order of additions, in float32: a test oracle
    (no wrapper calls it). ``terms`` [E, D] are the rows the kernel reads at
    each edge slot, ``seg`` [E] the slots' segment ids, non-decreasing with
    the padding (seg < 0 or >= n) at the tail, as the kernel reads them;
    ``keep`` [E] bool (None: all) is False where a gather drops the edge
    (idx < 0): that slot adds nothing but still counts toward its row's
    chunks. Row r is cut into chunks of ``chunk`` slots counted from its
    first slot; each chunk is summed from +0.0 one slot after another, and
    the chunk sums from +0.0 in chunk order. A row of at most ``chunk``
    slots is so a plain sequential sum. Returns [n, D] float32.

    Vectorised over rows: one step per position within a chunk, then one
    per chunk index; elementwise float32 adds, so the result has the
    kernel's bits on any device."""
    n = num_segments
    dev = terms.device
    t = terms.float()
    if keep is not None:
        t = torch.where(keep[:, None], t, 0.0)  # +0.0 adds nothing: no sum is -0.0
    key = seg.long().masked_fill(~_valid(seg, n), n)
    ptr = torch.searchsorted(key, torch.arange(n + 1, device=dev))
    lens = ptr[1:] - ptr[:-1]
    chunks = (lens + chunk - 1) // chunk
    chunk0 = torch.cumsum(chunks, 0) - chunks  # each row's first chunk id
    valid = key < n
    rows = key[valid]
    pos = torch.nonzero(valid).flatten() - ptr[rows]  # slot within its row
    cid = chunk0[rows] + pos // chunk
    step = pos % chunk
    by_step = torch.argsort(step, stable=True)
    per_step = torch.bincount(step, minlength=chunk).tolist()
    x = t[valid][by_step]
    cid = cid[by_step]
    partial = t.new_zeros((int(chunks.sum()), t.shape[1]))
    at = 0
    for count in per_step:  # a chunk has one slot at each step: no index repeats
        sel = cid[at:at + count]
        partial[sel] = partial[sel] + x[at:at + count]
        at += count
    out = t.new_zeros((n, t.shape[1]))
    by_chunks = torch.argsort(chunks, descending=True, stable=True)
    ranked = chunks[by_chunks]
    for k in range(int(chunks.max()) if n else 0):
        r = by_chunks[: int((ranked > k).sum())]
        out[r] = out[r] + partial[chunk0[r] + k]
    return out


def segment_spmm_ref(
    msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = sum_{e: seg[e]==s} msg[e], summed in float32 and cast to
    msg's dtype, as the kernel does; padding dropped."""
    ok = _valid(seg, num_segments)
    out = msg.new_zeros((num_segments,) + tuple(msg.shape[1:]), dtype=torch.float32)
    return out.index_add_(0, seg[ok].long(), msg[ok].float()).to(msg.dtype)


def segment_spmm_ragged_ref(
    msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The ragged kernel's tile skip changes nothing semantically."""
    return segment_spmm_ref(msg, seg, num_segments)


def gather_spmm_ref(
    feats: torch.Tensor, idx: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = sum_{e: seg[e]==s} feats[idx[e]], summed in float32 and cast
    to feats' dtype; edges with idx or seg padding are dropped."""
    ok = _valid(seg, num_segments) & (idx >= 0)
    out = feats.new_zeros((num_segments, feats.shape[1]), dtype=torch.float32)
    msg = feats.index_select(0, idx[ok].long()).float()
    return out.index_add_(0, seg[ok].long(), msg).to(feats.dtype)


def gather_spmm_ragged_ref(
    feats: torch.Tensor, idx: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The ragged kernel's tile skip changes nothing semantically."""
    return gather_spmm_ref(feats, idx, seg, num_segments)


def gather_spmm_ragged_backward_ref(
    grad: torch.Tensor, idx: torch.Tensor, seg: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """d feats of :func:`gather_spmm_ref` for the upstream ``grad`` [n, D]:
    dfeats[f] = sum_{e: idx[e]==f} grad[seg[e]], the same function with the
    roles of ``idx`` and ``seg`` swapped."""
    n = grad.shape[0]
    seg_ok = torch.where(_valid(seg, n), seg, torch.full_like(seg, -1))
    return gather_spmm_ref(grad, seg_ok, idx, num_rows)


def segment_max_ref(
    x: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment max (padding excluded) in x's dtype, from -inf; a segment
    that is empty, or whose max is not finite, yields 0.0 (the JAX
    reference's ``isfinite`` fix). The order is total, as the kernel's: a
    NaN counts as above +inf (so its segment yields 0.0, as a NaN that
    propagates would) and -0.0 as below +0.0, so the result does not depend
    on the order of the edges on any device."""
    ok = _valid(seg, num_segments)
    xs, s = x[ok], seg[ok].long()
    xs = torch.where(torch.isnan(xs), float("inf"), xs)
    mx = x.new_full((num_segments,), float("-inf")).scatter_reduce(0, s, xs, "amax")
    pos_zero = ((xs == 0) & ~torch.signbit(xs)).to(torch.int32)
    any_pos_zero = torch.zeros_like(mx, dtype=torch.int32).scatter_reduce(0, s, pos_zero, "amax")
    zero = torch.where(any_pos_zero > 0, mx.abs(), -mx.abs())  # +0.0 or -0.0
    mx = torch.where(mx == 0, zero, mx)
    return torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))


def segment_sort_ref(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The int32 permutation that stable-sorts ``seg`` by its key: the id,
    or ``num_segments`` for padding (seg < 0) and ids >= num_segments, which
    so come last in index order. The plain version of ``csrc/segment_sort.cu``
    (``torch.sort``; never on the card's path)."""
    key = seg.long().masked_fill(~_valid(seg, num_segments), num_segments)
    return torch.sort(key, stable=True).indices.to(torch.int32)


def table_rows_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """float32 [len(ids), F]: row ``ids[r]`` of ``table`` [N, F], a zero row
    where ``ids[r]`` is padding (< 0) or >= N. The plain version of
    ``csrc/batch_finish.cu``'s ``table_rows_kernel``."""
    out = torch.zeros((ids.shape[0], table.shape[1]), dtype=torch.float32)
    keep = _valid(ids, table.shape[0])
    out[keep] = table[ids[keep].long()].to(torch.float32)
    return out


def sorted_counts_ref(keys: torch.Tensor, num_rows: int) -> torch.Tensor:
    """float32 [num_rows, 1]: how many of ``keys`` equal each row in [0,
    num_rows), keys out of that range (the padding) counting for none. The
    plain version of ``csrc/batch_finish.cu``'s ``sorted_counts_kernel``,
    which reads the counts off sorted keys."""
    keep = keys[_valid(keys, num_rows)].long()
    return torch.bincount(keep, minlength=num_rows).to(torch.float32)[:, None]


def gat_softmax_aggregate_ref(
    logits: torch.Tensor, msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """3-pass version of the one-pass kernel for one head: segment max,
    exp/normalize with the ``max(z, 1e-9)`` guard, weighted segment sum in
    float32, cast to msg's dtype. Empty segments return 0. The max is a
    shift the softmax does not depend on, so no gradient flows through it."""
    ok = _valid(seg, num_segments)
    seg0 = torch.where(ok, seg, torch.zeros_like(seg)).long()
    lf = logits.float()
    mx = segment_max_ref(lf.detach(), seg, num_segments)
    e = torch.where(ok, torch.exp(lf - mx.index_select(0, seg0)), torch.zeros_like(lf))
    z = lf.new_zeros(num_segments).index_add_(0, seg0, e)
    alpha = e / torch.clamp_min(z.index_select(0, seg0), 1e-9)
    weighted = torch.where(ok[:, None], msg.float(), 0.0) * alpha[:, None]
    out = lf.new_zeros((num_segments, msg.shape[1])).index_add_(0, seg0, weighted)
    return out.to(msg.dtype)


def gat_softmax_aggregate_backward_ref(
    grad: torch.Tensor,
    logits: torch.Tensor,
    msg: torch.Tensor,
    seg: torch.Tensor,
    num_segments: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d logits, d msg) of :func:`gat_softmax_aggregate_ref` for one head
    and the upstream ``grad`` [n, D], in float32. With
    alpha_e = exp(l_e - M_s) / max(Z_s, 1e-9) for the row s of edge e:
    dmsg[e] = alpha_e * g_s and dlogit[e] = alpha_e * (g_s . msg[e] - g_s . out_s).
    Padding edges get 0."""
    ok = _valid(seg, num_segments)
    seg0 = torch.where(ok, seg, torch.zeros_like(seg)).long()
    lf = logits.float()
    mx = segment_max_ref(lf, seg, num_segments)
    e = torch.where(ok, torch.exp(lf - mx[seg0]), torch.zeros_like(lf))
    z = lf.new_zeros(num_segments).index_add_(0, seg0, e)
    alpha = e / torch.clamp_min(z[seg0], 1e-9)
    out = gat_softmax_aggregate_ref(logits, msg, seg, num_segments).float()
    g = grad.float()
    g_e = torch.where(ok[:, None], g[seg0], 0.0)
    g_out = (g * out).sum(1)[seg0]
    dmsg = alpha[:, None] * g_e
    dlogit = torch.where(ok, alpha * ((g_e * msg.float()).sum(1) - g_out), 0.0)
    return dlogit, dmsg


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Dense attention in float32 with the flash kernel's masks. q [B, Sq,
    H, D]; k [B, Skv, Hkv, D] and v [B, Skv, Hkv, Dv] with Hkv dividing H
    (query head h reads kv head h // (H / Hkv)); v's width may differ
    (MLA). Query i sits at absolute position ``kv_offset + i``: causal
    keeps keys at or before it, ``window > 0`` keeps the last ``window`` of
    those. Scores are scaled by 1/sqrt(D) and masked with -1e30; the result
    [B, Sq, H, Dv] has q's dtype."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q5 = q.reshape(b, sq, hkv, h // hkv, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k.float()) / d**0.5
    q_pos = kv_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, -1e30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


# The kernel's plain version under the JAX package's paired name.
flash_attention_ref = attention_ref


def attention_lse_ref(q, k, *, causal: bool = True, window: int = 0, kv_offset: int = 0):
    """Each query row's log-sum-exp of its scaled, masked scores (float32
    [B, H, Sq], natural log), the flash kernel's ``lse`` output: the
    backward kernel recomputes P = exp(s - lse) from it."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q5 = q.reshape(b, sq, hkv, h // hkv, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k.float()) / d**0.5
    q_pos = kv_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return torch.logsumexp(torch.where(mask, s, -1e30), dim=-1).reshape(b, h, sq)


def attention_backward_ref(q, k, v, dout, *, causal: bool = True, window: int = 0,
                           kv_offset: int = 0):
    """(dq, dk, dv) of :func:`attention_ref` for the output gradient
    ``dout``, by ``torch.autograd`` (the backward kernel's twin); each in
    its input's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, window=window, kv_offset=kv_offset)
        return torch.autograd.grad(out, leaves, dout)


def bf16_operand(t: torch.Tensor, parts: int) -> torch.Tensor:
    """A float32 tensor as a bf16 tensor-core operand, back in float32: the
    sum of ``parts`` bf16 tensors, each the bf16 of what the ones before it
    leave (one product each): 1 rounds once, 2 keeps about 16 bits, 3
    float32's 24."""
    out = torch.zeros_like(t)
    for _ in range(parts):
        out = out + (t - out).bfloat16().float()
    return out


# Which operands of the bf16 flash backward kernel are split into a high
# and a low bf16 part (csrc/flash_attention_backward.cu, kSplitP / kSplitDS)
FLASH_BWD_SPLIT_P = False
FLASH_BWD_SPLIT_DS = True


def attention_backward_bf16_ref(q, k, v, dout, *, causal: bool = True, window: int = 0,
                                kv_offset: int = 0, split_p: bool = FLASH_BWD_SPLIT_P,
                                split_ds: bool = FLASH_BWD_SPLIT_DS):
    """(dq, dk, dv) as the bf16 tensor-core backward kernel forms them, in
    plain PyTorch: S, dP, D = rowsum(dO o) with o the float32 output (as
    the forward hands it to training) and every sum in float32, but P
    rounded to bf16 as the A operand of dV = P^T dO and dS as that of dK =
    dS^T q and dQ = dS k (each a high/low split instead where ``split_p``
    / ``split_ds``); each gradient rounded once to its input's dtype, dK
    and dV after the sum over a KV head's query heads."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    grp = h // hkv
    qf = q.reshape(b, sq, hkv, grp, d).float()
    kf, vf = k.float(), v.float()
    dof = dout.reshape(b, sq, hkv, grp, v.shape[-1]).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) / d**0.5
    q_pos = kv_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, -1e30)
    p = torch.where(mask, torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True)), 0.0)
    o32 = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    delta = (dof * o32).sum(-1)  # [b, q, h, g]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    pr, dsr = bf16_operand(p, 1 + split_p), bf16_operand(ds, 1 + split_ds)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pr, dof)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", dsr, qf) / d**0.5
    dq = torch.einsum("bhgqk,bkhd->bqhgd", dsr, kf) / d**0.5
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_scan_ref(
    x: torch.Tensor,  # [S, H, P]
    dt: torch.Tensor,  # [S, H]
    A: torch.Tensor,  # [H]
    B: torch.Tensor,  # [S, G, N]
    C: torch.Tensor,  # [S, G, N]
) -> torch.Tensor:
    """The sequential SSD (Mamba-2) recurrence, one step at a time:

        state_s = exp(A_h dt_s) * state_{s-1} + dt_s * B_s (x) x_s
        y_s     = C_s . state_s

    from a zero state, in float32; heads h read group h // (H / G).
    Returns y [S, H, P] in x's dtype."""
    S, H, P = x.shape
    reps = H // B.shape[1]
    Bh = B.repeat_interleave(reps, dim=1).float()
    Ch = C.repeat_interleave(reps, dim=1).float()
    decay = torch.exp(A[None, :] * dt).float()
    dtf, xf = dt.float(), x.float()
    state = x.new_zeros((H, P, B.shape[2]), dtype=torch.float32)
    ys = []
    for s in range(S):
        state = state * decay[s][:, None, None] + (
            dtf[s][:, None, None] * xf[s][:, :, None] * Bh[s][:, None, :]
        )
        ys.append(torch.einsum("hpn,hn->hp", state, Ch[s]))
    return torch.stack(ys).to(x.dtype)


def ssd_chunked_ref(x, a, dt, B, C, *, chunk: int = 128, init_state=None):
    """The chunked SSD of ``ssd_chunked_jnp``: x [Bz, S, H, P]; a = dt * A
    and dt [Bz, S, H] float32; B, C [Bz, S, G, N] in group form (head h
    reads group h // (H / G)); init_state [Bz, H, P, N] float32 or None
    (zeros). Within a chunk of ``chunk`` steps the token-token term is the
    L x L matrix (C_i . B_j) exp(csum_i - csum_j) dt_j (j <= i) times x;
    the earlier chunks enter through the carried state. A ragged tail is
    padded with a = 0 and dt = 0, which leaves the state as it was.
    Returns (y [Bz, S, H, P] in x's dtype, final_state [Bz, H, P, N]
    float32)."""
    bz, S, H, P = x.shape
    G, N = B.shape[-2], B.shape[-1]
    reps = H // G
    pad = (-S) % chunk
    if pad:
        x, B, C = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        a, dt = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (a, dt))
    nc = (S + pad) // chunk
    state = (
        x.new_zeros((bz, H, P, N), dtype=torch.float32) if init_state is None
        else init_state.float()
    )
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xk = x[:, sl].float()
        bk = B[:, sl].repeat_interleave(reps, dim=2).float()
        ck = C[:, sl].repeat_interleave(reps, dim=2).float()
        ak, dk = a[:, sl].float(), dt[:, sl].float()
        csum = torch.cumsum(ak, dim=1)  # [Bz, L, H]
        cb = torch.einsum("blhn,bmhn->bhlm", ck, bk)
        seg = csum[:, :, None] - csum[:, None, :]  # [Bz, L, L, H]
        decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
        m = cb * decay.permute(0, 3, 1, 2) * dk.permute(0, 2, 1)[:, :, None, :]
        y = torch.einsum("bhlm,bmhp->blhp", m, xk)
        y = y + torch.exp(csum)[..., None] * torch.einsum("blhn,bhpn->blhp", ck, state)
        w = torch.exp(csum[:, -1:, :] - csum) * dk  # [Bz, L, H]
        state = torch.exp(csum[:, -1])[:, :, None, None] * state + torch.einsum(
            "blhp,blhn->bhpn", xk * w[..., None], bk
        )
        ys.append(y)
    if not ys:  # S = 0
        return x.new_empty((bz, 0, H, P)), state
    return torch.cat(ys, dim=1)[:, :S].to(x.dtype), state


def _ssd_chunks(x, a, dt, B, C, chunk):
    """Inputs padded to whole chunks (a = 0, dt = 0, x = B = C = 0 past S)
    and cut into them: x [Bz, nc, L, H, P], a and dt [Bz, nc, L, H], B and C
    [Bz, nc, L, H, N] with the groups repeated over their heads, all
    float32; and the running sum of a within each chunk."""
    bz, S, H, P = x.shape
    reps = H // B.shape[2]
    pad = (-S) % chunk
    if pad:
        x, B, C = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        a, dt = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (a, dt))
    nc = (S + pad) // chunk

    def cut(t):
        return t.float().reshape((bz, nc, chunk) + t.shape[2:])

    xc, ac, dc = cut(x), cut(a), cut(dt)
    Bc, Cc = (cut(t.repeat_interleave(reps, dim=2)) for t in (B, C))
    return xc, ac, dc, Bc, Cc, torch.cumsum(ac, dim=2)


def ssd_chunk_states_ref(x, a, dt, B, *, chunk: int):
    """The SSD kernels' first phase (``ssd_scan_kernel_chunk_state``): each
    chunk's own state S_c = sum_j exp(csum_L - csum_j) dt_j x_j (x) B_j and
    its decay exp(csum_L), from the chunk alone. x [Bz, S, H, P]; a = dt * A
    and dt [Bz, S, H]; B [Bz, S, G, N]. Returns (states [Bz, H, nc, P, N],
    decay [Bz, H, nc]), float32; nc = ceil(S / chunk)."""
    xc, _, dc, Bc, _, csum = _ssd_chunks(x, a, dt, B, B, chunk)
    w = torch.exp(csum[:, :, -1:] - csum) * dc  # [Bz, nc, L, H]
    states = torch.einsum("bclhp,bclhn->bhcpn", xc * w[..., None], Bc)
    return states, torch.exp(csum[:, :, -1]).permute(0, 2, 1)


def ssd_state_pass_ref(states, decay, init_state=None):
    """The second phase (``ssd_scan_kernel_state_pass``): the state entering
    each chunk, H_{c-1}, in chunk order from ``init_state`` [Bz, H, P, N]
    (None: zeros), with H_c = decay_c H_{c-1} + S_c. Returns (entering
    [Bz, H, nc, P, N], final_state [Bz, H, P, N]), float32."""
    h = torch.zeros_like(states[:, :, 0]) if init_state is None else init_state.float()
    entering = []
    for c in range(states.shape[2]):
        entering.append(h)
        h = decay[:, :, c, None, None] * h + states[:, :, c]
    return torch.stack(entering, dim=2) if entering else states.clone(), h


def ssd_chunk_out_ref(x, a, dt, B, C, entering, *, chunk: int):
    """The third phase (``ssd_scan_kernel_chunk_out``): per chunk
    y = diag(exp(csum)) C H_{c-1}^T + M x, M_ij = (C_i . B_j)
    exp(csum_i - csum_j) dt_j for j <= i, with ``entering`` the states from
    :func:`ssd_state_pass_ref`. Returns y [Bz, S, H, P] in x's dtype."""
    bz, S, H, P = x.shape
    xc, _, dc, Bc, Cc, csum = _ssd_chunks(x, a, dt, B, C, chunk)
    g = torch.einsum("bclhn,bcmhn->bchlm", Cc, Bc)
    seg = csum[:, :, :, None, :] - csum[:, :, None, :, :]  # [Bz, nc, L, L, H]: i, j
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    m = g * decay.permute(0, 1, 4, 2, 3) * dc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y = torch.einsum("bchlm,bcmhp->bclhp", m, xc)
    y = y + torch.exp(csum)[..., None] * torch.einsum("bclhn,bhcpn->bclhp", Cc, entering)
    return y.reshape(bz, -1, H, P)[:, :S].to(x.dtype)


def ssd_phases_ref(x, a, dt, B, C, *, chunk: int, init_state=None):
    """The SSD as the kernels split it: chunk states, state passing, chunk
    output, in plain PyTorch; the same function as :func:`ssd_chunked_ref`.
    Returns (y [Bz, S, H, P] in x's dtype, final_state [Bz, H, P, N])."""
    states, decay = ssd_chunk_states_ref(x, a, dt, B, chunk=chunk)
    entering, final = ssd_state_pass_ref(states, decay, init_state)
    return ssd_chunk_out_ref(x, a, dt, B, C, entering, chunk=chunk), final


def ssd_backward_ref(x, a, dt, B, C, dy, dfinal=None, *, chunk: int = 128, init_state=None):
    """The gradients of :func:`ssd_chunked_ref` for dy (y's gradient) and
    dfinal (the final state's, None: zero), by ``torch.autograd`` (the SSD
    backward kernels' twin): (dx, da, ddt, dB, dC, dinit), dt's gradient
    its direct part only (a = dt * A carries the rest), dinit None without
    an ``init_state``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, a, dt, B, C)]
        init = None if init_state is None else init_state.detach().requires_grad_(True)
        y, final = ssd_chunked_ref(*ins, chunk=chunk, init_state=init)
        outs, grads = [y], [dy]
        if dfinal is not None:
            outs.append(final)
            grads.append(dfinal)
        got = torch.autograd.grad(outs, ins + ([init] if init is not None else []), grads)
    return (*got[:5], got[5] if init is not None else None)


def ssd_chunk_grads_ref(x, a, dt, B, C, dy, dfinal=None, *, chunk: int = 64, init_state=None,
                        split: bool = False):
    """The SSD backward kernels' algorithm (``csrc/ssd_scan_backward.cu``)
    in plain PyTorch, float32: the states entering each chunk (H_c) and the
    gradients arriving at each chunk's end (D_c) by two state passes, then
    each chunk's gradients from its quadratic form. With ``split``, the
    bf16 kernels' operands (:func:`bf16_operand`): x w and dy e for the
    chunk states, H_c and D_c in three bf16 parts, m1 = G E dt and m2 =
    X E dt in two; x, dy, B and C enter as given (the kernels' bf16
    inputs). Returns what :func:`ssd_backward_ref` returns."""
    bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    reps = H // G
    xc, ac, dc, Bc, Cc, csum = _ssd_chunks(x, a, dt, B, C, chunk)
    dyc = _ssd_chunks(dy, a, dt, B, C, chunk)[0]
    nc = xc.shape[1]
    last = csum[:, :, -1:]  # [Bz, nc, 1, H]
    ej = torch.exp(last - csum)  # exp(csum_L - csum_j)
    ei = torch.exp(csum)
    def op(t, parts):  # a product's float32 operand as the bf16 kernels take it
        return bf16_operand(t, parts) if split else t

    # the chunks' own forward and reverse states, then the two passes
    own_f = torch.einsum("bclhp,bclhn->bchpn", op(xc * (ej * dc)[..., None], 3), Bc)
    own_r = torch.einsum("bclhp,bclhn->bchpn", op(dyc * ei[..., None], 3), Cc)
    decay = torch.exp(last[:, :, 0])  # [Bz, nc, H]
    h = x.new_zeros((bz, H, P, N), dtype=torch.float32) if init_state is None else init_state.float()
    entering = []
    for c in range(nc):
        entering.append(h)
        h = decay[:, c, :, None, None] * h + own_f[:, c]
    g = x.new_zeros((bz, H, P, N), dtype=torch.float32) if dfinal is None else dfinal.float()
    arriving = [None] * nc
    for c in reversed(range(nc)):
        arriving[c] = g
        g = decay[:, c, :, None, None] * g + own_r[:, c]
    Hc, Dc = torch.stack(entering, 1), torch.stack(arriving, 1)  # [Bz, nc, H, P, N]
    Hs, Ds = op(Hc, 3), op(Dc, 3)  # as the products take them
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]  # i, j
    seg = csum[:, :, :, None, :] - csum[:, :, None, :, :]
    E = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)  # [Bz, nc, i, j, H]
    Gm = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)
    Xm = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    dtj = dc[:, :, None, :, :]
    m1, m2, w = op(Gm * E * dtj, 2), op(Xm * E * dtj, 2), Gm * Xm * E
    u = torch.einsum("bcjhn,bchpn->bcjhp", Bc, Ds)  # D_c B_j
    dx = torch.einsum("bcijh,bcihp->bcjhp", m1, dyc) + (dc * ej)[..., None] * u
    dB = torch.einsum("bcijh,bcihn->bcjhn", m2, Cc) + (dc * ej)[..., None] * torch.einsum(
        "bcjhp,bchpn->bcjhn", xc, Ds)
    dC = torch.einsum("bcijh,bcjhn->bcihn", m2, Bc) + ei[..., None] * torch.einsum(
        "bcihp,bchpn->bcihn", dyc, Hs)
    xdb = (xc * u).sum(-1)  # x_j^T D_c B_j
    ddt = w.sum(2) + ej * xdb
    q = w * dtj
    tj = dc * ej * xdb
    rr = ei * (Cc * torch.einsum("bcihp,bchpn->bcihn", dyc, Hs)).sum(-1)
    dcs = q.sum(3) - q.sum(2) + rr - tj
    dcs[:, :, -1] += tj.sum(2) + decay * (Dc * Hc).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcs, [2]), 2), [2])

    def unchunk(t):
        return t.reshape((bz, nc * chunk) + t.shape[3:])[:, :S]

    dB_g, dC_g = (unchunk(t).reshape(bz, S, G, reps, N).sum(3) for t in (dB, dC))
    dinit = g if init_state is not None else None
    return (unchunk(dx).to(x.dtype), unchunk(da), unchunk(ddt), dB_g.to(B.dtype),
            dC_g.to(C.dtype), dinit)
