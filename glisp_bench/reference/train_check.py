"""The training cells' comparison: the program's first steps against the
reference's, from the same weights over the same sampled edges.

For each checked step the reference reads the program's batch only to
find its sample: each table row's vertex is found by its feature row, and
the layers' edge lists give the hops (layer K-1 holds hop 0, layer K-2
hops 0-1, ...). The sample is checked by itself (``samples.HopCheck``),
and so are the batch's seeds (distinct training vertices, as many as the
batch size) and its table (the sorted vertices of the sample). The
reference then builds its own batch from the graph's features and labels
and trains its own copy of the weights for the same steps, in float64. A
float32 reference on the card sums with atomic adds (``index_add``) in an
order that changes from run to run, and now and then takes a ReLU or
LeakyReLU input within rounding of 0 to the other side of the kink, which
moves the median leaf's gradient and change as far as the control moves
them (PERF.md). The float64 reference takes no such turn at float32's
scale, so a seed reads the same numbers on every run.

Numbers compared, each against its limit:

* ``loss_gap``: the largest |program loss - reference loss| / |reference
  loss| over the checked steps;
* ``grad_gap``: the first step's gradient as the optimizer took it (the
  program's from its first moment after one step, mu / (1 - b1)), by the
  median leaf of |program norm - reference norm| over the larger of the
  reference leaf's norm and the median leaf's (the worst leaf swings with
  float32 rounding at the ReLU and LeakyReLU kinks: see PERF.md);
* ``change_gap``: each leaf's change over the checked steps, by the median
  leaf as ``grad_gap``, leaving out leaves whose reference gradient is
  under a thousandth of the median leaf's (they move by round-off alone);
* ``sample_faults``: faults of the sample, the seeds and the table;
* ``sample_fill``: the sampled edges over the edges the hops could hold.
"""
from __future__ import annotations

import numpy as np
import torch

from glisp_bench.reference import gnn
from glisp_bench.reference.samples import EdgeIndex, HopCheck

__all__ = ["rows_to_vertices", "batch_sample", "reference_run", "gaps", "check_training",
           "leaf_gaps"]


def rows_to_vertices(feats: np.ndarray):
    """A lookup from a feature row's bytes to its vertex."""
    table = {row.tobytes(): v for v, row in enumerate(feats)}
    return lambda rows: np.array([table.get(r.tobytes(), -1) for r in rows], np.int64)


def batch_sample(batch: dict, lookup, num_layers: int, hc: HopCheck, fanouts, train_ids,
                 batch_size: int):
    """(seeds, hops [(src, dst)]) of a program batch, its faults into ``hc``."""
    valid = batch["valid"]
    rows = batch["feats"][valid]
    verts = lookup(rows)
    hc.fault(int((verts < 0).sum()))
    if verts.shape[0] > 1 and not np.all(np.diff(verts) > 0):
        hc.fault()  # the table is the sample's vertices, sorted and distinct
    seeds = verts[batch["seed_pos"]] if verts.shape[0] else np.zeros(0, np.int64)
    if np.unique(seeds).shape[0] != seeds.shape[0] or seeds.shape[0] != batch_size:
        hc.fault()
    hc.fault(int((~np.isin(seeds, train_ids)).sum()))
    sizes = []
    layer_pairs = []
    for k in range(num_layers):
        d_pos, s_pos = batch["layer_dst"][k], batch["layer_src"][k]
        e = int((d_pos >= 0).sum())
        if np.any(d_pos[e:] >= 0) or np.any(s_pos[:e] < 0) or np.any(s_pos[e:] >= 0):
            hc.fault()  # padding only at the tail
        ok = (d_pos[:e] < verts.shape[0]) & (s_pos[:e] < verts.shape[0])
        hc.fault(int((~ok).sum()))
        layer_pairs.append((verts[d_pos[:e][ok]], verts[s_pos[:e][ok]]))
        sizes.append(e)
    # hop h is layer 0's edges past the first (layers K-1 .. K-h)'s
    full_s, full_d = layer_pairs[0]
    hops = []
    lo = 0
    for h in range(num_layers):
        hi = layer_pairs[num_layers - 1 - h][0].shape[0]
        hops.append((full_s[lo:hi], full_d[lo:hi]))
        lo = hi
    for k in range(num_layers):
        s, d = layer_pairs[k]
        if not (np.array_equal(s, full_s[:s.shape[0]]) and np.array_equal(d, full_d[:d.shape[0]])):
            hc.fault()  # layer k's edges are hops 0 .. K-1-k
    frontier = seeds
    for h, (s, d) in enumerate(hops):
        hc.hop(frontier, s, d, fanouts[h])
        frontier = np.unique(d)
    every = np.unique(np.concatenate([seeds] + [x for hop in hops for x in hop]))
    if not np.array_equal(every, verts):
        hc.fault()
    return seeds, hops


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |program norm - reference norm| over the larger of the
    reference leaf's norm and the median leaf's."""
    ref_norm = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in ref}
    median = float(np.median(list(ref_norm.values())))
    return {n: abs(float(torch.linalg.vector_norm(prog[n].double())) - ref_norm[n])
            / max(ref_norm[n], median, 1e-30) for n in ref if keep is None or keep(n)}


def _worst(by_leaf: dict) -> list:
    name = max(by_leaf, key=by_leaf.get)
    return [name, by_leaf[name]]


def reference_run(cfg: dict, arrays: dict, weights: dict, samples: list, device,
                  precision: str = "float32", dtype=torch.float32) -> dict:
    """The reference's own steps from ``weights`` over the checked steps'
    ``samples`` [(seeds, hops)]: each step's loss, the first step's
    clipped gradient, and the weights after the last step, by leaf name.
    ``dtype=torch.float64`` computes it all in float64 (the reference the
    numbers are taken against)."""
    gnn.set_float32()
    kind, K = cfg["model"], cfg["num_layers"]
    feats = torch.as_tensor(arrays["vertex_feats"], device=device).to(dtype)
    labels = torch.as_tensor(arrays["labels"].astype(np.int64), device=device)
    tree = {"layers": [{k: v.detach().to(dtype, copy=True) for k, v in p.items()}
                       for p in weights["layers"]],
            "out": weights["out"].detach().to(dtype, copy=True)}
    start = {name: t.clone() for name, t in gnn.leaves(tree)}
    state = gnn.adamw_state(tree)
    losses, first = [], None
    for seeds, hops in samples:
        verts = np.unique(np.concatenate([seeds] + [x for hop in hops for x in hop]))
        pos = lambda v: torch.as_tensor(np.searchsorted(verts, v), device=device)  # noqa: E731
        layer_edges = []
        for k in range(K):
            s = np.concatenate([hop[0] for hop in hops[:K - k]])
            d = np.concatenate([hop[1] for hop in hops[:K - k]])
            layer_edges.append((pos(s), pos(d)))
        for _, t in gnn.leaves(tree):
            t.requires_grad_(True)
            t.grad = None
        vtab = torch.as_tensor(verts, device=device)
        loss = gnn.loss(kind, tree, feats.index_select(0, vtab), layer_edges, pos(seeds),
                        labels.index_select(0, torch.as_tensor(seeds, device=device)), precision)
        loss.backward()
        grads = {name: t.grad.detach() for name, t in gnn.leaves(tree)}
        for _, t in gnn.leaves(tree):
            t.requires_grad_(False)
        clipped = gnn.adamw_step(tree, grads, state, cfg["optimizer"])
        first = clipped if first is None else first
        losses.append(float(loss.detach()))
    return {"losses": losses, "grads": first, "start": start,
            "after": {name: t.clone() for name, t in gnn.leaves(tree)}}


def gaps(losses: list, grads: dict, after: dict, ref: dict) -> dict:
    """``loss_gap``, and the median leaf's ``grad_gap`` and ``change_gap``,
    of a run (its losses, first gradient and final weights by leaf) against
    the reference's; the worst leaf of each under ``_worst``."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(losses, ref["losses"]))
    grad = leaf_gaps(grads, ref["grads"])
    grad_norm = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["grads"].items()}
    floor = 1e-3 * float(np.median(list(grad_norm.values())))
    start = ref["start"]
    ref_change = {k: ref["after"][k] - start[k] for k in start}
    change = leaf_gaps({k: after[k] - start[k].to(after[k].dtype) for k in start}, ref_change,
                       keep=lambda k: grad_norm[k] >= floor)
    return {"loss_gap": loss_gap, "grad_gap": float(np.median(list(grad.values()))),
            "change_gap": float(np.median(list(change.values()))),
            "_worst": {"grad": _worst(grad), "change": _worst(change)},
            "_left_out": sorted(k for k, v in grad_norm.items() if v < floor)}


def check_training(cfg: dict, arrays: dict, train_ids: np.ndarray, weights: dict, steps: list,
                   mu1: dict, after: dict, device, control: bool = False,
                   witness: bool = False) -> dict:
    """The numbers of the module's docstring. ``steps`` holds, per checked
    step, the program's batch as numpy arrays and its loss; ``weights``
    the starting weights, ``mu1`` the program's first moments after one
    step and ``after`` its weights after the checked steps, each by leaf
    name (``gnn.leaves``). ``control``: also the numbers of the reference
    computed in TF32 in the program's place (``"control"``). ``witness``:
    also the gaps of the reference computed in float32 (``"_witness"``):
    float32's own rounding, beside the program's."""
    n, K = arrays["num_vertices"], cfg["num_layers"]
    hc = HopCheck(EdgeIndex(arrays["src"], arrays["dst"], n))
    lookup = rows_to_vertices(arrays["vertex_feats"])
    samples = [batch_sample(batch, lookup, K, hc, cfg["fanouts"], train_ids, cfg["batch_size"])
               for batch, _ in steps]
    ref = reference_run(cfg, arrays, weights, samples, device, dtype=torch.float64)
    b1 = cfg["optimizer"]["b1"]
    out = gaps([float(loss) for _, loss in steps], {k: v / (1 - b1) for k, v in mu1.items()},
               after, ref)
    out.update(sample_faults=hc.bad, sample_fill=hc.fill())
    if control:
        low = reference_run(cfg, arrays, weights, samples, device, precision="tf32")
        out["control"] = gaps(low["losses"], low["grads"], low["after"], ref)
    if witness:
        same = reference_run(cfg, arrays, weights, samples, device)
        out["_witness"] = gaps(same["losses"], same["grads"], same["after"], ref)
    return out
