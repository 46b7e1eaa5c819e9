"""The yardstick: the card's published peaks, the GNN kernels' operations
and bytes, and the model FLOPs of a GNN step or layer slice.

``PEAKS`` and the op formulas are a frozen copy of ``HW`` and of the GNN
rows of ``KERNEL_OPS`` in ``src/repro_torch/launch/roofline.py`` at commit
2c9ddc5f1ad4cf75904747720f1e0edd62342e0b, so that a later change to the
program cannot move the bounds it is measured against. Every count is of
what the call's inputs need: each input byte read once, each output byte
written once; ids are int32, the GAT logits float32, ``dtype_bytes``
defaults to 4 (float32).
"""
from __future__ import annotations

__all__ = [
    "PEAKS",
    "OPS",
    "peaks",
    "op_flops_bytes",
    "bound_s",
    "train_step_flops",
    "slice_flops",
]

# Published peaks of the card, keyed by ``torch.cuda.get_device_name()``:
# the H100 SXM part at its 700 W limit (NVIDIA's data sheet, dense rates)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "peak_flops_bf16": 989e12,  # bf16 dense on the tensor cores
        "peak_flops_f32": 67e12,  # float32 outside the tensor cores
        "hbm_bw": 3.35e12,  # device memory, bytes/s
    },
}


def peaks(name: str) -> dict:
    """The peaks of the card named ``name``; an unknown card raises."""
    if name not in PEAKS:
        raise ValueError(f"no peaks for the card {name!r}; known: {sorted(PEAKS)}")
    return dict(PEAKS[name])


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


# op -> (flops, bytes) of one call
OPS = {
    "segment_spmm_ragged": _segment_sum,
    "gather_spmm_ragged": _gather_sum,
    "gather_spmm_ragged_backward": _gather_sum_backward,
    "gat_softmax_aggregate": _gat,
    "gat_softmax_aggregate_backward": _gat_backward,
}


def op_flops_bytes(op: str, shape: dict) -> tuple[float, float]:
    if op not in OPS:
        raise ValueError(f"unknown kernel op {op!r}; known: {sorted(OPS)}")
    return OPS[op](shape)


def bound_s(op: str, shape: dict, hw: dict) -> float:
    """The least time the card could take for one call: the larger of its
    operations at the float32 peak (the GNN kernels add in float32) and its
    bytes at the memory rate."""
    fl, by = op_flops_bytes(op, shape)
    return max(fl / hw["peak_flops_f32"], by / hw["hbm_bw"])


def _dense(rows: int, din: int, dout: int) -> float:
    return 2.0 * rows * din * dout


def train_step_flops(kind: str, dims: list, heads: int, classes: int, vertices: int,
                     edges: list, seeds: int) -> float:
    """Model FLOPs of one training step over a batch's real rows: the
    forward's dense products three times (forward, and the two products of
    their backward), and each layer's aggregation forward and backward by
    the op counts above. ``dims`` are the layer widths [in, h1, ..., hK],
    ``vertices`` the batch's valid vertex rows, ``edges[k]`` layer k's
    valid edges, ``seeds`` the rows the head reads."""
    total = 3.0 * _dense(seeds, dims[-1], classes)
    for k, e in enumerate(edges):
        din, dout = dims[k], dims[k + 1]
        if kind == "sage":
            total += 3.0 * _dense(vertices, 2 * din, dout)
            total += op_flops_bytes("gather_spmm_ragged", {"edges": e, "segments": vertices,
                                                           "dim": din})[0]
            if k > 0:  # layer 0's input takes no gradient
                total += op_flops_bytes("gather_spmm_ragged_backward",
                                        {"edges": e, "segments": vertices, "dim": din})[0]
        elif kind == "gat":
            dh = dout // heads
            total += 3.0 * _dense(vertices, din, dout)
            total += 3.0 * 2.0 * 2.0 * e * dout  # the two edge scores, each a dot of width dh
            shape = {"edges": e, "segments": vertices, "dim": dh, "heads": heads}
            total += op_flops_bytes("gat_softmax_aggregate", shape)[0]
            total += op_flops_bytes("gat_softmax_aggregate_backward", shape)[0]
        else:
            raise ValueError(f"no FLOP count for the model kind {kind!r}")
    return total


def slice_flops(kind: str, din: int, dout: int, heads: int, rows: int, edges: int) -> float:
    """Model FLOPs of one layer slice over a batch's real rows and edges,
    as ``GNNModel.layer_slice`` computes it: SAGE's sum and count (a sum of
    width 1) and one product of the joined [self, mean] rows; GAT's product
    of the self rows and of every edge's neighbour row, the two edge
    scores, the softmax aggregate."""
    if kind == "sage":
        return (op_flops_bytes("segment_spmm_ragged", {"edges": edges, "segments": rows,
                                                       "dim": din + 1})[0]
                + _dense(rows, 2 * din, dout))
    if kind == "gat":
        dh = dout // heads
        return (_dense(rows + edges, din, dout) + 2.0 * 2.0 * edges * dout
                + op_flops_bytes("gat_softmax_aggregate",
                                 {"edges": edges, "segments": rows, "dim": dh, "heads": heads})[0])
    raise ValueError(f"no FLOP count for the model kind {kind!r}")
