"""Data-parallel training and forked sampling workers on the card.

The ``gpu`` tests need a CUDA card: the ``cuda`` fixture skips without one
(decided at run time, so every pytest-xdist worker collects the same
tests). Run them with ``pytest -m gpu tests/test_torch_dp_gpu.py``. Imports
nothing of JAX, so it runs where only PyTorch is installed.

- The merged step's aggregates, layer by layer, bitwise the launches of
  each shard alone on the same layer inputs (S = 4, SAGE and GAT): a CSR
  row's bits depend on its own edges only, and the block-diagonal layout
  gives each shard rows of its own; and bitwise the per-shard loop's own
  forward. The first check runs on the CPU's plain versions here too.
- Sampling workers forked from a process whose CUDA context is live
  answer bit for bit as the in-process system, before and after a worker
  is killed and respawned.
"""
import multiprocessing as mp
from contextlib import contextmanager
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as torch_api  # noqa: E402
from repro_torch.graph import power_law_graph  # noqa: E402
from repro_torch.kernels import fused_gnn, ops  # noqa: E402
from repro_torch.models.gnn import GNNModel, models  # noqa: E402
from repro_torch.train.data_parallel import merge_shards, shard, stack_batches  # noqa: E402

CONFIG = dict(num_parts=4, fanouts=(15, 10, 5), seed=0, dist_dispatch_timeout=60.0)
IDS = np.arange(0, 6000, 2)
SHARDS = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def system():
    g = power_law_graph(6000, avg_degree=8, seed=3, feat_dim=32, num_classes=8)
    return torch_api.GLISPSystem.build(g, torch_api.GLISPConfig(**CONFIG))


class AggregateRecorder:
    """Keeps every call of the model's two aggregation entry points (the
    gather aggregate of gcn/sage, the softmax aggregate of gat/hgt)."""

    def __init__(self):
        self.calls = []

    @contextmanager
    def patched(self):
        def wrap(kind, fn):
            def call(*args):
                out = fn(*args)
                self.calls.append((kind, args, out))
                return out

            return call

        with mock.patch.object(models, "gnn_gather_aggregate",
                               wrap("gather", models.gnn_gather_aggregate)), \
                mock.patch.object(models, "gnn_gat_aggregate",
                                  wrap("gat", models.gnn_gat_aggregate)):
            yield self


def _bits(t):
    return t.contiguous().view(torch.int32)


@torch.no_grad()
def shard_mismatches(calls, num_shards: int, rows: int) -> list:
    """For each recorded merged call, the count of output elements whose
    bits differ from each shard's own launch over its rows and edges of the
    same inputs (the merged edges are dst-sorted, so shard s's edges are
    one run)."""
    out = []
    for kind, args, merged in calls:
        seg = args[2]
        real = seg[seg >= 0]
        starts = torch.arange(num_shards + 1, device=seg.device, dtype=seg.dtype) * rows
        cuts = torch.searchsorted(real, starts).tolist()
        bad = []
        for s in range(num_shards):
            a, b, lo = cuts[s], cuts[s + 1], s * rows
            if kind == "gather":
                got = ops.gnn_gather_aggregate(args[0][lo:lo + rows].detach(),
                                               args[1][a:b] - lo, seg[a:b] - lo, rows)
            else:
                got = ops.gnn_gat_aggregate(args[0][a:b].detach(), args[1][a:b].detach(),
                                            seg[a:b] - lo, rows)
            bad.append(int((_bits(got) != _bits(merged[lo:lo + rows].detach())).sum()))
        out.append(bad)
    return out


def first_step_batches(system, num_shards, batch_size, device):
    """The first step's stacked batch of a DP trainer's shard pipelines."""
    tm = GNNModel("sage", system.graph.vertex_feats.shape[1], hidden=16, num_layers=3,
                  num_classes=8, device=device)
    tr = system.dp_trainer(tm, IDS, num_shards=num_shards, batch_size=batch_size, prefetch=0,
                           device=device)
    batches = []
    for pl in tr.pipelines:
        stream = pl.host_batches(1)
        batches.append(next(stream)[1])
        stream.close()
    return stack_batches(batches)


def _aggregates_check(system, kind, device, *, loop=False):
    """The merged forward's aggregates, layer by layer, bitwise each
    shard's own launches on the same layer inputs; with ``loop``, also
    bitwise the per-shard loop's own forward (its layer inputs come from
    matmuls over V rows, not S x V: the card's gave the same bits, the
    CPU's need not)."""
    stacked = first_step_batches(system, SHARDS, 64 * SHARDS, device)
    model = GNNModel(kind, system.graph.vertex_feats.shape[1], hidden=64, num_layers=3,
                     num_classes=8, num_heads=4, device=device)
    rec = AggregateRecorder()
    with torch.no_grad(), rec.patched():
        model.apply(merge_shards(stacked).to(device))
    assert len(rec.calls) == 3
    rows = stacked.feats.shape[1]
    bad = shard_mismatches(rec.calls, SHARDS, rows)
    assert bad == [[0] * SHARDS] * 3, bad
    if loop:
        each = AggregateRecorder()
        with torch.no_grad(), each.patched():
            for s in range(SHARDS):
                model.apply(shard(stacked, s).to(device))
        for k in range(3):
            merged = rec.calls[k][2]
            for s in range(SHARDS):
                own = each.calls[3 * s + k][2]
                assert torch.equal(_bits(merged[s * rows:(s + 1) * rows]), _bits(own)), (k, s)


@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_merged_aggregates_are_the_shards_own_on_the_cpu(system, kind):
    _aggregates_check(system, kind, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_merged_aggregates_are_the_shards_own(system, cuda, kind):
    fused_gnn.reset_launches()
    _aggregates_check(system, kind, cuda, loop=True)
    name = "gather_spmm_ragged" if kind == "sage" else "gat_softmax_aggregate"
    # 3 merged launches, 3 x S per-shard launches on its inputs, 3 x S of the loop
    assert fused_gnn.LAUNCHES[name] == 3 + 6 * SHARDS


def _same(a, b):
    assert len(a.hops) == len(b.hops)
    for ha, hb in zip(a.hops, b.hops):
        assert np.array_equal(ha.src, hb.src) and np.array_equal(ha.dst, hb.dst)
        assert np.array_equal(ha.eid, hb.eid)


@pytest.mark.gpu
def test_workers_forked_after_cuda_answer_bitwise_and_respawn(system, cuda):
    live = torch.randn(1 << 20, device=cuda,  # a live context and allocation
                       generator=torch.Generator(cuda).manual_seed(0))
    torch.cuda.synchronize()
    remote = torch_api.GLISPSystem.build(
        system.graph, torch_api.GLISPConfig(**dict(CONFIG, dist_transport="mp"))
    )
    try:
        pool = remote.backend.service.dispatcher
        for i in range(4):
            seeds = np.arange(64, dtype=np.int64) * 7 + i
            _same(system.sample(seeds, key=(11, i)), remote.sample(seeds, key=(11, i)))
        victim = pool._workers[2].proc
        victim.kill()
        victim.join(timeout=5.0)
        for i in range(4, 8):
            seeds = np.arange(64, dtype=np.int64) * 7 + i
            _same(system.sample(seeds, key=(11, i)), remote.sample(seeds, key=(11, i)))
        assert pool.respawn_count == 1
        assert float(live.sum()) == float(live.sum())  # the parent's context still works
    finally:
        remote.close()
    assert [p for p in mp.active_children() if p.is_alive()] == []
