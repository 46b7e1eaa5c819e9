"""The port's training launcher and GNN configs against the JAX package's,
on the CPU.

``repro_torch.configs.gnn`` is a copy of ``repro.configs.gnn``: the same
entries, field by field, and system configs that validate.
``repro_torch.launch.train.run_gnn`` keeps the reference's host half step
for step, so at a small scale the dataset, the edge partition, the
train/test split and the first sampled batch are the reference's bits.
From the same parameters (the JAX trainer's ``jax.random`` draw, loaded
into the port) the first batch's loss agrees within the training
tolerance, rtol 1e-4 / atol 1e-6 (two frameworks' matmuls and sum orders).
Each graph is cut to about 500 vertices, so that an epoch holds at least
one full batch of 256 seeds.
"""
import dataclasses
import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs.gnn as jax_configs  # noqa: E402
import repro.core.partition as jax_partition  # noqa: E402
import repro.launch.train as jax_launch  # noqa: E402
import repro.train as jax_train  # noqa: E402
import repro_torch.configs.gnn as torch_configs  # noqa: E402
from repro.graph.generate import DATASETS  # noqa: E402
from repro.models.gnn import GNNModel as JaxGNN  # noqa: E402
from repro_torch.launch import train as torch_launch  # noqa: E402
from repro_torch.models.gnn import load_jax_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
NAMES = sorted(jax_configs.GNN_CONFIGS)


def _args(name, **kw):
    scale = 500 / DATASETS[jax_configs.GNN_CONFIGS[name].dataset]["num_vertices"]
    base = dict(config=name, epochs=1, scale=scale, seed=0, log_every=1, device="cpu")
    base.update(kw)
    return Namespace(**base)


def test_gnn_configs_equal_the_reference_field_by_field():
    assert sorted(torch_configs.GNN_CONFIGS) == NAMES
    fields = [f.name for f in dataclasses.fields(jax_configs.GNNExperimentConfig)]
    assert [f.name for f in dataclasses.fields(torch_configs.GNNExperimentConfig)] == fields
    for name in NAMES:
        a, b = jax_configs.get_gnn_config(name), torch_configs.get_gnn_config(name)
        assert isinstance(b, torch_configs.GNNExperimentConfig)
        for f in fields:
            assert getattr(a, f) == getattr(b, f), (name, f)
    with pytest.raises(KeyError):
        torch_configs.get_gnn_config("no-such-config")


@pytest.mark.parametrize("name", NAMES)
def test_to_glisp_config_is_valid_and_the_reference_s(name):
    from repro_torch.api import GLISPConfig

    for overrides in ({}, {"num_parts": 2, "seed": 3}):
        got = torch_configs.get_gnn_config(name).to_glisp_config(**overrides)
        want = jax_configs.get_gnn_config(name).to_glisp_config(**overrides)
        assert isinstance(got, GLISPConfig)
        assert got.validate() == got
        for f in dataclasses.fields(want):
            if hasattr(got, f.name):
                assert getattr(got, f.name) == getattr(want, f.name), (name, f.name)


class _Stop(Exception):
    pass


def _reference_run(args):
    """The reference's ``run_gnn`` up to its training call: returns the
    edge partition and the trainer."""
    seen = {}

    def partition(fn):
        def wrapped(*a, **kw):
            seen["ep"] = fn(*a, **kw)
            return seen["ep"]
        return wrapped

    def train(self, *a, **kw):
        seen["trainer"] = self
        raise _Stop

    part = jax_configs.get_gnn_config(args.config).partitioner
    name = {"adadne": "adadne", "dne": "distributed_ne", "hash2d": "hash2d_partition",
            "random": "random_edge_partition"}[part]
    with mock.patch.object(jax_partition, name, partition(getattr(jax_partition, name))), \
            mock.patch.object(jax_train.GNNTrainer, "train", train), \
            pytest.raises(_Stop):
        jax_launch.run_gnn(args)
    return seen["ep"], seen["trainer"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", ["gcn-products", "hgt-relnet", "sage-paper"])
def test_run_gnn_host_path_is_the_reference_s(name):
    args = _args(name)
    ep, jt = _reference_run(args)
    run = torch_launch.build_gnn(args)
    try:
        g, jg = run.graph, jt.g
        for field in ("src", "dst", "edge_types", "vertex_feats", "labels"):
            assert np.array_equal(getattr(g, field), getattr(jg, field)), field
        assert np.array_equal(run.edge_parts, ep)
        assert np.array_equal(run.trainer.loader.ids, jt.loader.ids)
        assert np.array_equal(run.train_ids, jt.loader.ids)
        # the rest of the seeded shuffle, in its order
        ids = np.arange(g.num_vertices)
        np.random.default_rng(args.seed).shuffle(ids)
        assert np.array_equal(run.test_ids, ids[run.train_ids.shape[0]:])
        assert run.train_ids.shape[0] == int(0.8 * g.num_vertices) >= 256
        seeds, tb = next(iter(run.trainer.pipeline.batches(1)))
        jseeds, jb = next(iter(jt.pipeline.batches(1)))
        assert np.array_equal(seeds, jseeds)
        for f in ("feats", "valid", "seed_pos", "labels"):
            assert np.array_equal(_np(getattr(tb, f)), np.asarray(getattr(jb, f))), f
        for f in ("layer_dst", "layer_src", "layer_etype", "layer_cnt"):
            for a, b in zip(getattr(tb, f), getattr(jb, f)):
                assert np.array_equal(_np(a), np.asarray(b)), f
    finally:
        run.trainer.pipeline.close()
        jt.pipeline.close()


@pytest.mark.parametrize("name", ["gcn-products", "sage-products", "gat-products", "hgt-relnet"])
def test_first_loss_matches_the_reference_from_the_same_parameters(name):
    import jax

    args = _args(name)
    _, jt = _reference_run(args)
    run = torch_launch.build_gnn(args)
    try:
        cfg = run.cfg
        jm = JaxGNN(cfg.model, cfg.feat_dim, hidden=cfg.hidden, num_layers=cfg.num_layers,
                    num_classes=cfg.num_classes, num_heads=cfg.num_heads)
        load_jax_params(run.model, jax.tree.map(np.asarray, jt.params))
        _, tb = next(iter(run.trainer.pipeline.batches(1)))
        _, jb = next(iter(jt.pipeline.batches(1)))
        want = float(jm.loss(jt.params, jb))
        got = float(run.model.loss(tb).detach())
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    finally:
        run.trainer.pipeline.close()
        jt.pipeline.close()


def test_run_gnn_trains_on_the_cpu_from_the_numpy_draw():
    args = _args("sage-products", scale=0.03)  # 1,200 vertices: 3 steps
    got = torch_launch.run_gnn(args)
    assert len(got["losses"]) == 3 and np.all(np.isfinite(got["losses"]))
    assert 0.0 <= got["test_acc"] <= 1.0
    run = torch_launch.build_gnn(args)
    run.trainer.pipeline.close()
    want = run.model.init_numpy(0)
    assert np.array_equal(run.model.layers[0]["w"].detach().numpy(), want["layers"][0]["w"])
    assert np.array_equal(run.model.out.detach().numpy(), want["out"])
    again = torch_launch.run_gnn(args)
    assert again["losses"] == got["losses"] and again["test_acc"] == got["test_acc"]


def test_the_card_is_the_default_device():
    args = torch_launch.parser().parse_args(["gnn", "--config", "gcn-products"])
    assert args.device == "cuda" and args.scale == 0.25 and args.epochs == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_launch.main(["gnn", "--config", "gcn-products", "--scale", "0.01"])


def test_lm_mode_raises_and_names_the_roadmap_item(capsys):
    """The LM mode, which raised before LM training was ported, now trains
    a reduced config for a few steps; its flags are the reference's, the
    ``--reduced`` that cannot be turned off included, and configs fed
    embeddings exit as there."""
    ref = jax_launch.main.__code__  # the reference's parser is built inside main
    assert "--reduced" in ref.co_consts and "--ckpt" in ref.co_consts
    args = torch_launch.parser().parse_args(["lm"])
    assert (args.arch, args.reduced, args.steps, args.batch, args.seq, args.seed,
            args.log_every, args.ckpt, args.device) == (
        "gemma-2b", True, 50, 8, 128, 0, 10, "", "cuda")
    assert torch_launch.parser().parse_args(["lm", "--reduced"]).reduced
    got = torch_launch.main(["lm", "--arch", "mamba2-130m", "--steps", "3", "--batch", "2",
                             "--seq", "16", "--log-every", "1", "--device", "cpu"])
    assert got["steps"] == [0, 1, 2] and np.all(np.isfinite(got["losses"]))
    assert "nll: " in capsys.readouterr().out
    with pytest.raises(SystemExit, match="embeddings"):
        torch_launch.main(["lm", "--arch", "musicgen-medium", "--device", "cpu"])
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_launch.main(["lm", "--steps", "1"])


def test_the_module_runs_as_a_script_without_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['train', 'gnn', '--config', 'gat-products', '--scale', '0.0125',\n"
        "            '--device', 'cpu', '--log-every', '1']\n"
        "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n"
        "print(','.join(sorted(k for k in sys.modules\n"
        "                      if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))) or 'none')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("dataset ogbn-products: 500 vertices")
    assert lines[-2].startswith("final loss ") and "test acc" in lines[-2]
    assert lines[-1] == "none"
