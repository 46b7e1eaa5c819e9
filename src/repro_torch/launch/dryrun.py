"""Production-mesh dry run: trace every (architecture x input shape) step,
sharded by the reference's rules, on the production mesh without the
cards, and report per device its memory, its collectives and a roofline.
Port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --mesh single --out experiments/dryrun_torch

The reference lowers and compiles onto 256 / 512 host placeholder devices.
The port does what they do in one process: :func:`run_one` initialises a
fake process group (``torch.testing._internal.distributed.fake_pg``) of
256 ranks, a (16, 16) ("data", "model") mesh, or 512 and (2, 16, 16) with
a "pod" axis, and destroys it when it returns. Every tensor is a fake CPU
tensor (``FakeTensorMode``): parameters, optimizer state, cache and inputs
are DTensors placed by ``launch.shardings``, each rank holding only its
shard's shape. The step (train, prefill or decode, ``launch.specs``) runs
eagerly on them as this process's rank; the fake group's collectives move
nothing. Being on the CPU, the port's dispatch takes the plain paths, as
the reference's lowering does (no kernel): attention by
``BLOCKWISE_THRESHOLD``.

What it measures, for one device:
  * ``argument_bytes``: its shards of params, optimizer state, cache and
    inputs (equal to what the specs imply: ``shardings.device_bytes``);
  * ``peak_bytes_per_device``: the most bytes of live tensors at any point
    of the step (arguments included), ``temp_bytes`` = peak - arguments,
    ``output_bytes``: the results' tensors;
  * ``collectives``: every collective its operations issued, by kind, with
    the bytes of each result (``roofline.CollectiveRecorder``);
  * ``roofline``: ``roofline.mesh_roofline`` for the H100, with the FLOPs
    of its traced operations beside the analytic ones.
PyTorch issues a Shard-to-Shard redistribution on a CPU mesh as an
all-gather and a local chunk (its CPU stand-in for an all-to-all), and the
recorder counts what is issued.

The reference's ``--unroll`` has no counterpart: eager tracing runs every
layer. Importing this module creates no process group.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import weakref
from contextlib import contextmanager

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import HW, CollectiveRecorder, mesh_roofline
from repro_torch.launch.shardings import (
    batch_specs,
    cache_specs,
    device_bytes,
    distribute,
    opt_state_specs,
    param_specs,
)
from repro_torch.launch.specs import (
    SHAPES,
    cache_shapes,
    make_decode_step,
    make_prefill_step,
    input_specs,
    make_train_step,
    opt_shapes,
    params_shapes,
    resolve_config,
)
from repro_torch.train.optim import tree_leaves, tree_map

__all__ = ["run_one", "trace_step", "build_arguments", "fake_group", "main", "TARGET"]

TARGET = "NVIDIA H100 80GB HBM3"  # the card whose peaks the roofline uses


def _shape(shape) -> dict:
    return SHAPES[shape] if isinstance(shape, str) else shape


def build_arguments(cfg, shape, mesh, *, weight_dtype=torch.float32):
    """The step's arguments as stand-ins, and their specs: ``params``
    (``weight_dtype``; float32 as the reference keeps them, or the dtypes
    ``init_params`` stores with ``weight_dtype=None``), ``opt`` (training),
    ``cache`` (prefill and decode, as long as the shape's sequence) and
    ``batch``. Returns (tree, specs), both dicts with those keys."""
    from repro_torch.models.transformer.model import init_params

    sh = _shape(shape)
    if weight_dtype is None:
        params = init_params(cfg, torch.Generator(), device="meta")
    else:
        params = tree_map(lambda t: t.to(weight_dtype), params_shapes(cfg))
    pspecs = param_specs(cfg, params, mesh)
    bspecs = batch_specs(cfg, sh["batch"], mesh)
    batch = input_specs(cfg, sh)
    tree = {"params": params, "batch": batch}
    specs = {"params": pspecs, "batch": {k: bspecs[k] for k in batch}}
    if sh["kind"] == "train":
        tree["opt"] = opt_shapes(cfg)
        specs["opt"] = opt_state_specs(pspecs)
    else:
        tree["cache"] = cache_shapes(cfg, sh["batch"], sh["seq"])
        specs["cache"] = cache_specs(cfg, tree["cache"], mesh)
    return tree, specs


class _LiveBytes:
    """Bytes of the live storages of the tensors it was shown, and their
    most: a storage counts from the first tensor seen on it until the last
    of those is freed."""

    def __init__(self):
        self.refs: dict[int, list] = {}  # storage -> [bytes, tensors alive]
        self.now = 0
        self.peak = 0

    def add(self, t, held: int | None = None) -> None:
        """Count ``t`` (a tensor, or a list or tuple of them); ``held``, if
        given, is the bytes its storage counts for in place of its own."""
        if not isinstance(t, torch.Tensor):
            if isinstance(t, (list, tuple)):
                for x in t:
                    self.add(x)
            return
        local = getattr(t, "_local_tensor", t)
        storage = local.untyped_storage()
        key = storage._cdata
        if key in self.refs:
            self.refs[key][1] += 1
        else:
            nbytes = storage.nbytes() if held is None else held
            self.refs[key] = [nbytes, 1]
            self.now += nbytes
            self.peak = max(self.peak, self.now)
        weakref.finalize(local, self._drop, key)

    def _drop(self, key: int) -> None:
        ref = self.refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            self.now -= ref[0]
            del self.refs[key]


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        local = getattr(t, "_local_tensor", t)
        st = local.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _fold_pod(tree):
    """Specs with each ("pod", "data") entry as "data"."""
    if isinstance(tree, dict):
        return {k: _fold_pod(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fold_pod(v) for v in tree]
    return tuple("data" if e == ("pod", "data") else e for e in tree)


def trace_mesh(mesh):
    """The mesh the step is traced on. Under the rules "pod" shards only
    together with "data", as one ("pod", "data") entry, so a multi-pod
    mesh is traced as its (pod * data, model) fold over the same ranks in
    the same order, named ("data", "model"): the same shards and the same
    collective groups, and DTensor's redistribution planner, whose search
    grows with the mesh's rank, stays on two dims."""
    from torch.distributed.device_mesh import init_device_mesh

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if "pod" not in sizes:
        return mesh
    return init_device_mesh(mesh.device_type, (sizes["pod"] * sizes["data"], sizes["model"]),
                            mesh_dim_names=("data", "model"))


def trace_step(cfg, shape, mesh, *, weight_dtype=torch.float32) -> dict:
    """One step of ``shape`` (a name in ``SHAPES`` or a dict with ``seq``,
    ``batch`` and ``kind``) traced over DTensors on ``mesh`` (whose process
    group is initialised; see :func:`trace_mesh`), under ``FakeTensorMode``,
    with the arguments of :func:`build_arguments`. Returns the result's
    ``memory``, ``collectives``, ``roofline`` (for the H100) and
    ``trace_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    sh = _shape(shape)
    tree, specs = build_arguments(cfg, sh, mesh, weight_dtype=weight_dtype)
    spec_bytes = device_bytes(tree, specs, mesh)
    tmesh = trace_mesh(mesh)
    if tmesh is not mesh:
        specs = _fold_pod(specs)
        if cfg.data_axis_names:
            cfg = dataclasses.replace(cfg, data_axis_names=("data",))
    live = _LiveBytes()
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        args = {k: distribute(tree[k], specs[k], tmesh) for k in tree}
        arg_leaves = tree_leaves(args)
        for t in arg_leaves:
            live.add(t)
        argument_bytes = _storage_bytes(arg_leaves)
        rec = CollectiveRecorder(fake_mode=fake, on_output=live.add)
        t0 = time.perf_counter()
        # a tensor made inside the step (positions, masks) is the same on
        # every rank: replicated
        with rec, implicit_replication():
            if sh["kind"] == "train":
                out = make_train_step(cfg)(args["params"], args["opt"], args["batch"])
            elif sh["kind"] == "prefill":
                out = make_prefill_step(cfg)(args["params"], args["cache"], args["batch"])
            else:
                out = make_decode_step(cfg)(args["params"], args["cache"], args["batch"],
                                            sh["seq"] - 1)
        trace_s = time.perf_counter() - t0
        output_bytes = _storage_bytes(tree_leaves(list(out)))
    if argument_bytes != spec_bytes:
        raise RuntimeError(f"argument bytes {argument_bytes} differ from the specs' {spec_bytes}")
    coll = rec.totals()
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {
        "trace_s": trace_s,
        "memory": {
            "argument_bytes": int(argument_bytes),
            "output_bytes": int(output_bytes),
            "temp_bytes": int(max(0, live.peak - argument_bytes)),
            "peak_bytes_per_device": int(live.peak),
        },
        "collectives": coll,
        "roofline": mesh_roofline(cfg, sh, mesh_shape, mesh.size(), rec.flops, coll, HW[TARGET]),
    }


@contextmanager
def fake_group(world: int):
    """``with fake_group(world):`` a fake process group of ``world`` ranks
    (this process is rank 0; collectives move nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def resolve(arch: str, shape_name: str, multi_pod: bool):
    """The config the dry run traces: ``resolve_config`` at a model axis of
    16, then the MoE dispatch-group rule of the reference: grouped
    per-data-shard dispatch only when the experts do not divide the model
    axis (mixtral 8/16; deepseek's 64/16 take expert parallelism from the
    sharded weights), with G the data shards. None: skipped."""
    cfg = resolve_config(get_config(arch), shape_name, model_axis=16)
    if cfg is not None and cfg.moe is not None and cfg.moe.num_experts % 16:
        dsize = 32 if multi_pod else 16
        if SHAPES[shape_name]["batch"] * SHAPES[shape_name]["seq"] % dsize == 0:
            axes = ("pod", "data") if multi_pod else ("data",)
            cfg = dataclasses.replace(cfg, moe_dispatch_groups=dsize, data_axis_names=axes)
    return cfg


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str, verbose=True):
    cfg = resolve(arch, shape_name, multi_pod)
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "skipped": True}
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        traced = trace_step(cfg, shape_name, mesh)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "num_chips": 512 if multi_pod else 256,
        "trace_s": round(traced["trace_s"], 1),
        "memory": traced["memory"],
        "collectives": traced["collectives"],
        "roofline": traced["roofline"],
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{'multi' if multi_pod else 'single'}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=2)
    if verbose:
        rf = result["roofline"]
        print(
            f"[dryrun] {arch} × {shape_name} × {result['mesh']}: "
            f"trace {traced['trace_s']:.1f}s | "
            f"mem/dev {result['memory']['peak_bytes_per_device']/2**30:.2f} GiB | "
            f"compute {rf['compute_s']*1e3:.2f} ms, memory {rf['memory_s']*1e3:.2f} ms, "
            f"collective {rf['collective_s']*1e3:.2f} ms -> {rf['dominant']}",
            flush=True,
        )
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=list(SHAPES) + ["all"])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = []
    for a in archs:
        for s in shapes:
            for mp in meshes:
                try:
                    run_one(a, s, mp, args.out)
                except Exception as e:  # noqa: BLE001 — report and continue
                    failures.append((a, s, mp, repr(e)))
                    print(f"[dryrun] FAIL {a} × {s} × {'multi' if mp else 'single'}: {e}",
                          flush=True)
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nAll dry-runs traced successfully.")


if __name__ == "__main__":
    main()
