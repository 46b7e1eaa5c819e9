"""Finds a cell's files by name and assembles a run's result.

``BENCHMARK.json`` names the cell; the cell names its configuration
(``configs/<config>.json``, the file the configuration's entry gives) and
its traffic mix (``traffic/<mix>.json``); the mix's ``kind`` names its
driver (``drivers/<kind>.py``); the cell's limits are
``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``. A later cell, mix, configuration or metric is new
files and entries, never an edit of these.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["ROOT", "BENCH", "Cell", "Ctx", "Outcome", "load_cell", "load_module", "cells",
           "read_metric", "judge", "execute"]

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic mix file's contents
    limits: dict  # number -> {"limit": x, "kind": "max"|"min"}
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list
    driver: object  # the mix's driver module


def cells(root: Path = ROOT) -> list:
    return [w["name"] for w in json.loads((root / "BENCHMARK.json").read_text())["workloads"]]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; known: {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "glisp_bench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "glisp_bench" / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in names and _reports(m, name)]
    driver = load_module(root / "glisp_bench" / "drivers" / f"{traffic['kind']}.py",
                         f"glisp_bench_driver_{traffic['kind']}")
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer, driver)


def read_metric(metric: str, record: dict, root: Path = ROOT):
    """The per-layer metric's reader (``metrics/<metric>.py``'s ``read``)
    over a traced run's record; None when it finds nothing to read."""
    path = root / "glisp_bench" / "metrics" / f"{metric}.py"
    module = load_module(path, "glisp_bench_metric_" + metric.replace(".", "_").replace("-", "_"))
    return module.read(record)


@dataclass
class Ctx:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_process: float  # the host clock at the process's start
    hw: dict | None = None  # the card's peaks (``yardstick.peaks``); None off the card
    control: bool = False  # also read the control (TF32 reference in the program's place)
    witness: bool = False  # also the gaps of a float32 reference (training)

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def log(self, *parts) -> None:
        print(*parts, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    e2e: dict  # end-to-end metric -> value
    attempted: int
    failed: int
    numbers: dict  # compared number -> value
    record: dict = field(default_factory=dict)  # what the per-layer readers read
    memory_peak_bytes: int = 0
    profile: dict | None = None  # trace.Profile.read() of the traced stretch
    control: dict | None = None  # the control's numbers, when asked for


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit: ``{name: {"value", "limit",
    "ok"}}``; correct when every number is within its limit. A number with
    no limit, or a limit with no number, is not correct."""
    out, correct = {}, True
    for name in sorted(set(numbers) | set(limits)):
        lim = limits.get(name)
        val = numbers.get(name)
        if lim is None or val is None:
            ok = False
        elif lim["kind"] == "max":
            ok = val <= lim["limit"]
        else:
            ok = val >= lim["limit"]
        correct &= bool(ok)
        out[name] = {"value": val, "limit": None if lim is None else lim["limit"],
                     "kind": None if lim is None else lim["kind"], "ok": bool(ok)}
    return correct, out


def _written():
    """Bytes this process has written to storage (Linux), or "unknown"."""
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("write_bytes:"):
                return int(line.split()[1])
    except OSError:
        pass
    return "unknown"


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_process: float,
            control: bool = False, witness: bool = False) -> tuple[dict, Outcome]:
    """One run of ``cell``: its driver, the judgement of its compared
    numbers, and the result line's object (``checks``, each compared
    number beside its limit, last)."""
    import torch

    from glisp_bench.harness.yardstick import peaks

    cuda = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    ctx = Ctx(cell, int(seed), float(seconds), bool(trace), device, t_process,
              hw=peaks(kind) if cuda else None, control=control, witness=witness)
    out = cell.driver.run(ctx)
    ctx.log(f"{cell.name}: {_written()} bytes written by this process")
    correct, checks = judge(out.numbers, cell.limits)
    correct &= out.attempted > 0
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = read_metric(m["name"], out.record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace and out.profile is not None:
        dev["busy_s"] = out.profile["busy_s"]
        dev["window_s"] = out.profile["window_s"]
        result["breakdown"] = {"device_ops": [list(kv) for kv in out.profile["device_ops"]],
                               "idle_gaps": [list(kv) for kv in out.profile["idle_gaps"]]}
    result["checks"] = checks
    return result, out
