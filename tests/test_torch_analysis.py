"""``repro_torch.analysis``, the port's glint linter and its runtime guard,
against the reference's ``repro.analysis`` on the CPU.

1. **Corpus parity**: on each file of the reference's self-test corpus
   (``tests/analysis_corpus/repro/``, read, not edited) the port's (line,
   rule) findings for the ids both linters share (DET001-004, PRJ001-006)
   equal the reference's and the file's ``# expect[...]`` annotations.
2. **The port's own rules** (KRN001 for the CUDA wrappers, TRH001 host
   sync, TRH002 unbucketed pad, DET001's torch calls): inline corpora with
   ``# expect[...]`` markers, checked as a kernel module of the port.
3. **Mechanics** against the reference on the same inputs: pragmas, E001 /
   E002, selection, the skip marker, reporters and the CLI's exit codes.
4. **Self-gate**: the port's own files lint clean under the port's rules.
5. **Guard**: ``recompile_guard`` over a fake engine and over the real
   engine on the CPU with a stand-in tuner.
6. **The dry run's DTensor repairs**: each op rewritten for PyTorch 2.11,
   on DTensors over a fake 4-rank group, gives each device the plain op's
   forward and backward on its shard, bit for bit.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.analysis as ref_analysis  # noqa: E402
from repro.analysis.__main__ import main as ref_main  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    PARSE_ERROR_ID,
    PRAGMA_REASON_ID,
    RecompileError,
    active_rules,
    check_file,
    check_source,
    iter_python_files,
    recompile_guard,
    render_json,
    render_rule_catalog,
    render_text,
    run_checks,
)
from repro_torch.analysis.__main__ import default_paths, main  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CORPUS_DIR = REPO / "tests" / "analysis_corpus"
CORPUS = sorted((CORPUS_DIR / "repro").glob("*.py"))
SHARED = {f"DET00{i}" for i in range(1, 5)} | {f"PRJ00{i}" for i in range(1, 7)}
PORT_ONLY = {"KRN001", "TRH001", "TRH002"}
KERNEL_PATH = "src/repro_torch/kernels/x.py"

_EXPECT = re.compile(r"#\s*expect\[([A-Z0-9,]+)\]")


def _expected(source: str, ids=None) -> set:
    out = set()
    for lineno, line in enumerate(source.splitlines(), 1):
        m = _EXPECT.search(line)
        if m:
            out |= {(lineno, r) for r in m.group(1).split(",") if ids is None or r in ids}
    return out


def _pairs(findings, ids=None) -> set:
    return {(f.line, f.rule) for f in findings if ids is None or f.rule in ids}


# ---------------------------------------------------------------------------
# 1. corpus parity with the reference
# ---------------------------------------------------------------------------


def test_the_corpus_is_the_reference_s():
    assert len(CORPUS) == 15


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_corpus_findings_equal_the_reference_s_on_shared_ids(path):
    source = path.read_text()
    got, suppressed = check_file(path)
    want, want_suppressed = ref_analysis.check_file(path)
    assert not suppressed and not want_suppressed
    assert _pairs(got, SHARED) == _pairs(want, SHARED) == _expected(source, SHARED), (
        "\n".join(f.render() for f in got))
    # the port's own rules fire only where the reference's JAX004 counterpart does
    extra = _pairs(got) - _pairs(got, SHARED)
    if path.stem == "jax004_unbucketed_pad":
        assert {r for _, r in extra} == {"TRH002"}
        assert {line for line, _ in extra} <= {line for line, _ in _expected(source)}
    else:
        assert not extra


def test_rule_catalog_and_ids():
    rules = active_rules()
    ids = [r.id for r in rules]
    assert set(ids) == SHARED | PORT_ONLY and len(ids) == len(set(ids))
    ref_ids = {r.id for r in ref_analysis.active_rules()}
    assert ref_ids - set(ids) == {"JAX001", "JAX002", "JAX003", "JAX004"}
    for r in rules:
        assert r.family in ("determinism", "torch", "kernels", "project")
        assert r.rationale.strip() and re.fullmatch(r"[A-Z]{3}\d{3}", r.id)
    shared = {r.id: r for r in ref_analysis.active_rules()}
    for r in rules:
        if r.id in SHARED:
            assert (r.name, r.family) == (shared[r.id].name, shared[r.id].family)
    # each replacement names the reference rule it replaces
    by_id = {r.id: r for r in rules}
    assert "JAX001" in by_id["TRH001"].rationale and "JAX004" in by_id["TRH002"].rationale
    assert "pallas" in by_id["KRN001"].rationale
    catalog = render_rule_catalog()
    assert all(i in catalog for i in ids)
    doc = sys.modules["repro_torch.analysis.rules"].__doc__
    assert "JAX002" in doc and "JAX003" in doc
    assert analysis.__all__ == ref_analysis.__all__


# ---------------------------------------------------------------------------
# 2. the port's own rules: inline corpora (as a kernel module of the port)
# ---------------------------------------------------------------------------

KRN001_SRC = '''
import torch
from repro_torch.kernels import ref
from repro_torch.kernels.build import on_cpu
from repro_torch.kernels.ref import segment_spmm_ref


def launch_sum(msg, out):
    pass


def _on_card(msg):
    out = torch.empty_like(msg)
    launch_sum(msg, out)
    return out


def _check(msg):
    if on_cpu(msg):
        return True
    return False


def _plain(msg, seg, n):
    return segment_spmm_ref(msg, seg, n)


def good_direct(msg, seg, n):
    if on_cpu(msg, seg):
        return segment_spmm_ref(msg, seg, n)
    return _on_card(msg)


def good_helper_test(msg, seg, n):
    if _check(msg):
        return ref.segment_spmm_ref(msg, seg, n)
    return _on_card(msg)


def good_negated(msg, seg, n):
    if not on_cpu(msg):
        out = _on_card(msg)
    else:
        out = ref.segment_spmm_ref(msg, seg, n)
    return out


def good_through_wrapper(msg, seg, n):
    return good_direct(msg, seg, n) * 2


def no_launch(msg):
    return msg + 1


def bad_no_branch(msg, seg, n):  # expect[KRN001]
    return _on_card(msg)


def bad_branch_without_plain(msg, seg, n):  # expect[KRN001]
    if on_cpu(msg):
        raise ValueError("card only")
    return _on_card(msg)


def bad_direct_launch(msg):  # expect[KRN001]
    out = torch.empty_like(msg)
    launch_sum(msg, out)
    return out


def fallback(msg, seg, n):
    if on_cpu(msg, seg):
        return segment_spmm_ref(msg, seg, n)
    try:
        return _on_card(msg)
    except RuntimeError:
        return segment_spmm_ref(msg.cpu(), seg.cpu(), n)  # expect[KRN001]


def fallback_through_helper(msg, seg, n):
    if on_cpu(msg, seg):
        return segment_spmm_ref(msg, seg, n)
    try:
        return _on_card(msg)
    except RuntimeError:
        return _plain(msg, seg, n)  # expect[KRN001]


def raises_again(msg, seg, n):
    if on_cpu(msg, seg):
        return segment_spmm_ref(msg, seg, n)
    try:
        return _on_card(msg)
    except RuntimeError as err:
        raise ValueError("the kernel failed") from err
'''

TRH001_SRC = '''
import torch


def launch(x, out, *, causal: bool, window: int, dtype: torch.dtype):
    n = x.shape[0]
    rows = n * 2
    flag = int(bool(causal))
    steps = int(window)
    for p in range(rows):
        last = int(p == rows - 1)
    total = int(x.numel())
    width = float(len(out))
    return flag, steps, last, total, width, dtype


def bad(x, seg):
    n = int(seg.max())  # expect[TRH001]
    m = seg.max().item()  # expect[TRH001]
    lst = seg.tolist()  # expect[TRH001]
    host = x.cpu()  # expect[TRH001]
    arr = x.numpy()  # expect[TRH001]
    torch.cuda.synchronize()  # expect[TRH001]
    ok = bool((seg >= 0).all())  # expect[TRH001]
    return n, m, lst, host, arr, ok
'''

TRH002_SRC = '''
import numpy as np
import torch.nn.functional as F

from repro_torch.utils import round_up


def bad(x, batch):
    n = x.shape[0]
    a = F.pad(x, (0, 0, 0, n - x.shape[0]))  # expect[TRH002]
    b = np.pad(x, ((0, len(batch)), (0, 0)))  # expect[TRH002]
    return a, b


def good(x, chunk):
    m = x.shape[0]
    pad = (-m) % chunk
    a = F.pad(x, (0, 0, 0, pad))
    m_pad = round_up(m, 64)
    b = F.pad(x, (0, 0, 0, m_pad - m))
    c = np.pad(x, ((0, 3), (0, 0)))
    return a, b, c
'''

DET001_SRC = '''
import torch
from torch import randn


def bad(x, t):
    torch.manual_seed(0)  # expect[DET001]
    torch.cuda.manual_seed_all(0)  # expect[DET001]
    a = torch.rand(3)  # expect[DET001]
    b = randn(3, device="cuda")  # expect[DET001]
    c = torch.randint(0, 9, (4,))  # expect[DET001]
    d = torch.randperm(5)  # expect[DET001]
    e = torch.rand_like(x)  # expect[DET001]
    x.normal_(0.0, 1.0)  # expect[DET001]
    t.uniform_()  # expect[DET001]
    f = torch.multinomial(x, 2)  # expect[DET001]
    return a, b, c, d, e, f


def good(x, t, kw):
    g = torch.Generator().manual_seed(0)
    a = torch.rand(3, generator=g)
    b = torch.randn(3, generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    c = torch.randperm(5, generator=g)
    x.normal_(0.0, 1.0, generator=g)
    t.uniform_(**kw)  # generator may ride in kwargs
    d = torch.empty(3).normal_(generator=g)
    e = torch.randn_like(x, generator=g)
    return a, b, c, d, e
'''

INLINE = {"krn001": KRN001_SRC, "trh001": TRH001_SRC, "trh002": TRH002_SRC,
          "det001_torch": DET001_SRC}


@pytest.mark.parametrize("name", sorted(INLINE))
def test_port_rules_inline_corpus_exact(name):
    src = INLINE[name]
    want = _expected(src)
    rule = {r for _, r in want}
    assert len(rule) == 1 and len(want) >= 2
    findings, suppressed = check_source(src, path=KERNEL_PATH, rules=active_rules(select=rule))
    assert not suppressed
    assert _pairs(findings) == want, "\n".join(f.render() for f in findings)


def test_kernel_rules_are_scoped_to_the_wrapper_modules():
    for path in ("src/repro_torch/kernels/ref.py", "src/repro_torch/kernels/build.py",
                 "src/repro_torch/kernels/autotune.py", "src/repro_torch/models/x.py",
                 "tools/x.py"):
        for src in (KRN001_SRC, TRH001_SRC):
            assert not [f for f in check_source(src, path=path)[0]
                        if f.rule in ("KRN001", "TRH001")], path
    # the pad and torch-RNG rules apply everywhere
    assert _pairs(check_source(TRH002_SRC, path="tools/x.py")[0]) == _expected(TRH002_SRC)
    assert _pairs(check_source(DET001_SRC, path="tests/x.py")[0]) == _expected(DET001_SRC)


def test_the_reference_linter_sees_none_of_the_torch_snippets():
    """The port's rules are new ground: the reference flags none of these."""
    for src in (KRN001_SRC, TRH001_SRC, DET001_SRC):
        assert not ref_analysis.check_source(src, path=KERNEL_PATH)[0]


def _lines_matching(path: Path, needle: str) -> list:
    return [i for i, line in enumerate(path.read_text().splitlines(), 1) if needle in line]


def test_pad_rule_agrees_with_jax004_on_the_mirrored_calls():
    """The conv's pad (a weight shape) is flagged and suppressed on both
    sides; the SSD scan's chunk pads (``pad = (-S) % chunk``) on neither."""
    port_ssm = REPO / "src/repro_torch/models/transformer/ssm.py"
    port_ref = REPO / "src/repro_torch/kernels/ref.py"
    ref_ssm = REPO / "src/repro/models/transformer/ssm.py"
    trh = active_rules(select=["TRH002"])
    jax = ref_analysis.active_rules(select=["JAX004"])
    found, sup = check_file(port_ssm, rules=trh)
    rfound, rsup = ref_analysis.check_file(ref_ssm, rules=jax)
    assert not found and not rfound
    conv = _lines_matching(port_ssm, "xp = F.pad(x, (0, 0, width - 1, 0))")
    rconv = _lines_matching(ref_ssm, "xp = jnp.pad(x, ((0, 0), (width - 1, 0), (0, 0)))")
    assert len(conv) == len(rconv) == 1
    assert conv[0] in {f.line for f in sup} and {f.line for f in rsup} == set(rconv)
    # the chunk pads: none flagged, none suppressed
    chunk_pads = _lines_matching(port_ref, "torch.nn.functional.pad(")
    rchunk = _lines_matching(ref_ssm, "= jnp.pad(") + _lines_matching(ref_ssm, "B = jnp.pad(")
    assert len(chunk_pads) == 4 and len(set(rchunk) - set(rconv)) == 5
    assert check_file(port_ref, rules=trh) == ([], [])
    assert not set(rchunk) - set(rconv) & {f.line for f in rfound + rsup}


# ---------------------------------------------------------------------------
# 3. engine mechanics, against the reference on the same inputs
# ---------------------------------------------------------------------------

_BAD = "import numpy as np\nx = np.random.rand(3)\n"
MECHANICS = {
    "plain": _BAD,
    "trailing-pragma": _BAD.replace("rand(3)", "rand(3)  # glint: disable=DET001 -- demo"),
    "pragma-without-reason": _BAD.replace("rand(3)", "rand(3)  # glint: disable=DET001"),
    "standalone-pragma": ("import numpy as np\n# glint: disable=DET001 -- standalone, multi-line\n"
                          "# continues here\nx = np.random.rand(3)\n"),
    "bare-disable": "import numpy as np\nx = np.random.rand(3)  # glint: disable -- all\n",
    "other-rule-pragma": _BAD.replace("rand(3)", "rand(3)  # glint: disable=PRJ001 -- wrong id"),
    "parse-error": "def broken(:\n",
    "import-alias": "from numpy import random as nr\nx = nr.rand(3)\n",
    "two-rules": "import numpy as np\nimport time\nx = np.random.rand(int(time.time()))\n",
}


def _summary(result):
    findings, suppressed = result
    return ([(f.line, f.rule) for f in findings], [(f.line, f.rule) for f in suppressed])


@pytest.mark.parametrize("case", sorted(MECHANICS))
def test_mechanics_equal_the_reference_s(case):
    src = MECHANICS[case]
    got = _summary(check_source(src))
    assert got == _summary(ref_analysis.check_source(src))
    if case == "pragma-without-reason":
        assert [r for _, r in got[0]] == [PRAGMA_REASON_ID]
    if case == "parse-error":
        assert [r for _, r in got[0]] == [PARSE_ERROR_ID]


def test_select_and_ignore_filters():
    src = MECHANICS["two-rules"]
    assert {f.rule for f in check_source(src)[0]} == {"DET001", "DET003"}
    only = check_source(src, rules=active_rules(select=["DET001"]))[0]
    assert {f.rule for f in only} == {"DET001"}
    assert not check_source(src, rules=active_rules(ignore=["determinism"]))[0]
    assert not check_source(src, rules=active_rules(select=["unseeded-global-rng"],
                                                    ignore=["DET001"]))[0]


def test_skip_marker_prunes_directory_scans():
    assert iter_python_files([CORPUS_DIR]) == ref_analysis.iter_python_files([CORPUS_DIR]) == []
    assert iter_python_files([CORPUS[0]]) == [CORPUS[0]]


def test_library_scope_covers_both_packages():
    submit = "def f(service, seeds, spec):\n    return service.submit(seeds, spec)\n"
    for path, flagged in (("src/repro_torch/serve/x.py", True), ("tests/analysis_corpus/repro/x.py",
                          True), ("tools/x.py", False), ("examples/x.py", False)):
        assert bool(check_source(submit, path=path)[0]) == flagged, path


def test_reporters_roundtrip():
    report = run_checks([CORPUS[0]])
    want = ref_analysis.run_checks([CORPUS[0]])
    assert not report.ok and report.files_checked == 1
    assert [f.to_dict() for f in report.findings] == [f.to_dict() for f in want.findings]
    text = render_text(report)
    assert text == ref_analysis.render_text(want).replace(
        f"{len(want.rule_ids)} rule(s)", f"{len(report.rule_ids)} rule(s)")
    data = json.loads(render_json(report))
    assert data["ok"] is False and data["counts"] == {"DET001": 4}
    assert {f["rule"] for f in data["findings"]} <= set(data["rules"])


def test_cli_exit_codes_equal_the_reference_s(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    out, rout = tmp_path / "port.json", tmp_path / "ref.json"
    for argv in ([str(CORPUS[0])], [str(clean)], ["--list-rules"],
                 [str(CORPUS[0]), "--ignore", "DET001"], [str(CORPUS[0]), "--select", "project"],
                 [str(CORPUS[0]), "--select", "determinism"], [str(clean), "--show-suppressed"]):
        assert main(argv) == ref_main(argv), argv
    assert main([str(CORPUS[0]), "--format", "json", "--out", str(out)]) == 1
    assert ref_main([str(CORPUS[0]), "--format", "json", "--out", str(rout)]) == 1
    got, want = json.loads(out.read_text()), json.loads(rout.read_text())
    assert got["findings"] == want["findings"] and got["ok"] is False
    for bad in (["--format", "xml"], ["--no-such-flag"]):
        with pytest.raises(SystemExit) as port_exit:
            main(bad)
        with pytest.raises(SystemExit) as ref_exit:
            ref_main(bad)
        assert port_exit.value.code == ref_exit.value.code == 2
    capsys.readouterr()


# ---------------------------------------------------------------------------
# 4. the self-gate over the port's own files
# ---------------------------------------------------------------------------


def test_the_port_is_glint_clean():
    paths = default_paths(REPO)
    assert paths[0] == REPO / "src" / "repro_torch" and REPO / "chip_smoke.py" in paths
    assert REPO / "tests" / "test_torch_analysis.py" in paths
    report = run_checks(paths)
    assert report.files_checked > 100
    assert report.ok, "\n".join(f.render() for f in report.findings)
    # every suppression names a rule and carries its reason (no E002)
    assert all(f.rule != PRAGMA_REASON_ID for f in report.findings)


def test_the_cli_gates_the_port_by_default(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_import_loads_no_torch_jax_or_reference():
    code = (
        "import sys\n"
        "import repro_torch.analysis, repro_torch.analysis.__main__\n"
        "from repro_torch.analysis import check_source\n"
        "assert check_source('import torch\\nx = torch.rand(3)\\n')[0]\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


# ---------------------------------------------------------------------------
# 5. recompile_guard: a tuner sweep per new (op, bucket, dtype) key
# ---------------------------------------------------------------------------


class _FakeEngine:
    def __init__(self):
        self.sweeps = 0
        self.keys = set()

    def sweep_count(self):
        return self.sweeps

    def tuned_key_count(self):
        return len(self.keys)

    def run_batch(self, key):
        if key not in self.keys:  # the tuner's table: a miss sweeps once
            self.keys.add(key)
            self.sweeps += 1


class _FakeSystem:
    def __init__(self):
        self.infer_engine = None


def test_recompile_guard_ok_within_bound():
    eng = _FakeEngine()
    with recompile_guard(eng) as rec:
        eng.run_batch("segment_spmm_ragged/4096x512x128/float32")
        eng.run_batch("gat_softmax_aggregate/4096x512x64/float32")
    assert (rec.compiles, rec.new_shapes, rec.bound) == (2, 2, 2)


def test_recompile_guard_raises_on_a_second_sweep():
    eng = _FakeEngine()
    with pytest.raises(RecompileError, match="2 sweep"):
        with recompile_guard(eng):
            eng.run_batch("k")
            eng.sweeps += 1  # the same key swept again: the table was dropped
    eng2 = _FakeEngine()
    with recompile_guard(eng2, extra=1):  # extra= widens the bound
        eng2.run_batch("k")
        eng2.sweeps += 1


def test_recompile_guard_only_counts_the_guarded_region():
    eng = _FakeEngine()
    eng.run_batch("a")  # before the guard: not counted
    with recompile_guard(eng) as rec:
        eng.run_batch("a")  # a table hit: no sweep
        eng.run_batch("b")
    assert (rec.compiles, rec.new_shapes) == (1, 1)


def test_recompile_guard_accepts_a_system_with_a_late_engine():
    sys_like = _FakeSystem()
    with recompile_guard(sys_like) as rec:
        sys_like.infer_engine = eng = _FakeEngine()  # built mid-guard
        eng.run_batch("a")
    assert (rec.compiles, rec.new_shapes) == (1, 1)
    with recompile_guard(None) as rec0:
        pass
    assert (rec0.compiles, rec0.new_shapes, rec0.bound) == (0, 0, 0)


GRAPH = dict(num_vertices=1200, avg_degree=6, seed=5, feat_dim=16, num_classes=4)


@pytest.fixture(scope="module")
def system():
    import repro_torch.api as torch_api
    from repro_torch.graph import power_law_graph

    return torch_api.GLISPSystem.build(
        power_law_graph(**GRAPH), torch_api.GLISPConfig(num_parts=2, fanouts=(6, 4), seed=0))


def _sage_fns():
    from repro_torch.models.gnn import GNNModel

    model = GNNModel("sage", GRAPH["feat_dim"], hidden=16, num_layers=2, device="cpu")
    return [model.embed_layer_fn(k) for k in range(2)]


def test_an_untuned_engine_reads_no_sweep(system, tmp_path):
    fns = _sage_fns()
    with recompile_guard(system) as rec:
        system.infer_layerwise(fns, str(tmp_path / "run"), out_dims=[16, 16], batch_size=256,
                               device="cpu")
    eng = system.infer_engine
    assert eng.shape_count() > 0
    assert (eng.sweep_count(), eng.tuned_key_count()) == (0, 0)
    assert (rec.compiles, rec.new_shapes, rec.bound) == (0, 0, 0)


def test_the_engine_sweeps_each_key_once_under_the_guard(system, tmp_path, monkeypatch):
    """The real engine's counters with a stand-in tuner (a CPU has no
    sweep): the first pass sweeps each new key once, a repeat pass
    nothing; the tuner's table dropped mid-run sweeps again and trips it."""
    from repro_torch.core.inference import engine as engine_mod
    from repro_torch.kernels import autotune as at

    def tuner(shapes, dtype, *, cache_dir=None, device="cuda"):
        for op, shape in shapes:
            key = at.tuned_key(op, shape, dtype)
            if key in at._TUNED:
                at._STATS["memory_hits"] += 1
            else:
                at._TUNED[key] = at.KernelConfig(1, 1, 1)
                at._STATS["measured"] += 1

    monkeypatch.setattr(engine_mod, "autotune_for_slice", tuner)
    at.reset()
    try:
        fns = _sage_fns()
        kw = dict(out_dims=[16, 16], batch_size=256, device="cpu", kernel_autotune=True)
        with recompile_guard(system) as first:
            system.infer_layerwise(fns, str(tmp_path / "run"), **kw)
        eng = system.infer_engine
        assert eng.kernel_autotune and first.compiles == first.new_shapes > 0
        assert first.compiles == eng.sweep_count() == at.stats()["measured"]
        assert eng.tuned_key_count() == len(at._TUNED)
        with recompile_guard(system) as again:
            system.infer_layerwise(fns, str(tmp_path / "run"), **kw)
        assert system.infer_engine is eng
        assert (again.compiles, again.new_shapes) == (0, 0)
        # a new engine over a dropped table sweeps each of its keys once
        at.reset()
        system.infer_layerwise(fns, str(tmp_path / "run2"), **kw)
        fresh = system.infer_engine
        assert fresh is not eng and fresh.sweep_count() == fresh.tuned_key_count() > 0
    finally:
        at.reset()


# ---------------------------------------------------------------------------
# 6. the dry run's DTensor repairs: each device's forward and backward
# ---------------------------------------------------------------------------

DTENSOR_CODE = r"""
import json, torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.dryrun import fake_group
from repro_torch.kernels.ops import ssd_scan
from repro_torch.models.transformer import layers, ssm

g = torch.Generator().manual_seed(0)
res = {}

def rnd(*shape):
    return torch.randn(*shape, generator=g)

def same(a, b):
    return a.shape == b.shape and torch.equal(a, b)

with fake_group(4):
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

    def dt(local, pls):  # a leaf DTensor whose rank-0 shard is ``local``
        d = DTensor.from_local(local.detach().clone(), mesh, pls, run_check=False)
        return d.requires_grad_(local.requires_grad)

    # the causal conv's front pad (training: no state), batch over data, channels over model
    xl, wl, gl = rnd(2, 9, 6).requires_grad_(), rnd(4, 6).requires_grad_(), rnd(2, 9, 6)
    x, w = dt(xl, [Shard(0), Shard(2)]), dt(wl, [Replicate(), Shard(1)])
    y, _ = ssm._causal_conv(x, w)
    y.backward(dt(gl, list(y.placements)))
    want, _ = ssm._causal_conv(xl, wl)
    want.backward(gl)
    res["conv"] = [same(y.to_local(), want), same(x.grad.to_local(), xl.grad),
                   same(w.grad.to_local(), wl.grad), list(y.placements) == [Shard(0), Shard(2)]]

    # mm of a cache sharded on batch and sequence
    xl, wl, gl = rnd(2, 8, 5).requires_grad_(), rnd(5, 7).requires_grad_(), rnd(2, 8, 7)
    x, w = dt(xl, [Shard(0), Shard(1)]), dt(wl, [Replicate(), Replicate()])
    y = layers.mm(x, w)
    y.backward(dt(gl, list(y.placements)))
    want = xl @ wl
    want.backward(gl)
    res["mm"] = [same(y.to_local(), want), same(x.grad.to_local(), xl.grad),
                 same(w.grad.to_local(), wl.grad), list(y.placements) == [Shard(0), Shard(1)]]

    # the SSD scan: heads and groups over model (4 and 2 over 2), then heads replicated
    for name, (h, grp) in {"ssd_heads": (4, 2), "ssd_replicated": (3, 1)}.items():
        split = h % 2 == 0 and grp % 2 == 0
        hp = Shard(2) if split else Replicate()
        xl, dtl, gyl = rnd(2, 10, h, 3), torch.rand(2, 10, h, generator=g), rnd(2, 10, h, 3)
        Al, Bl, Cl = -torch.rand(h, generator=g), rnd(2, 10, grp, 4), rnd(2, 10, grp, 4)
        loc = [t.requires_grad_() for t in (xl, dtl, Al, Bl, Cl)]
        pls = [[Shard(0), hp], [Shard(0), hp], [Replicate(), Shard(0) if split else Replicate()],
               [Shard(0), hp], [Shard(0), hp]]
        ins = [dt(t, p) for t, p in zip(loc, pls)]
        y, st = ssm._sharded_ssd_scan(*ins, chunk=4)
        y.backward(dt(gyl, list(y.placements)))
        wy, wst = ssd_scan(*loc, chunk=4)
        wy.backward(gyl)
        res[name] = [same(y.to_local(), wy), same(st.to_local(), wst)] + [
            same(d.grad.to_local(), t.grad) for d, t in zip(ins, loc)]

    # decode attention: MLA-like (kv heads = q heads, both over model), then GQA (kv replicated)
    for name, (h, hkv) in {"decode_mla": (4, 4), "decode_gqa": (4, 1)}.items():
        ql, kl, vl = rnd(2, 1, h, 8), rnd(2, 6, hkv, 8), rnd(2, 6, hkv, 8)
        kpos = torch.tensor([0, 1, 2, 3, -1, -1])
        kp = Shard(2) if hkv % 2 == 0 else Replicate()
        q, k, v = dt(ql, [Shard(0), Shard(2)]), dt(kl, [Shard(0), kp]), dt(vl, [Shard(0), kp])
        o = layers._decode_attention(q, k, v, kpos, 3, 0)
        # rank 0 holds q heads 0-3 of 8; GQA: they all read the one kv head
        want = layers._decode_attention(ql, kl, vl, kpos, 3, 0)
        res[name] = [same(o.to_local(), want), list(o.placements) == [Shard(0), Shard(2)]]
print(json.dumps(res))
"""


def test_the_dry_run_repairs_keep_each_device_s_forward_and_backward():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(DTENSOR_CODE)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"conv", "mm", "ssd_heads", "ssd_replicated", "decode_mla", "decode_gqa"}
    for name, checks in res.items():
        assert all(checks), (name, checks)


SPLIT_DECODE_CODE = r"""
import json, socket, sys, torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.models.transformer import layers

def run(rank, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(0)
        res = {}
        for name, (h, hkv, L, window) in {"mqa": (4, 1, 10, 0), "mla": (4, 4, 12, 0),
                                          "window": (4, 2, 9, 5)}.items():
            q, k, v = (torch.randn(2, 1, h, 8, generator=g), torch.randn(2, L, hkv, 8, generator=g),
                       torch.randn(2, L, hkv, 6, generator=g))
            kpos = torch.arange(L)
            kpos[-2:] = -1  # empty slots
            pos = L - 3
            want = layers._decode_attention(q, k, v, kpos, pos, window)
            part = -(-L // 2)
            sl = slice(rank * part, (rank + 1) * part)
            qd = DTensor.from_local(q, mesh, [Replicate(), Replicate()], run_check=False)
            kd, vd = (DTensor.from_local(t[:, sl].contiguous(), mesh, [Replicate(), Shard(1)],
                                         run_check=False, shape=t.shape, stride=t.stride())
                      for t in (k, v))
            got = layers._decode_attention(qd, kd, vd, kpos, pos, window)
            res[name] = [got.shape == want.shape,
                         torch.allclose(got.full_tensor(), want, rtol=1e-5, atol=1e-6)]
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()

s = socket.socket()
s.bind(("127.0.0.1", 0))
port = s.getsockname()[1]
s.close()
tmp.start_processes(run, args=(port, sys.argv[1]), nprocs=2, start_method="fork")
"""


def test_split_decode_attention_over_two_ranks_equals_the_plain(tmp_path):
    """A cache sharded on its sequence over a real 2-rank gloo group: each
    rank's partials over its own keys, gathered and combined, give the
    plain decode attention (within float32 rounding: P.V in float32)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("JAX_PLATFORMS", None)
    out = tmp_path / "res.json"
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(SPLIT_DECODE_CODE), str(out)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    res = json.loads(out.read_text())
    assert set(res) == {"mqa", "mla", "window"}
    for name, checks in res.items():
        assert all(checks), (name, checks)


def test_decode_partials_combine_to_the_plain_attention():
    """The split decode's math on plain tensors: partials over three key
    slices, combined, equal the plain path within float32 rounding."""
    from repro_torch.models.transformer import layers

    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 1, 6, 16, generator=gen), torch.randn(2, 20, 2, 16, generator=gen),
               torch.randn(2, 20, 2, 12, generator=gen))
    kpos = torch.arange(20)
    kpos[15:] = -1
    want = layers._decode_attention(q, k, v, kpos, 14, 8)
    cuts = [slice(0, 7), slice(7, 14), slice(14, 20)]  # the last slice wholly masked
    parts = [layers._decode_partials(q, k[:, c], v[:, c], kpos[c], 14, 8) for c in cuts]
    got = layers._combine_partials(*(torch.stack(t) for t in zip(*parts)), q.dtype)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_the_repairs_leave_plain_tensors_on_their_paths(monkeypatch):
    """A plain tensor never takes a DTensor branch: the pad and the matmul
    run as before (the single-card bits; the LM tests hold them to JAX)."""
    from repro_torch.models.transformer import layers, ssm

    def boom(*a, **k):
        raise AssertionError("a DTensor branch on a plain tensor")

    for mod, name in ((ssm, "_pad_front_sharded"), (ssm, "_sharded_ssd_scan"),
                      (layers, "_rowwise_mm"), (layers, "_sharded_attention"),
                      (layers, "_split_decode_attention")):
        monkeypatch.setattr(mod, name, boom)
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 5, 3, generator=gen), torch.randn(4, 3, generator=gen)
    y, state = ssm._causal_conv(x, w)
    xp = torch.cat([torch.zeros(2, 3, 3), x], dim=1)
    want = sum(xp[:, i:i + 5] * w[i] for i in range(4))
    assert torch.equal(y, want) and torch.equal(state, x[:, -3:])
    m = torch.randn(2, 5, 4, generator=gen)
    assert torch.equal(layers.mm(x, m[0, :3]), x @ m[0, :3])
    q, k = torch.randn(2, 1, 4, 8, generator=gen), torch.randn(2, 6, 2, 8, generator=gen)
    o = layers._decode_attention(q, k, k, torch.arange(6), 5, 0)
    assert o.shape == (2, 1, 4, 8) and bool(torch.isfinite(o).all())
