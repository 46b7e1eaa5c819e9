"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``) on the CPU: the analytic FLOPs and
bytes equal the reference's exactly for every arch and shape, the dict
shapes ``chip_smoke.py`` runs included; the kernel formulas give the bounds
``PERF.md`` §6 holds for the LM rows; an unknown card raises."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.launch.specs as jax_specs  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import roofline as ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch.specs import SHAPES, resolve_config  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"

# chip_smoke.py's runs: serving at batch 4, prompt 2048 (decode at the prompt
# plus half of 32 generated tokens), training at its LM_TRAIN shapes
SMOKE_SHAPES = [
    (arch, dict(seq=2048, batch=4, kind="prefill"))
    for arch in ("gemma_2b", "mamba2_130m", "deepseek_v2_lite_16b", "recurrentgemma_2b")
] + [
    (arch, dict(seq=2048 + 16, batch=4, kind="decode"))
    for arch in ("gemma_2b", "mamba2_130m", "deepseek_v2_lite_16b", "recurrentgemma_2b")
] + [
    ("gemma_2b", dict(seq=2048, batch=2, kind="train")),
    ("mamba2_130m", dict(seq=2048, batch=4, kind="train")),
    ("recurrentgemma_2b", dict(seq=4096, batch=1, kind="train")),
]


def _configs(arch, shape_name):
    cfg_j = jax_specs.resolve_config(jax_get_config(arch), shape_name)
    cfg_t = resolve_config(get_config(arch), shape_name)
    return cfg_j, cfg_t


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_analytic_flops_equals_reference(arch, shape):
    cfg_j, cfg_t = _configs(arch, shape)
    assert rf.analytic_flops(cfg_t, shape) == ref.analytic_flops(cfg_j, shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_analytic_hbm_bytes_equals_reference(arch, shape):
    cfg_j, cfg_t = _configs(arch, shape)
    assert rf.analytic_hbm_bytes(cfg_t, shape, weight_bytes=4) == ref.analytic_hbm_bytes(
        cfg_j, shape, {})


@pytest.mark.parametrize("S", [1, 2, 7, 2048, 4096, 32768])
def test_avg_context_equals_reference(S):
    for window in (-1, 0, 1, 2, 5, 2047, 2048, 4096, 8192):
        assert rf._avg_context(S, window) == ref._avg_context(S, window), window


@pytest.mark.parametrize("arch,shape", SMOKE_SHAPES,
                         ids=[f"{a}-{s['kind']}-{s['batch']}x{s['seq']}" for a, s in SMOKE_SHAPES])
def test_chip_smoke_shapes_equal_reference(arch, shape, monkeypatch):
    """The dict shapes reach the reference through its own ``SHAPES``; bf16
    weights take half the float32 weights' bytes, and nothing else."""
    monkeypatch.setitem(jax_specs.SHAPES, "smoke", shape)
    cfg_j, cfg_t = jax_get_config(arch), get_config(arch)
    assert rf.analytic_flops(cfg_t, shape) == ref.analytic_flops(cfg_j, "smoke")
    b4 = rf.analytic_hbm_bytes(cfg_t, shape)
    assert b4 == ref.analytic_hbm_bytes(cfg_j, "smoke", {})
    if shape["kind"] != "train":
        assert b4 - rf.analytic_hbm_bytes(cfg_t, shape, weight_bytes=2) == 2 * cfg_t.num_params()


def _lm_kernel_calls():
    """PERF.md §6's LM rows at their fixed calls, shapes from the configs."""
    gemma, ds, mamba = (get_config(a) for a in ("gemma-2b", "deepseek-v2-lite-16b",
                                                "mamba2-130m"))
    attn = dict(seq_q=2048, heads=gemma.num_heads, kv_heads=gemma.num_kv_heads,
                dim=gemma.resolved_head_dim, dtype_bytes=2)
    s = mamba.ssm
    ssd = dict(batch=4, seq=2048, heads=s.expand * mamba.d_model // s.head_dim,
               head_dim=s.head_dim, groups=s.num_groups, state_dim=s.state_dim, dtype_bytes=2)
    return [
        ("7", "flash_attention", {**attn, "batch": 4}, 0.0695, "compute"),
        ("7b", "flash_attention",
         dict(batch=4, seq_q=2048, heads=ds.num_heads, kv_heads=ds.num_heads,
              dim=ds.resolved_head_dim + ds.rope_head_dim, dim_v=ds.resolved_head_dim,
              dtype_bytes=2), 0.0869, "compute"),
        ("7-bw", "flash_attention_backward", {**attn, "batch": 2, "o_bytes": 4}, 0.0869,
         "compute"),
        ("8", "ssd_scan", {**ssd, "init_state": True}, 0.0186, "memory"),
        ("8-bw", "ssd_scan_backward", ssd, 0.0260, "memory"),
    ]


@pytest.mark.parametrize("row", range(5), ids=["7", "7b", "7-bw", "8", "8-bw"])
def test_lm_kernel_bounds_equal_perf_md(row):
    _, op, shape, want_ms, bound = _lm_kernel_calls()[row]
    got = rf.kernel_roofline(op, shape, 1e-3, "bf16", rf.hardware(H100))
    assert round(got["bound_s"] * 1e3, 4) == want_ms
    assert got["bound"] == bound


def test_attention_pairs_equal_the_mask():
    """Unmasked pairs under a window and a kv_offset, against the mask
    counted with numpy."""
    sq, skv, window, offset = 37, 53, 9, 16
    for causal in (True, False):
        for w in (0, window):
            shape = dict(batch=2, seq_q=sq, seq_kv=skv, heads=3, dim=8, causal=causal,
                         window=w, kv_offset=offset)
            q = offset + np.arange(sq)[:, None]
            k = np.arange(skv)[None, :]
            mask = (k <= q) if causal else np.ones((sq, skv), bool)
            if w:
                mask &= k > q - w
            assert rf.kernel_flops("flash_attention", shape) == 2 * 16 * 2 * 3 * mask.sum()


def test_every_reference_kernel_op_has_a_port_formula():
    shape = dict(edges=4096, segments=512, dim=64, valid_edges=3000, rows_read=700)
    hw = rf.hardware(H100)
    for op in ref.KERNEL_OPS:
        assert op in rf.KERNEL_OPS, op
        got = rf.kernel_roofline(op, shape, 1e-5, "f32", hw)
        assert got["flops"] > 0 and got["hbm_bytes"] > 0, op
    fused, unfused = (rf.kernel_hbm_bytes(op, shape)
                      for op in ("gather_spmm_ragged", "unfused_gather_spmm"))
    assert unfused - fused == 2 * 3000 * 64 * 4  # the messages' round trip
    assert rf.kernel_hbm_bytes("segment_spmm_ragged", shape) < rf.kernel_hbm_bytes(
        "segment_spmm_ragged", {**shape, "valid_edges": 4096})


def test_kernel_roofline_returns_reference_keys():
    shape = dict(edges=4096, segments=512, dim=64)
    want = ref.kernel_roofline("segment_spmm", shape, 1e-3)
    got = rf.kernel_roofline("segment_spmm", shape, 1e-3, "f32", rf.hardware(H100))
    assert set(got) == set(want)
    assert got["bound_s"] == max(got["compute_s"], got["memory_s"])
    assert got["frac_of_bound"] == got["bound_s"] / 1e-3


def test_kernel_roofline_peak_follows_dtype():
    hw = rf.hardware(H100)
    shape = dict(edges=4096, segments=512, dim=64)
    f32 = rf.kernel_roofline("segment_spmm", shape, 1e-3, "float32", hw)
    bf16 = rf.kernel_roofline("segment_spmm", shape, 1e-3, "bfloat16", hw)
    assert f32["compute_s"] == 4096 * 64 / 67e12
    assert bf16["compute_s"] == 4096 * 64 / 989e12
    with pytest.raises(ValueError, match="dtype"):
        rf.kernel_roofline("segment_spmm", shape, 1e-3, "f8", hw)
    with pytest.raises(ValueError, match="unknown kernel op"):
        rf.kernel_flops("segment_mean", shape)


def test_hardware():
    hw = rf.hardware(H100)
    assert hw == {"peak_flops_bf16": 989e12, "peak_flops_f32": 67e12, "hbm_bw": 3.35e12,
                  "nvlink_bw": 450e9, "nvlink_ranks": 8, "ib_bw": 50e9}
    hw["hbm_bw"] = 0.0  # a copy: the table stays
    assert rf.HW[H100]["hbm_bw"] == 3.35e12
    with pytest.raises(ValueError, match="unknown card"):
        rf.hardware("unknown card")
    with pytest.raises(ValueError, match="NVIDIA A100"):
        rf.hardware("NVIDIA A100-SXM4-80GB")


def test_step_roofline():
    """The reference's keys (less those read from HLO), no collectives on one
    card, and the shares of a measured wall."""
    cfg = get_config("gemma-2b")
    shape = dict(seq=2048, batch=4, kind="prefill")
    hw = rf.hardware(H100)
    got = rf.roofline(cfg, shape, hw=hw, weight_bytes=2)
    fl = rf.analytic_flops(cfg, shape)
    by = rf.analytic_hbm_bytes(cfg, shape, weight_bytes=2)
    assert got["collective_s"] == 0.0
    assert got["compute_s"] == fl["total"] / 989e12 and got["memory_s"] == by / 3.35e12
    assert got["dominant"] == "compute_s"
    assert got["step_time_bound_s"] == got["compute_s"]
    assert got["useful_flops_ratio"] == fl["6nd"] / fl["total"]
    assert "mfu" not in got and "hbm_share" not in got
    timed = rf.roofline(cfg, shape, hw=hw, wall_s=0.0713, weight_bytes=2)
    assert timed["mfu"] == fl["total"] / (0.0713 * 989e12)
    assert timed["hbm_share"] == by / (0.0713 * 3.35e12)
    assert 0.4 < timed["mfu"] < 0.55  # the issue's sizing: 3.37e13 FLOPs in 71.3 ms
    decode = rf.roofline(cfg, dict(seq=2064, batch=4, kind="decode"), hw=hw)
    assert decode["dominant"] == "memory_s"
    keys = {"compute_s", "memory_s", "collective_s", "dominant", "step_time_bound_s",
            "analytic_flops_global", "model_flops_6nd_global", "useful_flops_ratio",
            "analytic_bytes_per_device"}
    assert set(decode) == keys


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_reads_its_bounds_from_the_roofline(chip_smoke):
    """No bound arithmetic of its own: a row's bound is ``kernel_roofline``'s
    (row 8 at mamba2-130m's prefill, PERF.md §6), an LM step's shares are
    ``roofline``'s."""
    for name in ("bound_ms", "HBM_BYTES_PER_S", "F32_FLOPS", "BF16_FLOPS"):
        assert not hasattr(chip_smoke, name), name
    hw = rf.hardware(H100)
    _, op, shape, want_ms, _ = _lm_kernel_calls()[3]
    row = chip_smoke.bound_fields(hw, op, shape, 0.1705, "bf16")
    assert round(row["bound_ms"], 4) == want_ms and row["bound_by"] == "bytes"
    assert row["bound_share"] == row["bound_ms"] / 0.1705
    assert row["roofline_op"] == op
    cfg = get_config("gemma-2b")
    shape = dict(seq=2048, batch=2, kind="train")
    got = chip_smoke.step_roofline("train gemma-2b", cfg, shape, 407.3, hw, 4)
    want = rf.roofline(cfg, shape, hw=hw, wall_s=0.4073)
    assert got == {k: want[k] for k in ("mfu", "hbm_share", "step_time_bound_s", "dominant")}


def test_chip_smoke_fails_a_share_over_one(chip_smoke):
    hw = rf.hardware(H100)
    with pytest.raises(RuntimeError, match="bound_share"):
        chip_smoke.bound_fields(hw, "segment_sort", {"edges": 10**9}, 1e-3)
    with pytest.raises(RuntimeError, match="mfu"):
        chip_smoke.step_roofline("serve gemma-2b prefill", get_config("gemma-2b"),
                                 dict(seq=2048, batch=4, kind="prefill"), 1.0, hw, 2)
