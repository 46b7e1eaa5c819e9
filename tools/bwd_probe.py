"""Two probes of the LM-training backward kernels on the card.

    python3 tools/bwd_probe.py [--only ssd|flash|flash-phases] [--package SRC]
                               [--flash-src PATH] [--out build/bwd_probe.json]

``--package`` is the ``src`` directory whose ``repro_torch`` the probes
import (default: this checkout's; the parent's, unpacked by ``git archive``
under ``build/parent``, times the parent's SSD kernels).

1. **Where the SSD backward's time goes.** At mamba2-130m's training call
   (B 4, S 2048, H 24, P 64, G 1, N 128, bf16; x, B and C strided slices
   of one [B, S, H P + 2 G N] tensor, as the model hands them over) the
   wrapper ``ssd_scan.ssd_scan_backward`` is timed as ``chip_smoke.py``
   times it (CUDA-graph replay, inputs rotated over four copies), eagerly,
   and under ``torch.profiler``, which lists every device kernel and copy
   of a call by name, with and without the rotation. The kernels' sum
   beside the graph time says what fills the gap.

2. **The flash backward's D.** At gemma-2b's training call (B 2, S 2048,
   H 8 over 1, D 256, causal, bf16) the backward source at ``--flash-src``
   (default: the parent's, unpacked by ``git archive`` under
   ``build/parent``) is built with its D kernel's launch removed, so the
   caller hands it D = rowsum(dO o). It runs with D from the bf16 output
   (what the source computes itself) and from the float32 output of the
   plain version on the same inputs; for each, dq, dk and dv's largest
   error from autograd of the plain version on the inputs upcast to
   float32, over the plain bf16 version's own (``chip_smoke.py``'s
   ATTN_BF16_GRAD_RATIO gate, 2.0).

3. **The flash backward by kernel** (``--only flash-phases``): at
   gemma-2b's training call, o the forward's float32 output, graph replay
   and the profiler's device events of a call.

Prints the card's name and power limit and one JSON line (also written to
``--out``). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def device_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_name(full: str) -> str:
    """A device event's kernel name without its return type, namespace and
    arguments: "ssd_bwd_kernel_chunk_grad<__nv_bfloat16, 64, 128>"."""
    name = full.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120]


def profile_calls(fn, calls: int) -> dict:
    """Device ms per call by kernel name, and the device span per call
    (first kernel's start to the last one's end, over ``calls``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    starts, ends = [], []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = kernel_name(evt.name)
        by_name[name] = by_name.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3 / calls
        starts.append(evt.time_range.start)
        ends.append(evt.time_range.end)
    span = (max(ends) - min(starts)) / 1e3 / calls if starts else None
    return {"kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
            "kernels_sum_ms": sum(by_name.values()), "device_span_ms": span}


def ssd_probe() -> dict:
    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan as sk

    b, s, h, p, g, n = 4, 2048, 24, 64, 1, 128
    gen = torch.Generator("cuda").manual_seed(0)
    xbc = torch.randn((b, s, h * p + 2 * g * n), generator=gen, device="cuda").bfloat16()
    x = xbc[..., : h * p].reshape(b, s, h, p)
    B = xbc[..., h * p: h * p + g * n].reshape(b, s, g, n)
    C = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    dt = torch.rand((b, s, h), generator=gen, device="cuda") * 0.5 + 0.01
    a = dt * -(torch.rand(h, generator=gen, device="cuda") + 0.1)
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").bfloat16()
    args = (x, a, dt, B, C, dy, None)
    contiguous = tuple(t.contiguous() if torch.is_tensor(t) else t for t in args)
    rot = cs.rotating(sk.ssd_scan_backward, *args)
    out = {
        "shape": {"B": b, "S": s, "H": h, "P": p, "G": g, "N": n, "dtype": "bfloat16",
                  "x_B_C_strided": not x.is_contiguous()},
        "graph_ms_rotated": cs.graph_ms(rot, iters=5),
        "graph_ms_same_inputs": cs.graph_ms(lambda: sk.ssd_scan_backward(*args), iters=5),
        "graph_ms_contiguous_inputs": cs.graph_ms(lambda: sk.ssd_scan_backward(*contiguous),
                                                  iters=5),
        "eager_ms_rotated": cs.time_ms(rot, iters=20),
        "profile_rotated": profile_calls(rot, 8),
        "profile_same_inputs": profile_calls(lambda: sk.ssd_scan_backward(*args), 8),
        "profile_contiguous_inputs": profile_calls(lambda: sk.ssd_scan_backward(*contiguous), 8),
    }
    return out


def flash_phases() -> dict:
    """The flash backward at gemma-2b's training call (o float32, as
    training hands it over): graph-replay ms with rotated inputs, and the
    profiler's device events of a call by kernel."""
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    b, s, h, hkv, d = 2, 2048, 8, 1, 256
    kw = dict(causal=True, window=0, kv_offset=0)
    q, k, v = cs.attn_inputs(b, s, s, h, hkv, d, torch.bfloat16, s + d)
    dout = cs.attn_inputs(b, s, 1, h, 1, d, torch.bfloat16, s + d + 1)[0]
    lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device="cuda")
    o32 = torch.empty((b, s, h, d), dtype=torch.float32, device="cuda")
    fa.launch_flash_attention(q, k, v, out, lse, o32, **kw)

    def call(*t):
        return fa.flash_attention_backward(*t, **kw)

    rot = cs.rotating(call, q, k, v, o32, dout, lse)
    return {"graph_ms_rotated": cs.graph_ms(rot, iters=5),
            "profile_rotated": profile_calls(rot, 6)}


def build_flash_variant(src: Path) -> ctypes.CDLL:
    """``src`` with its D kernel's launch taken out (D comes from the
    caller), built with the repo's flags."""
    from repro_torch.kernels import build

    text = src.read_text()
    launch = ("flash_bwd_kernel_delta<T, DV><<<static_cast<unsigned>(delta_blocks), kThreads, 0, "
              "stream>>>(a);")
    if launch not in text:
        raise RuntimeError(f"{src}: the D kernel's launch is not where the probe expects it")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    patched = build.BUILD_DIR / "flash_attention_backward-delta-given.cu"
    patched.write_text(text.replace(launch, "(void)delta_blocks;"))
    fd, out = tempfile.mkstemp(prefix="flash_bwd-delta-given-", suffix=".so", dir=build.BUILD_DIR)
    os.close(fd)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", out, str(patched)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}")
    return build._bind(ctypes.CDLL(out), "flash_attention_backward")


def flash_probe(src: Path) -> dict:
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_backward_ref, attention_ref

    lib = build_flash_variant(src)
    b, s, h, hkv, d = 2, 2048, 8, 1, 256
    kw = dict(causal=True, window=0, kv_offset=0)
    q, k, v = cs.attn_inputs(b, s, s, h, hkv, d, torch.bfloat16, s + d)
    dout = cs.attn_inputs(b, s, 1, h, 1, d, torch.bfloat16, s + d + 1)[0]
    lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    o16 = torch.empty((b, s, h, d), dtype=torch.bfloat16, device="cuda")
    fa.launch_flash_attention(q, k, v, o16, lse, **kw)
    o32 = attention_ref(q.float(), k.float(), v.float(), **kw)
    up = attention_backward_ref(q.float(), k.float(), v.float(), dout.float(), **kw)
    plain = attention_backward_ref(q, k, v, dout, **kw)
    plain_err = [cs.max_err(w, u) for w, u in zip(plain, up)]

    def run(o_for_delta):
        delta = (dout.float() * o_for_delta.float()).sum(-1).permute(0, 2, 1).contiguous()
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        f32 = dict(dtype=torch.float32, device="cuda")
        dk_part = torch.empty((b, h, s, d), **f32)
        dv_part = torch.empty((b, h, s, d), **f32)
        code = lib.flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o16.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            dk_part.data_ptr(), dv_part.data_ptr(), b, s, s, h, hkv, d, d, 1, 1, 0, 0,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: {code}")
        torch.cuda.synchronize()
        errs = [cs.max_err(g, u) for g, u in zip((dq, dk, dv), up)]
        return {name: {"err": e, "plain_err": pe, "ratio": e / pe, "share_of_attn_tol":
                       cs.tol_share(g, u, cs.ATTN_TOL[torch.bfloat16])}
                for name, e, pe, g, u in zip(("dq", "dk", "dv"), errs, plain_err, (dq, dk, dv),
                                             up)}

    return {"shape": {"B": b, "S": s, "H": h, "Hkv": hkv, "D": d, "causal": True,
                      "dtype": "bfloat16"},
            "delta_from_bf16_o": run(o16), "delta_from_float32_o": run(o32),
            "o16_vs_o32_max_abs": cs.max_err(o16, o32)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flash-src", type=Path, default=ROOT / "build" / "parent" / "src" /
                    "repro_torch" / "kernels" / "csrc" / "flash_attention_backward.cu")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "bwd_probe.json")
    ap.add_argument("--only", choices=("ssd", "flash", "flash-phases"))
    ap.add_argument("--package", type=Path, default=ROOT / "src")
    args = ap.parse_args()
    sys.path.insert(0, str(args.package.resolve()))
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"device": device_line(), "package": str(args.package)}
    if args.only in (None, "ssd"):
        res["ssd_backward"] = ssd_probe()
    if args.only in (None, "flash"):
        res["flash_delta"] = flash_probe(args.flash_src)
    if args.only in (None, "flash-phases"):
        res["flash_backward"] = flash_phases()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    print(res["device"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
