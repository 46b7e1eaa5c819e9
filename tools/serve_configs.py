"""Serve, on the card, the single-card configs that ``chip_smoke.py`` does not.

    python3 tools/serve_configs.py [--archs internlm2-1.8b granite-3-2b ...]

Builds the port's kernels, then runs ``chip_smoke.py``'s ``serve_lm`` for
each config at its full width in bf16 (batch 4, llava-next-34b batch 1,
prompt 2048, 32 greedy tokens, weights drawn on the card from seed 0;
musicgen-medium and llava-next-34b are fed random embeddings): the
flash-attention launches one
per layer's prefill and none in decode, two runs bitwise equal, the
prefill's logits against the plain versions in float32 at the depth given
below and in bf16 within ``LM_BF16_RATIO``, and a profiled prefill. Then it
times the flash kernel at the first prefill call of a D 128 config
(internlm2-1.8b) and of a D 64 one (granite-3-2b), as ``chip_smoke.py``
times rows 7 and 7b. Prints the card's name and power limit and one JSON
line with every config's serving numbers and the two kernel rows. A
config that fails is reported with its error and the others still run;
the exit code is then 1. Needs one CUDA card; kept out of
``chip_smoke.py``'s time budget (granite-20b is 40 GB of weights,
llava-next-34b 68 GB).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# arch -> (layers of the float32 check, None: all; batch). granite-20b's
# check at 4 layers (8 GB in float32 beside its 40 GB); llava-next-34b's at
# 1 layer and batch 1: beside its 68 GB, neither its 4 layers in float32
# nor the plain attention's float32 scores of a batch of 4 (3.5 GB) fit
CONFIGS = {
    "internlm2-1.8b": (None, 4),
    "granite-3-2b": (None, 4),
    "musicgen-medium": (None, 4),
    "granite-20b": (4, 4),
    "llava-next-34b": (1, 1),
}
# the config whose first prefill call times the kernel at each head width
TIMED = {"internlm2-1.8b": "flash_attention_d128", "granite-3-2b": "flash_attention_d64"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("serve_configs: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.build_kernels()
    served, rows, failed = {}, [], {}
    for arch in args.archs:
        torch.cuda.empty_cache()
        captured: dict = {}
        t0 = time.perf_counter()
        f32_layers, chip_smoke.LM_BATCH = CONFIGS[arch]
        try:
            info = chip_smoke.serve_lm(arch, "flash_attention", f32_layers, captured)
        except Exception as e:  # report it and go on with the others
            failed[arch] = f"{type(e).__name__}: {e}"[:400]
            traceback.print_exc()
            continue
        info["phase_s"] = time.perf_counter() - t0
        served[arch] = {k: info[k] for k in (
            "phase_s", "batch", "prefill_ms", "again_prefill_ms", "decode_ms_per_token",
            "peak_memory_gb", "launches", "two_runs_bitwise_equal", "f32_depth",
            "f32_logits_max_abs_err_vs_plain", "bf16_kernels_err_vs_f32",
            "bf16_plain_err_vs_f32", "profile")}
        if arch in TIMED:
            rows.append(chip_smoke.time_flash(captured[arch], info["launches"]["flash_attention"],
                                              name=TIMED[arch]))
        del captured
    card = chip_smoke.device_line()
    print(card, flush=True)
    print(json.dumps({"card": card, "served": served, "kernels": rows, "failed": failed}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
