"""Serving launcher: batched prefill + greedy decode with the KV/state cache.
Port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --no-reduced \
        --batch 4 --prompt-len 2048 --gen 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
        --no-reduced --batch 4 --prompt-len 2048 --gen 32

Serves the dense, SSM and MoE families (deepseek-v2-lite with MLA,
mixtral-8x7b; mixtral's full config, 93 GB in bf16, does not fit one
80 GB card). Runs on the card by default (``--device cpu`` for the CPU).
Every attention prefill, MLA's included, goes through the flash-attention
kernel and every Mamba-2 prefill through the SSD-scan kernel; decode, the
MoE routing and the expert products are plain tensor code, as the JAX
package leaves them to XLA.

Reports prefill and per-token decode latency. The flags are the JAX CLI's,
except that ``--reduced`` is a ``BooleanOptionalAction`` (default still
reduced), so ``--no-reduced`` reaches the full config; the JAX flag is
``store_true`` with ``default=True`` and cannot be turned off.

Weights are random, drawn on the device from a ``torch.Generator`` seeded
with ``--seed``; prompts come from a numpy generator with the same seed
(``jax.random`` has no counterpart).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.specs import make_decode_step, make_prefill_step
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.model import init_cache, init_params

__all__ = ["serve", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(
    cfg: ArchConfig,
    *,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    seed: int = 0,
    device="cuda",
    params=None,
) -> dict:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens (numpy seed
    ``seed``), then ``gen`` greedy decode steps. ``params`` defaults to
    :func:`init_params` from a generator seeded with ``seed`` on the
    device. Returns ``prefill_ms``, ``decode_ms_per_token`` (host clock
    around work that ends in a device sync), ``tokens`` (int64 [batch,
    gen + 1]: the prefill's greedy token, then each decode step's) and
    ``logits`` (the prefill's last-position logits [batch, Vp], float32,
    on the device)."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        shape = (batch, prompt_len, cfg.d_model)
        prompt = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)
        # the JAX launcher feeds one fixed random embedding at every step
        step_in = torch.as_tensor(
            rng.standard_normal((batch, 1, cfg.d_model), dtype=np.float32), device=dev
        )
    else:
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)), device=dev)
    cache = init_cache(cfg, batch, prompt_len + gen, dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, cache, {"inputs": prompt})
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        toks = [logits[:, : cfg.vocab_size].argmax(dim=-1)]
        t0 = time.perf_counter()
        for i in range(gen):
            inp = step_in if cfg.input_mode == "embeddings" else toks[-1][:, None]
            step_logits, cache = decode(params, cache, {"inputs": inp}, prompt_len + i)
            toks.append(step_logits[:, : cfg.vocab_size].argmax(dim=-1))
        _sync(dev)
        t_decode = (time.perf_counter() - t0) / max(gen, 1)
    return {
        "prefill_ms": t_prefill * 1e3,
        "decode_ms_per_token": t_decode * 1e3,
        "tokens": torch.stack(toks, dim=1).cpu().numpy(),
        "logits": logits,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                seed=args.seed, device=args.device)
    print(f"arch {cfg.name}: prefill({args.prompt_len} tok) {out['prefill_ms']:.1f} ms, "
          f"decode {out['decode_ms_per_token']:.1f} ms/tok")
    print("sampled tokens (greedy):", [int(t) for t in out["tokens"][0]][:10], "...")


if __name__ == "__main__":
    main()
