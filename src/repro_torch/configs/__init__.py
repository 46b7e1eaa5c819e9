"""Architecture registry: one module per assigned arch (--arch <id>).

Each module defines CONFIG (the exact assigned configuration, source cited)
and REDUCED (same family at smoke-test scale: ≤2 layers·d_model≤512·≤4
experts, used by per-arch CPU smoke tests)."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "gemma_2b",
    "granite_3_2b",
    "mamba2_130m",
    "granite_20b",
    "internlm2_1_8b",
    "llava_next_34b",
    "recurrentgemma_2b",
    "deepseek_v2_lite_16b",
    "mixtral_8x7b",
    "musicgen_medium",
]

# canonical dashed ids from the assignment
DASHED = {i.replace("_", "-"): i for i in ARCH_IDS}
DASHED["internlm2-1.8b"] = "internlm2_1_8b"
DASHED["granite-3-2b"] = "granite_3_2b"


def get_config(arch: str, reduced: bool = False):
    mod_name = DASHED.get(arch, arch.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(reduced: bool = False):
    return {a: get_config(a, reduced) for a in ARCH_IDS}
