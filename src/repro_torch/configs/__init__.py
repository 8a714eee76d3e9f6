# repro: quarantine -- growth-seed LM model configs; nothing in the battery system reads them
"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``
(port of ``repro/configs``).

The dense, vlm, moe, ssm and hybrid architectures are ported
(qwen2-1.5b, gemma2-27b, glm4-9b, chameleon-34b, nemotron-4-340b,
granite-moe-1b-a400m, deepseek-v2-236b, xlstm-1.3b, zamba2-1.2b). The
reference's one other architecture, whisper-small's encoder-decoder,
raises a ``KeyError`` that says so (ROADMAP.md, queue 1, item 4).
"""
from __future__ import annotations

import importlib

_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "gemma2-27b": "gemma2_27b",
    "glm4-9b": "glm4_9b",
    "chameleon-34b": "chameleon_34b",
    "nemotron-4-340b": "nemotron_4_340b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-1.2b": "zamba2_1_2b",
}
NOT_PORTED = ("whisper-small",)

ARCH_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet (see ROADMAP.md, "
                       f"queue 1 item 4); ported: {sorted(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _mod(arch_id).CONFIG


def get_reduced(arch_id: str):
    return _mod(arch_id).reduced()
