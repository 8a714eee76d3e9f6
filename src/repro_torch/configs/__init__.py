# repro: quarantine -- growth-seed LM model configs; nothing in the battery system reads them
"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``
(port of ``repro/configs``).

Every architecture of the reference is ported: the dense, vlm, moe,
audio, ssm and hybrid families (qwen2-1.5b, gemma2-27b, glm4-9b,
chameleon-34b, nemotron-4-340b, granite-moe-1b-a400m, deepseek-v2-236b,
whisper-small, xlstm-1.3b, zamba2-1.2b). ``NOT_PORTED`` is empty; an
architecture the reference lacks raises a ``KeyError``.
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
    "whisper-small": "whisper_small",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-1.2b": "zamba2_1_2b",
}
# the reference's architectures the port does not run yet: none
NOT_PORTED = ()

ARCH_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _mod(arch_id).CONFIG


def get_reduced(arch_id: str):
    return _mod(arch_id).reduced()
