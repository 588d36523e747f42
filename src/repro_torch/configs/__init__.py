"""Config registry: ``get_config(arch_id)`` / ``ARCHS``."""
from repro_torch.configs.base import (ModelConfig, ParleConfig, replace,
                                      smoke_variant)

from repro_torch.configs.internvl2_1b import CONFIG as _internvl2_1b
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4_scout
from repro_torch.configs.llama3_405b import CONFIG as _llama3_405b
from repro_torch.configs.qwen1_5_32b import CONFIG as _qwen15_32b
from repro_torch.configs.musicgen_large import CONFIG as _musicgen_large
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2_moe
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2
from repro_torch.configs.llama3_8b import CONFIG as _llama3_8b
from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen25_3b
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2

ARCHS = {c.name: c for c in [
    _internvl2_1b, _llama4_scout, _llama3_405b, _qwen15_32b,
    _musicgen_large, _qwen2_moe, _zamba2, _llama3_8b, _qwen25_3b, _mamba2,
]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
