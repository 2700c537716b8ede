"""Assigned-architecture registry: --arch <id> resolves here.

Every config cites its public source; reduced smoke variants come from
`repro_torch.models.config.reduced`. A copy of `repro/configs/__init__.py`;
each config module is a copy of its counterpart there.
"""
from repro_torch.configs.stablelm_3b import CONFIG as STABLELM_3B
from repro_torch.configs.llama_3_2_vision_90b import CONFIG as LLAMA_32_VISION_90B
from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA2_27B
from repro_torch.configs.command_r_plus_104b import CONFIG as COMMAND_R_PLUS_104B
from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B
from repro_torch.configs.granite_3_8b import CONFIG as GRANITE_3_8B
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA_15B
from repro_torch.configs.musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from repro_torch.configs.dbrx_132b import CONFIG as DBRX_132B
from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN25_3B

ARCHITECTURES = {
    c.name: c
    for c in [
        STABLELM_3B,
        LLAMA_32_VISION_90B,
        MAMBA2_27B,
        COMMAND_R_PLUS_104B,
        ARCTIC_480B,
        GRANITE_3_8B,
        HYMBA_15B,
        MUSICGEN_MEDIUM,
        DBRX_132B,
        QWEN25_3B,
    ]
}


def get_config(name: str):
    if name not in ARCHITECTURES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}"
        )
    return ARCHITECTURES[name]
