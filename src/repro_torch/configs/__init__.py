"""Configuration registry: the paper's ScalaBFS configurations (Table II)
and the LM architectures (``--arch <id>`` resolves here)."""
from repro_torch.configs import (gemma3_4b, h2o_danube_18b, llama3_8b,
                                 llama32_3b, llava_next_34b, mamba2_370m,
                                 phi35_moe_42b, qwen3_moe_30b,
                                 recurrentgemma_2b, whisper_small)
from repro_torch.configs.scalabfs import CONFIGS, ScalaBFSConfig
from repro_torch.models.config import ArchConfig

_MODULES = {
    "llava-next-34b": llava_next_34b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b,
    "whisper-small": whisper_small,
    "mamba2-370m": mamba2_370m,
    "llama3-8b": llama3_8b,
    "h2o-danube-1.8b": h2o_danube_18b,
    "gemma3-4b": gemma3_4b,
    "llama3.2-3b": llama32_3b,
    "recurrentgemma-2b": recurrentgemma_2b,
}

ARCH_NAMES = list(_MODULES)
SCALABFS_CONFIGS = CONFIGS          # the reference's name for Table II


def get_config(name: str) -> ArchConfig:
    return _MODULES[name].CONFIG


def get_reduced_config(name: str) -> ArchConfig:
    return _MODULES[name].REDUCED


__all__ = ["ARCH_NAMES", "CONFIGS", "SCALABFS_CONFIGS", "ScalaBFSConfig",
           "get_config", "get_reduced_config"]
