from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import ARCHS, get_arch, smoke_config

__all__ = ["ModelConfig", "TrainConfig", "ARCHS", "get_arch", "smoke_config"]
