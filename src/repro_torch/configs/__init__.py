from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS, get_arch, smoke_config

__all__ = ["ModelConfig", "ARCHS", "get_arch", "smoke_config"]
