from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig, ShapeConfig,
                                     TrainConfig)
from repro_torch.configs.registry import (ARCHS, get_arch, get_shape,
                                         shape_applicable, smoke_config)

__all__ = ["INPUT_SHAPES", "ModelConfig", "ShapeConfig", "TrainConfig",
           "ARCHS", "get_arch", "get_shape", "shape_applicable",
           "smoke_config"]
