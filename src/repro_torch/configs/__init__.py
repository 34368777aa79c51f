from repro_torch.configs.base import SHAPES, ModelConfig, MoEConfig, ShapeConfig, SSMConfig, sub_quadratic_ready
from repro_torch.configs.registry import ARCH_NAMES, get, reduced

__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
    "sub_quadratic_ready", "ARCH_NAMES", "get", "reduced",
]
