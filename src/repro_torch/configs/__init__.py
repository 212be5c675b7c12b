from .base import (ARCH_IDS, SHAPES, ArchConfig, MLAConfig, MoEConfig,
                   ShapeSpec, SSMConfig, get_config, reduced_config)

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "MLAConfig", "MoEConfig",
           "ShapeSpec", "SSMConfig", "get_config", "reduced_config"]
