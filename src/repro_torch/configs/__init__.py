from repro_torch.configs.base import (ARCH_IDS, LONG_CONTEXT_ARCHS, SHAPES,
                                ModelConfig, MoEConfig, RWKVConfig, ShapeSpec,
                                SSMConfig, arch_shape_cells, get_config,
                                shape_for)

__all__ = [
    "ARCH_IDS", "LONG_CONTEXT_ARCHS", "SHAPES", "ModelConfig", "MoEConfig",
    "RWKVConfig", "ShapeSpec", "SSMConfig", "arch_shape_cells", "get_config",
    "shape_for",
]
