"""Architecture configs (``--arch <id>``) + shape registry."""

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeConfig,
    SHAPES,
    get_config,
    get_shape,
    list_archs,
    REGISTRY,
)
