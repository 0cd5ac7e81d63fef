"""Configs of the port: the model zoo, the DAG-FL deployment and the paper tasks."""
from repro_torch.configs.base import (
    SHAPES,
    DagFLConfig,
    ModelConfig,
    RunConfig,
    ShapeSpec,
    TrainConfig,
)
from repro_torch.configs.registry import (
    ARCHS,
    POD_GRANULARITY,
    get_arch,
    get_shape,
    list_archs,
    long_context_variant,
)

__all__ = [
    "DagFLConfig",
    "ModelConfig",
    "SHAPES",
    "RunConfig",
    "ShapeSpec",
    "TrainConfig",
    "ARCHS",
    "POD_GRANULARITY",
    "get_arch",
    "get_shape",
    "list_archs",
    "long_context_variant",
]
