"""Device mesh of the port: the reference's five named axes over
``torch.device``s (only ``seq`` may exceed 1 so far)."""

from .mesh import (
    ALL_AXES,
    AXIS_SEQ,
    DeviceMesh,
    MeshConfig,
    axis_size,
    build_mesh,
)

__all__ = ["ALL_AXES", "AXIS_SEQ", "DeviceMesh", "MeshConfig", "axis_size",
           "build_mesh"]
