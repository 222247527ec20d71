"""Configuration of CenterPoint, voxel variant, on nuScenes (Yin, Zhou and
Krähenbühl, "Center-based 3D Object Detection and Tracking", CVPR 2021;
OpenPCDet ``tools/cfgs/nuscenes_models/
cbgs_voxel0075_res3d_centerpoint.yaml``).

The defaults are the published values: 10 sweeps at 20 Hz with a time-lag
channel, 0.075 x 0.075 x 0.2 m voxels over [-54, -54, -5, 54, 54, 3] (a
1440 x 1440 x 40 grid), MeanVFE over a voxel's first 10 points, at most
160,000 voxels, VoxelResBackBone8x (16/32/64/128 channels), the BEV
backbone of two levels to 512 channels and six class groups of separate
heads, with per-group rotated NMS. The BEV part is the InsMOS
:class:`~insmos_tpu_torch.config.BEVConfig`, so ``nn/bev_backbone.py``
serves both models unchanged.

Every capacity is a fixed array size; what a capacity drops is counted in
the step's ``overflow`` gates, never silent.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from .config import BEVConfig

CLASS_NAMES = ("car", "truck", "construction_vehicle", "bus", "trailer",
               "barrier", "motorcycle", "bicycle", "pedestrian",
               "traffic_cone")


@dataclass(frozen=True)
class CPDataConfig:
    point_cloud_range: tuple[float, ...] = (-54.0, -54.0, -5.0, 54.0, 54.0,
                                            3.0)
    voxel_size: tuple[float, float, float] = (0.075, 0.075, 0.2)

    @property
    def grid_size(self) -> tuple[int, int, int]:
        """(X, Y, Z) voxel grid dims."""
        r, v = self.point_cloud_range, self.voxel_size
        return tuple(int(round((r[i + 3] - r[i]) / v[i])) for i in range(3))

    @property
    def sparse_shape(self) -> tuple[int, int, int]:
        """The backbone's input dims: one z cell more than the grid
        (spconv's ``grid_size[::-1] + [1, 0, 0]``)."""
        gx, gy, gz = self.grid_size
        return (gx, gy, gz + 1)


@dataclass(frozen=True)
class SweepConfig:
    """The sweep window: ``n_sweeps`` sweeps, the newest first in the
    merged cloud, each point's lag ``sweep_dt`` x its sweep's age; points
    of older sweeps with |x| and |y| under ``ego_radius`` in their own
    sensor frame are removed (OpenPCDet ``remove_ego_points``)."""

    n_sweeps: int = 10
    sweep_dt: float = 0.05
    ego_radius: float = 1.0


@dataclass(frozen=True)
class BackboneConfig:
    """MeanVFE and VoxelResBackBone8x."""

    channels: tuple[int, ...] = (16, 32, 64, 128)
    max_points_per_voxel: int = 10
    max_voxels: int = 160_000
    # site capacities of the strided outputs at strides 2, 4, 8 and of
    # conv_out: 1.16, 1.59, 1.91 and 1.28 times the most sites the nus32
    # drive gave on 24 full-size windows (169,943, 71,917, 21,401, 19,230;
    # the most voxels 140,068); none dropped in ~7,000 window steps since
    site_capacities: tuple[int, ...] = (196_608, 114_688, 40_960, 24_576)


@dataclass(frozen=True)
class CPHeadConfig:
    """The shared conv and six class groups of separate heads (each head
    two 3x3 convs)."""

    shared_channels: int = 64
    head_channels: int = 64
    groups: tuple = (("car",), ("truck", "construction_vehicle"),
                     ("bus", "trailer"), ("barrier",),
                     ("motorcycle", "bicycle"),
                     ("pedestrian", "traffic_cone"))
    heads: tuple = (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2),
                    ("vel", 2))
    out_size_factor: int = 8
    bn_eps: float = 1e-5


@dataclass(frozen=True)
class CPPostConfig:
    """Decode and per-group NMS."""

    max_obj_per_group: int = 500
    score_thresh: float = 0.1
    center_limit_range: tuple[float, ...] = (-61.2, -61.2, -10.0, 61.2, 61.2,
                                             10.0)
    nms_thresh: float = 0.2
    nms_pre_maxsize: int = 1000
    nms_post_maxsize: int = 83


def _bev() -> BEVConfig:
    return BEVConfig(num_bev_features=256, layer_nums=(5, 5),
                     layer_strides=(1, 2), num_filters=(128, 256),
                     upsample_strides=(1, 2),
                     num_upsample_filters=(256, 256))


@dataclass(frozen=True)
class CPModelConfig:
    point_features: int = 5  # x, y, z, intensity, lag
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    bev: BEVConfig = field(default_factory=_bev)
    head: CPHeadConfig = field(default_factory=CPHeadConfig)
    post: CPPostConfig = field(default_factory=CPPostConfig)


@dataclass(frozen=True)
class CPRuntimeConfig:
    max_points_per_scan: int = 34_688
    # "bfloat16": bf16 matmul operands with float32 accumulation
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class CenterPointConfig:
    experiment_id: str = "CenterPoint-voxel0075-nuScenes"
    data: CPDataConfig = field(default_factory=CPDataConfig)
    sweeps: SweepConfig = field(default_factory=SweepConfig)
    model: CPModelConfig = field(default_factory=CPModelConfig)
    runtime: CPRuntimeConfig = field(default_factory=CPRuntimeConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CenterPointConfig":
        """Inverse of :meth:`to_dict` (lists become tuples, nested ones
        too); fields that ``d`` lacks keep their defaults."""
        return _build(cls, d)

    @property
    def class_labels(self) -> tuple[tuple[int, ...], ...]:
        """Each group's classes as nuScenes label ids (1-10, in
        ``CLASS_NAMES`` order)."""
        return tuple(tuple(CLASS_NAMES.index(c) + 1 for c in g)
                     for g in self.model.head.groups)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


def _build(tp, val):
    defaults = tp()
    kw = {}
    for f in dataclasses.fields(tp):
        if f.name not in val:
            continue
        cur, v = getattr(defaults, f.name), val[f.name]
        kw[f.name] = (_build(type(cur), v) if dataclasses.is_dataclass(cur)
                      else _tuples(v))
    return dataclasses.replace(defaults, **kw)
