"""Typed configuration (the port's own copy of ``insmos_tpu/config.py``).

The dataclasses, fields and defaults are those of the JAX package, so a
config built on either side holds the same values
(``tests/test_torch_config.py`` checks ``dataclasses.asdict`` of both).
Every capacity is a fixed array size: overflow is counted and gated, never
silent. The YAML and dict loaders are not carried over yet; they come with
the ``predict_mos`` entry point.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class DataConfig:
    # crop applied before the 3D UNet voxelizer (reference DATA.POINT_CLOUD_RANGE)
    point_cloud_range: tuple[float, ...] = (-60.0, -50.0, -3.0, 60.0, 50.0, 1.0)
    voxel_size: tuple[float, float, float] = (0.1, 0.1, 0.1)
    transform: bool = True  # pose-align the window to the current frame
    poses_file: str = "poses.txt"
    shuffle: bool = True
    num_workers: int = 4
    delta_t_data: float = 0.1
    split_train: tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6, 7, 9, 10)
    split_val: tuple[int, ...] = (8,)
    split_test: tuple[int, ...] = (8,)

    @property
    def grid_size(self) -> tuple[int, int, int]:
        """(X, Y, Z) voxel grid dims."""
        r = self.point_cloud_range
        v = self.voxel_size
        return (
            int(round((r[3] - r[0]) / v[0])),
            int(round((r[4] - r[1]) / v[1])),
            int(round((r[5] - r[2]) / v[2])),
        )


@dataclass(frozen=True)
class MotionNetConfig:
    """4D motion backbone: MinkUNet14 with PLANES=(8,16,32,64,64,32,16,8),
    INIT_DIM=8, D=4."""

    init_dim: int = 8
    planes: tuple[int, ...] = (8, 16, 32, 64, 64, 32, 16, 8)
    out_channels: int = 3
    # spatial crop of the 4D grid (the UNet range plus a receptive-field
    # margin; mins are multiples of 8 voxels so strided coords stay aligned)
    crop_range: tuple[float, ...] = (-64.0, -54.4, -7.2, 64.0, 54.4, 5.6)
    # 3D site-union capacities at strides 1/2/4/8
    site_capacities: tuple[int, ...] = (327_680, 131_072, 45_056, 14_336)
    # site capacity of the single-scan stem slab (incremental stem)
    stem_scan_capacity: int = 65_536
    # decoder outputs only on dilated halos of the current scan's sites
    decoder_capacities: tuple[int, ...] = (163_840, 73_728, 32_768)
    decoder_prune: bool = True

    @property
    def grid_size(self) -> tuple[int, int, int]:
        r = self.crop_range
        return (
            int(round((r[3] - r[0]) / 0.1)),
            int(round((r[4] - r[1]) / 0.1)),
            int(round((r[5] - r[2]) / 0.1)),
        )


@dataclass(frozen=True)
class BEVConfig:
    """BEV backbone."""

    num_bev_features: int = 256
    layer_nums: tuple[int, ...] = (5,)
    layer_strides: tuple[int, ...] = (1,)
    num_filters: tuple[int, ...] = (128,)
    upsample_strides: tuple[int, ...] = (2,)
    num_upsample_filters: tuple[int, ...] = (256,)


@dataclass(frozen=True)
class HeadConfig:
    """CenterHead and its target assigner."""

    num_class: int = 3
    max_objs: int = 100
    out_size_factor: int = 4
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    cls_weight: float = 1.0
    loc_weight: float = 2.0
    code_weights: tuple[float, ...] = (1.0,) * 8
    # static patch half-size of the gaussian splat (cap on radius)
    max_gaussian_radius: int = 31


@dataclass(frozen=True)
class PostProcessConfig:
    """NMS and recall."""

    score_thresh: float = 0.1
    nms_thresh: float = 0.01
    nms_pre_maxsize: int = 4096
    nms_post_maxsize: int = 500
    recall_thresh_list: tuple[float, ...] = (0.3, 0.5, 0.7)
    output_raw_score: bool = False
    multi_classes_nms: bool = False


@dataclass(frozen=True)
class ModelConfig:
    delta_t_prediction: float = 0.1
    n_past_steps: int = 10
    use_motion_loss: bool = True
    point_features: int = 4  # x, y, z, intensity
    # 3D UNet encoder channels at strides 1/2/4/8
    unet_channels: tuple[int, ...] = (16, 32, 64, 128)
    max_voxels: int = 100_000
    max_points_per_voxel: int = 5
    # capacities of the voxelizer and of the strided conv outputs at strides
    # 2/4/8 and the z-downsampled encoded tensor
    unet_capacities: tuple[int, ...] = (100_000, 81_920, 40_960, 18_432, 12_288)
    # post-voxelizer compaction of the UNet's working set
    unet_site_capacity: int = 65_536
    motionnet: MotionNetConfig = field(default_factory=MotionNetConfig)
    bev: BEVConfig = field(default_factory=BEVConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    post: PostProcessConfig = field(default_factory=PostProcessConfig)


@dataclass(frozen=True)
class TrainConfig:
    max_epoch: int = 160
    lr: float = 1e-4
    lr_epoch: int = 1
    lr_decay: float = 0.99
    weight_decay: float = 1e-4
    batch_size: int = 1
    acc_batches: int = 1
    augmentation: bool = True
    # BatchNorm running-stat momentum multiplier (1.0: the per-layer values)
    bn_momentum_scale: float = 1.0


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution parameters."""

    max_points_per_scan: int = 131_072  # KITTI HDL-64E ceiling
    # "bfloat16": bf16 matmul operands with float32 accumulation;
    # "float32" for exact comparisons
    compute_dtype: str = "bfloat16"
    conv_chunk: int = 65_536
    sparse_engine: str = "auto"
    data_axis: str = "data"
    # fixed-frame stem reuse across window shifts (not ported yet)
    incremental_stem: bool = False


@dataclass(frozen=True)
class Config:
    experiment_id: str = "InsMOS"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def tiny(self, *, points: int = 2048, max_voxels: int = 4096) -> "Config":
        """A small-capacity clone for tests."""
        mn = dataclasses.replace(
            self.model.motionnet,
            site_capacities=(4 * points, 2 * points, points, points),
            stem_scan_capacity=points,
        )
        model = dataclasses.replace(
            self.model,
            max_voxels=max_voxels,
            unet_capacities=(max_voxels,) + tuple(
                max(256, max_voxels // (2**i)) for i in range(1, 5)
            ),
            unet_site_capacity=max_voxels,
            motionnet=mn,
        )
        runtime = dataclasses.replace(self.runtime, max_points_per_scan=points)
        return dataclasses.replace(self, model=model, runtime=runtime)
