"""Configuration tree for the intentbev framework.

Single source of truth for BEV grid geometry, anchor shapes, the intention
taxonomy, model hyper-parameters, loss weights, and train/eval knobs.

This replaces the reference's three-tier config system (module globals in
``constants.py``, script-top globals in ``train_*.py``/``eval_*.py``, and
try-import feature flags; see reference ``constants.py:18-84``,
``train_vit.py:16-56``) with one frozen-dataclass tree that is hashable, can
be closed over by jitted functions as static data, and is serialised into
checkpoints so that evaluation can rebuild the exact model + anchor grid
(the reference's self-describing-checkpoint contract, ``eval_cnn.py:63-79``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

# ---------------------------------------------------------------------------
# Intention taxonomy (reference constants.py:50-77)
# ---------------------------------------------------------------------------

INTENTIONS_MAP: Mapping[str, int] = {
    "KEEP_LANE": 0,
    "TURN_LEFT": 1,
    "TURN_RIGHT": 2,
    "LEFT_CHANGE_LANE": 3,
    "RIGHT_CHANGE_LANE": 4,
    "STOPPING_STOPPED": 5,
    "PARKED": 6,
    "OTHER": 7,
}
INTENTIONS_MAP_REV: Mapping[int, str] = {v: k for k, v in INTENTIONS_MAP.items()}

NUM_INTENTION_CLASSES = 8

DOMINANT_CLASSES_FOR_DOWNSAMPLING = (
    INTENTIONS_MAP["KEEP_LANE"],
    INTENTIONS_MAP["OTHER"],
    INTENTIONS_MAP["PARKED"],
)
INTENTION_DOWNSAMPLE_RATIO = 0.85

# Vehicle categories participating in GT (reference constants.py:80-84).
VEHICLE_CATEGORIES = frozenset(
    {
        "REGULAR_VEHICLE", "LARGE_VEHICLE", "BUS", "BOX_TRUCK", "TRUCK",
        "MOTORCYCLE", "SCHOOL_BUS", "ARTICULATED_BUS", "VEHICULAR_TRAILER",
        "TRUCK_CAB", "BICYCLE", "BICYCLIST", "MOTORCYCLIST",
    }
)

# Default anchor (w, l, yaw) shapes, metric (reference constants.py:18-24).
ANCHOR_CONFIGS_PAPER: tuple[tuple[float, float, float], ...] = (
    (2.0, 4.5, 0.0),
    (2.0, 4.5, math.pi / 2),
    (2.5, 2.5, 0.0),
    (1.5, 9.0, 0.0),
    (4.0, 2.0, 0.0),
)


# ---------------------------------------------------------------------------
# Grid geometry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GridConfig:
    """BEV grid geometry (reference constants.py:28-47).

    The grid is 400 rows x 720 cols at 0.2 m/px. Ego-frame +x (forward) maps
    to decreasing row index, ego +y (left) maps to increasing column index.
    Ego sits at pixel (row=300, col=360): x range [-20 m, +60 m], y range
    [-72 m, +72 m].
    """

    height_px: int = 400
    width_px: int = 720
    voxel_size_m: float = 0.2
    z_min: float = -2.0
    z_max: float = 3.8
    lidar_height_channels: int = 29
    lidar_sweeps: int = 10
    map_channels: int = 9

    @property
    def pixel_offset_x(self) -> float:
        """Column of ego origin (reference constants.py:38)."""
        return self.width_px / 2.0

    @property
    def pixel_offset_y(self) -> float:
        """Row of ego origin (reference constants.py:39)."""
        return self.height_px * 3.0 / 4.0

    @property
    def lidar_total_channels(self) -> int:
        return self.lidar_height_channels * self.lidar_sweeps

    @property
    def x_range_m(self) -> float:
        return self.height_px * self.voxel_size_m

    @property
    def y_range_m(self) -> float:
        return self.width_px * self.voxel_size_m

    @property
    def bev_x_min(self) -> float:
        return -self.x_range_m / 4.0

    @property
    def bev_x_max(self) -> float:
        return self.x_range_m * 3.0 / 4.0

    @property
    def bev_y_min(self) -> float:
        return -self.y_range_m / 2.0

    @property
    def bev_y_max(self) -> float:
        return self.y_range_m / 2.0


@dataclass(frozen=True)
class AnchorGridConfig:
    """Anchor grid over the feature map (reference utils.py:519-562)."""

    anchor_shapes: tuple[tuple[float, float, float], ...] = ANCHOR_CONFIGS_PAPER
    stride: int = 8

    @property
    def num_anchors_per_loc(self) -> int:
        return len(self.anchor_shapes)

    def num_total_anchors(self, grid: GridConfig) -> int:
        fh = grid.height_px // self.stride
        fw = grid.width_px // self.stride
        return fh * fw * self.num_anchors_per_loc


# ---------------------------------------------------------------------------
# Intention heuristic knobs (reference constants.py:50-61)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HeuristicConfig:
    horizon_secs: float = 3.0
    horizon_steps: int = 30
    min_future_points: int = 5
    min_speed_stopped: float = 0.5
    min_speed_moving: float = 1.0
    heading_change_thresh_turn: float = math.radians(20.0)
    heading_change_thresh_lane_keep: float = math.radians(5.0)
    parked_max_disp_m: float = 0.5
    keep_lane_max_lat_dist_fallback: float = 0.5
    map_search_radius: float = 5.0


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HeadConfig:
    """Detection + intention heads (reference heads.py:6-43)."""

    num_anchors: int = 5
    num_box_params: int = 6
    num_intention_classes: int = NUM_INTENTION_CLASSES


@dataclass(frozen=True)
class CNNBackboneConfig:
    """Two-stream residual CNN backbone (reference model_cnn.py:35-123)."""

    lidar_input_channels: int = 290
    map_input_channels: int = 9
    lidar_planes: tuple[int, int, int] = (160, 192, 224)
    map_planes: tuple[int, int, int] = (32, 64, 96)
    stage_strides: tuple[int, int, int] = (2, 1, 2)
    fusion_planes: int = 512
    fusion_layers: int = 2
    fusion_stride: int = 2
    num_blocks_per_stage: int = 2
    stream_kernel_size: int = 5
    fusion_kernel_size: int = 3

    @property
    def total_stride(self) -> int:
        s = 1
        for st in self.stage_strides:
            s *= st
        return s * self.fusion_stride


@dataclass(frozen=True)
class ViTBackboneConfig:
    """Two-stream ViT backbone (reference model_vit.py:38-142).

    Mirrors timm ``vit_small_patch8_224``: patch 8, embed 384, depth 12,
    6 heads, MLP ratio 4, qkv bias, learned pos-embed + CLS token
    (reference model_vit.py:62-74).
    """

    lidar_input_channels: int = 290
    map_input_channels: int = 9
    img_size: tuple[int, int] = (400, 720)
    patch_size: int = 8
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    adapter_out_channels: int = 192
    fusion_planes: int = 512
    fusion_layers: int = 2
    fusion_kernel_size: int = 3
    fusion_stride: int = 1
    # W8A8 serving path: the MLP's fc1/fc2 through int8 matmuls with
    # dynamic activation quantisation (ops.int8); attention stays in the
    # compute dtype. Inference only — the model is trained bf16/f32 and
    # quantizes on the fly.
    serving_int8: bool = False

    @property
    def grid_size(self) -> tuple[int, int]:
        return (self.img_size[0] // self.patch_size, self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    @property
    def total_stride(self) -> int:
        return self.patch_size * self.fusion_stride


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LossConfig:
    """Combined detection + intention loss (reference loss.py:10-55)."""

    iou_threshold: float = 0.6
    neg_iou_threshold: float = 0.45
    box_weight: float = 1.0
    cls_weight: float = 1.0
    intent_weight: float = 0.5
    use_rotated_iou: bool = False
    focal_loss_alpha: float = 0.25
    focal_loss_gamma: float = 2.0
    smooth_l1_beta: float = 1.0 / 9.0
    apply_intention_downsampling: bool = True
    dominant_intentions: tuple[int, ...] = DOMINANT_CLASSES_FOR_DOWNSAMPLING
    intention_downsample_ratio: float = INTENTION_DOWNSAMPLE_RATIO
    max_gt_boxes: int = 128  # fixed GT padding for vectorised assignment


# ---------------------------------------------------------------------------
# Train / eval / data
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AugmentConfig:
    """BEV augmentations (reference utils.py:394-517)."""

    flip_prob: float = 0.5
    rotate_prob: float = 0.5
    rotate_range_deg: tuple[float, float] = (-15.0, 15.0)
    scale_prob: float = 0.5
    scale_range: tuple[float, float] = (0.95, 1.05)
    dropout_prob: float = 0.1
    dropout_patch_px: tuple[int, int] = (20, 50)
    dropout_num_patches: tuple[int, int] = (1, 5)


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    num_epochs: int = 10
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    plateau_factor: float = 0.1
    plateau_patience: int = 3
    seed: int = 0
    checkpoint_every_steps: int = 500
    log_every_steps: int = 20
    compute_dtype: str = "bfloat16"
    # remat (jax.checkpoint per ViT block) trades recomputation for
    # activation memory
    remat_vit_blocks: bool = False
    donate_train_state: bool = True
    # "points": ship packed points, device augments + scatter-max
    # voxelizes. "chunks": the loader applies the drawn augmentation to
    # the points on the HOST and ships deduplicated voxel placement chunks
    # (ops.voxel_embed) — the train step places them into the BEV with a
    # scatter-add over unique cells instead of the scatter-max.
    transport: str = "points"
    chunk_capacity: int = 768  # fixed chunk-array size (shape-stable jit)


@dataclass(frozen=True)
class EvalConfig:
    """Eval semantics (reference eval_cnn.py:22-29)."""

    confidence_threshold: float = 0.1
    nms_iou_threshold: float = 0.2
    batch_size: int = 8
    detection_iou_thresholds: tuple[float, ...] = (0.5, 0.6, 0.7, 0.8, 0.9)
    iou_threshold_for_intention_match: float = 0.5
    use_rotated_iou: bool = False
    max_pre_nms: int = 1024   # top-K candidates kept before NMS
    max_detections: int = 128  # fixed NMS output size


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for pjit sharding over ICI/DCN."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: all remaining devices
    model_parallel: int = 1


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level config bundle; serialised into checkpoints."""

    model_family: str = "vit"  # "vit" | "cnn"
    grid: GridConfig = field(default_factory=GridConfig)
    anchors: AnchorGridConfig = field(default_factory=AnchorGridConfig)
    heads: HeadConfig = field(default_factory=HeadConfig)
    cnn: CNNBackboneConfig = field(default_factory=CNNBackboneConfig)
    vit: ViTBackboneConfig = field(default_factory=ViTBackboneConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    heuristic: HeuristicConfig = field(default_factory=HeuristicConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


# ---------------------------------------------------------------------------
# (De)serialisation — checkpoints embed the config as a plain dict, mirroring
# the reference's self-describing `backbone_cfg` (train_vit.py:206-211).
# ---------------------------------------------------------------------------

def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        out = {"__dataclass__": type(cfg).__name__}
        for f in dataclasses.fields(cfg):
            out[f.name] = config_to_dict(getattr(cfg, f.name))
        return out
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(v) for v in cfg]
    return cfg


_CONFIG_CLASSES = {
    cls.__name__: cls
    for cls in (
        GridConfig, AnchorGridConfig, HeuristicConfig, HeadConfig,
        CNNBackboneConfig, ViTBackboneConfig, LossConfig, AugmentConfig,
        TrainConfig, EvalConfig, MeshConfig, ExperimentConfig,
    )
}


def _coerce(value: Any, annotation: Any) -> Any:
    # JSON round-trips tuples as lists; coerce back for hashability.
    if isinstance(value, list):
        return tuple(_coerce(v, None) for v in value)
    return value


def config_from_dict(d: Any) -> Any:
    if isinstance(d, dict) and "__dataclass__" in d:
        cls = _CONFIG_CLASSES[d["__dataclass__"]]
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                kwargs[f.name] = config_from_dict(d[f.name])
        return cls(**kwargs)
    if isinstance(d, list):
        return tuple(config_from_dict(v) for v in d)
    return d


def default_vit_config() -> ExperimentConfig:
    return ExperimentConfig(model_family="vit")


def default_cnn_config() -> ExperimentConfig:
    return ExperimentConfig(model_family="cnn")


def tiny_test_config() -> ExperimentConfig:
    """Small-shape config for fast unit tests and multi-chip dry runs."""
    grid = GridConfig(height_px=64, width_px=96, lidar_height_channels=4, lidar_sweeps=2)
    vit = ViTBackboneConfig(
        lidar_input_channels=grid.lidar_total_channels,
        map_input_channels=grid.map_channels,
        img_size=(64, 96),
        patch_size=8,
        embed_dim=32,
        depth=2,
        num_heads=2,
        adapter_out_channels=16,
        fusion_planes=32,
        fusion_layers=1,
    )
    cnn = CNNBackboneConfig(
        lidar_input_channels=grid.lidar_total_channels,
        map_input_channels=grid.map_channels,
        lidar_planes=(16, 24, 32),
        map_planes=(8, 12, 16),
        fusion_planes=48,
        fusion_layers=1,
        num_blocks_per_stage=1,
    )
    return ExperimentConfig(
        model_family="vit",
        grid=grid,
        vit=vit,
        cnn=cnn,
        loss=LossConfig(max_gt_boxes=8),
        eval=EvalConfig(max_pre_nms=64, max_detections=16),
        train=TrainConfig(batch_size=2, compute_dtype="float32", remat_vit_blocks=False),
    )
