"""IntentNetCNN: two-stream residual CNN backbone + detection/intention heads.

Reference: model_cnn.py:35-150 (IntentNet paper Fig 2c downsampling).
LiDAR stream 290 -> 160(s2) -> 192(s1) -> 224(s2); map stream
9 -> 32(s2) -> 64(s1) -> 96(s2); concat at 4x downsample; fusion
2 x BasicBlock(k=3) -> 512 at stride 2 => total stride 8.

Forward contract: (lidar_bev, map_bev) -> (cls_logits [B,N,1],
box_deltas [B,N,6], intent_logits [B,N,8]) with N = (H/8)*(W/8)*A.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from ..configs import CNNBackboneConfig, HeadConfig
from .blocks import ensure_nhwc, init_residual_stage, residual_stage
from .heads import apply_heads, init_heads
from .layers import Model, child_key


class IntentNetCNN(Model):
    """Reference model_cnn.py:125-150."""

    def __init__(self, cfg: CNNBackboneConfig, head_cfg: HeadConfig,
                 dtype: Any = jnp.float32):
        self.cfg = cfg
        self.head_cfg = head_cfg
        self.dtype = dtype

    def _streams(self):
        cfg = self.cfg
        return (("lidar", cfg.lidar_input_channels, cfg.lidar_planes),
                ("map", cfg.map_input_channels, cfg.map_planes))

    def init_variables(self, key) -> tuple[dict, dict]:
        cfg = self.cfg
        kb = child_key(key, "backbone")
        bp, bs = {}, {}
        for prefix, c, planes in self._streams():
            for i, (p, s) in enumerate(zip(planes, cfg.stage_strides)):
                name = f"{prefix}_stage{i + 1}"
                bp[name], bs[name] = init_residual_stage(
                    child_key(kb, name), c, p, cfg.num_blocks_per_stage, s,
                    cfg.stream_kernel_size)
                c = p
        bp["fusion"], bs["fusion"] = init_residual_stage(
            child_key(kb, "fusion"), cfg.lidar_planes[-1] + cfg.map_planes[-1],
            cfg.fusion_planes, cfg.fusion_layers, cfg.fusion_stride,
            cfg.fusion_kernel_size)
        params = {"backbone": bp,
                  **init_heads(key, cfg.fusion_planes, self.head_cfg)}
        return params, {"backbone": bs}

    def forward(self, params, stats, lidar_bev, map_bev, *, train: bool,
                dropout_key=None):
        del dropout_key  # no stochastic layers
        cfg, dt = self.cfg, self.dtype
        bp, bs = params["backbone"], stats["backbone"]
        new = {}
        inputs = {"lidar": lidar_bev, "map": map_bev}
        feats = []
        for prefix, c, planes in self._streams():
            x = ensure_nhwc(inputs[prefix], c).astype(dt)
            for i, s in enumerate(cfg.stage_strides):
                name = f"{prefix}_stage{i + 1}"
                x, new[name] = residual_stage(
                    bp[name], bs[name], x, stride=s, dtype=dt, train=train)
            feats.append(x)
        fused, new["fusion"] = residual_stage(
            bp["fusion"], bs["fusion"], jnp.concatenate(feats, axis=-1),
            stride=cfg.fusion_stride, dtype=dt, train=train)
        return apply_heads(params, fused, self.head_cfg, dt), {"backbone": new}
