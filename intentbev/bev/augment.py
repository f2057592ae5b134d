"""BEV augmentations, GT-consistent. Two implementations:

1. **Point-space path (default in the train step)**: geometric parameters
   (flip / rotate / scale) are drawn per sample on the HOST
   (:func:`draw_aug_params`); the raw LiDAR points are transformed on
   device BEFORE voxelization (:func:`augment_points_gt` — a 2x2 matmul on
   [S, P, 2]) and the map is RASTERIZED at the augmented
   pose on the host (rasterize.py ``aug_linear``) — the polygon draw is
   per-pose anyway, so composing the augmentation is free. Patch dropout
   stays on device (:func:`patch_dropout`). This replaces 299-channel
   bilinear image gathers with a 2x2 point transform, and is geometrically EXACT where the reference's post-voxelization
   image warp (utils.py:394-517) smears cells bilinearly and zero-fills
   content rotating in from outside the grid.

2. **Image-space path** (:func:`augment_bev`): the faithful equivalent of
   the reference's cv2 warps for callers that only have a voxelized BEV.

Deliberate fixes vs the reference (SURVEY.md §2 'decide deliberately'):
- rotation and scaling transform about the EGO origin, the same point
  about which the GT boxes are transformed — the reference rotates the
  image about the image centre while rotating GT about the ego origin
  (utils.py:425-447), leaving image and boxes inconsistent by up to ~20 px.
Everything else (probabilities, ranges, label swaps, dropout geometry)
matches the reference exactly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..configs import AugmentConfig, GridConfig
from ..configs import INTENTIONS_MAP as IM


class AugmentedSample(NamedTuple):
    lidar_bev: jnp.ndarray   # f32[H, W, CL]
    map_bev: jnp.ndarray     # f32[H, W, CM]
    gt_boxes: jnp.ndarray    # f32[G, 5]
    gt_intentions: jnp.ndarray  # i32[G]


# LEFT/RIGHT swap table for horizontal flip (utils.py:406-414).
# Kept as numpy at module scope: a jnp array here would initialise the JAX
# backend at import time, before CLIs can select a platform.
import numpy as _np

_FLIP_INTENT_TABLE_NP = _np.array(
    [
        IM["KEEP_LANE"],
        IM["TURN_RIGHT"],        # TURN_LEFT ->
        IM["TURN_LEFT"],         # TURN_RIGHT ->
        IM["RIGHT_CHANGE_LANE"],  # LEFT_CHANGE_LANE ->
        IM["LEFT_CHANGE_LANE"],   # RIGHT_CHANGE_LANE ->
        IM["STOPPING_STOPPED"],
        IM["PARKED"],
        IM["OTHER"],
    ],
    dtype=_np.int32,
)


def _bilinear_sample(img: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample img [H, W, C] at float (rows, cols) [H, W]; zero pad."""
    h, w, _ = img.shape
    r0 = jnp.floor(rows)
    c0 = jnp.floor(cols)
    dr = (rows - r0)[..., None]
    dc = (cols - c0)[..., None]
    r0i = r0.astype(jnp.int32)
    c0i = c0.astype(jnp.int32)

    def gather(ri, ci):
        ok = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
        ri_s = jnp.clip(ri, 0, h - 1)
        ci_s = jnp.clip(ci, 0, w - 1)
        vals = img[ri_s, ci_s]  # [H, W, C]
        return jnp.where(ok[..., None], vals, 0.0)

    v00 = gather(r0i, c0i)
    v01 = gather(r0i, c0i + 1)
    v10 = gather(r0i + 1, c0i)
    v11 = gather(r0i + 1, c0i + 1)
    return (
        v00 * (1 - dr) * (1 - dc)
        + v01 * (1 - dr) * dc
        + v10 * dr * (1 - dc)
        + v11 * dr * dc
    )


# ---------------------------------------------------------------------------
# point-space path: host-drawn params, device point/GT transform
# ---------------------------------------------------------------------------

def draw_aug_params(cfg: AugmentConfig, rng: "_np.random.Generator", n: int) -> "_np.ndarray":
    """Host-side per-sample draw of (flip_sign, theta_rad, scale), f32[n, 3].

    Same distributions as the reference (utils.py:394-480): flip with
    flip_prob; rotation angle uniform over rotate_range_deg with
    rotate_prob; scale uniform over scale_range with scale_prob. Identity
    rows are (1, 0, 1).
    """
    flip = _np.where(rng.random(n) < cfg.flip_prob, -1.0, 1.0)
    theta = _np.deg2rad(
        rng.uniform(cfg.rotate_range_deg[0], cfg.rotate_range_deg[1], n)
    ) * (rng.random(n) < cfg.rotate_prob)
    scale = _np.where(
        rng.random(n) < cfg.scale_prob,
        rng.uniform(cfg.scale_range[0], cfg.scale_range[1], n),
        1.0,
    )
    return _np.stack([flip, theta, scale], axis=1).astype(_np.float32)


IDENTITY_AUG = _np.array([1.0, 0.0, 1.0], dtype=_np.float32)


def aug_linear_matrix(params_row) -> "_np.ndarray":
    """2x2 content transform A = scale * R(theta) * diag(1, flip_sign) in
    ego-metric (x fwd, y left) coordinates; host rasterizers compose it
    into the world->ego transform so the map is DRAWN at the augmented
    pose instead of image-warped after the fact."""
    fs, theta, s = (float(v) for v in params_row)
    c, si = _np.cos(theta), _np.sin(theta)
    rot = _np.array([[c, -si], [si, c]], dtype=_np.float64)
    return s * rot @ _np.array([[1.0, 0.0], [0.0, fs]], dtype=_np.float64)


def augment_points_np(points: "_np.ndarray",
                      aug_params: "_np.ndarray") -> "_np.ndarray":
    """HOST (numpy) mirror of the point half of :func:`augment_points_gt`:
    p' = s * R(theta) * diag(1, flip_sign) * p on f32[..., 4] points.

    Used by the chunk train transport (data/pipeline.py): the aug params
    are host-drawn anyway, so the points transform before the host chunk
    build instead of on device — the device's scatter-max voxelizer then
    disappears from the train step entirely (ops.voxel_embed fills the BEV
    from the pre-transformed chunks). Same f32 op order as the device
    version; parity is tested cell-exactly through the voxelizer
    (tests/test_train_chunks.py)."""
    fs = _np.float32(aug_params[0])
    theta = _np.float32(aug_params[1])
    s = _np.float32(aug_params[2])
    x = points[..., 0]
    y = points[..., 1] * fs
    ca, sa = _np.cos(theta, dtype=_np.float32), _np.sin(theta, dtype=_np.float32)
    out = points.copy()
    out[..., 0] = s * (x * ca - y * sa)
    out[..., 1] = s * (x * sa + y * ca)
    return out


def augment_gt(
    gt_boxes: jnp.ndarray,    # f32[G, 5]
    gt_intentions: jnp.ndarray,
    gt_valid: jnp.ndarray,
    aug_params: jnp.ndarray,  # f32[3] = (flip_sign, theta, scale)
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """GT half of :func:`augment_points_gt` (flip/rotate/scale boxes +
    L/R intent swap) — the chunk train transport pre-transforms the points
    on the host and only the GT transform remains on device."""
    fs, theta, s = aug_params[0], aug_params[1], aug_params[2]
    do_flip = fs < 0
    ca, sa = jnp.cos(theta), jnp.sin(theta)
    boxes = gt_boxes
    flipped = boxes.at[:, 1].multiply(-1.0).at[:, 4].multiply(-1.0)
    boxes = jnp.where(do_flip, flipped, boxes)
    flip_table = jnp.asarray(_FLIP_INTENT_TABLE_NP)
    intents = jnp.where(
        do_flip, flip_table[jnp.maximum(gt_intentions, 0)], gt_intentions
    )
    cx, cy = boxes[:, 0], boxes[:, 1]
    boxes = boxes.at[:, 0].set(cx * ca - cy * sa).at[:, 1].set(cx * sa + cy * ca)
    boxes = boxes.at[:, 4].add(theta)
    boxes = boxes.at[:, :4].multiply(s)
    boxes = boxes.at[:, 4].set(jnp.arctan2(jnp.sin(boxes[:, 4]), jnp.cos(boxes[:, 4])))

    boxes = jnp.where(gt_valid[:, None], boxes, gt_boxes)
    intents = jnp.where(gt_valid, intents, gt_intentions)
    return boxes, intents.astype(jnp.int32)


def augment_points_gt(
    points: jnp.ndarray,      # f32[S, P, 4]
    gt_boxes: jnp.ndarray,    # f32[G, 5]
    gt_intentions: jnp.ndarray,
    gt_valid: jnp.ndarray,
    aug_params: jnp.ndarray,  # f32[3] = (flip_sign, theta, scale)
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Apply (flip -> rotate -> scale) to raw points + GT, pre-voxelization.

    Exactly the transform :func:`aug_linear_matrix` applies to the map:
    p' = s * R(theta) * diag(1, flip_sign) * p. Points leaving the grid are
    dropped by the voxelizer's bounds mask; points rotating IN are real
    content (the image warp zero-fills there). GT math matches
    :func:`augment_bev` (utils.py:406-414, 441-448, 478-479).
    """
    fs, theta, s = aug_params[0], aug_params[1], aug_params[2]
    x, y = points[..., 0], points[..., 1] * fs
    ca, sa = jnp.cos(theta), jnp.sin(theta)
    x, y = s * (x * ca - y * sa), s * (x * sa + y * ca)
    points = jnp.stack([x, y, points[..., 2], points[..., 3]], axis=-1)
    boxes, intents = augment_gt(gt_boxes, gt_intentions, gt_valid, aug_params)
    return points, boxes, intents


def dropout_keep_mask(rng: jax.Array, cfg: AugmentConfig, h: int, w: int) -> jnp.ndarray:
    """bool[h, w] patch-dropout keep mask (utils.py:482-498)."""
    kd = jax.random.split(rng, 2 + 5 * 4)
    do_drop = jax.random.bernoulli(kd[0], float(cfg.dropout_prob))
    max_patches = cfg.dropout_num_patches[1]
    num_patches = jax.random.randint(
        kd[1], (), cfg.dropout_num_patches[0], max_patches + 1
    )
    keep = jnp.ones((h, w), dtype=bool)
    rows_i = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols_i = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    lo, hi = cfg.dropout_patch_px
    for j in range(max_patches):
        kj = kd[2 + j * 4 : 2 + (j + 1) * 4]
        ph = jax.random.randint(kj[0], (), lo, hi + 1)
        pw = jax.random.randint(kj[1], (), lo, hi + 1)
        r0 = jax.random.randint(kj[2], (), 0, jnp.maximum(1, h - ph + 1))
        c0 = jax.random.randint(kj[3], (), 0, jnp.maximum(1, w - pw + 1))
        in_patch = (
            (rows_i >= r0) & (rows_i < r0 + ph) & (cols_i >= c0) & (cols_i < c0 + pw)
        )
        active = do_drop & (j < num_patches)
        keep = keep & ~(in_patch & active)
    return keep


@functools.partial(jax.jit, static_argnames=("cfg", "grid"))
def augment_bev(
    lidar_bev: jnp.ndarray,
    map_bev: jnp.ndarray,
    gt_boxes: jnp.ndarray,
    gt_intentions: jnp.ndarray,
    gt_valid: jnp.ndarray,
    rng: jax.Array,
    cfg: AugmentConfig,
    grid: GridConfig,
) -> AugmentedSample:
    """Single-sample augmentation; vmap over batch via batched_augment_bev."""
    k_flip, k_rot_p, k_rot_a, k_scl_p, k_scl_s, k_drop = jax.random.split(rng, 6)

    h, w = grid.height_px, grid.width_px
    oy, ox = grid.pixel_offset_y, grid.pixel_offset_x

    boxes = gt_boxes
    intents = gt_intentions

    # ---- flip (utils.py:394-415): mirror W axis, negate cy & yaw, swap L/R
    do_flip = jax.random.bernoulli(k_flip, float(cfg.flip_prob))
    lidar_bev = jnp.where(do_flip, jnp.flip(lidar_bev, axis=1), lidar_bev)
    map_bev = jnp.where(do_flip, jnp.flip(map_bev, axis=1), map_bev)
    flipped_boxes = boxes.at[:, 1].multiply(-1.0).at[:, 4].multiply(-1.0)
    boxes = jnp.where(do_flip, flipped_boxes, boxes)
    flip_table = jnp.asarray(_FLIP_INTENT_TABLE_NP)
    intents = jnp.where(do_flip, flip_table[jnp.maximum(intents, 0)], intents)

    # ---- rotate + scale as one composed inverse affine about ego origin
    do_rot = jax.random.bernoulli(k_rot_p, float(cfg.rotate_prob))
    angle_deg = jax.random.uniform(
        k_rot_a, (), minval=cfg.rotate_range_deg[0], maxval=cfg.rotate_range_deg[1]
    )
    theta = jnp.where(do_rot, jnp.deg2rad(angle_deg), 0.0)

    do_scale = jax.random.bernoulli(k_scl_p, float(cfg.scale_prob))
    s = jax.random.uniform(
        k_scl_s, (), minval=cfg.scale_range[0], maxval=cfg.scale_range[1]
    )
    s = jnp.where(do_scale, s, 1.0)

    # forward map (metric, about ego): p' = s * R(theta) p
    # inverse map for output pixel -> source pixel: p = R(-theta) p' / s
    rows = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    x_out = (oy - rows) * grid.voxel_size_m
    y_out = (cols - ox) * grid.voxel_size_m
    ct, st = jnp.cos(-theta), jnp.sin(-theta)
    x_src = (ct * x_out - st * y_out) / s
    y_src = (st * x_out + ct * y_out) / s
    src_rows = oy - x_src / grid.voxel_size_m
    src_cols = ox + y_src / grid.voxel_size_m

    identity = (~do_rot) & (~do_scale)

    # Warp lidar and map as ONE concatenated tensor: a separate 9-channel
    # map gather pads rows to the 128-lane tile (14x wasted bandwidth) and
    # profiled at ~220 ms/step across the 4 bilinear corners; widening the
    # 290-channel gather by 9 extra channels is nearly free.
    cl = lidar_bev.shape[-1]
    map_dtype = map_bev.dtype
    combined = jnp.concatenate([lidar_bev, map_bev.astype(lidar_bev.dtype)], axis=-1)
    combined = jnp.where(
        identity, combined, _bilinear_sample(combined, src_rows, src_cols)
    )
    lidar_bev = combined[..., :cl]
    map_bev = combined[..., cl:].astype(map_dtype)

    # GT: rotate centres + heading (utils.py:441-448), then scale cx,cy,w,l
    # (utils.py:478-479)
    cx, cy = boxes[:, 0], boxes[:, 1]
    ca, sa = jnp.cos(theta), jnp.sin(theta)
    boxes = boxes.at[:, 0].set(cx * ca - cy * sa).at[:, 1].set(cx * sa + cy * ca)
    boxes = boxes.at[:, 4].add(theta)
    boxes = boxes.at[:, :4].multiply(s)
    boxes = boxes.at[:, 4].set(jnp.arctan2(jnp.sin(boxes[:, 4]), jnp.cos(boxes[:, 4])))

    # ---- patch dropout (utils.py:482-498)
    keep = dropout_keep_mask(k_drop, cfg, h, w)
    keep_f = keep[..., None].astype(lidar_bev.dtype)
    lidar_bev = lidar_bev * keep_f
    map_bev = map_bev * keep_f

    boxes = jnp.where(gt_valid[:, None], boxes, gt_boxes)
    intents = jnp.where(gt_valid, intents, gt_intentions)
    return AugmentedSample(lidar_bev, map_bev, boxes, intents.astype(jnp.int32))


def batched_augment_bev(
    lidar_bev: jnp.ndarray,
    map_bev: jnp.ndarray,
    gt_boxes: jnp.ndarray,
    gt_intentions: jnp.ndarray,
    gt_valid: jnp.ndarray,
    rng: jax.Array,
    cfg: AugmentConfig,
    grid: GridConfig,
) -> AugmentedSample:
    """Per-sample independent augmentation over a batch."""
    keys = jax.random.split(rng, lidar_bev.shape[0])
    return jax.vmap(
        lambda l, m, b, i, v, k: augment_bev(l, m, b, i, v, k, cfg, grid)
    )(lidar_bev, map_bev, gt_boxes, gt_intentions, gt_valid, keys)
