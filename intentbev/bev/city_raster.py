"""Per-log city-frame map raster cache + per-sample device-side warp.

The parity path (``rasterize_map_ego_centric``) redraws every lane polygon
per sample, as the reference does with cv2 (utils.py:108-182). This module
implements the fast path from SURVEY.md §7: rasterize each log's map ONCE
in the *city* frame (axis-aligned, same 0.2 m resolution, covering the map
bounds + margin), then produce each sample's ego-centric 9-channel BEV with
a single affine bilinear resample — which is a device-compilable gather and
can fuse into the train step, or run on host via numpy.

Numerics caveat (documented in SURVEY): warping a pre-drawn raster differs
from re-drawing rotated polygons along boundaries. Fill channels
(drivable/intersection/bus/crosswalk) agree at ~0.87-0.95 channel-IoU;
the 1-px POLYLINE channels (boundaries, markings) shift by +-1 px under
half-pixel resampling — a 0.5 threshold ZEROES them (a 1-px line bilinear-
resampled at a half-pixel offset peaks at 0.25-0.5), so polyline channels
use a 0.25 threshold (tested: non-empty and within 1 px of the direct
draw, at the cost of lines dilating to 1-2 px).

STATUS: the TRUSTED fast path is now exact per-pose visibility culling in
``rasterize_map_ego_centric`` (cull=True, bitwise-identical, default
everywhere). This module remains the *approximate* alternative whose value
is the DEVICE-side warp (``warp_city_to_ego_device``): ship one city
raster per log and generate every ego-centric map on the device — relevant
for streaming inference where host raster time is the bottleneck.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..configs import GridConfig
from ..geometry import quat_to_yaw
from .rasterize import MapElements, _MARK_CHANNELS, draw_polyline, fill_polygon


@dataclass
class CityRaster:
    raster: np.ndarray      # f32[Hc, Wc, 9], city-frame, axis-aligned
    origin_xy: tuple[float, float]  # world coords of pixel (row 0, col 0)
    voxel_size: float
    # city pixel convention: col = (x - origin_x)/voxel, row = (y - origin_y)/voxel


_POLYLINE_CHANNELS = (1, 2, 6, 7, 8)


def _channel_thresholds(fill_threshold: float) -> np.ndarray:
    """[9] per-channel binarization thresholds: fills at ``fill_threshold``
    (default 0.5), 1-px polyline channels at half of it — bilinear
    resampling of a 1-px line at a half-pixel offset peaks at 0.25-0.5, so
    a 0.5 threshold erases the line entirely (the round-2 defect that kept
    this path off by default)."""
    t = np.full(9, fill_threshold, dtype=np.float32)
    t[list(_POLYLINE_CHANNELS)] = fill_threshold / 2.0
    return t


def build_city_raster(
    elements: MapElements, grid: GridConfig, margin_m: float = 20.0
) -> CityRaster:
    """Rasterize a log's map once in the city frame."""
    pts = []
    for lane in elements.lanes:
        if len(lane.left_boundary):
            pts.append(lane.left_boundary)
        if len(lane.right_boundary):
            pts.append(lane.right_boundary)
    pts.extend(p for p in elements.crosswalks if len(p))
    if not pts:
        raster = np.zeros((8, 128, grid.map_channels), dtype=np.float32)
        return CityRaster(raster, (0.0, 0.0), grid.voxel_size_m)
    allp = np.concatenate(pts, axis=0)
    x0, y0 = allp.min(axis=0) - margin_m
    x1, y1 = allp.max(axis=0) + margin_m
    v = grid.voxel_size_m
    wc = int(np.ceil((x1 - x0) / v))
    hc = int(np.ceil((y1 - y0) / v))

    def to_px(world_xy: np.ndarray) -> np.ndarray:
        col = (world_xy[:, 0] - x0) / v
        row = (world_xy[:, 1] - y0) / v
        return np.round(np.stack([col, row], axis=1)).astype(np.int32)

    out = np.zeros((grid.map_channels, hc, wc), dtype=np.uint8)
    for lane in elements.lanes:
        lp = to_px(lane.left_boundary) if len(lane.left_boundary) else np.empty((0, 2), np.int32)
        rp = to_px(lane.right_boundary) if len(lane.right_boundary) else np.empty((0, 2), np.int32)
        if len(lp) > 1 and len(rp) > 1:
            poly = np.vstack([lp, rp[::-1]])
            if poly.shape[0] >= 3:
                fill_polygon(out[0], poly)
                if lane.is_intersection:
                    fill_polygon(out[4], poly)
                if lane.lane_type == "BUS":
                    fill_polygon(out[5], poly)
        if len(lp) > 1:
            draw_polyline(out[1], lp)
        if len(rp) > 1:
            draw_polyline(out[2], rp)
        if lane.left_mark_type in _MARK_CHANNELS and len(lp) > 1:
            draw_polyline(out[_MARK_CHANNELS[lane.left_mark_type]], lp)
        if lane.right_mark_type in _MARK_CHANNELS and len(rp) > 1:
            draw_polyline(out[_MARK_CHANNELS[lane.right_mark_type]], rp)
    for cw in elements.crosswalks:
        px = to_px(cw)
        if len(px) >= 3:
            fill_polygon(out[3], px)

    return CityRaster(
        np.transpose(out, (1, 2, 0)).astype(np.float32),
        (float(x0), float(y0)),
        v,
    )


def warp_city_to_ego(
    city: CityRaster, ego_pose, grid: GridConfig, binary_threshold: float = 0.5,
    aug_linear: np.ndarray | None = None,
) -> np.ndarray:
    """Ego-centric f32[H, W, 9] raster via one bilinear resample (host).

    ``aug_linear``: optional 2x2 ego-metric content transform (see
    bev.augment.aug_linear_matrix); the inverse is applied to the sample
    coordinates, matching rasterize_map_ego_centric's composed transform.
    """
    tx = float(ego_pose["tx_m"])
    ty = float(ego_pose["ty_m"])
    yaw = float(quat_to_yaw(ego_pose["qx"], ego_pose["qy"], ego_pose["qz"], ego_pose["qw"]))
    h, w = grid.height_px, grid.width_px
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    # output pixel -> ego metric (note: world_to_bev_pixel uses ROUNDED px,
    # so sample at integer pixel centres)
    x_ego = (grid.pixel_offset_y - rows) * grid.voxel_size_m
    y_ego = (cols - grid.pixel_offset_x) * grid.voxel_size_m
    if aug_linear is not None:
        inv = np.linalg.inv(np.asarray(aug_linear, dtype=np.float64))
        x_ego, y_ego = (
            inv[0, 0] * x_ego + inv[0, 1] * y_ego,
            inv[1, 0] * x_ego + inv[1, 1] * y_ego,
        )
    # ego -> world
    c, s = np.cos(yaw), np.sin(yaw)
    x_w = c * x_ego - s * y_ego + tx
    y_w = s * x_ego + c * y_ego + ty
    # world -> city pixel
    src_col = (x_w - city.origin_xy[0]) / city.voxel_size
    src_row = (y_w - city.origin_xy[1]) / city.voxel_size

    hc, wc, _ = city.raster.shape
    r0 = np.floor(src_row).astype(np.int64)
    c0 = np.floor(src_col).astype(np.int64)
    dr = (src_row - r0)[..., None]
    dc = (src_col - c0)[..., None]

    def gather(ri, ci):
        ok = (ri >= 0) & (ri < hc) & (ci >= 0) & (ci < wc)
        ris = np.clip(ri, 0, hc - 1)
        cis = np.clip(ci, 0, wc - 1)
        vals = city.raster[ris, cis]
        vals[~ok] = 0.0
        return vals

    out = (
        gather(r0, c0) * (1 - dr) * (1 - dc)
        + gather(r0, c0 + 1) * (1 - dr) * dc
        + gather(r0 + 1, c0) * dr * (1 - dc)
        + gather(r0 + 1, c0 + 1) * dr * dc
    )
    return (out >= _channel_thresholds(binary_threshold)).astype(np.float32)


def warp_city_to_ego_device(
    city_raster, origin_xy, ego_xy_yaw, grid: GridConfig,
    binary_threshold: float = 0.5,
):
    """Device twin of :func:`warp_city_to_ego` (jit/vmap-able).

    city_raster f32[Hc, Wc, 9]; ego_xy_yaw f32[3] = (tx, ty, yaw).
    """
    import jax
    import jax.numpy as jnp

    h, w = grid.height_px, grid.width_px
    rows = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    x_ego = (grid.pixel_offset_y - rows) * grid.voxel_size_m
    y_ego = (cols - grid.pixel_offset_x) * grid.voxel_size_m
    tx, ty, yaw = ego_xy_yaw[0], ego_xy_yaw[1], ego_xy_yaw[2]
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    x_w = c * x_ego - s * y_ego + tx
    y_w = s * x_ego + c * y_ego + ty
    src_col = (x_w - origin_xy[0]) / grid.voxel_size_m
    src_row = (y_w - origin_xy[1]) / grid.voxel_size_m

    from .augment import _bilinear_sample

    out = _bilinear_sample(city_raster, src_row, src_col)
    thresh = jnp.asarray(_channel_thresholds(binary_threshold), out.dtype)
    return (out >= thresh).astype(jnp.float32)
