"""ctypes bindings for the C++ host library (cpp/intentbev_host.cpp).

Feature-flag pattern mirrors the reference's optional-dependency gates
(constants.py:4-15): if ``libintentbev_host.so`` is absent, every wrapper
falls back to the pure-numpy implementation and ``NATIVE_AVAILABLE`` is
False. Build with ``cpp/build.sh``.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_LIB_CANDIDATES = [
    Path(__file__).resolve().parents[2] / "cpp" / "libintentbev_host.so",
    Path(os.environ.get("INTENTBEV_NATIVE_LIB", "")),
]


def _try_build() -> None:
    """Build the .so from source on first import if a toolchain is present
    (fresh checkouts ship only cpp/intentbev_host.cpp; running the host
    pipeline on the numpy fallbacks is ~10x slower per sample). Failures are
    silent — the numpy paths are always correct. Set INTENTBEV_NO_NATIVE_BUILD
    to skip."""
    if os.environ.get("INTENTBEV_NO_NATIVE_BUILD"):
        return
    src = Path(__file__).resolve().parents[2] / "cpp" / "intentbev_host.cpp"
    out = src.with_name("libintentbev_host.so")
    if not src.is_file() or out.is_file():
        return
    import subprocess

    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-std=c++17", str(src), "-o", str(out) + ".tmp"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(str(out) + ".tmp", out)  # atomic vs concurrent builders
    except Exception:
        pass


native_lib = None
for _attempt in range(2):
    for _p in _LIB_CANDIDATES:
        if _p and _p.is_file():
            try:
                native_lib = ctypes.CDLL(str(_p))
                break
            except OSError:
                native_lib = None
    if native_lib is not None or _attempt:
        break
    _try_build()

NATIVE_AVAILABLE = native_lib is not None

if NATIVE_AVAILABLE:
    _i64 = ctypes.c_int64
    _f64 = ctypes.c_double
    native_lib.ib_fill_polygon.argtypes = [
        ctypes.c_void_p, _i64, _i64, ctypes.c_void_p, _i64]
    native_lib.ib_draw_polyline.argtypes = [
        ctypes.c_void_p, _i64, _i64, ctypes.c_void_p, _i64]
    native_lib.ib_voxelize_sweep.argtypes = [
        ctypes.c_void_p, _i64, _i64, _i64, ctypes.c_void_p, _i64, _i64, _i64,
        _f64, _f64, _f64, _f64, _f64]
    native_lib.ib_transform_points.argtypes = [
        ctypes.c_void_p, _i64, ctypes.c_void_p, ctypes.c_void_p]
    native_lib.ib_rotated_iou.argtypes = [
        ctypes.c_void_p, _i64, ctypes.c_void_p, _i64, ctypes.c_void_p]
    if hasattr(native_lib, "ib_build_chunks"):  # stale pre-built .so guard
        native_lib.ib_build_chunks.restype = _i64
        native_lib.ib_build_chunks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, _i64, _i64, _i64, _i64, _i64,
            _f64, _f64, _f64, _f64, _f64, _i64, _i64, _i64, _i64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]


def fill_polygon_native(mask: np.ndarray, pts: np.ndarray) -> bool:
    """In-place fill; returns False if the native lib is unavailable."""
    if not NATIVE_AVAILABLE or pts.shape[0] < 3:
        return False
    mask_c = np.ascontiguousarray(mask, dtype=np.uint8)
    pts_c = np.ascontiguousarray(pts, dtype=np.int32)
    native_lib.ib_fill_polygon(
        mask_c.ctypes.data, mask.shape[0], mask.shape[1],
        pts_c.ctypes.data, pts_c.shape[0])
    if mask_c is not mask:
        mask[...] = mask_c
    return True


def draw_polyline_native(mask: np.ndarray, pts: np.ndarray) -> bool:
    if not NATIVE_AVAILABLE or pts.shape[0] < 2:
        return False
    mask_c = np.ascontiguousarray(mask, dtype=np.uint8)
    pts_c = np.ascontiguousarray(pts, dtype=np.int32)
    native_lib.ib_draw_polyline(
        mask_c.ctypes.data, mask.shape[0], mask.shape[1],
        pts_c.ctypes.data, pts_c.shape[0])
    if mask_c is not mask:
        mask[...] = mask_c
    return True


def transform_points_native(points: np.ndarray, T: np.ndarray) -> np.ndarray | None:
    """Nx3 f64 points through a 4x4 transform -> f32 Nx3; None if no lib."""
    if not NATIVE_AVAILABLE:
        return None
    pts = np.ascontiguousarray(points[:, :3], dtype=np.float64)
    m = np.ascontiguousarray(T, dtype=np.float64)
    out = np.empty((pts.shape[0], 3), dtype=np.float32)
    native_lib.ib_transform_points(
        pts.ctypes.data, pts.shape[0], m.ctypes.data, out.ctypes.data)
    return out


def voxelize_sweep_native(
    bev: np.ndarray, points_xyzi: np.ndarray, sweep_idx: int,
    z_channels: int, voxel_size: float, offset_col: float, offset_row: float,
    z_min: float, z_max: float,
) -> bool:
    """Scatter-max one sweep into bev f32[H, W, C] in place."""
    if not NATIVE_AVAILABLE:
        return False
    assert bev.flags.c_contiguous and bev.dtype == np.float32
    pts = np.ascontiguousarray(points_xyzi, dtype=np.float32)
    native_lib.ib_voxelize_sweep(
        bev.ctypes.data, bev.shape[0], bev.shape[1], bev.shape[2],
        pts.ctypes.data, pts.shape[0], sweep_idx, z_channels,
        voxel_size, offset_col, offset_row, z_min, z_max)
    return True


def rotated_iou_native(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray | None:
    if not NATIVE_AVAILABLE:
        return None
    b1 = np.ascontiguousarray(boxes1, dtype=np.float32)
    b2 = np.ascontiguousarray(boxes2, dtype=np.float32)
    out = np.empty((b1.shape[0], b2.shape[0]), dtype=np.float32)
    native_lib.ib_rotated_iou(
        b1.ctypes.data, b1.shape[0], b2.ctypes.data, b2.shape[0],
        out.ctypes.data)
    return out


def build_chunks_native(
    points: np.ndarray, valid: np.ndarray, grid, *,
    window: int, cap: int, nb: int, nc: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int] | None:
    """C++ twin of ops.voxel_embed.build_voxel_chunks's core (sort + dedup +
    window grouping). Returns (wid, sl, ch, val, count, needed_nc) or None
    if the native lib is unavailable or predates ib_build_chunks."""
    if not NATIVE_AVAILABLE or not hasattr(native_lib, "ib_build_chunks"):
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    vld = np.ascontiguousarray(valid, dtype=np.uint8)
    s, p = vld.shape
    wid = np.zeros((nb, nc), np.int32)
    sl = np.zeros((nb, nc, 1, cap), np.int32)
    ch = np.zeros((nb, nc, 1, cap), np.int32)
    val = np.zeros((nb, nc, 1, cap), np.float32)
    count = np.zeros((nb,), np.int32)
    needed = native_lib.ib_build_chunks(
        pts.ctypes.data, vld.ctypes.data, s, p,
        grid.height_px, grid.width_px, grid.lidar_height_channels,
        float(grid.voxel_size_m), float(grid.pixel_offset_x),
        float(grid.pixel_offset_y), float(grid.z_min), float(grid.z_max),
        window, cap, nb, nc,
        wid.ctypes.data, sl.ctypes.data, ch.ctypes.data, val.ctypes.data,
        count.ctypes.data)
    return wid, sl, ch, val, count, int(needed)
