"""Multi-sweep LiDAR BEV voxelization.

Reference semantics (utils.py:62-106): per sweep, points in the *current*
ego frame are floored into the 400x720 grid; z in [z_min, z_max) is binned
into 29 height slices; each (sweep, slice) channel takes the per-pixel
**max intensity**; missing sweeps leave zero channels. Output layout here
is channels-last f32[H, W, S*Z] with channel = sweep * Z + z_slice (the
reference's [S*Z, H, W] transposed).

Device path: the host packs each sample's sweeps into a fixed-size
padded tensor (``pack_points``) and the scatter-max runs on device inside
the jitted step (``voxelize_packed``) — one XLA scatter-max per sample
instead of the reference's 29-way python loop over ``np.maximum.at``
(utils.py:98-105). ``voxelize_numpy`` is the host/oracle twin.

Every path bins a point with ``point_cells`` (the C++ builders in
cpp/intentbev_host.cpp repeat its arithmetic), so host and device put a
point on a cell edge into the same cell.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import GridConfig


def bin_constants(grid: GridConfig) -> tuple[np.float32, ...]:
    """f32 (y_lo, x_hi, inv_voxel, z_lo, z_hi, z_scale) of ``point_cells``:
    the ego-frame y of column 0's left edge, the x of row 0's top edge, and
    the per-metre scales, each computed in f64 and rounded once."""
    v = grid.voxel_size_m
    return (np.float32(-grid.pixel_offset_x * v), np.float32(grid.pixel_offset_y * v),
            np.float32(1.0 / v), np.float32(grid.z_min), np.float32(grid.z_max),
            np.float32(grid.lidar_height_channels / (grid.z_max - grid.z_min)))


def point_cells(x, y, z, grid: GridConfig):
    """(row, col, z_slice, in_grid) of each point; numpy or jax arrays.

    The reference's ``floor(offset + y / voxel)`` bins differently on host
    and device: XLA turns a division by a constant into a multiply by its
    reciprocal (and folds the z scales into one), and the GPU may fuse a
    multiply and an add into one FMA. So a point within rounding of a cell
    edge fell into neighbouring cells. Here each coordinate takes one
    rounded f32 subtract and one rounded f32 multiply by a constant, which
    numpy, C++ and XLA on any backend compute the same.
    """
    y_lo, x_hi, inv_v, z_lo, z_hi, z_scale = bin_constants(grid)
    if isinstance(x, jax.Array):
        xp, idx = jnp, jnp.int32
    else:
        xp, idx = np, np.int64
        x, y, z = (np.asarray(a, np.float32) for a in (x, y, z))
    col = xp.floor((y - y_lo) * inv_v).astype(idx)
    row = xp.floor((x_hi - x) * inv_v).astype(idx)
    zi = xp.clip(xp.floor((z - z_lo) * z_scale).astype(idx), 0,
                 grid.lidar_height_channels - 1)
    ok = ((col >= 0) & (col < grid.width_px) & (row >= 0) & (row < grid.height_px)
          & (z >= z_lo) & (z < z_hi))
    return row, col, zi, ok


def pack_points(
    points_list: list[np.ndarray | None],
    intensity_list: list[np.ndarray | None],
    num_sweeps: int,
    max_points_per_sweep: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Ragged per-sweep point clouds -> fixed (f32[S, P, 4], bool[S, P]).

    Columns: x, y, z (current-ego frame) and intensity. Sweeps beyond the
    provided lists, ``None`` entries, and points beyond ``max_points_per_sweep``
    (uniformly subsampled if overfull) are masked out — matching the
    reference's zero-padding of missing sweeps (utils.py:69-75).
    """
    s, p = num_sweeps, max_points_per_sweep
    packed = np.zeros((s, p, 4), dtype=np.float32)
    valid = np.zeros((s, p), dtype=bool)
    n = min(len(points_list), len(intensity_list), s)
    for i in range(n):
        pts, inten = points_list[i], intensity_list[i]
        if pts is None or inten is None or len(pts) == 0:
            continue
        k = len(pts)
        if k > p:
            sel = np.linspace(0, k - 1, p).astype(np.int64)
            pts, inten = pts[sel], inten[sel]
            k = p
        packed[i, :k, :3] = pts[:, :3]
        packed[i, :k, 3] = inten
        valid[i, :k] = True
    return packed, valid


# Host->device point transport: xyz in int16 CENTIMETERS (exact to 1 cm,
# range +-327 m covers any AV2 sweep), intensity raw (0-255, exact in i16).
# Halves the per-batch transfer vs f32 [B, S, P, 4]; the <=5 mm rounding is
# 2.5% of a 0.2 m voxel (below sensor noise). Loaders/oracles stay f32 —
# quantization happens only at the batch-stack transport boundary
# (data.pipeline._stack) and is undone on device before any geometry.
_POINT_QUANT_SCALE = np.array([100.0, 100.0, 100.0, 1.0], np.float32)


def quantize_points_cm(points: np.ndarray) -> np.ndarray:
    """f32[..., 4] (x, y, z, intensity) -> i16[..., 4] transport encoding.

    Assumes intensity is integral (real AV2 reflectance is 0-255 integers,
    so the round is exact). Float intensities (e.g. synthetic continuous
    uniforms) are perturbed by up to 0.5 in the max-intensity channel —
    oracle-vs-pipeline parity tests should feed f32 directly (the
    ``dequantize_points`` passthrough path), which they do.
    """
    q = np.round(points * _POINT_QUANT_SCALE)
    return np.clip(q, -32767, 32767).astype(np.int16)


def dequantize_points(points: jnp.ndarray) -> jnp.ndarray:
    """Device-side inverse of ``quantize_points_cm``; f32 passes through
    (tests and pre-quantization callers feed f32 directly)."""
    if points.dtype == jnp.int16:
        inv = jnp.asarray([0.01, 0.01, 0.01, 1.0], jnp.float32)
        return points.astype(jnp.float32) * inv
    return points


@functools.partial(jax.jit, static_argnames=("grid", "out_dtype"))
def voxelize_packed(
    points: jnp.ndarray, valid: jnp.ndarray, grid: GridConfig,
    out_dtype=jnp.float32,
) -> jnp.ndarray:
    """Device scatter-max voxelizer.

    points f32[S, P, 4]; valid bool[S, P] -> bev [H, W, S*Z] in
    ``out_dtype``. Emitting bf16 directly halves the device-memory read of the
    290-channel BEV by the patch-embed conv (f32 batch-8 BEV is ~2.7 GB).
    """
    if not jnp.issubdtype(points.dtype, jnp.floating):
        raise TypeError(
            "voxelize_packed expects floating-point points (meters); got "
            f"{points.dtype}. i16 transport points must be decoded with "
            "dequantize_points first — feeding centimeters here would put "
            "nearly every point outside the grid and silently produce an "
            "empty BEV."
        )
    h, w = grid.height_px, grid.width_px
    z_ch = grid.lidar_height_channels
    s = points.shape[0]
    c = s * z_ch

    inten = points[..., 3]
    row, col, zi, ok = point_cells(points[..., 0], points[..., 1], points[..., 2], grid)
    ok = valid & ok

    sweep_idx = jax.lax.broadcasted_iota(jnp.int32, points.shape[:2], 0)
    channel = sweep_idx * z_ch + zi
    flat = (row * w + col) * c + channel
    flat = jnp.where(ok, flat, h * w * c)  # out-of-range -> dropped

    # one flat 1-D scatter per sample into the [H*W*C] buffer; invalid
    # points carry the out-of-range index and are dropped
    bev = jnp.zeros((h * w * c,), dtype=out_dtype)
    if jnp.issubdtype(out_dtype, jnp.integer):
        # integer target (u8 serving path: AV2 intensity is integral 0-255,
        # so a u8 BEV is exact and halves the scatter target + downstream
        # reads vs bf16); invalid points are dropped by INDEX above, so
        # their update value just needs to be in-range
        upd = jnp.clip(jnp.round(inten), 0, jnp.iinfo(out_dtype).max)
    else:
        upd = jnp.where(ok, inten, -jnp.inf)
    bev = bev.at[flat.reshape(-1)].max(
        upd.reshape(-1).astype(out_dtype), mode="drop"
    )
    return bev.reshape(h, w, c)


def dedup_cells_host(
    points: np.ndarray, valid: np.ndarray, grid: GridConfig
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side per-cell max-reduction of a packed sample.

    points f32[S, P, 4], valid bool[S, P] -> (cell_ids i32[S*P],
    values f32[S*P]): SORTED UNIQUE flat cell indices with their max
    intensity, padded at the tail with ids ascending past h*w*c (so
    sortedness and uniqueness hold over the whole fixed-size array; the
    device scatter drops them via mode="drop").

    Rationale: the on-device scatter-max over raw points resolves
    conflicting updates to the same cell. The max-combine is associative
    and the loader already touches every point, so the host can
    pre-reduce duplicates (np.maximum.reduceat over a lexsort, ~O(n log n)
    per sample) and ship (id, value) pairs instead; the device scatter
    then carries ``unique_indices=True, indices_are_sorted=True``.
    Exactness: bf16-cast commutes with max (casting is monotonic), so
    host f32 max + device cast == device bf16 max.
    """
    h, w = grid.height_px, grid.width_px
    z_ch = grid.lidar_height_channels
    s = points.shape[0]
    c = s * z_ch
    n_total = points.shape[0] * points.shape[1]

    inten = points[..., 3]
    row, col, zi, ok = point_cells(points[..., 0], points[..., 1], points[..., 2], grid)
    ok &= np.asarray(valid, bool)
    sweep_idx = np.arange(s, dtype=np.int64)[:, None]
    flat = ((row * w + col) * c + sweep_idx * z_ch + zi)[ok]
    vals = inten[ok].astype(np.float32)

    order = np.argsort(flat, kind="stable")
    flat, vals = flat[order], vals[order]
    boundaries = np.flatnonzero(np.diff(flat)) + 1
    starts = np.concatenate([[0], boundaries]) if len(flat) else np.zeros(0, np.int64)
    uniq_ids = flat[starts] if len(flat) else flat
    uniq_vals = np.maximum.reduceat(vals, starts) if len(flat) else vals

    out_ids = np.arange(n_total, dtype=np.int64) + (h * w * c)
    out_vals = np.zeros(n_total, dtype=np.float32)
    u = len(uniq_ids)
    out_ids[:u] = uniq_ids
    out_ids[u:] = h * w * c + np.arange(n_total - u, dtype=np.int64)
    out_vals[:u] = uniq_vals
    return out_ids.astype(np.int32), out_vals


@functools.partial(jax.jit, static_argnames=("grid", "out_dtype"))
def voxelize_cells(
    cell_ids: jnp.ndarray, values: jnp.ndarray, grid: GridConfig,
    out_dtype=jnp.float32,
) -> jnp.ndarray:
    """Device scatter of host-pre-reduced (cell_id, max_value) pairs.

    Counterpart of ``dedup_cells_host``; produces the same BEV as
    ``voxelize_packed`` on the raw points (see its parity test). The
    unique+sorted guarantees let XLA drop the conflict handling of the
    general scatter-max path.
    """
    h, w = grid.height_px, grid.width_px
    c = grid.lidar_sweeps * grid.lidar_height_channels
    bev = jnp.zeros((h * w * c,), dtype=out_dtype)
    bev = bev.at[cell_ids].max(
        values.astype(out_dtype), mode="drop",
        unique_indices=True, indices_are_sorted=True,
    )
    return bev.reshape(h, w, c)


def voxelize_numpy(
    points_list: list[np.ndarray | None],
    intensity_list: list[np.ndarray | None],
    grid: GridConfig,
    num_expected_sweeps: int | None = None,
) -> np.ndarray:
    """Host-side oracle; line-for-line semantics of utils.py:62-106 but
    producing channels-last [H, W, S*Z]."""
    s = num_expected_sweeps or grid.lidar_sweeps
    h, w, z_ch = grid.height_px, grid.width_px, grid.lidar_height_channels
    bev = np.zeros((h, w, z_ch * s), dtype=np.float32)
    n = min(len(points_list), len(intensity_list))
    for i in range(n):
        pts, inten = points_list[i], intensity_list[i]
        if pts is None or inten is None or pts.shape[0] == 0:
            continue
        row, col, zi, ok = point_cells(pts[:, 0], pts[:, 1], pts[:, 2], grid)
        row, col, zi, it = row[ok], col[ok], zi[ok], inten[ok]
        np.maximum.at(bev, (row, col, i * z_ch + zi), it.astype(np.float32))
    return bev
