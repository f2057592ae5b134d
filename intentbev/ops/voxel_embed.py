"""Chunk transport: host-built voxel placement chunks -> dense LiDAR BEV.

The serving and chunk-training paths ship the LiDAR sweep as placement
chunks instead of raw points: the HOST voxelizes (``dedup_cells_host``:
per-cell max over the points, exact — the bf16 cast commutes with max) and
groups the unique cells by 64-pixel *window* (64 consecutive pixels in
row-major order) into *chunks* of <= 64 cells, banded by
:func:`rows_per_program` patch rows so the arrays have a fixed,
shape-stable size per band. The C++ builder (cpp ``ib_build_chunks``)
produces the same arrays ~10x faster than numpy.

On device, :func:`voxel_fill_bev` decodes the chunks to flat cell indices
and scatter-ADDS the values into a zero BEV. Placement is a sum over
unique cells, so zero padding (empty slots, chunks past a band's count)
adds nothing; pad slots are routed out of range and dropped so they do
not pile onto one address. The BEV then feeds the patch-embed conv (ViT)
or the first stage (CNN) exactly like the scatter-max BEV of
``bev.voxelize.voxelize_packed``, which it matches bit for bit.

Voxelize semantics match utils.py:62-106 via bev/voxelize.py: per-cell max
intensity, empty cells 0 (host clamps values to >= 0, which the reference's
zeros-init ``np.maximum.at`` implies).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

WINDOW = 64  # pixels per placement window
CAP = 64     # max cells per chunk

# Band geometry the CNN chunk path builds/consumes with (the CNN family has
# no patch size of its own; the transport just needs ONE agreed value so
# build_voxel_chunks and voxel_fill_bev band identically).
CNN_CHUNK_PATCH = 8

# patch rows per band when the grid's patch rows divide by it (else 1)
ROWS_PER_BAND = 5


def rows_per_program(grid_h: int, patch: int) -> int:
    """Patch rows per band for a grid of ``grid_h`` pixel rows — the one
    banding rule the host builder and :func:`voxel_fill_bev` share."""
    gh = grid_h // patch
    return ROWS_PER_BAND if gh % ROWS_PER_BAND == 0 else 1


class VoxelChunks(NamedTuple):
    """Host-built placement chunks for one batch.

    Per-cell vectors have shape [..., 1, CAP] (the layout both host
    builders emit).
    """

    wid: jnp.ndarray    # i32[B, NB, NC]        window index within band
    sl: jnp.ndarray     # i32[B, NB, NC, 1, CAP] pixel slot within window
    ch: jnp.ndarray     # i32[B, NB, NC, 1, CAP] channel of the cell
    val: jnp.ndarray    # f32[B, NB, NC, 1, CAP] cell value (max intensity)
    count: jnp.ndarray  # i32[B, NB]            real chunks per band


def pack_chunk_transport(chunks: VoxelChunks,
                         window: int = WINDOW) -> VoxelChunks:
    """Host-side compact encoding of placement chunks for the H2D link.

    The chunk payload is the sustained-serving transport limiter (the
    device consumes batches faster than the host link ships them on
    bandwidth-bound deployments), so every exact bit-saving matters:

    - ``sl`` + ``ch`` pack into ONE u16 per cell (slot-in-window in the
      low 6 bits — window is 64 slots — channel in the high 10) whenever
      the channel index fits 10 bits (the 290-channel flagship grid does).
      EXACT; 3 bytes -> 2 per cell. The placeholder ``ch`` ships as a
      zero-size array (0 bytes).
    - ``val`` ships u8 when every value is integral in [0, 255]. AV2
      LiDAR intensity IS uint8 (the feather column the reference reads,
      dataset.py:311), so on real data this is exact; synthetic float
      intensities keep f32 and only pay the 2-byte sl/ch saving.
    - ``wid`` stays i32 (one per chunk, not per cell — negligible).

    Together: 452 -> 196 bytes/chunk on integral-intensity data (u16
    packed indices + u8 values), a 2.3x transport cut. Inverse:
    :func:`decode_chunk_transport` (elementwise, inside the jitted
    program).
    """
    sl = np.asarray(chunks.sl)
    ch = np.asarray(chunks.ch)
    val = np.asarray(chunks.val)
    out = chunks._replace(
        wid=np.asarray(chunks.wid).astype(np.int32),
        count=np.asarray(chunks.count).astype(np.int32),
    )
    if window <= 64 and int(ch.max(initial=0)) < (1 << 10):
        packed = ((ch.astype(np.uint16) << 6)
                  | sl.astype(np.uint16)).astype(np.uint16)
        out = out._replace(
            sl=packed, ch=np.zeros(ch.shape[:-1] + (0,), np.int16))
    elif window <= 256 and int(ch.max(initial=0)) < (1 << 15):
        out = out._replace(sl=sl.astype(np.uint8), ch=ch.astype(np.int16))
    if (val.size == 0
            or (val.min(initial=0.0) >= 0.0 and val.max(initial=0.0) <= 255.0
                and np.array_equal(val, np.rint(val)))):
        out = out._replace(val=val.astype(np.uint8))
    return out


def decode_chunk_transport(chunks: VoxelChunks) -> VoxelChunks:
    """Device-side inverse of :func:`pack_chunk_transport` — also accepts
    unpacked (i32/f32) chunks unchanged. Elementwise converts inside the
    jitted consumer; shapes/dtypes are static per trace."""
    sl = chunks.sl
    if sl.dtype == jnp.uint16:
        p = sl.astype(jnp.int32)
        sl_i = p & 63
        ch_i = p >> 6
    else:
        sl_i = sl.astype(jnp.int32)
        ch_i = chunks.ch.astype(jnp.int32)
    val = chunks.val
    if val.dtype != jnp.float32:
        val = val.astype(jnp.float32)
    return chunks._replace(
        wid=chunks.wid.astype(jnp.int32), sl=sl_i, ch=ch_i, val=val)


def build_voxel_chunks(
    points: np.ndarray,
    valid: np.ndarray,
    grid,
    patch: int,
    *,
    window: int = WINDOW,
    cap: int = CAP,
    num_chunks: int | None = None,
    on_overflow: str = "raise",
    use_native: bool = True,
) -> tuple[VoxelChunks, int]:
    """One sample's packed points -> placement chunks (host).

    points f32[S, P, 4], valid bool[S, P]. Returns (chunks with leading
    batch dim of 1, num_chunks actually used). With ``num_chunks=None``
    the chunk arrays are sized to the sample (rounded up to a multiple of
    8); pass a fixed value for shape-stable streaming. ``on_overflow``:
    'raise' or 'drop' (drop whole excess chunks, rarest-window cells last).
    ``use_native`` prefers the C++ builder (cpp ib_build_chunks, ~10x the
    numpy throughput) when the host library is available; both produce
    identical arrays (parity-tested).
    """
    from ..bev.voxelize import dedup_cells_host

    h, w = grid.height_px, grid.width_px
    c = grid.lidar_sweeps * grid.lidar_height_channels
    rows_band = rows_per_program(h, patch) * patch
    if h % rows_band:
        raise ValueError(f"height {h} not divisible by band rows {rows_band}")
    band_px = rows_band * w
    if band_px % window:
        raise ValueError(f"band pixels {band_px} not divisible by window {window}")
    nb = h // rows_band
    wins_per_band = band_px // window

    if num_chunks is not None and num_chunks % 8:
        # chunk counts are kept to multiples of 8 (the auto-sized builds
        # round the same way); extra zero chunks place nothing
        num_chunks = -(-num_chunks // 8) * 8

    if use_native:
        from ..utils.native import build_chunks_native

        nc0 = num_chunks if num_chunks is not None else max(
            8, -(-(int(np.count_nonzero(valid)) // 48) // 8) * 8)
        out = build_chunks_native(
            points, valid, grid, window=window, cap=cap, nb=nb, nc=nc0)
        if out is not None:
            wid, sl, ch, val, count, needed = out
            if needed > nc0:
                if num_chunks is not None:
                    if on_overflow == "raise":
                        raise ValueError(
                            f"band needs {needed} chunks > num_chunks={nc0}; "
                            "raise num_chunks or pass on_overflow='drop'"
                        )
                else:  # auto-size: retry once at the exact requirement
                    # (ib_build_chunks counts demand past nc, so `needed`
                    # is exact and the retry cannot overflow again)
                    nc0 = -(-needed // 8) * 8
                    wid, sl, ch, val, count, needed = build_chunks_native(
                        points, valid, grid, window=window, cap=cap,
                        nb=nb, nc=nc0)
                    assert needed <= nc0, (needed, nc0)
            if num_chunks is None and nc0 > 8:
                tight = max(8, -(-max(int(count.max()), 1) // 8) * 8)
                if tight < nc0:  # trim the over-guess (numpy-size parity)
                    wid, sl, ch, val = (a[:, :tight] for a in (wid, sl, ch, val))
                    nc0 = tight
            return (
                VoxelChunks(wid=wid[None], sl=sl[None], ch=ch[None],
                            val=val[None], count=count[None]),
                nc0,
            )

    ids, vals = dedup_cells_host(points, valid, grid)
    n_real = int(np.searchsorted(ids, h * w * c))
    ids = ids[:n_real].astype(np.int64)
    # reference semantics: cells are max(0, intensities) (zeros-init
    # np.maximum.at, utils.py:101-105)
    vals = np.maximum(vals[:n_real], 0.0)

    p = ids // c
    chn = (ids % c).astype(np.int32)
    win_global = p // window
    slot = (p % window).astype(np.int32)

    n = len(ids)
    if n:
        new = np.empty(n, bool)
        new[0] = True
        new[1:] = win_global[1:] != win_global[:-1]
        run_id = np.cumsum(new) - 1
        rank = np.arange(n) - np.flatnonzero(new)[run_id]
    else:
        rank = np.zeros(0, np.int64)
    mcw = -(-(window * c) // cap)  # chunks per window upper bound
    ckey = win_global * mcw + rank // cap
    k_in_chunk = (rank % cap).astype(np.int64)

    # ckey is non-decreasing (cells arrive sorted by flat id, so win_global
    # is non-decreasing and rank//cap increases within a window) — run
    # detection replaces np.unique's redundant O(n log n) sort
    if n:
        cnew = np.empty(n, bool)
        cnew[0] = True
        cnew[1:] = ckey[1:] != ckey[:-1]
        inv = np.cumsum(cnew) - 1
        uc = ckey[cnew]
    else:
        inv = np.zeros(0, np.int64)
        uc = ckey
    cwin = uc // mcw
    cband = cwin // wins_per_band
    m = len(uc)
    if m:
        cb_new = np.empty(m, bool)
        cb_new[0] = True
        cb_new[1:] = cband[1:] != cband[:-1]
        cb_run = np.cumsum(cb_new) - 1
        clocal = np.arange(m) - np.flatnonzero(cb_new)[cb_run]
    else:
        clocal = np.zeros(0, np.int64)
    counts = np.bincount(cband, minlength=nb).astype(np.int32)

    nc = num_chunks
    if nc is None:
        nc = max(int(counts.max()) if m else 0, 8)
        nc = -(-nc // 8) * 8
    if m and int(counts.max()) > nc:
        if on_overflow == "raise":
            raise ValueError(
                f"band needs {int(counts.max())} chunks > num_chunks={nc}; "
                "raise num_chunks or pass on_overflow='drop'"
            )
        keep_chunk = clocal < nc
        keep_cell = keep_chunk[inv]
        inv = inv[keep_cell]
        chn, slot, vals = chn[keep_cell], slot[keep_cell], vals[keep_cell]
        k_in_chunk = k_in_chunk[keep_cell]
        counts = np.minimum(counts, nc)

    wid = np.zeros((nb, nc), np.int32)
    sl = np.zeros((nb, nc, 1, cap), np.int32)
    ch = np.zeros((nb, nc, 1, cap), np.int32)
    val = np.zeros((nb, nc, 1, cap), np.float32)
    if m:
        sel = clocal < nc
        wid[cband[sel], clocal[sel]] = (cwin[sel] % wins_per_band).astype(np.int32)
        b_cell = cband[inv]
        l_cell = clocal[inv]
        sl[b_cell, l_cell, 0, k_in_chunk] = slot
        ch[b_cell, l_cell, 0, k_in_chunk] = chn
        val[b_cell, l_cell, 0, k_in_chunk] = vals
    return (
        VoxelChunks(
            wid=wid[None], sl=sl[None], ch=ch[None], val=val[None],
            count=counts[None],
        ),
        nc,
    )


def stack_voxel_chunks(samples: list[VoxelChunks]) -> VoxelChunks:
    """Stack per-sample chunks (batch dim 1 each) into one batch, padding
    the chunk axis to the largest sample (zero chunks are no-ops)."""
    nc = max(s.wid.shape[2] for s in samples)

    def pad(a, target):
        pad_width = [(0, 0)] * a.ndim
        pad_width[2] = (0, target - a.shape[2])
        return np.pad(np.asarray(a), pad_width)

    return VoxelChunks(
        wid=np.concatenate([pad(s.wid, nc) for s in samples]),
        sl=np.concatenate([pad(s.sl, nc) for s in samples]),
        ch=np.concatenate([pad(s.ch, nc) for s in samples]),
        val=np.concatenate([pad(s.val, nc) for s in samples]),
        count=np.concatenate([np.asarray(s.count) for s in samples]),
    )


def chunk_cell_indices(chunks: VoxelChunks, grid_hw: tuple[int, int],
                       channels: int, patch: int, *,
                       window: int = WINDOW) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Decoded chunks -> (flat cell index into [H*W*C], value), each
    [B, NB*NC*CAP]. Slots holding zero (padding) get the out-of-range
    index H*W*C."""
    h, w = grid_hw
    b, nb, nc = chunks.wid.shape
    band_px = rows_per_program(h, patch) * patch * w
    assert nb * band_px == h * w, (nb, band_px, h, w)
    band = jnp.arange(nb, dtype=jnp.int32)[None, :, None, None]
    pix = (band * band_px + chunks.wid[..., None] * window
           + chunks.sl[:, :, :, 0, :])
    idx = pix * channels + chunks.ch[:, :, :, 0, :]
    val = chunks.val[:, :, :, 0, :]
    idx = jnp.where(val != 0, idx, h * w * channels)
    return idx.reshape(b, -1), val.reshape(b, -1)


@jax.named_scope("chunk_placement")
def voxel_fill_bev(
    chunks: VoxelChunks,
    grid_hw: tuple[int, int],
    channels: int,
    patch: int,
    dtype=jnp.bfloat16,
    *,
    window: int = WINDOW,
) -> jnp.ndarray:
    """Placement chunks (packed or not) -> dense BEV [B, H, W, C].

    ``patch`` must match the value the chunks were built with (the band
    height is derived from it), so one host transport serves both model
    families. Exact vs ``voxelize_packed`` up to the output dtype cast (the
    per-cell max is computed on the host in f32, and each cell is written
    once).
    """
    h, w = grid_hw
    # channels must cover the builder's channel count: a too-small value
    # would alias cells into the next pixel. Checked when the chunk arrays
    # are concrete (host build -> direct call); traced calls skip it.
    if not isinstance(chunks.ch, jax.core.Tracer) and chunks.ch.size:
        ch_max = int(np.max(np.asarray(chunks.ch)))
        assert ch_max < channels, (
            f"chunks carry channel index {ch_max} but voxel_fill_bev was "
            f"called with channels={channels}"
        )
    chunks = decode_chunk_transport(chunks)
    b = chunks.wid.shape[0]
    idx, val = chunk_cell_indices(chunks, grid_hw, channels, patch,
                                  window=window)
    rows = jnp.broadcast_to(jnp.arange(b, dtype=jnp.int32)[:, None], idx.shape)
    bev = jnp.zeros((b, h * w * channels), dtype).at[rows, idx].add(
        val.astype(dtype), mode="drop")
    return bev.reshape(b, h, w, channels)
