"""Chunk transport: host chunk builders + device placement (voxel_fill_bev)
against the scatter-max voxelizer, alone and followed by the patch-embed
conv the ViT runs on the placed BEV."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from intentbev.configs import GridConfig
from intentbev.bev.voxelize import voxelize_packed
from intentbev.models.layers import conv
from intentbev.ops import voxel_embed as ve

GRID = GridConfig(height_px=64, width_px=96, lidar_height_channels=4,
                  lidar_sweeps=2)
PATCH = 8
HW = (GRID.height_px, GRID.width_px)
C = GRID.lidar_total_channels


def _random_points(rng, s=2, p=500):
    """Points spanning in/out of grid bounds and z range, with duplicates."""
    pts = np.empty((s, p, 4), np.float32)
    pts[..., 0] = rng.uniform(-20, 10, (s, p))   # x: rows (grid is 12.8 m tall)
    pts[..., 1] = rng.uniform(-12, 12, (s, p))   # y: cols
    pts[..., 2] = rng.uniform(-3, 5, (s, p))     # z: spans outside [-2, 3.8)
    pts[..., 3] = rng.uniform(0, 255, (s, p))
    # force exact duplicates of the same cell with different intensities
    pts[:, 1] = pts[:, 0]
    pts[:, 1, 3] = rng.uniform(0, 255, (s,))
    valid = rng.uniform(size=(s, p)) < 0.9
    return pts, valid


def _embed(chunks, kernel, bias):
    """Placement -> patch-embed conv -> tokens [B, N, D] (the ViT's path)."""
    bev = ve.voxel_fill_bev(chunks, HW, C, PATCH, dtype=kernel.dtype)
    y = conv({"kernel": kernel, "bias": bias}, bev, kernel.dtype, stride=PATCH,
             padding="VALID")
    return np.asarray(y.reshape(y.shape[0], -1, y.shape[-1]), np.float32)


def _oracle_tokens(pts, valid, kernel, bias):
    bev = voxelize_packed(jnp.asarray(pts), jnp.asarray(valid), GRID)
    y = jax.lax.conv_general_dilated(
        bev[None].astype(kernel.dtype), kernel,
        window_strides=(PATCH, PATCH), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    ) + bias
    return np.asarray(y.reshape(1, -1, y.shape[-1]), np.float32)


def _jnp(chunks):
    return jax.tree_util.tree_map(jnp.asarray, chunks)


@pytest.fixture
def weights(rng):
    c = GRID.lidar_total_channels
    k = jnp.asarray(rng.normal(0, 0.05, (PATCH, PATCH, c, 16)).astype(np.float32))
    b = jnp.asarray(rng.normal(0, 0.02, 16).astype(np.float32))
    return k, b


class TestVoxelEmbed:
    @pytest.mark.parametrize("packed", [False, True])
    def test_parity_vs_conv_voxelize(self, rng, weights, packed):
        k, b = weights
        pts, valid = _random_points(rng)
        chunks, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH)
        if packed:
            chunks = ve.pack_chunk_transport(chunks)
        got = _embed(_jnp(chunks), k, b)
        want = _oracle_tokens(pts, valid, k, b)
        np.testing.assert_allclose(got[0], want[0], atol=2e-3, rtol=1e-4)

    def test_batch_stacking(self, rng, weights):
        k, b = weights
        samples, wants = [], []
        for _ in range(3):
            pts, valid = _random_points(rng, p=300)
            c, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH)
            samples.append(c)
            wants.append(_oracle_tokens(pts, valid, k, b)[0])
        got = _embed(_jnp(ve.stack_voxel_chunks(samples)), k, b)
        np.testing.assert_allclose(got, np.stack(wants), atol=2e-3, rtol=1e-4)

    def test_bf16_matches_bf16_bev_path(self, rng, weights):
        """bf16 placement + conv == conv over the bf16 voxelizer output."""
        k, b = weights
        pts, valid = _random_points(rng)
        bev16 = voxelize_packed(jnp.asarray(pts), jnp.asarray(valid), GRID,
                                out_dtype=jnp.bfloat16)
        want = jax.lax.conv_general_dilated(
            bev16[None], k.astype(jnp.bfloat16),
            window_strides=(PATCH, PATCH), padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ) + b.astype(jnp.bfloat16)
        want = np.asarray(want.reshape(1, -1, 16), np.float32)
        chunks, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH)
        got = _embed(_jnp(chunks), k.astype(jnp.bfloat16), b)
        np.testing.assert_allclose(got, want, atol=0.5, rtol=0.05)

    def test_empty_sample(self, weights):
        k, b = weights
        pts = np.zeros((2, 10, 4), np.float32)
        valid = np.zeros((2, 10), bool)
        chunks, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH)
        got = _embed(_jnp(chunks), k, b)
        want = _oracle_tokens(pts, valid, k, b)
        np.testing.assert_allclose(got[0], want[0], atol=2e-3, rtol=1e-4)

    def test_overflow_raise_and_drop(self, rng, weights):
        pts, valid = _random_points(rng, p=2000)
        with pytest.raises(ValueError, match="chunks"):
            ve.build_voxel_chunks(pts, valid, GRID, PATCH, num_chunks=8)
        chunks, nc = ve.build_voxel_chunks(
            pts, valid, GRID, PATCH, num_chunks=8, on_overflow="drop")
        assert nc == 8 and chunks.wid.shape[2] == 8
        assert int(np.max(chunks.count)) <= 8

    def test_fixed_num_chunks_shape_stable(self, rng):
        pts, valid = _random_points(rng, p=100)
        c1, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH, num_chunks=64)
        pts2, valid2 = _random_points(rng, p=400)
        c2, _ = ve.build_voxel_chunks(pts2, valid2, GRID, PATCH, num_chunks=64)
        assert c1.wid.shape == c2.wid.shape


class TestModelIntegration:
    def test_intentnet_vit_chunks_match_bev(self, rng):
        """IntentNetViT.apply with VoxelChunks == apply with the dense BEV
        (same params — the chunks path reuses the conv's kernel/bias)."""
        import dataclasses
        from intentbev.configs import tiny_test_config
        from intentbev.models import build_model

        cfg = dataclasses.replace(tiny_test_config(), model_family="vit")
        g = cfg.grid
        model = build_model(cfg)
        pts, valid = _random_points(rng, s=g.lidar_sweeps, p=400)
        bev = voxelize_packed(jnp.asarray(pts), jnp.asarray(valid), g)[None]
        mp = jnp.asarray(
            rng.normal(0, 1, (1, g.height_px, g.width_px, g.map_channels))
            .astype(np.float32))
        params = model.init(jax.random.key(0), bev, mp)
        want = model.apply(params, bev, mp)

        chunks, _ = ve.build_voxel_chunks(
            np.asarray(pts), np.asarray(valid), g, cfg.vit.patch_size)
        got = model.apply(params, _jnp(chunks), mp)
        for a, b in zip(got, want):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=1e-4, rtol=1e-4)


class TestPlacementPadding:
    def test_slot0_cell_survives_padding(self):
        """A real cell in band 0, window 0, slot 0, channel 0 shares its
        flat index with every zero pad slot; placement must keep it."""
        pts = np.zeros((2, 4, 4), np.float32)
        valid = np.zeros((2, 4), bool)
        # row 0 / col 0 is the grid's top-left pixel: x just below x_max,
        # y at y_min; z in the lowest slice; sweep 0 -> channel 0
        pts[0, 0] = [GRID.bev_x_max - 0.05, GRID.bev_y_min + 0.05,
                     GRID.z_min + 0.01, 77.0]
        valid[0, 0] = True
        chunks, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH,
                                          num_chunks=64)
        bev = np.asarray(ve.voxel_fill_bev(_jnp(chunks), HW, C, PATCH,
                                           dtype=jnp.float32))[0]
        want = np.asarray(voxelize_packed(jnp.asarray(pts), jnp.asarray(valid), GRID))
        assert want[0, 0, 0] == 77.0
        np.testing.assert_array_equal(bev, want)

    @pytest.mark.parametrize("num_chunks", [None, 256])
    def test_spare_capacity_places_nothing(self, rng, num_chunks):
        pts, valid = _random_points(rng)
        chunks, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH,
                                          num_chunks=num_chunks)
        got = np.asarray(ve.voxel_fill_bev(_jnp(chunks), HW, C, PATCH,
                                           dtype=jnp.float32))[0]
        want = np.asarray(voxelize_packed(jnp.asarray(pts), jnp.asarray(valid), GRID))
        np.testing.assert_array_equal(got, want)


class TestNativeBuilder:
    def test_native_matches_numpy_on_cell_edges(self, rng):
        from intentbev.utils.native import NATIVE_AVAILABLE, native_lib
        if not NATIVE_AVAILABLE or not hasattr(native_lib, "ib_build_chunks"):
            pytest.skip("native lib unavailable")
        from test_bev import _edge_points

        pts = _edge_points(GRID, rng)
        valid = np.ones(pts.shape[:2], bool)
        a, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH, use_native=True)
        b, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH, use_native=False)
        for name, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)

    def test_native_matches_numpy(self, rng):
        from intentbev.utils.native import NATIVE_AVAILABLE, native_lib
        if not NATIVE_AVAILABLE or not hasattr(native_lib, "ib_build_chunks"):
            pytest.skip("native lib unavailable")
        pts, valid = _random_points(rng, p=800)
        a, nc_a = ve.build_voxel_chunks(pts, valid, GRID, PATCH, use_native=True)
        b, nc_b = ve.build_voxel_chunks(pts, valid, GRID, PATCH, use_native=False)
        assert nc_a == nc_b
        for name, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)

    def test_native_fixed_nc_and_overflow(self, rng):
        from intentbev.utils.native import NATIVE_AVAILABLE, native_lib
        if not NATIVE_AVAILABLE or not hasattr(native_lib, "ib_build_chunks"):
            pytest.skip("native lib unavailable")
        pts, valid = _random_points(rng, p=2000)
        with pytest.raises(ValueError, match="chunks"):
            ve.build_voxel_chunks(pts, valid, GRID, PATCH, num_chunks=8,
                                  use_native=True)
        a, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH, num_chunks=8,
                                     on_overflow="drop", use_native=True)
        b, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH, num_chunks=8,
                                     on_overflow="drop", use_native=False)
        for name, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)

    def test_native_autosize_concentrated_band(self, rng):
        """Points concentrated in one band: the initial auto-size guess is
        far too low, and the exact-`needed` retry must match numpy (the
        saturated-needed bug silently dropped cells here)."""
        from intentbev.utils.native import NATIVE_AVAILABLE, native_lib
        if not NATIVE_AVAILABLE or not hasattr(native_lib, "ib_build_chunks"):
            pytest.skip("native lib unavailable")
        s, p = 2, 4000
        pts = np.empty((s, p, 4), np.float32)
        # rows 48..63 only (the grid's last band; row = 48 - x/0.2),
        # spread over all cols
        pts[..., 0] = rng.uniform(-3.1, -0.1, (s, p))
        pts[..., 1] = rng.uniform(-9.6, 9.6, (s, p))
        pts[..., 2] = rng.uniform(-2, 3.7, (s, p))
        pts[..., 3] = rng.uniform(0, 255, (s, p))
        valid = np.ones((s, p), bool)
        a, nc_a = ve.build_voxel_chunks(pts, valid, GRID, PATCH, use_native=True)
        b, nc_b = ve.build_voxel_chunks(pts, valid, GRID, PATCH, use_native=False)
        assert nc_a == nc_b
        for name, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
        # the concentrated band really needed more than the initial guess
        assert int(np.max(a.count)) * 8 > int(np.count_nonzero(valid)) // 48


class TestVoxelFillBev:
    """Dense-BEV placement vs voxelize_packed, same chunk transport."""

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_parity_vs_voxelize(self, rng, dtype):
        """Bit-equal: both write the same per-cell max, cast once."""
        pts, valid = _random_points(rng)
        chunks, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH)
        got = ve.voxel_fill_bev(_jnp(chunks), HW, C, PATCH, dtype=dtype)
        want = voxelize_packed(jnp.asarray(pts), jnp.asarray(valid), GRID,
                               out_dtype=dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(np.asarray(got[0], np.float32),
                                      np.asarray(want, np.float32))

    def test_empty_points(self, rng):
        pts = np.zeros((2, 16, 4), np.float32)
        valid = np.zeros((2, 16), bool)
        chunks, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH)
        got = np.asarray(ve.voxel_fill_bev(_jnp(chunks), HW, C, PATCH,
                                           dtype=jnp.float32))
        assert got.shape == (1, GRID.height_px, GRID.width_px,
                             GRID.lidar_total_channels)
        assert np.all(got == 0.0)


class TestChunkTransportPacking:
    """pack_chunk_transport / decode_chunk_transport (the compact H2D
    encoding the streaming serving path ships)."""

    def _chunks(self, rng, integral_intensity):
        pts, valid = _random_points(rng)
        if integral_intensity:
            pts[..., 3] = np.rint(pts[..., 3])
        chunks, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH)
        return chunks

    def test_roundtrip_exact_integral(self, rng):
        """Integral 0-255 intensities (AV2's uint8): pack->decode is a
        bit-exact roundtrip and val ships as u8."""
        chunks = self._chunks(rng, integral_intensity=True)
        packed = ve.pack_chunk_transport(chunks)
        assert packed.sl.dtype == np.uint16
        assert packed.ch.shape[-1] == 0
        assert packed.val.dtype == np.uint8
        dec = ve.decode_chunk_transport(
            jax.tree_util.tree_map(jnp.asarray, packed))
        np.testing.assert_array_equal(np.asarray(dec.sl), chunks.sl)
        np.testing.assert_array_equal(np.asarray(dec.ch), chunks.ch)
        np.testing.assert_array_equal(np.asarray(dec.val), chunks.val)
        np.testing.assert_array_equal(np.asarray(dec.wid), chunks.wid)

    def test_float_intensity_keeps_f32_values(self, rng):
        """Non-integral intensities: indices still pack (exact), values
        stay f32 (no silent quantisation)."""
        chunks = self._chunks(rng, integral_intensity=False)
        packed = ve.pack_chunk_transport(chunks)
        assert packed.sl.dtype == np.uint16
        assert packed.val.dtype == np.float32
        dec = ve.decode_chunk_transport(
            jax.tree_util.tree_map(jnp.asarray, packed))
        np.testing.assert_array_equal(np.asarray(dec.sl), chunks.sl)
        np.testing.assert_array_equal(np.asarray(dec.ch), chunks.ch)
        np.testing.assert_array_equal(np.asarray(dec.val), chunks.val)

    def test_payload_shrinks(self, rng):
        chunks = self._chunks(rng, integral_intensity=True)
        def nbytes(c):
            return sum(np.asarray(a).nbytes for a in c)
        assert nbytes(ve.pack_chunk_transport(chunks)) < 0.5 * nbytes(chunks)

    def test_decode_passthrough_unpacked(self, rng):
        """decode_chunk_transport accepts raw i32/f32 chunks unchanged."""
        chunks = self._chunks(rng, integral_intensity=False)
        dec = ve.decode_chunk_transport(
            jax.tree_util.tree_map(jnp.asarray, chunks))
        np.testing.assert_array_equal(np.asarray(dec.sl), chunks.sl)
        np.testing.assert_array_equal(np.asarray(dec.val), chunks.val)

    def test_placement_consumes_packed_chunks(self, rng, weights):
        """pack -> ship -> placement (which decodes) matches the direct
        unpacked path."""
        k, b = weights
        pts, valid = _random_points(rng)
        pts[..., 3] = np.rint(pts[..., 3])
        chunks, _ = ve.build_voxel_chunks(pts, valid, GRID, PATCH)
        want = _embed(_jnp(chunks), k, b)
        got = _embed(_jnp(ve.pack_chunk_transport(chunks)), k, b)
        np.testing.assert_allclose(got, want, atol=1e-5)
