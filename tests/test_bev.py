"""Tests for voxelizer, rasterizer, and device-side augmentations."""

import dataclasses

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from intentbev.configs import AugmentConfig, GridConfig, INTENTIONS_MAP
from intentbev.bev.voxelize import pack_points, voxelize_numpy, voxelize_packed
from intentbev.bev.rasterize import (
    LaneSegment,
    MapElements,
    draw_polyline,
    fill_polygon,
    rasterize_map_ego_centric,
)
from intentbev.bev.augment import augment_bev


SMALL_GRID = GridConfig(height_px=64, width_px=96, lidar_height_channels=4, lidar_sweeps=2)


def _edge_points(grid: GridConfig, rng) -> np.ndarray:
    """f32[2, P, 4] points on and one ulp either side of every cell edge
    (x, y and z), where ``floor(offset + y / voxel)`` binned differently
    on host and device."""
    v = grid.voxel_size_m
    xs = grid.pixel_offset_y * v - np.arange(grid.height_px + 1) * v
    ys = -grid.pixel_offset_x * v + np.arange(grid.width_px + 1) * v
    zs = grid.z_min + np.arange(grid.lidar_height_channels + 1) * (
        (grid.z_max - grid.z_min) / grid.lidar_height_channels)

    def around(e):
        e = e.astype(np.float32)
        return np.concatenate([np.nextafter(e, -np.inf), e, np.nextafter(e, np.inf)])

    x, y, z = around(xs), around(ys), around(zs)
    n = 3 * max(x.size, y.size)
    pts = np.stack([rng.permutation(np.resize(x, n)), rng.permutation(np.resize(y, n)),
                    np.resize(z, n), rng.integers(1, 256, n)], -1).astype(np.float32)
    return np.stack([pts, pts[::-1]])


class TestVoxelizer:
    @pytest.mark.parametrize("path", ["jit", "cells", "native"])
    def test_edge_points_bin_alike_everywhere(self, rng, path):
        """Points on cell edges land in the same cell on every path: the
        numpy oracle, the jitted device voxelizer, the host cell dedup and
        the C++ twin."""
        from intentbev.bev.voxelize import dedup_cells_host, voxelize_cells

        grid = SMALL_GRID
        pts = _edge_points(grid, rng)
        valid = np.ones(pts.shape[:2], bool)
        want = voxelize_numpy([p[:, :3] for p in pts], [p[:, 3] for p in pts], grid)
        assert np.count_nonzero(want) > 1000
        if path == "jit":
            got = np.asarray(voxelize_packed(jnp.asarray(pts), jnp.asarray(valid), grid))
        elif path == "cells":
            ids, vals = dedup_cells_host(pts, valid, grid)
            got = np.asarray(voxelize_cells(jnp.asarray(ids), jnp.asarray(vals), grid))
        else:
            from intentbev.utils.native import NATIVE_AVAILABLE, voxelize_sweep_native
            if not NATIVE_AVAILABLE:
                pytest.skip("native lib unavailable")
            got = np.zeros_like(want)
            for i in range(2):
                assert voxelize_sweep_native(
                    got, pts[i], i, grid.lidar_height_channels, grid.voxel_size_m,
                    grid.pixel_offset_x, grid.pixel_offset_y, grid.z_min, grid.z_max)
        np.testing.assert_array_equal(got, want)

    def test_device_matches_numpy_oracle(self, rng):
        grid = SMALL_GRID
        pts_list, int_list = [], []
        for _ in range(2):
            n = 500
            pts = np.stack([
                rng.uniform(-15, 10, n),   # x in/out of range
                rng.uniform(-12, 12, n),
                rng.uniform(-3, 5, n),     # z crosses gates
            ], axis=1).astype(np.float32)
            pts_list.append(pts)
            int_list.append(rng.uniform(0, 255, n).astype(np.float32))
        want = voxelize_numpy(pts_list, int_list, grid)
        packed, valid = pack_points(pts_list, int_list, 2, 512)
        got = np.asarray(voxelize_packed(jnp.asarray(packed), jnp.asarray(valid), grid))
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_cell_transport_matches_packed(self, rng):
        """Host dedup (sorted-unique per-cell max) + device unique/sorted
        scatter must reproduce voxelize_packed bitwise — bf16 cast commutes
        with max, so host f32 reduction then cast equals device bf16 max."""
        from intentbev.bev.voxelize import dedup_cells_host, voxelize_cells

        grid = SMALL_GRID
        pts = np.stack([
            rng.uniform(-15, 10, (2, 512)),
            rng.uniform(-12, 12, (2, 512)),
            rng.uniform(-3, 5, (2, 512)),
            rng.uniform(0, 255, (2, 512)),
        ], axis=-1).astype(np.float32)
        valid = rng.uniform(0, 1, (2, 512)) < 0.9
        for out_dtype in (jnp.float32, jnp.bfloat16):
            want = np.asarray(voxelize_packed(
                jnp.asarray(pts), jnp.asarray(valid), grid, out_dtype=out_dtype))
            ids, vals = dedup_cells_host(pts, valid, grid)
            assert ids.shape == vals.shape == (2 * 512,)
            assert np.all(np.diff(ids.astype(np.int64)) > 0), "ids sorted+unique"
            got = np.asarray(voxelize_cells(
                jnp.asarray(ids), jnp.asarray(vals), grid, out_dtype=out_dtype))
            np.testing.assert_array_equal(got, want)

        # all-invalid sample -> empty BEV, padding ids only
        ids, vals = dedup_cells_host(pts, np.zeros_like(valid), grid)
        got = np.asarray(voxelize_cells(jnp.asarray(ids), jnp.asarray(vals), grid))
        assert got.sum() == 0

    def test_u8_out_dtype_exact_for_integral_intensity(self, rng):
        """u8 serving target (kept as a transport option): exact vs the f32 oracle when intensities
        are integral, and invalid/out-of-range points still dropped."""
        grid = SMALL_GRID
        n = 400
        pts = np.stack([
            rng.uniform(-15, 10, n),
            rng.uniform(-12, 12, n),
            rng.uniform(-3, 5, n),
        ], axis=1).astype(np.float32)
        inten = rng.integers(0, 256, n).astype(np.float32)
        want = voxelize_numpy([pts], [inten], grid, num_expected_sweeps=1)
        packed, valid = pack_points([pts], [inten], 1, 512)
        got = np.asarray(voxelize_packed(
            jnp.asarray(packed), jnp.asarray(valid), grid,
            out_dtype=jnp.uint8))
        np.testing.assert_array_equal(got.astype(np.float32), want)

    def test_reference_semantics_hand_cases(self):
        grid = SMALL_GRID
        oy, ox = grid.pixel_offset_y, grid.pixel_offset_x  # 48, 48
        pts = np.array([
            [0.0, 0.0, grid.z_min],            # ego origin, lowest bin
            [0.0, 0.0, grid.z_max - 1e-4],     # highest bin
            [0.0, 0.0, grid.z_max],            # excluded (z >= z_max)
            [0.1, -0.1, 0.0],
        ], dtype=np.float32)
        inten = np.array([10.0, 20.0, 99.0, 30.0], dtype=np.float32)
        packed, valid = pack_points([pts], [inten], 1, 8)
        bev = np.asarray(voxelize_packed(jnp.asarray(packed), jnp.asarray(valid), grid))
        row, col = int(oy), int(ox)
        assert bev[row, col, 0] == 10.0
        assert bev[row, col, grid.lidar_height_channels - 1] == 20.0
        assert not (bev == 99.0).any()
        # (0.1, -0.1): col = floor(48 - 0.5) = 47, row = floor(48 - 0.5) = 47
        zi = int(np.floor((0.0 - grid.z_min) / (grid.z_max - grid.z_min) * 4))
        assert bev[47, 47, zi] == 30.0

    def test_max_pooling_and_missing_sweep(self):
        grid = SMALL_GRID
        pts = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0]], dtype=np.float32)
        inten = np.array([5.0, 50.0], dtype=np.float32)
        packed, valid = pack_points([pts, None], [inten, None], 2, 4)
        bev = np.asarray(voxelize_packed(jnp.asarray(packed), jnp.asarray(valid), grid))
        assert bev.max() == 50.0
        # sweep 1 channels all zero
        assert bev[..., grid.lidar_height_channels:].max() == 0.0

    def test_pack_points_subsampling(self, rng):
        pts = rng.normal(0, 5, (100, 3)).astype(np.float32)
        inten = rng.uniform(0, 1, 100).astype(np.float32)
        packed, valid = pack_points([pts], [inten], 1, 32)
        assert valid.sum() == 32

    def test_point_transport_roundtrip(self, rng):
        """i16-cm transport encoding: xyz exact to 5 mm, integer intensity
        exact, f32 passthrough unchanged."""
        from intentbev.bev.voxelize import dequantize_points, quantize_points_cm

        pts = np.zeros((2, 64, 4), np.float32)
        pts[..., 0] = rng.uniform(-75, 75, (2, 64))
        pts[..., 1] = rng.uniform(-75, 75, (2, 64))
        pts[..., 2] = rng.uniform(-3, 4, (2, 64))
        pts[..., 3] = rng.integers(0, 256, (2, 64))
        q = quantize_points_cm(pts)
        assert q.dtype == np.int16
        deq = np.asarray(dequantize_points(jnp.asarray(q)))
        np.testing.assert_allclose(deq[..., :3], pts[..., :3], atol=0.005 + 1e-6)
        np.testing.assert_array_equal(deq[..., 3], pts[..., 3])
        passthrough = np.asarray(dequantize_points(jnp.asarray(pts)))
        np.testing.assert_array_equal(passthrough, pts)


class TestRasterPrimitives:
    def test_fill_polygon_vs_cv2(self, rng):
        for trial in range(5):
            k = rng.integers(3, 8)
            pts = rng.uniform(5, 58, (k, 2)).astype(int)
            mine = np.zeros((64, 64), dtype=np.uint8)
            fill_polygon(mine, pts)
            ref = np.zeros((64, 64), dtype=np.uint8)
            cv2.fillPoly(ref, [pts.reshape(-1, 1, 2).astype(np.int32)], color=1)
            inter = (mine & ref).sum()
            union = (mine | ref).sum()
            if union == 0:
                continue
            assert inter / union > 0.85, f"trial {trial}: IoU {inter/union}"

    def test_draw_polyline_vs_cv2(self, rng):
        pts = np.array([[3, 3], [40, 10], [50, 50], [10, 45]], dtype=np.int32)
        mine = np.zeros((64, 64), dtype=np.uint8)
        draw_polyline(mine, pts)
        ref = np.zeros((64, 64), dtype=np.uint8)
        cv2.polylines(ref, [pts.reshape(-1, 1, 2)], isClosed=False, color=1, thickness=1)
        # Bresenham vs cv2 line rasterization: near-identical; allow 1-px slack
        # by dilating each and requiring mutual coverage.
        kernel = np.ones((3, 3), np.uint8)
        assert (mine & ~cv2.dilate(ref, kernel)).sum() == 0
        assert (ref & ~cv2.dilate(mine, kernel)).sum() == 0


def _square(cx, cy, half):
    return np.array([
        [cx - half, cy - half], [cx + half, cy - half],
        [cx + half, cy + half], [cx - half, cy + half]], dtype=np.float64)


class TestRasterizeMap:
    def _elements(self):
        # straight lane along world x near origin
        xs = np.linspace(-10, 10, 11)
        left = np.stack([xs, np.full_like(xs, 2.0)], axis=1)
        right = np.stack([xs, np.full_like(xs, -2.0)], axis=1)
        lane = LaneSegment(
            left_boundary=left, right_boundary=right,
            is_intersection=True, lane_type="BUS",
            left_mark_type="SOLID_YELLOW", right_mark_type="DASHED_WHITE",
        )
        cw = _square(5.0, 0.0, 1.5)
        return MapElements(lanes=[lane], crosswalks=[cw])

    def test_channels_and_orientation(self):
        grid = SMALL_GRID
        pose = {"tx_m": 0.0, "ty_m": 0.0, "qx": 0, "qy": 0, "qz": 0, "qw": 1}
        out = rasterize_map_ego_centric(self._elements(), pose, grid)
        assert out.shape == (64, 96, 9)
        # lane fill present, intersection & bus mirror it, markings drawn
        assert out[..., 0].sum() > 50
        np.testing.assert_array_equal(out[..., 4], out[..., 0])
        np.testing.assert_array_equal(out[..., 5], out[..., 0])
        assert out[..., 1].sum() > 5 and out[..., 2].sum() > 5
        assert out[..., 8].sum() > 5 and out[..., 6].sum() > 5
        assert out[..., 7].sum() == 0  # no SOLID_WHITE configured
        assert out[..., 3].sum() > 10  # crosswalk
        # lane along +x at y=±2: ego row for x=5,y=0 is oy - 25 = 23, col 48
        assert out[23, 48, 0] == 1.0

    def test_ego_rotation_moves_raster(self):
        grid = SMALL_GRID
        # ego rotated 90 deg (yaw=pi/2): lane along world-x becomes along ego -y
        qz, qw = np.sin(np.pi / 4), np.cos(np.pi / 4)
        pose = {"tx_m": 0.0, "ty_m": 0.0, "qx": 0, "qy": 0, "qz": qz, "qw": qw}
        out = rasterize_map_ego_centric(self._elements(), pose, grid)
        # world (5, 0) -> ego (0, -5): row = oy, col = ox - 25 = 23
        assert out[48, 23, 0] == 1.0
        assert out[23, 48, 0] == 0.0


class TestAugment:
    def _sample(self, rng, grid=SMALL_GRID):
        cl = grid.lidar_total_channels
        lidar = rng.uniform(0, 1, (grid.height_px, grid.width_px, cl)).astype(np.float32)
        mp = rng.uniform(0, 1, (grid.height_px, grid.width_px, grid.map_channels)).astype(np.float32)
        boxes = np.array([[2.0, 1.5, 2.0, 4.0, 0.3]], dtype=np.float32)
        boxes = np.vstack([boxes, np.zeros((3, 5), np.float32)])
        intents = np.array([INTENTIONS_MAP["TURN_LEFT"], 0, 0, 0], dtype=np.int32)
        valid = np.array([True, False, False, False])
        return (jnp.asarray(lidar), jnp.asarray(mp), jnp.asarray(boxes),
                jnp.asarray(intents), jnp.asarray(valid))

    def test_identity_when_disabled(self, rng):
        cfg = AugmentConfig(flip_prob=0, rotate_prob=0, scale_prob=0, dropout_prob=0)
        l, m, b, i, v = self._sample(rng)
        out = augment_bev(l, m, b, i, v, jax.random.key(0), cfg, SMALL_GRID)
        np.testing.assert_array_equal(np.asarray(out.lidar_bev), np.asarray(l))
        np.testing.assert_array_equal(np.asarray(out.map_bev), np.asarray(m))
        np.testing.assert_allclose(np.asarray(out.gt_boxes), np.asarray(b), atol=1e-6)
        np.testing.assert_array_equal(np.asarray(out.gt_intentions), np.asarray(i))

    def test_flip_semantics(self, rng):
        cfg = AugmentConfig(flip_prob=1.0, rotate_prob=0, scale_prob=0, dropout_prob=0)
        l, m, b, i, v = self._sample(rng)
        out = augment_bev(l, m, b, i, v, jax.random.key(0), cfg, SMALL_GRID)
        np.testing.assert_array_equal(np.asarray(out.lidar_bev), np.asarray(l)[:, ::-1])
        box = np.asarray(out.gt_boxes)[0]
        np.testing.assert_allclose(box[1], -1.5, atol=1e-6)
        np.testing.assert_allclose(box[4], -0.3, atol=1e-6)
        assert int(out.gt_intentions[0]) == INTENTIONS_MAP["TURN_RIGHT"]

    def test_rotate_image_gt_consistency(self, rng):
        """Deliberate fix vs reference: image warps about the ego origin, so a
        blob at the GT centre must land at the rotated GT centre."""
        grid = SMALL_GRID
        cfg = AugmentConfig(flip_prob=0, rotate_prob=1.0, rotate_range_deg=(25.0, 25.0),
                            scale_prob=0, dropout_prob=0)
        lidar = np.zeros((grid.height_px, grid.width_px, 2), dtype=np.float32)
        gx, gy = 3.0, 2.0
        r = int(grid.pixel_offset_y - gx / grid.voxel_size_m)
        c = int(grid.pixel_offset_x + gy / grid.voxel_size_m)
        lidar[r - 1 : r + 2, c - 1 : c + 2, 0] = 10.0
        mp = np.zeros((grid.height_px, grid.width_px, grid.map_channels), np.float32)
        boxes = np.zeros((2, 5), np.float32)
        boxes[0] = [gx, gy, 2.0, 2.0, 0.0]
        valid = np.array([True, False])
        gsmall = dataclasses.replace(grid, lidar_height_channels=1, lidar_sweeps=2)
        out = augment_bev(jnp.asarray(lidar), jnp.asarray(mp), jnp.asarray(boxes),
                          jnp.zeros(2, jnp.int32), jnp.asarray(valid),
                          jax.random.key(3), cfg, gsmall)
        nb = np.asarray(out.gt_boxes)[0]
        th = np.deg2rad(25.0)
        np.testing.assert_allclose(nb[0], gx * np.cos(th) - gy * np.sin(th), atol=1e-5)
        np.testing.assert_allclose(nb[1], gx * np.sin(th) + gy * np.cos(th), atol=1e-5)
        np.testing.assert_allclose(nb[4], 0.0 + th, atol=1e-5)
        img = np.asarray(out.lidar_bev)[..., 0]
        rr, cc = np.unravel_index(np.argmax(img), img.shape)
        er = grid.pixel_offset_y - nb[0] / grid.voxel_size_m
        ec = grid.pixel_offset_x + nb[1] / grid.voxel_size_m
        assert abs(rr - er) <= 2 and abs(cc - ec) <= 2, (rr, cc, er, ec)

    def test_scale_image_gt_consistency(self, rng):
        grid = SMALL_GRID
        cfg = AugmentConfig(flip_prob=0, rotate_prob=0, scale_prob=1.0,
                            scale_range=(1.05, 1.05), dropout_prob=0)
        l, m, b, i, v = self._sample(rng)
        out = augment_bev(l, m, b, i, v, jax.random.key(0), cfg, grid)
        nb = np.asarray(out.gt_boxes)[0]
        np.testing.assert_allclose(nb[:4], np.asarray(b)[0, :4] * 1.05, atol=1e-5)
        np.testing.assert_allclose(nb[4], np.asarray(b)[0, 4], atol=1e-6)

    def test_dropout_zeroes_both_streams(self, rng):
        cfg = AugmentConfig(flip_prob=0, rotate_prob=0, scale_prob=0, dropout_prob=1.0)
        l, m, b, i, v = self._sample(rng)
        out = augment_bev(l, m, b, i, v, jax.random.key(1), cfg, SMALL_GRID)
        lo = np.asarray(out.lidar_bev)
        mo = np.asarray(out.map_bev)
        zero_mask_l = (lo == 0).all(axis=-1)
        zero_mask_m = (mo == 0).all(axis=-1)
        assert zero_mask_l.sum() >= 20 * 20  # at least one patch
        np.testing.assert_array_equal(zero_mask_l & zero_mask_m, zero_mask_l)


class TestPointSpaceAugment:
    """The host-params + device-point path (bev.augment draw_aug_params /
    augment_points_gt / aug_linear_matrix) that replaces the 299-channel
    image warp in the train step."""

    def test_gt_math_matches_image_path(self, rng):
        """For any (flip, theta, scale), augment_points_gt's GT transform
        must equal augment_bev's (same reference math, utils.py:406-479)."""
        from intentbev.bev.augment import augment_points_gt

        grid = SMALL_GRID
        boxes = jnp.asarray(
            np.array([[2.0, 1.5, 2.0, 4.0, 0.3], [-1.0, 0.5, 1.5, 3.0, -0.7]],
                     np.float32))
        intents = jnp.asarray(np.array([INTENTIONS_MAP["TURN_LEFT"],
                                        INTENTIONS_MAP["KEEP_LANE"]], np.int32))
        valid = jnp.asarray(np.array([True, True]))
        pts = jnp.asarray(rng.normal(0, 3, (2, 16, 4)).astype(np.float32))

        for fs, theta, s in [(-1.0, 0.4, 1.03), (1.0, -0.25, 0.97), (-1.0, 0.0, 1.0)]:
            params = jnp.asarray(np.array([fs, theta, s], np.float32))
            _, got_boxes, got_intents = augment_points_gt(pts, boxes, intents, valid, params)

            # image-path oracle with forced probabilities
            cfg = AugmentConfig(
                flip_prob=1.0 if fs < 0 else 0.0,
                rotate_prob=1.0, rotate_range_deg=(np.rad2deg(theta), np.rad2deg(theta)),
                scale_prob=1.0, scale_range=(s, s), dropout_prob=0.0,
            )
            cl = grid.lidar_total_channels
            l = jnp.zeros((grid.height_px, grid.width_px, cl))
            m = jnp.zeros((grid.height_px, grid.width_px, grid.map_channels))
            ref = augment_bev(l, m, boxes, intents, valid, jax.random.key(0), cfg, grid)
            np.testing.assert_allclose(
                np.asarray(got_boxes), np.asarray(ref.gt_boxes), atol=1e-5)
            np.testing.assert_array_equal(
                np.asarray(got_intents), np.asarray(ref.gt_intentions))

    def test_points_move_with_gt(self):
        """A point at the GT centre must land at the transformed GT centre."""
        from intentbev.bev.augment import augment_points_gt

        pts = jnp.asarray(np.array([[[2.0, 1.5, 0.5, 10.0]]], np.float32))
        boxes = jnp.asarray(np.array([[2.0, 1.5, 2.0, 4.0, 0.3]], np.float32))
        intents = jnp.zeros((1,), jnp.int32)
        valid = jnp.ones((1,), bool)
        params = jnp.asarray(np.array([-1.0, 0.35, 1.04], np.float32))
        new_pts, new_boxes, _ = augment_points_gt(pts, boxes, intents, valid, params)
        np.testing.assert_allclose(
            np.asarray(new_pts)[0, 0, :2], np.asarray(new_boxes)[0, :2], atol=1e-5)
        # z / intensity untouched
        np.testing.assert_allclose(np.asarray(new_pts)[0, 0, 2:], [0.5, 10.0])

    def test_raster_aug_linear_equals_rotated_pose(self):
        """Rasterizing with aug_linear=R(theta) must equal rasterizing at a
        pose whose yaw is (yaw - theta): the compose is exact, not a warp."""
        from intentbev.bev.augment import aug_linear_matrix
        from intentbev.bev.rasterize import MapElements, LaneSegment, rasterize_map_ego_centric

        grid = SMALL_GRID
        lane = LaneSegment(
            left_boundary=np.array([[0.0, -2.0], [20.0, -2.0]]),
            right_boundary=np.array([[0.0, 2.0], [20.0, 2.0]]),
            is_intersection=False, lane_type="VEHICLE",
            left_mark_type="NONE", right_mark_type="NONE",
        )
        elements = MapElements(lanes=[lane], crosswalks=[])
        theta = 0.3
        # pose with yaw=0
        pose0 = {"tx_m": 0.0, "ty_m": 0.0, "qx": 0.0, "qy": 0.0, "qz": 0.0, "qw": 1.0}
        aug = aug_linear_matrix(np.array([1.0, theta, 1.0], np.float32))
        got = rasterize_map_ego_centric(elements, pose0, grid, aug_linear=aug)
        # pose rotated by -theta: qz = sin(-theta/2), qw = cos(-theta/2)
        pose_r = {"tx_m": 0.0, "ty_m": 0.0, "qx": 0.0, "qy": 0.0,
                  "qz": np.sin(-theta / 2), "qw": np.cos(-theta / 2)}
        want = rasterize_map_ego_centric(elements, pose_r, grid)
        np.testing.assert_array_equal(got, want)

    def test_draw_params_distributions(self):
        from intentbev.bev.augment import draw_aug_params

        cfg = AugmentConfig(flip_prob=0.5, rotate_prob=0.5,
                            rotate_range_deg=(-15, 15),
                            scale_prob=0.5, scale_range=(0.95, 1.05))
        p = draw_aug_params(cfg, np.random.default_rng(0), 4000)
        assert p.shape == (4000, 3)
        assert set(np.unique(p[:, 0])) == {-1.0, 1.0}
        assert 0.4 < (p[:, 0] < 0).mean() < 0.6
        assert np.abs(p[:, 1]).max() <= np.deg2rad(15) + 1e-6
        assert 0.4 < (p[:, 1] != 0).mean() < 0.6
        assert p[:, 2].min() >= 0.95 - 1e-6 and p[:, 2].max() <= 1.05 + 1e-6
        id_rows = (p[:, 0] == 1) & (p[:, 1] == 0) & (p[:, 2] == 1)
        assert id_rows.mean() > 0.05  # identity rows exist


class TestMapTransport:
    """Bit-packed map transport (bev.rasterize.pack/unpack_map_channels)."""

    def test_pack_unpack_roundtrip(self, rng):
        import jax.numpy as jnp
        from intentbev.bev.rasterize import (
            decode_map_transport, pack_map_channels, unpack_map_channels)

        m = (rng.uniform(0, 1, (2, 16, 24, 9)) < 0.3).astype(np.uint8)
        packed = pack_map_channels(m)
        assert packed.shape == (2, 16, 24, 2) and packed.dtype == np.uint8
        out = np.asarray(unpack_map_channels(jnp.asarray(packed), 9, jnp.float32))
        np.testing.assert_array_equal(out, m.astype(np.float32))
        # decode dispatch: packed u8 -> unpack; plain u8 and f32 -> cast
        np.testing.assert_array_equal(
            np.asarray(decode_map_transport(jnp.asarray(packed), 9, jnp.float32)), m)
        np.testing.assert_array_equal(
            np.asarray(decode_map_transport(jnp.asarray(m), 9, jnp.float32)), m)
        np.testing.assert_array_equal(
            np.asarray(decode_map_transport(jnp.asarray(m, jnp.float32), 9, jnp.float32)), m)
