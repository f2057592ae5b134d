"""Chunk train transport: host-side augmentation + chunk build must
reproduce the device path (augment_points_gt -> voxelize_packed)
cell-for-cell, and the train step must run end to end on ChunkBatch
inputs."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from intentbev.bev.augment import (
    augment_gt,
    augment_points_gt,
    augment_points_np,
)
from intentbev.bev.voxelize import voxelize_packed
from intentbev.configs import GridConfig, tiny_test_config
from intentbev.ops import voxel_embed as ve

GRID = GridConfig(height_px=64, width_px=96, lidar_height_channels=4,
                  lidar_sweeps=2)
PATCH = 8

AUG_CASES = [
    np.array([1.0, 0.0, 1.0], np.float32),       # identity
    np.array([-1.0, 0.0, 1.0], np.float32),      # flip only (exact)
    np.array([1.0, 0.2, 1.0], np.float32),       # rotate
    np.array([-1.0, -0.15, 1.03], np.float32),   # all three
]


def _points(rng, s=2, p=2000):
    pts = np.empty((s, p, 4), np.float32)
    pts[..., 0] = rng.uniform(-15, 10, (s, p))
    pts[..., 1] = rng.uniform(-10, 10, (s, p))
    pts[..., 2] = rng.uniform(-2, 3.7, (s, p))
    pts[..., 3] = rng.integers(0, 256, (s, p)).astype(np.float32)
    valid = rng.uniform(size=(s, p)) < 0.95
    return pts, valid


class TestHostAugmentParity:
    @pytest.mark.parametrize("aug", AUG_CASES, ids=["id", "flip", "rot", "all"])
    def test_point_transform_matches_device(self, rng, aug):
        """augment_points_np == the point half of augment_points_gt.
        Flip/scale are exact f32 ops; rotation differs only by cos/sin
        ULPs between numpy and XLA."""
        pts, valid = _points(rng)
        g = np.zeros((4, 5), np.float32)
        gi = np.zeros(4, np.int32)
        gv = np.zeros(4, bool)
        dev_pts, _, _ = augment_points_gt(
            jnp.asarray(pts), jnp.asarray(g), jnp.asarray(gi),
            jnp.asarray(gv), jnp.asarray(aug))
        host_pts = augment_points_np(pts, aug)
        atol = 0.0 if aug[1] == 0.0 else 1e-4
        np.testing.assert_allclose(host_pts, np.asarray(dev_pts), atol=atol)

    @pytest.mark.parametrize("aug", AUG_CASES, ids=["id", "flip", "rot", "all"])
    def test_bev_matches_device_path(self, rng, aug):
        """host aug -> chunks -> pack -> voxel_fill_bev (decodes) equals
        device aug -> voxelize_packed, cell for cell (rotation: up to a
        handful of boundary cells from cos/sin ULP differences)."""
        pts, valid = _points(rng)
        g = np.zeros((4, 5), np.float32)
        gi = np.zeros(4, np.int32)
        gv = np.zeros(4, bool)

        dev_pts, _, _ = augment_points_gt(
            jnp.asarray(pts), jnp.asarray(g), jnp.asarray(gi),
            jnp.asarray(gv), jnp.asarray(aug))
        want = np.asarray(voxelize_packed(dev_pts, jnp.asarray(valid), GRID))

        host_pts = augment_points_np(pts, aug)
        chunks, _ = ve.build_voxel_chunks(host_pts, valid, GRID, PATCH)
        packed = jax.tree_util.tree_map(
            jnp.asarray, ve.pack_chunk_transport(chunks))
        got = np.asarray(ve.voxel_fill_bev(
            packed, (GRID.height_px, GRID.width_px), GRID.lidar_total_channels,
            PATCH, dtype=jnp.float32))[0]

        mismatch = np.count_nonzero(got != want)
        if aug[1] == 0.0:
            assert mismatch == 0
        else:
            # cos/sin ULP differences can flip cells whose rotated
            # coordinate lands within ~1e-5 m of a cell boundary
            assert mismatch <= 8, mismatch

    def test_gt_half_matches_combined(self, rng):
        """augment_gt == the GT half of augment_points_gt (it IS the
        factored implementation; guard the contract)."""
        pts = rng.normal(0, 5, (1, 10, 4)).astype(np.float32)
        boxes = rng.normal(0, 10, (6, 5)).astype(np.float32)
        intents = rng.integers(0, 8, 6).astype(np.int32)
        valid = rng.uniform(size=6) < 0.8
        aug = np.array([-1.0, 0.3, 0.97], np.float32)
        _, b_full, i_full = augment_points_gt(
            jnp.asarray(pts), jnp.asarray(boxes), jnp.asarray(intents),
            jnp.asarray(valid), jnp.asarray(aug))
        b_only, i_only = augment_gt(
            jnp.asarray(boxes), jnp.asarray(intents), jnp.asarray(valid),
            jnp.asarray(aug))
        np.testing.assert_array_equal(np.asarray(b_full), np.asarray(b_only))
        np.testing.assert_array_equal(np.asarray(i_full), np.asarray(i_only))


class TestChunkTrainStep:
    def _cfg(self):
        cfg = tiny_test_config()
        grid = dataclasses.replace(cfg.grid, lidar_sweeps=2)
        vit = dataclasses.replace(
            cfg.vit, lidar_input_channels=grid.lidar_total_channels)
        train = dataclasses.replace(
            cfg.train, batch_size=2, compute_dtype="float32",
            transport="chunks")
        return dataclasses.replace(cfg, grid=grid, vit=vit, train=train)

    def test_train_step_on_chunk_batch(self, rng):
        """One jitted train step on a ChunkBatch-shaped dict: finite loss,
        step increments, and the loss MATCHES the points-path step on the
        identical underlying data (identity aug => same BEV bit-for-bit)."""
        from intentbev.boxes.anchors import generate_anchors
        from intentbev.models import build_model
        from intentbev.train import (
            init_train_state,
            make_optimizer,
            make_train_step,
        )

        cfg = self._cfg()
        g = cfg.grid
        model = build_model(cfg, train_mode=True)
        tx = make_optimizer(cfg)
        anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
        step = make_train_step(model, cfg, anchors, tx)

        B, G = 2, cfg.loss.max_gt_boxes
        pts_list, val_list, ch_list = [], [], []
        for b in range(B):
            pts, valid = _points(rng, s=g.lidar_sweeps, p=1500)
            pts_list.append(pts)
            val_list.append(valid)
            ch_list.append(ve.build_voxel_chunks(
                pts, valid, g, PATCH, num_chunks=256, on_overflow="drop")[0])
        chunks = ve.pack_chunk_transport(ve.stack_voxel_chunks(ch_list))
        mapb = (rng.uniform(0, 1, (B, g.height_px, g.width_px, g.map_channels))
                < 0.05).astype(np.float32)
        gtb = np.zeros((B, G, 5), np.float32)
        gtb[:, 0] = [3.0, 1.0, 2.0, 4.5, 0.0]
        gtv = np.zeros((B, G), bool)
        gtv[:, 0] = True
        common = {
            "map_bev": jnp.asarray(mapb),
            "gt_boxes": jnp.asarray(gtb),
            "gt_intentions": jnp.zeros((B, G), jnp.int32),
            "gt_valid": jnp.asarray(gtv),
            "aug_params": jnp.tile(jnp.asarray([[1.0, 0.0, 1.0]]), (B, 1)),
        }
        batch_chunks = {
            "chunks": jax.tree_util.tree_map(jnp.asarray, chunks), **common}
        batch_points = {
            "points": jnp.asarray(np.stack(pts_list)),
            "points_valid": jnp.asarray(np.stack(val_list)), **common}

        state = init_train_state(model, cfg, tx, jax.random.key(0))
        new_state, m_chunks = jax.tree_util.tree_map(
            np.asarray, step(state, batch_chunks, jax.random.key(1)))
        state2 = init_train_state(model, cfg, tx, jax.random.key(0))
        _, m_points = jax.tree_util.tree_map(
            np.asarray, step(state2, batch_points, jax.random.key(1)))

        assert np.isfinite(m_chunks["loss"])
        assert int(new_state.step) == 1
        np.testing.assert_allclose(
            m_chunks["loss"], m_points["loss"], rtol=1e-5)

    def test_batch_iterator_chunks_end_to_end(self, tmp_path, rng):
        """batch_iterator(transport='chunks') on a synthetic log yields
        ChunkBatch with compact dtypes, and the chunks reproduce the
        points-path BEV through the loader's real augmentation draws."""
        from intentbev.data.argoverse import (
            ArgoverseSampleLoader,
            ScenarioValidator,
            build_sequence_index,
        )
        from intentbev.data.pipeline import ChunkBatch, batch_iterator
        from intentbev.data.synthetic import write_synthetic_log
        from intentbev.precompute_labels import run as precompute_run

        split = tmp_path / "train"
        split.mkdir()
        write_synthetic_log(split, log_id="chunktrain01", num_frames=6,
                            seed=5)
        precompute_run(str(tmp_path), ["train"], force=True)

        cfg = self._cfg()
        loader = ArgoverseSampleLoader(
            cfg.grid, max_points_per_sweep=4096,
            max_gt=cfg.loss.max_gt_boxes, verbose=False)
        seqs = build_sequence_index(
            ScenarioValidator(str(split)).find_valid_scenarios(),
            cfg.grid.lidar_sweeps)
        batches = list(batch_iterator(
            seqs, loader, 2, shuffle=True, seed=3, num_workers=1,
            augment=cfg.augment, transport="chunks", chunk_patch=PATCH,
            chunk_capacity=256))
        assert batches and all(isinstance(b, ChunkBatch) for b in batches)
        cb = batches[0]
        assert cb.chunks.sl.dtype == np.uint16  # compact transport
        assert cb.chunks.val.dtype == np.uint8  # synthetic intensity integral

        # the shipped chunks reproduce the device path on the same sample
        pb = list(batch_iterator(
            seqs, loader, 2, shuffle=True, seed=3, num_workers=1,
            augment=cfg.augment))[0]
        from intentbev.bev.voxelize import dequantize_points

        dev_pts, _, _ = jax.vmap(augment_points_gt)(
            dequantize_points(jnp.asarray(pb.points)),
            jnp.asarray(pb.gt_boxes), jnp.asarray(pb.gt_intentions),
            jnp.asarray(pb.gt_valid), jnp.asarray(pb.aug_params))
        want = np.asarray(jax.vmap(
            lambda p, v: voxelize_packed(p, v, cfg.grid)
        )(dev_pts, jnp.asarray(pb.points_valid)))
        got = np.asarray(ve.voxel_fill_bev(
            jax.tree_util.tree_map(jnp.asarray, cb.chunks),
            (cfg.grid.height_px, cfg.grid.width_px),
            cfg.grid.lidar_total_channels, PATCH, dtype=jnp.float32))
        # points path quantizes to cm for transport; host chunk path uses
        # raw f32 points — identical for the synthetic generator's data up
        # to boundary cells
        frac = np.count_nonzero(got != want) / want.size
        assert frac < 2e-4, frac
