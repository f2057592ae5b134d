"""Streaming sharded inference + train resume + class weights."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from intentbev.configs import MeshConfig, tiny_test_config
from intentbev.models import build_model
from intentbev.parallel import StreamingInferencer

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 fake CPU devices"
)


class TestStreamingInference:
    def test_sharded_stream_matches_single_device(self):
        cfg = tiny_test_config()
        cfg = dataclasses.replace(cfg, mesh=MeshConfig(model_parallel=1))
        g = cfg.grid
        model = build_model(cfg)
        rng = np.random.default_rng(0)
        B, S, P = 8, g.lidar_sweeps, 128
        lidar0 = jnp.zeros((1, g.height_px, g.width_px, g.lidar_total_channels))
        map0 = jnp.zeros((1, g.height_px, g.width_px, g.map_channels))
        variables = model.init(jax.random.key(0), lidar0, map0)

        inf = StreamingInferencer(cfg, variables)
        assert inf.batch_multiple == 8

        pts = rng.normal(0, 5, (B, S, P, 4)).astype(np.float32)
        pv = np.ones((B, S, P), bool)
        mapb = rng.uniform(0, 1, (B, g.height_px, g.width_px, g.map_channels)).astype(np.float32)

        det = inf(pts, pv, mapb)
        assert det.boxes_xywha.shape == (B, cfg.eval.max_detections, 5)

        # single-device comparison
        from intentbev.bev.voxelize import voxelize_packed
        from intentbev.boxes.anchors import generate_anchors
        from intentbev.boxes.nms import batched_postprocess

        anchors = jnp.asarray(generate_anchors(g, cfg.anchors))
        lidar = jax.vmap(lambda p, v: voxelize_packed(p, v, g))(
            jnp.asarray(pts), jnp.asarray(pv))
        out = model.apply(variables, lidar, jnp.asarray(mapb))
        det_ref = batched_postprocess(
            out[0], out[1], out[2], anchors,
            confidence_threshold=cfg.eval.confidence_threshold,
            nms_iou_threshold=cfg.eval.nms_iou_threshold,
            max_pre_nms=cfg.eval.max_pre_nms,
            max_detections=cfg.eval.max_detections)
        np.testing.assert_array_equal(det.valid, np.asarray(det_ref.valid))
        np.testing.assert_allclose(det.scores, np.asarray(det_ref.scores), atol=1e-5)


class TestResumeAndWeights:
    def test_resume_continues_from_checkpoint(self, tmp_path):
        from intentbev.data.synthetic import write_synthetic_log
        from intentbev.precompute_labels import run as precompute_run
        from intentbev.train import train

        root = tmp_path / "train"
        root.mkdir()
        write_synthetic_log(root, log_id="resumelog0001", num_frames=8, seed=0)
        precompute_run(str(tmp_path), ["train"], force=True)

        cfg = tiny_test_config()
        grid = dataclasses.replace(cfg.grid, lidar_sweeps=3)
        vit = dataclasses.replace(cfg.vit, lidar_input_channels=grid.lidar_total_channels)
        tr = dataclasses.replace(cfg.train, batch_size=2, num_epochs=1,
                                 log_every_steps=1, checkpoint_every_steps=1000)
        cfg = dataclasses.replace(cfg, grid=grid, vit=vit, train=tr)

        out = tmp_path / "run"
        train(cfg, str(root), str(out), num_workers=1, max_steps=2,
              log_fn=lambda *_: None)
        logs = []
        train(cfg, str(root), str(out), num_workers=1, max_steps=1,
              log_fn=logs.append, resume=True)
        assert any("resumed from step 2" in str(l) for l in logs), logs
        # metrics jsonl written
        lines = (out / "metrics.jsonl").read_text().strip().splitlines()
        assert lines and "loss" in json.loads(lines[0])

    def test_class_weight_computation(self, tmp_path):
        from intentbev.configs import GridConfig
        from intentbev.data.synthetic import write_synthetic_log
        from intentbev.data.argoverse import (
            ArgoverseSampleLoader, ScenarioValidator, build_sequence_index)
        from intentbev.precompute_labels import run as precompute_run
        from intentbev.train import compute_intention_class_weights

        root = tmp_path / "train"
        root.mkdir()
        write_synthetic_log(root, log_id="weightlog0001", num_frames=8, seed=0)
        precompute_run(str(tmp_path), ["train"], force=True)
        grid = GridConfig(height_px=64, width_px=96, lidar_height_channels=4,
                          lidar_sweeps=3)
        v = ScenarioValidator(str(root), verbose=False)
        seqs = build_sequence_index(v.find_valid_scenarios(), 3)
        loader = ArgoverseSampleLoader(grid, max_points_per_sweep=1024, max_gt=16,
                                       verbose=False)
        w = compute_intention_class_weights(seqs, loader)
        assert w.shape == (8,)
        np.testing.assert_allclose(w.sum(), 1.0, atol=1e-5)
        # classes absent from data get the highest weight
        assert w.min() > 0
        # bounded startup: the even-stride sample must agree with the full
        # pass when max_sequences >= len(seqs), and a strict subsample must
        # still produce a valid normalised weight vector
        w_full = compute_intention_class_weights(seqs, loader, max_sequences=None)
        np.testing.assert_allclose(w, w_full, atol=1e-6)
        w_sub = compute_intention_class_weights(seqs, loader, max_sequences=2)
        assert w_sub.shape == (8,) and abs(float(w_sub.sum()) - 1.0) < 1e-5


class TestChunkTransport:
    def test_chunks_transport_matches_points(self):
        """transport='chunks' (host chunk build + device placement)
        produces the same detections as the dense points transport."""

        cfg = tiny_test_config()
        cfg = dataclasses.replace(cfg, mesh=MeshConfig(model_parallel=1))
        g = cfg.grid
        model = build_model(cfg)
        rng = np.random.default_rng(1)
        B, S, P = 8, g.lidar_sweeps, 128
        lidar0 = jnp.zeros((1, g.height_px, g.width_px, g.lidar_total_channels))
        map0 = jnp.zeros((1, g.height_px, g.width_px, g.map_channels))
        variables = model.init(jax.random.key(0), lidar0, map0)

        pts = np.zeros((B, S, P, 4), np.float32)
        pts[..., 0] = rng.uniform(-10, 2, (B, S, P))
        pts[..., 1] = rng.uniform(-9, 9, (B, S, P))
        pts[..., 2] = rng.uniform(-2, 3.7, (B, S, P))
        pts[..., 3] = rng.uniform(0, 255, (B, S, P))
        pv = np.ones((B, S, P), bool)
        mapb = rng.uniform(0, 1, (B, g.height_px, g.width_px, g.map_channels)).astype(np.float32)

        det_pts = StreamingInferencer(cfg, variables)(pts, pv, mapb)
        # chunks transport on the same 8-device mesh: placement is plain
        # XLA, so it shards like the rest of the program
        inf = StreamingInferencer(cfg, variables, transport="chunks",
                                  num_chunks=64)
        det_chk = inf(pts, pv, mapb)
        np.testing.assert_array_equal(det_chk.valid, det_pts.valid)
        np.testing.assert_allclose(det_chk.scores, det_pts.scores, atol=1e-4)
        np.testing.assert_allclose(det_chk.boxes_xywha, det_pts.boxes_xywha,
                                   atol=1e-3)
