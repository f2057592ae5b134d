"""Edge cases: rotated-IoU eval matching, batch padding, GT overflow, and
adversarial synthetic scenes driven through the full loader -> model -> eval
path: crowds > max_gt_boxes, empty frames mid-log,
overlapping boxes straddling the NMS threshold, sub-threshold clutter floods
— the pathologies real AV2 data would throw at the metric stack."""

import dataclasses
import math

import numpy as np
import pytest
import jax.numpy as jnp

from intentbev.configs import tiny_test_config
from intentbev.data.synthetic import write_synthetic_log
from intentbev.metrics import match_intentions, sample_average_precision
from intentbev.data.pipeline import Batch, pad_batch
from intentbev.precompute_labels import run as precompute_run


class TestRotatedIoUEval:
    def test_rotated_matching_differs_from_axis_aligned(self):
        # a thin box rotated 45 deg barely overlaps its axis-aligned twin's
        # AABB footprint: axis-aligned matching says TP, rotated says FP
        gt = np.zeros((4, 5), np.float32)
        gt[0] = [0.0, 0.0, 1.0, 6.0, 0.0]
        gv = np.zeros(4, bool); gv[0] = True
        pred = np.zeros((8, 5), np.float32)
        pred[0] = [0.0, 0.0, 1.0, 6.0, np.pi / 2]
        pv = np.zeros(8, bool); pv[0] = True

        aa = sample_average_precision(
            jnp.asarray(pred), jnp.asarray(pv), jnp.asarray(gt), jnp.asarray(gv),
            iou_thresholds=(0.5,), use_rotated_iou=False)
        rot = sample_average_precision(
            jnp.asarray(pred), jnp.asarray(pv), jnp.asarray(gt), jnp.asarray(gv),
            iou_thresholds=(0.5,), use_rotated_iou=True)
        # axis-aligned IoU of identical (cx,cy,w,l) = 1.0 -> AP 1;
        # rotated IoU of crossed rectangles = (1*1)/(6+6-1) ~ 0.09 -> AP 0
        assert float(aa.ap[0]) == 1.0
        assert float(rot.ap[0]) == 0.0

    def test_rotated_match_intentions(self):
        gt = np.zeros((4, 5), np.float32)
        gt[0] = [0.0, 0.0, 2.0, 4.0, 0.7]
        gv = np.zeros(4, bool); gv[0] = True
        pred = np.zeros((4, 5), np.float32)
        pred[0] = [0.05, 0.0, 2.0, 4.0, 0.7]
        pv = np.zeros(4, bool); pv[0] = True
        _, _, pair_valid = match_intentions(
            jnp.asarray(pred), jnp.asarray(pv), jnp.zeros(4, jnp.int32),
            jnp.asarray(gt), jnp.asarray(gv), jnp.zeros(4, jnp.int32),
            iou_threshold=0.5, use_rotated_iou=True)
        assert bool(np.asarray(pair_valid)[0])


class TestPadBatch:
    def _batch(self, b):
        return Batch(
            points=np.ones((b, 2, 4, 4), np.float32),
            points_valid=np.ones((b, 2, 4), bool),
            map_bev=np.ones((b, 8, 8, 9), np.float32),
            gt_boxes=np.ones((b, 3, 5), np.float32),
            gt_intentions=np.ones((b, 3), np.int32),
            gt_valid=np.ones((b, 3), bool),
            aug_params=np.tile(np.array([[1.0, 0.0, 1.0]], np.float32), (b, 1)),
        )

    def test_pads_to_size(self):
        padded, valid = pad_batch(self._batch(3), 8)
        assert padded.points.shape[0] == 8
        assert valid.tolist() == [True] * 3 + [False] * 5
        # padding carries zero GT
        assert padded.gt_valid[3:].sum() == 0

    def test_full_batch_passthrough(self):
        b = self._batch(4)
        padded, valid = pad_batch(b, 4)
        assert padded is b
        assert valid.all()


# ---------------------------------------------------------------------------
# Adversarial synthetic scenes through the FULL loader -> model -> eval path.
# The tiny grid covers x in [-3.2, 9.6], y in [-9.6, 9.6] (64x96 @ 0.2 m/px,
# ego at row 48 / col 48); all scripted vehicles sit inside that window.
# ---------------------------------------------------------------------------

def _adv_cfg():
    cfg = tiny_test_config()
    grid = dataclasses.replace(cfg.grid, lidar_sweeps=3)
    vit = dataclasses.replace(
        cfg.vit, lidar_input_channels=grid.lidar_total_channels)
    train = dataclasses.replace(cfg.train, batch_size=2, num_epochs=1,
                                log_every_steps=100,
                                checkpoint_every_steps=1000)
    return dataclasses.replace(cfg, grid=grid, vit=vit, train=train)


def _parked(x, y, yaw=0.0, length=3.0, width=1.6, frames=None):
    v = {"start": (x, y), "velocity": (0.0, 0.0), "yaw": yaw,
         "category": "REGULAR_VEHICLE", "length": length, "width": width}
    if frames is not None:
        v["frames"] = frames
    return v


# 12 parked vehicles in-grid: 4 more than the tiny config's
# loss.max_gt_boxes=8, so GT truncation binds on EVERY frame.
CROWD = [_parked(x, y) for x in (0.0, 4.0, 8.0)
         for y in (-7.5, -4.5, 4.5, 7.5)]


@pytest.fixture(scope="module")
def adv_ckpt(tmp_path_factory):
    """One 2-step checkpoint trained on the crowd log; every eval test
    reuses it (the stress target is the eval stack, not the weights —
    a near-random model is exactly the conf-flood regime)."""
    from intentbev.train import train

    root = tmp_path_factory.mktemp("adv")
    split = root / "train"
    split.mkdir()
    write_synthetic_log(split, log_id="crowdlog00000001", num_frames=10,
                        seed=3, ego_speed=0.0, vehicles=CROWD)
    precompute_run(str(root), ["train"], force=True)
    out = tmp_path_factory.mktemp("advrun")
    train(_adv_cfg(), str(split), str(out), num_workers=2, max_steps=2,
          log_fn=lambda *_: None)
    return out, split


def _assert_metrics_sane(res, num_samples):
    assert res["num_samples"] == num_samples
    for t in (0.5, 0.6, 0.7, 0.8, 0.9):
        m = res[f"mAP@{t:.1f}"]
        assert 0.0 <= m <= 1.0 and math.isfinite(m), res
    for k in ("intention_accuracy", "intention_macro_f1"):
        if k in res:
            assert 0.0 <= res[k] <= 1.0 and math.isfinite(res[k]), res


class TestAdversarialScenes:
    def test_crowd_exceeding_max_gt_is_audited(self, adv_ckpt):
        """12 annotated vehicles vs loss.max_gt_boxes=8: the loader truncates
        GT on every frame (the reference keeps all boxes, utils.py:184-225),
        and the GT-truncation audit must say so; raising the cap past the
        crowd clears it without changing sample count."""
        from intentbev.checkpoint import load_checkpoint
        from intentbev.evaluate import evaluate

        out, split = adv_ckpt
        logs = []
        res = evaluate(str(out), str(split), num_workers=2, log_fn=logs.append)
        _assert_metrics_sane(res, 8)  # 10 frames, 3 sweeps -> 8 windows
        assert res["gt_overflow"] == 8, res
        assert any("GT truncated" in str(x) for x in logs)

        _, cfg = load_checkpoint(str(out))
        roomy = dataclasses.replace(
            cfg, loss=dataclasses.replace(cfg.loss, max_gt_boxes=16))
        res2 = evaluate(str(out), str(split), cfg_override=roomy,
                        num_workers=2, log_fn=lambda *_: None)
        _assert_metrics_sane(res2, 8)
        assert res2["gt_overflow"] == 0, res2

    def test_crowd_training_loss_finite(self, adv_ckpt):
        """The loss path (vmapped padded-GT assignment) on truncated crowds:
        the adv_ckpt fixture already trained 2 steps on the 12-vehicle log
        with max_gt_boxes=8; the checkpoint must hold finite params."""
        from intentbev.checkpoint import load_checkpoint

        out, _ = adv_ckpt
        state, _ = load_checkpoint(str(out))
        import jax

        for leaf in jax.tree.leaves(state["params"]):
            assert np.isfinite(np.asarray(leaf)).all()

    def test_empty_frames_mid_log(self, adv_ckpt, tmp_path):
        """Tracks that drop out mid-log (real AV2: occlusion / out of range)
        leave frames 4-6 with ZERO ground-truth boxes; the loader must emit
        empty-GT samples and eval must apply the no-GT AP edge rules without
        NaNs (reference eval_cnn.py:199-232 edge handling)."""
        from intentbev.data.argoverse import (
            ArgoverseSampleLoader, ScenarioValidator, build_sequence_index)
        from intentbev.evaluate import evaluate

        out, _ = adv_ckpt
        split = tmp_path / "train"
        split.mkdir()
        write_synthetic_log(
            split, log_id="emptymidlog00001", num_frames=10, seed=4,
            ego_speed=0.0,
            vehicles=[_parked(4.0, 4.5, frames=(0, 4)),
                      _parked(4.0, -4.5, frames=(7, 10))],
        )
        precompute_run(str(tmp_path), ["train"], force=True)

        cfg = _adv_cfg()
        scenarios = ScenarioValidator(str(split)).find_valid_scenarios()
        sequences = build_sequence_index(scenarios, cfg.grid.lidar_sweeps)
        loader = ArgoverseSampleLoader(cfg.grid, max_gt=cfg.loss.max_gt_boxes,
                                       verbose=False)
        # sequences are ordered by timestamp; the i-th window's current
        # frame is i + (sweeps-1) = i + 2
        gt_counts = []
        for seq in sequences:
            s = loader.load(seq)
            assert s is not None
            gt_counts.append(int(s.gt_valid.sum()))
        # frames 2-3: vehicle A only; 4-6: EMPTY; 7-9: vehicle B only
        assert gt_counts == [1, 1, 0, 0, 0, 1, 1, 1]

        res = evaluate(str(out), str(split), num_workers=2,
                       log_fn=lambda *_: None)
        _assert_metrics_sane(res, 8)
        assert res["gt_overflow"] == 0

    def test_overlapping_boxes_straddling_nms_threshold(self, adv_ckpt, tmp_path):
        """Two GT pairs whose axis-aligned IoU sits just above (0.25) and
        just below (~0.176) the eval NMS threshold 0.2 — the regime where a
        detector's correct duplicate suppression and correct two-object
        retention are one threshold apart. Assert the loader delivers both
        pairs with the intended IoUs, then run the full eval path on them."""
        from intentbev.boxes.iou import axis_aligned_iou
        from intentbev.data.argoverse import (
            ArgoverseSampleLoader, ScenarioValidator, build_sequence_index)
        from intentbev.evaluate import evaluate

        out, _ = adv_ckpt
        split = tmp_path / "train"
        split.mkdir()
        # Eval IoU is the reference's axis-aligned form (utils.py:276-292):
        # col 2 (w=2.0) is the x extent, col 3 (l=4.5) the y extent, yaw
        # ignored. Two boxes offset dy apart: IoU = 2(4.5-dy)/(18-2(4.5-dy)),
        # which crosses the NMS threshold 0.2 at dy = 3.0.
        # pair 1 at dy=2.8: IoU = 3.4/14.6 ~ 0.233 (> 0.2)
        # pair 2 at dy=3.2: IoU = 2.6/15.4 ~ 0.169 (< 0.2)
        write_synthetic_log(
            split, log_id="overlaplog000001", num_frames=10, seed=5,
            ego_speed=0.0,
            vehicles=[_parked(2.0, 4.0, length=4.5, width=2.0),
                      _parked(2.0, 6.8, length=4.5, width=2.0),
                      _parked(2.0, -4.0, length=4.5, width=2.0),
                      _parked(2.0, -7.2, length=4.5, width=2.0)],
        )
        precompute_run(str(tmp_path), ["train"], force=True)

        cfg = _adv_cfg()
        scenarios = ScenarioValidator(str(split)).find_valid_scenarios()
        sequences = build_sequence_index(scenarios, cfg.grid.lidar_sweeps)
        loader = ArgoverseSampleLoader(cfg.grid, max_gt=cfg.loss.max_gt_boxes,
                                       verbose=False)
        s = loader.load(sequences[0])
        boxes = s.gt_boxes[s.gt_valid]
        assert len(boxes) == 4
        iou = np.array(axis_aligned_iou(
            jnp.asarray(boxes), jnp.asarray(boxes)))  # copy: np.fill_diagonal writes
        np.fill_diagonal(iou, 0.0)
        above = iou[iou > 0.2]
        below = iou[(iou > 0.1) & (iou < 0.2)]
        assert len(above) == 2 and np.allclose(above, 0.233, atol=0.01), iou
        assert len(below) == 2 and np.allclose(below, 0.169, atol=0.01), iou

        res = evaluate(str(out), str(split), num_workers=2,
                       log_fn=lambda *_: None)
        _assert_metrics_sane(res, 8)

    def test_subthreshold_clutter_flood_binds_caps_not_metrics(self, adv_ckpt):
        """A near-random model floods conf>=0.1 on every anchor (the
        early-training pathology): with the tiny caps (max_pre_nms=64 <
        480 anchors) the audit must report the bind on every sample while
        the metrics stay bounded and finite — the reference's uncapped
        lists (eval_cnn.py:167-183) would simply grow."""
        from intentbev.evaluate import evaluate

        out, split = adv_ckpt
        logs = []
        res = evaluate(str(out), str(split), num_workers=2, log_fn=logs.append)
        assert res["pre_nms_overflow"] == 8, res
        assert 0 <= res["det_overflow"] <= 8
        assert any("caps bound" in str(x) for x in logs)
        _assert_metrics_sane(res, 8)
