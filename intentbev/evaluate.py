"""Evaluation CLI: detection mAP + intention metrics, computed on device.

Reproduces the reference eval semantics exactly (eval_cnn.py:33-325, the
canonical variant per SURVEY.md §2 — eval_vit.py intends the same
constants):

- model rebuilt from the checkpoint's embedded config (self-describing
  contract, eval_cnn.py:63-79);
- per sample: sigmoid -> conf >= 0.1 -> decode vs anchors -> NMS @ IoU 0.2
  -> argmax intention of surviving anchors;
- detection mAP: per-sample VOC AP averaged over samples at IoU
  {0.5..0.9}, with the no-pred/no-GT edge rules;
- intention accuracy / macro-F1 / weighted-F1 / per-class F1 over TP
  detections matched at IoU >= 0.5.

Forward + postprocess + AP + matching all run inside one jitted
program per batch; only tiny per-batch accumulators (AP sums and an 8x8
confusion matrix) come back to host. The reference pulls every box to CPU
per sample (eval_cnn.py:181-183).
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .boxes.anchors import generate_anchors
from .boxes.nms import batched_postprocess
from .checkpoint import load_checkpoint
from .configs import ExperimentConfig, INTENTIONS_MAP_REV
from .data.argoverse import ArgoverseSampleLoader, ScenarioValidator, build_sequence_index
from .data.pipeline import batch_iterator, device_prefetch, pad_batch
from .metrics import (
    IntentionConfusion,
    confusion_to_metrics,
    match_intentions,
    sample_average_precision,
)
from .bev.rasterize import decode_map_transport
from .bev.voxelize import dequantize_points, voxelize_packed
from .models import build_model


class EvalAccum(NamedTuple):
    ap_sum: jnp.ndarray      # f32[num_iou]
    num_samples: jnp.ndarray  # i32
    confusion: jnp.ndarray   # i32[C, C]
    # Truncation-cap audit (the reference keeps dynamic uncapped lists,
    # eval_cnn.py:167-183; intentbev's fixed shapes cap at max_pre_nms /
    # max_detections). Nonzero counts mean a cap bound and the metrics
    # deviate from the uncapped reference definition for those samples.
    pre_nms_overflow: jnp.ndarray  # i32 samples with conf-pass > max_pre_nms
    det_overflow: jnp.ndarray      # i32 samples with NMS-kept > max_detections


def make_eval_step(model, cfg: ExperimentConfig, anchors: jnp.ndarray,
                   mesh=None):
    """Jitted eval step; with ``mesh`` the batch is sharded over the 'data'
    axis and the EvalAccum updates become cross-device reductions (the
    per-sample sums over the sharded batch dimension lower to psums under
    GSPMD), so N chips evaluate N batch shards for the price of one.
    SURVEY.md §2.2 'on-device eval collectives'; per-sample semantics are
    identical to the single-device path (eval_cnn.py:199-322)."""
    grid, ev = cfg.grid, cfg.eval
    iou_thresholds = tuple(float(t) for t in ev.detection_iou_thresholds)
    num_classes = cfg.heads.num_intention_classes

    def eval_step_fn(variables, batch, sample_valid, accum: EvalAccum):
        lidar = jax.vmap(lambda p, v: voxelize_packed(p, v, grid))(
            dequantize_points(batch["points"]), batch["points_valid"]
        )
        cls_l, box_d, int_l = model.apply(
            variables, lidar,
            decode_map_transport(batch["map_bev"], grid.map_channels, lidar.dtype),
        )
        det = batched_postprocess(
            cls_l, box_d, int_l, anchors,
            confidence_threshold=ev.confidence_threshold,
            nms_iou_threshold=ev.nms_iou_threshold,
            max_pre_nms=ev.max_pre_nms,
            max_detections=ev.max_detections,
        )

        def per_sample(boxes, valid, intents, gtb, gtv, gti, svalid):
            res = sample_average_precision(
                boxes, valid, gtb, gtv,
                iou_thresholds=iou_thresholds,
                use_rotated_iou=ev.use_rotated_iou,
            )
            p_int, g_int, pair_valid = match_intentions(
                boxes, valid, intents, gtb, gtv, gti,
                iou_threshold=ev.iou_threshold_for_intention_match,
                use_rotated_iou=ev.use_rotated_iou,
            )
            ap = jnp.where(svalid, res.ap, 0.0)
            pair_valid = pair_valid & svalid
            return ap, p_int, g_int, pair_valid

        ap, p_int, g_int, pair_valid = jax.vmap(per_sample)(
            det.boxes_xywha, det.valid, det.intentions,
            batch["gt_boxes"], batch["gt_valid"], batch["gt_intentions"],
            sample_valid,
        )
        conf = IntentionConfusion(accum.confusion)
        conf = conf.update(
            p_int.reshape(-1), g_int.reshape(-1), pair_valid.reshape(-1)
        )
        return EvalAccum(
            ap_sum=accum.ap_sum + jnp.sum(ap, axis=0),
            num_samples=accum.num_samples + jnp.sum(sample_valid.astype(jnp.int32)),
            confusion=conf.matrix,
            pre_nms_overflow=accum.pre_nms_overflow + jnp.sum(
                ((det.num_conf > ev.max_pre_nms) & sample_valid).astype(jnp.int32)
            ),
            det_overflow=accum.det_overflow + jnp.sum(
                ((det.num_kept > ev.max_detections) & sample_valid).astype(jnp.int32)
            ),
        ), det

    def init_accum():
        return EvalAccum(
            ap_sum=jnp.zeros((len(iou_thresholds),), dtype=jnp.float32),
            num_samples=jnp.zeros((), dtype=jnp.int32),
            confusion=jnp.zeros((num_classes, num_classes), dtype=jnp.int32),
            pre_nms_overflow=jnp.zeros((), dtype=jnp.int32),
            det_overflow=jnp.zeros((), dtype=jnp.int32),
        )

    if mesh is None:
        eval_step = jax.jit(eval_step_fn)
    else:
        from .parallel.sharding import batch_sharding, replicated

        b_shard = batch_sharding(mesh, cfg.mesh)
        rep = replicated(mesh)
        batch_shardings = {
            "points": b_shard, "points_valid": b_shard, "map_bev": b_shard,
            "gt_boxes": b_shard, "gt_intentions": b_shard, "gt_valid": b_shard,
            "aug_params": b_shard,  # identity at eval; carried by Batch
        }
        accum_shardings = EvalAccum(ap_sum=rep, num_samples=rep, confusion=rep,
                                    pre_nms_overflow=rep, det_overflow=rep)
        # variables keep the (replicated) sharding the caller device_put them
        # with; detections come back batch-sharded.
        eval_step = jax.jit(
            eval_step_fn,
            in_shardings=(None, batch_shardings, b_shard, accum_shardings),
            out_shardings=(accum_shardings, None),
        )
    return eval_step, init_accum


def evaluate(
    ckpt_dir: str,
    data_dir: str,
    cfg_override: ExperimentConfig | None = None,
    num_workers: int = 4,
    max_batches: int | None = None,
    log_fn=print,
    distributed: bool = False,
    step: int | None = None,
) -> dict:
    """``step``: evaluate a specific retained checkpoint instead of the
    latest — lets a single run directory evidence the metric trend over
    training (e.g. step 250 vs final)."""
    state, cfg = load_checkpoint(ckpt_dir, step=step)
    if cfg_override is not None:
        cfg = cfg_override
    model = build_model(cfg)  # eval mode: f32, no remat
    variables = {"params": state["params"]}
    if state.get("batch_stats"):
        variables["batch_stats"] = state["batch_stats"]
    anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
    mesh = None
    batch_to_device = jax.device_put
    if distributed:
        from .parallel import batch_sharding, create_mesh
        from .parallel.sharding import replicated

        mesh = create_mesh(cfg.mesh)
        data_dim = mesh.devices.shape[0]
        if cfg.eval.batch_size % data_dim != 0:
            raise ValueError(
                f"eval batch_size {cfg.eval.batch_size} not divisible by "
                f"the data axis ({data_dim} of mesh {mesh.devices.shape})"
            )
        log_fn(f"distributed eval: mesh {mesh.devices.shape} (data x model)")
        variables = jax.device_put(variables, replicated(mesh))
        b_shard = batch_sharding(mesh, cfg.mesh)
        batch_to_device = lambda b: jax.device_put(b, b_shard)  # noqa: E731
    eval_step, init_accum = make_eval_step(model, cfg, anchors, mesh=mesh)

    scenarios = ScenarioValidator(data_dir).find_valid_scenarios()
    sequences = build_sequence_index(scenarios, cfg.grid.lidar_sweeps)
    if not sequences:
        raise ValueError(f"no sequences found under {data_dir}")
    log_fn(f"evaluating {len(sequences)} samples from {len(scenarios)} logs")

    loader = ArgoverseSampleLoader(cfg.grid, max_gt=cfg.loss.max_gt_boxes, verbose=False)
    accum = init_accum()
    t0 = time.time()
    n = 0
    it = batch_iterator(sequences, loader, cfg.eval.batch_size, num_workers=num_workers)

    def pad_and_put(batch):
        padded, sample_valid = pad_batch(batch, cfg.eval.batch_size)
        return batch_to_device((padded._asdict(), np.asarray(sample_valid)))

    for bdict, sample_valid in device_prefetch(iter(it), size=2, put=pad_and_put):
        accum, _ = eval_step(variables, bdict, sample_valid, accum)
        n += 1
        if max_batches is not None and n >= max_batches:
            break

    num = max(int(accum.num_samples), 1)
    maps = np.asarray(accum.ap_sum) / num
    results = {"num_samples": int(accum.num_samples)}
    pre_ovf, det_ovf = int(accum.pre_nms_overflow), int(accum.det_overflow)
    results["pre_nms_overflow"] = pre_ovf
    results["det_overflow"] = det_ovf
    # counted loader-side over every sample it produced (prefetch may load
    # slightly past max_batches)
    gt_ovf = loader.gt_overflow_samples
    results["gt_overflow"] = gt_ovf
    log_fn(f"GT-truncation audit: {gt_ovf} samples with more than "
           f"max_gt_boxes={cfg.loss.max_gt_boxes} annotated boxes"
           + (" (GT truncated: recall is understated vs the reference's "
              "uncapped GT — raise loss.max_gt_boxes)" if gt_ovf
              else " (never truncated)"))
    log_fn(f"truncation-cap audit: {pre_ovf} samples above max_pre_nms="
           f"{cfg.eval.max_pre_nms}, {det_ovf} above max_detections="
           f"{cfg.eval.max_detections}"
           + (" (caps bound: metrics deviate from the uncapped reference "
              "definition on those samples — raise eval.max_pre_nms/"
              "max_detections)" if pre_ovf or det_ovf else " (caps never bound)"))
    log_fn(f"--- Detection results ({int(accum.num_samples)} samples, "
           f"{time.time() - t0:.1f}s) ---")
    for t, m in zip(cfg.eval.detection_iou_thresholds, maps):
        log_fn(f"mAP @ IoU={t:.1f}: {m:.4f}")
        results[f"mAP@{t:.1f}"] = float(m)

    im = confusion_to_metrics(accum.confusion)
    n_matched = int(np.asarray(accum.confusion).sum())
    log_fn(f"--- Intention results (on {n_matched} TP detections @ IoU>="
           f"{cfg.eval.iou_threshold_for_intention_match}) ---")
    if n_matched:
        log_fn(f"Overall Accuracy: {float(im['accuracy']):.4f}")
        log_fn(f"F1 (Macro):   {float(im['macro_f1']):.4f}")
        log_fn(f"F1 (Weighted): {float(im['weighted_f1']):.4f}")
        for i, f1 in enumerate(np.asarray(im["per_class_f1"])):
            log_fn(f"  {INTENTIONS_MAP_REV.get(i, i):<20}: {f1:.4f}")
        results.update(
            intention_accuracy=float(im["accuracy"]),
            intention_macro_f1=float(im["macro_f1"]),
            intention_weighted_f1=float(im["weighted_f1"]),
        )
    else:
        log_fn("No TP detections to evaluate intention prediction.")
    return results


def main(argv=None):
    from .utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--rotated_iou", action="store_true",
                   help="exact rotated IoU for AP + intention matching "
                        "(reference EVAL_USE_ROTATED_IOU, eval_cnn.py:29)")
    p.add_argument("--distributed", action="store_true",
                   help="shard eval batches over the 'data' axis of a mesh "
                        "of all visible devices (psum-reduced accumulators)")
    p.add_argument("--platform", default=None)
    p.add_argument("--step", type=int, default=None,
                   help="evaluate this retained checkpoint step (default: latest)")
    args = p.parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    cfg_override = None
    if args.rotated_iou:
        import dataclasses

        from .checkpoint import load_checkpoint

        _, cfg = load_checkpoint(args.ckpt_dir)
        cfg_override = dataclasses.replace(
            cfg, eval=dataclasses.replace(cfg.eval, use_rotated_iou=True)
        )
    evaluate(args.ckpt_dir, args.data_dir, cfg_override=cfg_override,
             num_workers=args.num_workers, max_batches=args.max_batches,
             distributed=args.distributed, step=args.step)


if __name__ == "__main__":
    main()
