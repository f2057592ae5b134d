"""On-device fixed-shape NMS and detection post-processing.

Replaces the reference's host round-trip through ``torchvision.ops.nms``
(utils.py:259-274) with a jit-compilable greedy NMS: confidence filter ->
top-K candidate selection -> K x K IoU matrix -> sequential suppression scan
-> fixed ``max_detections`` output with a validity mask. Everything stays on
device; eval loops never bounce to host (the reference pulls ``.cpu()`` per
sample, eval_cnn.py:181-183).

Box-to-rect conversion for suppression deliberately ignores heading (w along
x, l along y), matching reference utils.py:267-272.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .codec import decode_boxes
from .iou import axis_aligned_iou

NEG_INF = -1e9


class Detections(NamedTuple):
    """Fixed-size per-sample detections, sorted by descending score.

    ``num_conf``/``num_kept`` audit the fixed-shape truncation caps that the
    reference's dynamic lists don't have (eval_cnn.py:167-183 keeps every
    anchor above the confidence threshold): ``num_conf > max_pre_nms`` or
    ``num_kept > max_detections`` means a cap bound and this sample's
    detection set differs from the uncapped reference definition. The eval
    CLI counts and reports these (``pre_nms_overflow``/``det_overflow``).
    """

    boxes_xywha: jnp.ndarray  # f32[max_det, 5]
    scores: jnp.ndarray       # f32[max_det]
    intentions: jnp.ndarray   # i32[max_det]
    valid: jnp.ndarray        # bool[max_det]
    num_conf: jnp.ndarray     # i32[] anchors above the confidence threshold
    num_kept: jnp.ndarray     # i32[] NMS survivors (pre max_detections cut)

    @property
    def num_valid(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32))


def greedy_nms_mask(
    boxes_xywha: jnp.ndarray,
    scores_sorted_valid: jnp.ndarray,
    iou_threshold: float,
) -> jnp.ndarray:
    """Greedy NMS over score-sorted candidates.

    Args:
      boxes_xywha: f32[K, 5] candidates already sorted by descending score.
      scores_sorted_valid: bool[K] validity of each candidate.
      iou_threshold: suppress a candidate whose IoU with an earlier kept
        candidate is strictly greater than this (torchvision semantics).

    Returns bool[K] keep mask.
    """
    k = boxes_xywha.shape[0]
    # Axis-aligned rects ignoring heading — parity with utils.py:267-272.
    iou = axis_aligned_iou(boxes_xywha[:, :4], boxes_xywha[:, :4])
    idx = jnp.arange(k)
    # overlap[j, i]: candidate j (earlier in score order) suppresses i
    overlap = (iou > iou_threshold) & (idx[:, None] < idx[None, :])

    # Exact greedy NMS as a fixpoint iteration instead of a K-step sequential
    # scan: keep <- valid & ~any_j(overlap[j, i] & keep[j]). After t
    # iterations the first t positions are exactly the greedy result (each
    # position depends only on earlier positions from the previous iterate),
    # so the loop terminates at a fixpoint == the sequential greedy answer —
    # typically within the suppression-chain depth (a handful of iterations)
    # rather than K. This removes the dominant sequential bottleneck of the
    # on-device postprocess.
    def cond(carry):
        keep, prev, it = carry
        return (it < k) & jnp.any(keep != prev)

    def body(carry):
        keep, _, it = carry
        suppressed = jnp.any(overlap & keep[:, None], axis=0)
        return scores_sorted_valid & ~suppressed, keep, it + 1

    keep0 = scores_sorted_valid
    keep, _, _ = jax.lax.while_loop(
        cond, body, (keep0, jnp.zeros_like(keep0), jnp.int32(0))
    )
    return keep


def postprocess_detections(
    cls_logits: jnp.ndarray,
    box_deltas: jnp.ndarray,
    intent_logits: jnp.ndarray,
    anchors: jnp.ndarray,
    *,
    confidence_threshold: float = 0.1,
    nms_iou_threshold: float = 0.2,
    max_pre_nms: int = 1024,
    max_detections: int = 128,
    approx_topk: bool = False,
) -> Detections:
    """Single-sample decode -> confidence filter -> NMS -> fixed-size output.

    Mirrors the reference eval post-process pipeline (eval_cnn.py:158-183):
    sigmoid -> conf >= 0.1 -> decode vs anchors -> NMS @ IoU 0.2 ->
    argmax intention of surviving anchors.

    Args:
      cls_logits: f32[N, 1] or f32[N] objectness logits over all anchors.
      box_deltas: f32[N, 6].
      intent_logits: f32[N, C].
      anchors: f32[N, 5].
      approx_topk: use the partial-reduction top-k
        (jax.lax.approx_max_k) for candidate selection instead of the exact
        sort — the serving-path choice (bench/streaming inference). In the
        common regime (fewer than max_pre_nms anchors above the confidence
        threshold) misses only fill slots; the parity eval CLI keeps the
        exact sort.
    """
    scores = jax.nn.sigmoid(cls_logits.reshape(-1))
    conf_ok = scores >= confidence_threshold
    masked_scores = jnp.where(conf_ok, scores, NEG_INF)

    if approx_topk:
        top_scores, top_idx = jax.lax.approx_max_k(
            masked_scores, max_pre_nms, recall_target=0.95,
            aggregate_to_topk=True,
        )
    else:
        top_scores, top_idx = jax.lax.top_k(masked_scores, max_pre_nms)
    top_valid = top_scores > NEG_INF / 2

    top_deltas = box_deltas[top_idx]
    top_anchors = anchors[top_idx]
    top_intent = intent_logits[top_idx]
    top_boxes = decode_boxes(top_deltas, top_anchors)

    keep = greedy_nms_mask(top_boxes, top_valid, nms_iou_threshold)

    # Select the first max_detections kept candidates, preserving score order.
    kept_rank = jnp.cumsum(keep.astype(jnp.int32)) - 1  # rank among kept
    slot = jnp.where(keep, kept_rank, max_detections)   # overflow -> dropped
    slot = jnp.minimum(slot, max_detections)            # clamp for scatter

    out_boxes = jnp.zeros((max_detections + 1, 5), dtype=top_boxes.dtype)
    out_scores = jnp.zeros((max_detections + 1,), dtype=scores.dtype)
    out_intent = jnp.zeros((max_detections + 1,), dtype=jnp.int32)
    out_valid = jnp.zeros((max_detections + 1,), dtype=bool)

    out_boxes = out_boxes.at[slot].set(top_boxes, mode="drop")
    out_scores = out_scores.at[slot].set(top_scores, mode="drop")
    out_intent = out_intent.at[slot].set(
        jnp.argmax(top_intent, axis=-1).astype(jnp.int32), mode="drop"
    )
    out_valid = out_valid.at[slot].set(keep, mode="drop")

    return Detections(
        boxes_xywha=out_boxes[:max_detections],
        scores=jnp.where(out_valid[:max_detections], out_scores[:max_detections], 0.0),
        intentions=out_intent[:max_detections],
        valid=out_valid[:max_detections],
        num_conf=jnp.sum(conf_ok.astype(jnp.int32)),
        num_kept=jnp.sum(keep.astype(jnp.int32)),
    )


def batched_postprocess(
    cls_logits: jnp.ndarray,
    box_deltas: jnp.ndarray,
    intent_logits: jnp.ndarray,
    anchors: jnp.ndarray,
    **kwargs,
) -> Detections:
    """vmap of :func:`postprocess_detections` over the batch dimension."""
    fn = lambda c, b, i: postprocess_detections(c, b, i, anchors, **kwargs)
    return jax.vmap(fn)(cls_logits, box_deltas, intent_logits)
