"""Detection and intention heads (NHWC).

Output-ordering contract (reference heads.py:16-25 <-> utils.py:553-562):
flattened anchor index is ``((h * Wf + w) * A + a)``. In NHWC a single 3x3
conv producing A*(1+6) (resp. A*C) channels followed by
``reshape(B, Hf, Wf, A, P)`` -> ``reshape(B, Hf*Wf*A, P)`` realises exactly
that order — torch needs the explicit permute (heads.py:22), NHWC gets it
for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..configs import HeadConfig
from .layers import child_key, conv, init_conv


def init_heads(key, c_in: int, head_cfg: HeadConfig) -> dict:
    """``det_head`` (reference heads.py:6-25) and ``intention_head``
    (heads.py:27-43): one 3x3 conv each."""
    a = head_cfg.num_anchors
    return {
        "det_head": {"conv": init_conv(
            child_key(key, "det_head"), 3, c_in,
            a * (1 + head_cfg.num_box_params))},
        "intention_head": {"conv": init_conv(
            child_key(key, "intention_head"), 3, c_in,
            a * head_cfg.num_intention_classes)},
    }


def detection_head(p: dict, x: jnp.ndarray, num_anchors: int, dtype
                   ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """3x3 conv -> per-anchor (objectness [B,Hf,Wf,A], box deltas
    [B,Hf,Wf,A,6])."""
    out = conv(p["conv"], x, dtype)
    b, hf, wf, c = out.shape
    out = out.reshape(b, hf, wf, num_anchors, c // num_anchors)
    return out[..., 0], out[..., 1:]


def intention_head(p: dict, x: jnp.ndarray, num_anchors: int, dtype
                   ) -> jnp.ndarray:
    """3x3 conv -> per-anchor intention logits [B,Hf,Wf,A,C]."""
    out = conv(p["conv"], x, dtype)
    b, hf, wf, c = out.shape
    return out.reshape(b, hf, wf, num_anchors, c // num_anchors)


def flatten_head_outputs(
    cls_logits: jnp.ndarray, box_preds: jnp.ndarray, intent_logits: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(B,Hf,Wf,A,·) -> (B, Hf*Wf*A, ·); reference model_cnn.py:145-150."""
    b = cls_logits.shape[0]
    return (
        cls_logits.reshape(b, -1, 1),
        box_preds.reshape(b, -1, box_preds.shape[-1]),
        intent_logits.reshape(b, -1, intent_logits.shape[-1]),
    )


@jax.named_scope("heads")
def apply_heads(p: dict, features: jnp.ndarray, head_cfg: HeadConfig, dtype
                ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Both heads, flattened, logits returned in f32 whatever the compute
    dtype (loss stability)."""
    a = head_cfg.num_anchors
    cls_l, box_p = detection_head(p["det_head"], features, a, dtype)
    int_l = intention_head(p["intention_head"], features, a, dtype)
    return tuple(o.astype(jnp.float32)
                 for o in flatten_head_outputs(cls_l, box_p, int_l))
