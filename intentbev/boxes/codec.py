"""Box delta codec: encode GT boxes against anchors, decode predictions.

6-parameter delta codec (dx, dy, dw, dl, sin dh, cos dh). The centre deltas
are scaled by anchor *width* for x and anchor *length* for y — this
asymmetric scaling is deliberate parity with the reference
(decode: utils.py:244-257; encode: loss.py:117-125).

Pure jnp; traces under jit/vmap and runs on any backend.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-6


def encode_boxes(gt_xywha: jnp.ndarray, anchors_xywha: jnp.ndarray) -> jnp.ndarray:
    """Encode GT boxes [..., 5] against anchors [..., 5] -> deltas [..., 6].

    Reference loss.py:117-125.
    """
    gx, gy, gw, gl, gh = jnp.moveaxis(gt_xywha, -1, 0)
    ax, ay, aw, al, ah = jnp.moveaxis(anchors_xywha, -1, 0)
    dx = (gx - ax) / (aw + _EPS)
    dy = (gy - ay) / (al + _EPS)
    dw = jnp.log(gw / (aw + _EPS) + _EPS)
    dl = jnp.log(gl / (al + _EPS) + _EPS)
    dh_sin = jnp.sin(gh - ah)
    dh_cos = jnp.cos(gh - ah)
    return jnp.stack([dx, dy, dw, dl, dh_sin, dh_cos], axis=-1)


def decode_boxes(deltas: jnp.ndarray, anchors_xywha: jnp.ndarray) -> jnp.ndarray:
    """Decode deltas [..., 6] against anchors [..., 5] -> boxes [..., 5].

    Reference utils.py:227-257 (``decode_box_predictions``).
    """
    dx, dy, dw, dl, d_sin, d_cos = jnp.moveaxis(deltas, -1, 0)
    ax, ay, aw, al, ah = jnp.moveaxis(anchors_xywha, -1, 0)
    cx = dx * aw + ax
    cy = dy * al + ay
    w = jnp.exp(dw) * aw
    l = jnp.exp(dl) * al
    h = ah + jnp.arctan2(d_sin, d_cos)
    h = jnp.arctan2(jnp.sin(h), jnp.cos(h))  # wrap to (-pi, pi]
    return jnp.stack([cx, cy, w, l, h], axis=-1)
