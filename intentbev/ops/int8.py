"""Int8 serving-path primitives (weights + dynamic activation quantization).

H100 tensor cores run int8 x int8 -> int32 at twice the bf16 rate
(NVIDIA data sheet: 1,979 TOPS vs 989 TFLOP/s dense); whether the
quantisation passes around the matmuls pay for that on this model is not
measured yet. The reference has no quantized path (torch fp32/amp only,
model_vit.py) — this is a new serving capability.

Scheme (standard W8A8 dynamic):
- weights: symmetric per-OUTPUT-channel int8, scale = absmax/127, computed
  on the fly from the bf16 params (cheap: weights are tiny next to the
  activations; XLA hoists the quantization of loop-invariant weights).
- activations: symmetric per-ROW (per-token) dynamic int8.
- accumulate int32, rescale in f32, bias in f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def quantize_rows(x: jnp.ndarray, eps: float = 1e-8) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Symmetric per-row int8: returns (q, scale) with x ~= q * scale.

    Rows are the leading axes; the scale has x.shape[:-1] + (1,).
    """
    absmax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    scale = jnp.maximum(absmax.astype(jnp.float32), eps) / 127.0
    q = jnp.clip(jnp.round(x.astype(jnp.float32) / scale), -127, 127).astype(jnp.int8)
    return q, scale


def quantize_cols(w: jnp.ndarray, eps: float = 1e-8) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Symmetric per-output-channel int8 for a [d_in, d_out] weight."""
    absmax = jnp.max(jnp.abs(w), axis=0, keepdims=True)
    scale = jnp.maximum(absmax.astype(jnp.float32), eps) / 127.0
    q = jnp.clip(jnp.round(w.astype(jnp.float32) / scale), -127, 127).astype(jnp.int8)
    return q, scale


def int8_dense(
    x: jnp.ndarray, w: jnp.ndarray, bias: jnp.ndarray | None = None,
    out_dtype=None,
) -> jnp.ndarray:
    """y = x @ w (+ bias) through an int8 matmul.

    x [..., d_in] (any float dtype), w [d_in, d_out] float params. Output in
    ``out_dtype`` (defaults to x.dtype). Relative error ~1% on normal data.
    """
    out_dtype = out_dtype or x.dtype
    xq, xs = quantize_rows(x)
    wq, ws = quantize_cols(w)
    y = jax.lax.dot_general(
        xq, wq, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32)
    y = y * xs * ws
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(out_dtype)
