"""Multi-head attention with an explicit, dtype-chosen implementation.

The reference uses timm's dense MHSA, which materialises the full
4501 x 4501 attention matrix per head (reference model_vit.py:119;
SURVEY.md §5 'long-context'). Here attention goes through
``jax.nn.dot_product_attention`` on the qkv projection's own
[B, T, H, D] layout (no head transposes), with the implementation named
by :func:`attention_implementation`:

- ``"cudnn"`` for bf16/fp16 on the GPU: cuDNN's fused flash attention
  (forward and backward; no T x T probabilities are kept for the
  backward pass);
- ``"xla"`` for every other case (f32 serving/eval, the CPU): the dense
  softmax, identical math to :func:`reference_attention`.

Nothing falls back silently: a shape cuDNN refuses is an error.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_CUDNN_DTYPES = (jnp.bfloat16, jnp.float16)


def attention_implementation(dtype) -> str:
    """The ``jax.nn.dot_product_attention`` implementation for ``dtype`` on
    the default backend."""
    if jax.default_backend() == "gpu" and jnp.dtype(dtype) in _CUDNN_DTYPES:
        return "cudnn"
    return "xla"


def padded_seq_len(t: int, dtype) -> int:
    """The token count to run attention at for ``t`` real tokens.

    On the cuDNN route the installed JAX hands its fused-attention
    gradient rule a placeholder bias, which then demands even sequence
    lengths; an odd ``t`` (4501 for the flagship ViT) therefore runs with
    one pad token, masked out of the keys through ``kv_len``.
    """
    if attention_implementation(dtype) == "cudnn":
        return t + t % 2
    return t


def dot_product_attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray, *,
                          kv_len: int | None = None) -> jnp.ndarray:
    """softmax(Q K^T / sqrt(D)) V over [B, T, H, D] tensors.

    ``kv_len``: only the first ``kv_len`` keys are attended (a padded
    tail is masked).
    """
    b, _, _, _ = q.shape
    s = k.shape[1]
    lengths = None
    if kv_len is not None and kv_len < s:
        lengths = jnp.full((b,), kv_len, jnp.int32)
    return jax.nn.dot_product_attention(
        q, k, v, key_value_seq_lengths=lengths,
        implementation=attention_implementation(q.dtype),
    )


def reference_attention(
    q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray, *, softmax_dtype=jnp.float32,
    kv_len: int | None = None, precision=None,
) -> jnp.ndarray:
    """Dense softmax(QK^T / sqrt(d)) V. Shapes: [B, H, T, D].

    The plain reference the routes are checked against. ``kv_len``: only
    the first kv_len keys are attended (padded tail masked).
    """
    d = q.shape[-1]
    scale = 1.0 / jnp.sqrt(jnp.asarray(d, dtype=softmax_dtype))
    logits = jnp.einsum("bhtd,bhsd->bhts", q, k,
                        preferred_element_type=softmax_dtype,
                        precision=precision)
    if kv_len is not None and kv_len < k.shape[-2]:
        mask = jnp.arange(k.shape[-2]) < kv_len
        logits = jnp.where(mask[None, None, None, :], logits, -1e30)
    probs = jax.nn.softmax(logits * scale, axis=-1)
    return jnp.einsum("bhts,bhsd->bhtd", probs.astype(v.dtype), v,
                      precision=precision)
