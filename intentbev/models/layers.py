"""Plain-JAX layers: parameter initialisers and pure apply functions.

Every layer is two functions: ``init_*`` builds its parameter dict (f32
leaves) and the apply function maps (params, inputs) to outputs in the
compute ``dtype``. Parameter names follow the tree the checkpoints use:
dense/conv ``{kernel, bias}`` (kernels [in, out] and HWIO), LayerNorm and
BatchNorm ``{scale, bias}``, BatchNorm running statistics ``{mean, var}``
in a separate ``batch_stats`` tree.

:class:`Model` carries the ``init`` / ``apply`` contract the training,
evaluation and serving code call on both model families.
"""

from __future__ import annotations

import zlib
from collections.abc import Mapping
from typing import Any

import jax
import jax.numpy as jnp

init_trunc02 = jax.nn.initializers.truncated_normal(stddev=0.02)
init_lecun = jax.nn.initializers.lecun_normal()
# Kaiming-normal fan-out, parity with reference model_cnn.py:102-108
init_kaiming_out = jax.nn.initializers.variance_scaling(2.0, "fan_out", "normal")


def child_key(key: jax.Array, name: str) -> jax.Array:
    """A key for the sub-tree ``name``, independent of its siblings."""
    return jax.random.fold_in(key, zlib.crc32(name.encode()))


def init_dense(key, d_in: int, d_out: int, *, kernel_init=init_lecun,
               bias: bool = True) -> dict:
    p = {"kernel": kernel_init(key, (d_in, d_out), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((d_out,), jnp.float32)
    return p


def init_conv(key, k: int, c_in: int, c_out: int, *, kernel_init=init_lecun,
              bias: bool = True) -> dict:
    p = {"kernel": kernel_init(key, (k, k, c_in, c_out), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((c_out,), jnp.float32)
    return p


def init_layer_norm(d: int) -> dict:
    return {"scale": jnp.ones((d,), jnp.float32),
            "bias": jnp.zeros((d,), jnp.float32)}


def init_batch_norm(c: int) -> tuple[dict, dict]:
    """(params, running statistics)."""
    return init_layer_norm(c), {"mean": jnp.zeros((c,), jnp.float32),
                                "var": jnp.ones((c,), jnp.float32)}


def dense(p: dict, x: jnp.ndarray, dtype) -> jnp.ndarray:
    y = jax.lax.dot_general(
        x.astype(dtype), p["kernel"].astype(dtype),
        (((x.ndim - 1,), (0,)), ((), ())),
    )
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def conv(p: dict, x: jnp.ndarray, dtype, *, stride: int = 1,
         padding: Any = "SAME") -> jnp.ndarray:
    """NHWC convolution with an HWIO kernel."""
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype),
        window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


@jax.named_scope("layer_norm")
def layer_norm(p: dict, x: jnp.ndarray, dtype, eps: float = 1e-6) -> jnp.ndarray:
    """LayerNorm over the last axis: elementwise math in the compute dtype,
    f32 accumulation inside the two reductions only."""
    xb = x.astype(dtype)
    m = jnp.mean(xb, axis=-1, keepdims=True, dtype=jnp.float32)
    xc = xb - m.astype(dtype)
    var = jnp.mean(jax.lax.square(xc), axis=-1, keepdims=True, dtype=jnp.float32)
    inv = jax.lax.rsqrt(var + eps).astype(dtype)
    return xc * inv * p["scale"].astype(dtype) + p["bias"].astype(dtype)


def batch_norm(p: dict, stats: dict, x: jnp.ndarray, dtype, *, train: bool,
               momentum: float = 0.9, eps: float = 1e-5
               ) -> tuple[jnp.ndarray, dict]:
    """BatchNorm over every axis but the last (torch BatchNorm2d semantics).

    ``train``: normalise with the batch statistics (f32, E[x^2] - E[x]^2)
    and return running statistics updated as
    ``momentum * old + (1 - momentum) * batch``; otherwise normalise with
    the running statistics and return them unchanged.
    """
    if train:
        xf = x.astype(jnp.promote_types(dtype, jnp.float32))
        axes = tuple(range(x.ndim - 1))
        mean = xf.mean(axes)
        var = jnp.maximum(0.0, jax.lax.square(xf).mean(axes) - jax.lax.square(mean))
        stats = {
            "mean": momentum * stats["mean"] + (1.0 - momentum) * mean,
            "var": momentum * stats["var"] + (1.0 - momentum) * var,
        }
    else:
        mean, var = stats["mean"], stats["var"]
    y = (x - mean) * (jax.lax.rsqrt(var + eps) * p["scale"]) + p["bias"]
    return y.astype(dtype), stats


def gelu(x: jnp.ndarray) -> jnp.ndarray:
    """Exact (erf) GELU, as torch's nn.GELU default and timm."""
    return jax.nn.gelu(x, approximate=False)


class Model:
    """``init`` / ``apply`` contract of both model families.

    ``init(rngs, *inputs, train=False)`` returns ``{"params": ...}`` plus
    ``"batch_stats"`` when the model has BatchNorm; ``rngs`` is a key or a
    dict with a ``"params"`` key. The inputs are accepted for call-site
    compatibility only: every shape comes from the config.

    ``apply(variables, *inputs, train=False, mutable=(), rngs=None)``
    returns the outputs, or ``(outputs, {"batch_stats": updated})`` when
    ``"batch_stats"`` is in ``mutable``. ``rngs["dropout"]`` drives
    stochastic depth in training.

    Subclasses implement ``init_variables(key) -> (params, stats)`` and
    ``forward(params, stats, *inputs, train, dropout_key) -> (out, stats)``.
    """

    dtype: Any = jnp.float32

    def init_variables(self, key) -> tuple[dict, dict]:
        raise NotImplementedError

    def forward(self, params, stats, *inputs, train: bool, dropout_key):
        raise NotImplementedError

    def init(self, rngs, *inputs, train: bool = False) -> dict:
        del inputs, train
        key = rngs["params"] if isinstance(rngs, Mapping) else rngs
        params, stats = self.init_variables(key)
        out = {"params": params}
        if stats:
            out["batch_stats"] = stats
        return out

    def apply(self, variables, *inputs, train: bool = False,
              mutable=(), rngs=None):
        dropout_key = rngs.get("dropout") if rngs else None
        out, stats = self.forward(
            variables["params"], variables.get("batch_stats", {}), *inputs,
            train=train, dropout_key=dropout_key)
        if "batch_stats" in (mutable or ()):
            return out, {"batch_stats": stats}
        return out
