"""Attention wrapper (ops/attention.py) against the plain reference.

The wrapper takes [B, T, H, D] (the qkv projection's own layout) and names
its ``jax.nn.dot_product_attention`` implementation by dtype and backend;
``reference_attention`` is the dense [B, H, T, D] oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from intentbev.ops import attention as attn_mod
from intentbev.ops.attention import (
    attention_implementation,
    dot_product_attention,
    padded_seq_len,
    reference_attention,
)


def _qkv(rng, b, t, h, d, dtype=jnp.float32):
    return tuple(jnp.asarray(rng.normal(0, 1, (b, t, h, d)).astype(np.float32), dtype)
                 for _ in range(3))


def _bhtd(x):
    return jnp.swapaxes(x, 1, 2)


def _numpy_attention(q, k, v, kv_len=None):
    """softmax(q k^T / sqrt(d)) v in float64, [B, T, H, D]."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    logits = np.einsum("bthd,bshd->bhts", q, k) / np.sqrt(q.shape[-1])
    if kv_len is not None:
        logits[..., kv_len:] = -np.inf
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhts,bshd->bthd", p, v)


class TestRouting:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.float16])
    def test_cpu_always_xla(self, dtype):
        assert attention_implementation(dtype) == "xla"

    @pytest.mark.parametrize("dtype,route", [
        (jnp.bfloat16, "cudnn"), (jnp.float16, "cudnn"), (jnp.float32, "xla"),
    ])
    def test_gpu_route_by_dtype(self, monkeypatch, dtype, route):
        monkeypatch.setattr(attn_mod.jax, "default_backend", lambda: "gpu")
        assert attention_implementation(dtype) == route

    @pytest.mark.parametrize("backend,dtype,t,want", [
        ("cpu", jnp.bfloat16, 4501, 4501),
        ("gpu", jnp.float32, 4501, 4501),
        ("gpu", jnp.bfloat16, 4501, 4502),
        ("gpu", jnp.bfloat16, 4608, 4608),
    ])
    def test_padded_seq_len(self, monkeypatch, backend, dtype, t, want):
        monkeypatch.setattr(attn_mod.jax, "default_backend", lambda: backend)
        assert padded_seq_len(t, dtype) == want

    def test_implementation_is_always_named(self, monkeypatch):
        """The wrapper never leaves the choice to jax (implementation=None)."""
        seen = []
        real = jax.nn.dot_product_attention

        def spy(*a, implementation=None, **kw):
            seen.append(implementation)
            return real(*a, implementation=implementation, **kw)

        monkeypatch.setattr(attn_mod.jax.nn, "dot_product_attention", spy)
        q = jnp.ones((1, 4, 2, 8))
        dot_product_attention(q, q, q)
        assert seen == ["xla"]


class TestForward:
    @pytest.mark.parametrize("shape", [
        (1, 5, 1, 8), (2, 17, 3, 8), (2, 33, 2, 16), (1, 97, 6, 64),
    ])
    @pytest.mark.parametrize("dtype,atol", [(jnp.float32, 2e-5), (jnp.bfloat16, 3e-2)])
    def test_matches_reference(self, rng, shape, dtype, atol):
        q, k, v = _qkv(rng, *shape, dtype=dtype)
        got = dot_product_attention(q, k, v)
        want = _bhtd(reference_attention(_bhtd(q), _bhtd(k), _bhtd(v)))
        assert got.shape == shape and got.dtype == dtype
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), atol=atol)

    @pytest.mark.parametrize("kv_len", [1, 7, 32, 33])
    def test_kv_len_masks_padded_keys(self, rng, kv_len):
        q, k, v = _qkv(rng, 2, 33, 2, 8)
        got = np.asarray(dot_product_attention(q, k, v, kv_len=kv_len))
        np.testing.assert_allclose(got, _numpy_attention(q, k, v, kv_len), atol=2e-5)
        want_ref = _bhtd(reference_attention(_bhtd(q), _bhtd(k), _bhtd(v),
                                             kv_len=kv_len))
        np.testing.assert_allclose(got, np.asarray(want_ref), atol=2e-5)

    def test_padded_keys_do_not_leak(self, rng):
        """Garbage in the padded tail changes nothing in the real rows."""
        q, k, v = _qkv(rng, 1, 20, 2, 8)
        k2 = k.at[:, 15:].set(1e3)
        v2 = v.at[:, 15:].set(-1e3)
        a = dot_product_attention(q, k, v, kv_len=15)
        b = dot_product_attention(q, k2, v2, kv_len=15)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    @pytest.mark.parametrize("d", [8, 16, 64])
    def test_scale_is_inverse_sqrt_head_dim(self, rng, d):
        q, k, v = _qkv(rng, 1, 9, 2, d)
        np.testing.assert_allclose(np.asarray(dot_product_attention(q, k, v)),
                                   _numpy_attention(q, k, v), atol=2e-5)

    def test_heads_are_independent(self, rng):
        """Layout check: head h of the output depends on head h only."""
        q, k, v = _qkv(rng, 1, 12, 3, 8)
        full = np.asarray(dot_product_attention(q, k, v))
        one = np.asarray(dot_product_attention(q[:, :, 1:2], k[:, :, 1:2], v[:, :, 1:2]))
        np.testing.assert_allclose(full[:, :, 1:2], one, atol=1e-6)

    def test_reference_attention_highest_precision(self, rng):
        q, k, v = (_bhtd(x) for x in _qkv(rng, 1, 10, 2, 8))
        a = reference_attention(q, k, v, precision=jax.lax.Precision.HIGHEST)
        np.testing.assert_allclose(np.asarray(_bhtd(a)),
                                   _numpy_attention(_bhtd(q), _bhtd(k), _bhtd(v)),
                                   atol=1e-5)


class TestGradient:
    @pytest.mark.parametrize("kv_len", [None, 11])
    def test_grad_matches_reference(self, rng, kv_len):
        q, k, v = _qkv(rng, 2, 16, 2, 8)
        w = jnp.asarray(rng.normal(0, 1, q.shape).astype(np.float32))

        def loss_wrapper(q, k, v):
            return jnp.sum(dot_product_attention(q, k, v, kv_len=kv_len) * w)

        def loss_ref(q, k, v):
            o = reference_attention(_bhtd(q), _bhtd(k), _bhtd(v), kv_len=kv_len)
            return jnp.sum(_bhtd(o) * w)

        g1 = jax.grad(loss_wrapper, argnums=(0, 1, 2))(q, k, v)
        g2 = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        for a, b in zip(g1, g2):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)

    def test_masked_keys_get_zero_grad(self, rng):
        q, k, v = _qkv(rng, 1, 12, 2, 8)
        gk, gv = jax.grad(
            lambda k, v: jnp.sum(dot_product_attention(q, k, v, kv_len=9) ** 2),
            argnums=(0, 1))(k, v)
        assert np.all(np.asarray(gk)[:, 9:] == 0)
        assert np.all(np.asarray(gv)[:, 9:] == 0)


class TestModelPadding:
    """The ViT pads its token axis once when the route needs an even
    length (cuDNN); the padded run must equal the unpadded one."""

    @pytest.mark.parametrize("train", [False, True])
    def test_padded_encoder_matches_unpadded(self, monkeypatch, rng, train):
        import intentbev.models.vit as vit_mod
        from intentbev.configs import tiny_test_config

        cfg = tiny_test_config().vit
        enc = vit_mod.ViTEncoder(cfg, in_channels=3)
        variables = enc.init(jax.random.key(0))
        x = jnp.asarray(rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32))
        key = {"dropout": jax.random.key(1)}
        want = enc.apply(variables, x, train=train, rngs=key)
        monkeypatch.setattr(vit_mod, "padded_seq_len", lambda t, dtype: t + 3)
        got = enc.apply(variables, x, train=train, rngs=key)
        assert got.shape == want.shape == (2, 1 + cfg.num_patches, cfg.embed_dim)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)
