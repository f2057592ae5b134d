"""Plain-JAX layers (models/layers.py, models/vit.py blocks) against numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import erf

from intentbev.models import layers as L
from intentbev.models import vit as V


def _ln_np(x, scale, bias, eps=1e-6):
    x = np.asarray(x, np.float64)
    m = x.mean(-1, keepdims=True)
    var = ((x - m) ** 2).mean(-1, keepdims=True)
    return (x - m) / np.sqrt(var + eps) * scale + bias


def _gelu_np(x):
    return 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))


def _dense_p(rng, i, o):
    return {"kernel": jnp.asarray(rng.normal(0, 0.1, (i, o)).astype(np.float32)),
            "bias": jnp.asarray(rng.normal(0, 0.1, o).astype(np.float32))}


class TestLayerNorm:
    @pytest.mark.parametrize("shape", [(4, 32), (2, 7, 384)])
    @pytest.mark.parametrize("dtype,atol", [(jnp.float32, 1e-5), (jnp.bfloat16, 5e-2)])
    def test_matches_numpy(self, rng, shape, dtype, atol):
        d = shape[-1]
        x = rng.normal(1.0, 2.0, shape).astype(np.float32)
        p = {"scale": jnp.asarray(rng.normal(1, 0.1, d).astype(np.float32)),
             "bias": jnp.asarray(rng.normal(0, 0.1, d).astype(np.float32))}
        got = L.layer_norm(p, jnp.asarray(x), dtype)
        assert got.dtype == dtype
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   _ln_np(x, np.asarray(p["scale"]), np.asarray(p["bias"])),
                                   atol=atol)

    def test_grad_matches_numeric(self, rng):
        x = jnp.asarray(rng.normal(0, 1, (3, 16)).astype(np.float32))
        p = L.init_layer_norm(16)
        f = lambda x: jnp.sum(jnp.sin(L.layer_norm(p, x, jnp.float32)))  # noqa: E731
        from jax.test_util import check_grads
        check_grads(f, (x,), order=1, modes=("rev",), atol=1e-2, rtol=1e-2)


class TestDenseConvGelu:
    def test_dense_matches_numpy(self, rng):
        p = _dense_p(rng, 12, 5)
        x = rng.normal(0, 1, (3, 4, 12)).astype(np.float32)
        want = x @ np.asarray(p["kernel"]) + np.asarray(p["bias"])
        np.testing.assert_allclose(np.asarray(L.dense(p, jnp.asarray(x), jnp.float32)),
                                   want, atol=1e-5)

    def test_dense_without_bias(self, rng):
        p = {"kernel": jnp.asarray(rng.normal(0, 1, (4, 3)).astype(np.float32))}
        x = rng.normal(0, 1, (2, 4)).astype(np.float32)
        np.testing.assert_allclose(np.asarray(L.dense(p, jnp.asarray(x), jnp.float32)),
                                   x @ np.asarray(p["kernel"]), atol=1e-5)

    @pytest.mark.parametrize("stride", [1, 2])
    def test_conv_matches_numpy(self, rng, stride):
        k = rng.normal(0, 0.2, (3, 3, 2, 4)).astype(np.float32)
        b = rng.normal(0, 0.1, 4).astype(np.float32)
        x = rng.normal(0, 1, (1, 6, 6, 2)).astype(np.float32)
        got = np.asarray(L.conv({"kernel": jnp.asarray(k), "bias": jnp.asarray(b)},
                                jnp.asarray(x), jnp.float32, stride=stride,
                                padding=((1, 1), (1, 1))))
        xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
        n = (6 - 1) // stride + 1
        want = np.zeros((1, n, n, 4))
        for i in range(n):
            for j in range(n):
                patch = xp[0, i * stride:i * stride + 3, j * stride:j * stride + 3]
                want[0, i, j] = np.einsum("hwc,hwco->o", patch, k) + b
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_gelu_is_exact_erf(self, rng):
        x = rng.normal(0, 3, 1000).astype(np.float32)
        np.testing.assert_allclose(np.asarray(L.gelu(jnp.asarray(x))), _gelu_np(x),
                                   atol=1e-5)


class TestBatchNorm:
    def _setup(self, rng):
        x = rng.normal(2.0, 3.0, (4, 5, 5, 6)).astype(np.float32)
        p = {"scale": jnp.asarray(rng.normal(1, 0.1, 6).astype(np.float32)),
             "bias": jnp.asarray(rng.normal(0, 0.1, 6).astype(np.float32))}
        s = {"mean": jnp.asarray(rng.normal(0, 1, 6).astype(np.float32)),
             "var": jnp.asarray(rng.uniform(0.5, 2, 6).astype(np.float32))}
        return x, p, s

    def test_train_uses_batch_statistics(self, rng):
        x, p, s = self._setup(rng)
        y, _ = L.batch_norm(p, s, jnp.asarray(x), jnp.float32, train=True)
        m, v = x.mean((0, 1, 2)), x.var((0, 1, 2))
        want = (x - m) / np.sqrt(v + 1e-5) * np.asarray(p["scale"]) + np.asarray(p["bias"])
        np.testing.assert_allclose(np.asarray(y), want, atol=1e-4)

    def test_running_stats_momentum_0_9(self, rng):
        x, p, s = self._setup(rng)
        _, new = L.batch_norm(p, s, jnp.asarray(x), jnp.float32, train=True)
        np.testing.assert_allclose(
            np.asarray(new["mean"]), 0.9 * np.asarray(s["mean"]) + 0.1 * x.mean((0, 1, 2)),
            atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(new["var"]), 0.9 * np.asarray(s["var"]) + 0.1 * x.var((0, 1, 2)),
            atol=1e-4)

    def test_eval_uses_running_statistics(self, rng):
        x, p, s = self._setup(rng)
        y, same = L.batch_norm(p, s, jnp.asarray(x), jnp.float32, train=False)
        want = ((x - np.asarray(s["mean"])) / np.sqrt(np.asarray(s["var"]) + 1e-5)
                * np.asarray(p["scale"]) + np.asarray(p["bias"]))
        np.testing.assert_allclose(np.asarray(y), want, atol=1e-4)
        assert same is s


class TestMlpAndBlock:
    def test_mlp_matches_numpy(self, rng):
        p = {"fc1": _dense_p(rng, 16, 64), "fc2": _dense_p(rng, 64, 16)}
        x = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
        np_ = {k: {n: np.asarray(a) for n, a in v.items()} for k, v in p.items()}
        want = (_gelu_np(x @ np_["fc1"]["kernel"] + np_["fc1"]["bias"])
                @ np_["fc2"]["kernel"] + np_["fc2"]["bias"])
        np.testing.assert_allclose(np.asarray(V.mlp(p, jnp.asarray(x), jnp.float32)),
                                   want, atol=1e-4)

    def test_int8_mlp_close_to_float(self, rng):
        p = {"fc1": _dense_p(rng, 64, 256), "fc2": _dense_p(rng, 256, 64)}
        x = jnp.asarray(rng.normal(0, 1, (2, 40, 64)).astype(np.float32))
        a = np.asarray(V.mlp(p, x, jnp.float32)).ravel()
        b = np.asarray(V.mlp(p, x, jnp.float32, int8=True)).ravel()
        assert np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999

    def test_encoder_block_matches_numpy(self, rng):
        d, h = 16, 2
        p = V.init_encoder_block(jax.random.key(3), d, 4.0, True)
        p = jax.tree.map(lambda a: a + jnp.asarray(rng.normal(0, 0.05, a.shape), a.dtype), p)
        x = rng.normal(0, 1, (2, 9, d)).astype(np.float32)
        pn = jax.tree.map(lambda a: np.asarray(a, np.float64), p)

        def dense(q, z):
            return z @ q["kernel"] + q["bias"]

        hh = _ln_np(x, pn["norm1"]["scale"], pn["norm1"]["bias"])
        qkv = dense(pn["attn"]["qkv"], hh).reshape(2, 9, 3, h, d // h)
        logits = np.einsum("bthd,bshd->bhts", qkv[:, :, 0], qkv[:, :, 1]) / np.sqrt(d // h)
        pr = np.exp(logits - logits.max(-1, keepdims=True))
        pr /= pr.sum(-1, keepdims=True)
        o = np.einsum("bhts,bshd->bthd", pr, qkv[:, :, 2]).reshape(2, 9, d)
        y = x + dense(pn["attn"]["proj"], o)
        hh = _ln_np(y, pn["norm2"]["scale"], pn["norm2"]["bias"])
        want = y + dense(pn["mlp"]["fc2"], _gelu_np(dense(pn["mlp"]["fc1"], hh)))
        got = V.encoder_block(p, jnp.asarray(x), None, num_heads=h, dtype=jnp.float32)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)

    def test_gate_zero_is_identity(self, rng):
        p = V.init_encoder_block(jax.random.key(0), 16, 4.0, True)
        x = jnp.asarray(rng.normal(0, 1, (2, 5, 16)).astype(np.float32))
        y = V.encoder_block(p, x, jnp.zeros((2, 5)), num_heads=2, dtype=jnp.float32)
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


class TestDropPathAndRemat:
    def test_gate_is_per_sample_zero_or_inverse_keep(self):
        g = np.asarray(V.drop_path_gate(jax.random.key(0), 0.25, (4096, 7)))
        assert np.all(g == g[:, :1])  # broadcast over tokens
        vals = set(np.unique(g).tolist())
        assert vals <= {0.0, float(np.float32(1.0) / np.float32(0.75))}
        keep_frac = float(np.mean(g[:, 0] > 0))
        assert abs(keep_frac - 0.75) < 0.03

    def test_train_needs_dropout_key(self, rng):
        from intentbev.configs import tiny_test_config

        cfg = tiny_test_config().vit
        enc = V.ViTEncoder(cfg, in_channels=3)
        v = enc.init(jax.random.key(0))
        x = jnp.zeros((1, 64, 96, 3))
        with pytest.raises(ValueError, match="dropout"):
            enc.apply(v, x, train=True)

    def test_remat_matches_plain(self, rng):
        from intentbev.configs import tiny_test_config

        cfg = tiny_test_config().vit
        x = jnp.asarray(rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32))
        plain = V.ViTEncoder(cfg, in_channels=3)
        remat = V.ViTEncoder(cfg, in_channels=3, remat=True)
        v = plain.init(jax.random.key(0))

        def loss(enc, params):
            return jnp.sum(enc.apply({"params": params}, x, train=True,
                                     rngs={"dropout": jax.random.key(1)}) ** 2)

        g1 = jax.grad(lambda p: loss(plain, p))(v["params"])
        g2 = jax.grad(lambda p: loss(remat, p))(v["params"])
        for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5)
