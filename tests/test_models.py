"""Model forward-contract tests (tiny shapes, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from intentbev.configs import tiny_test_config
from intentbev.models import IntentNetCNN, IntentNetViT, build_model
from intentbev.ops.attention import reference_attention


@pytest.fixture(scope="module")
def cfg():
    return tiny_test_config()


def _inputs(cfg, batch=2, layout="nhwc"):
    g = cfg.grid
    rng = np.random.default_rng(1)
    lidar = rng.normal(0, 1, (batch, g.height_px, g.width_px, g.lidar_total_channels)).astype(np.float32)
    mp = rng.normal(0, 1, (batch, g.height_px, g.width_px, g.map_channels)).astype(np.float32)
    if layout == "nchw":
        lidar = lidar.transpose(0, 3, 1, 2)
        mp = mp.transpose(0, 3, 1, 2)
    return jnp.asarray(lidar), jnp.asarray(mp)


def _num_anchors(cfg):
    fh = cfg.grid.height_px // cfg.anchors.stride
    fw = cfg.grid.width_px // cfg.anchors.stride
    return fh * fw * cfg.anchors.num_anchors_per_loc


class TestForwardContract:
    @pytest.mark.parametrize("family", ["cnn", "vit"])
    def test_output_shapes(self, cfg, family):
        import dataclasses
        cfg2 = dataclasses.replace(cfg, model_family=family)
        model = build_model(cfg2)
        lidar, mp = _inputs(cfg2)
        params = model.init(jax.random.key(0), lidar, mp)
        cls_l, box_d, int_l = model.apply(params, lidar, mp)
        n = _num_anchors(cfg2)
        assert cls_l.shape == (2, n, 1)
        assert box_d.shape == (2, n, 6)
        assert int_l.shape == (2, n, 8)
        assert jnp.isfinite(cls_l).all() and jnp.isfinite(box_d).all() and jnp.isfinite(int_l).all()

    def test_nchw_inputs_accepted(self, cfg):
        model = build_model(cfg)
        lidar, mp = _inputs(cfg, layout="nhwc")
        lidar_cf, mp_cf = _inputs(cfg, layout="nchw")
        params = model.init(jax.random.key(0), lidar, mp)
        out_a = model.apply(params, lidar, mp)
        out_b = model.apply(params, lidar_cf, mp_cf)
        for a, b in zip(out_a, out_b):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    def test_head_anchor_ordering_contract(self, cfg):
        """The flattened anchor index must be ((h*Wf + w)*A + a)."""
        from intentbev.configs import HeadConfig
        from intentbev.models.heads import (detection_head, flatten_head_outputs,
                                            init_heads)

        A = 5
        feat = jnp.zeros((1, 3, 4, 8))
        params = init_heads(jax.random.key(0), 8, HeadConfig(num_anchors=A))
        cls_l, box_p = detection_head(params["det_head"], feat, A, jnp.float32)
        assert cls_l.shape == (1, 3, 4, A)
        # mark one spatial-anchor cell and check where it lands after flatten
        marked = cls_l.at[0, 1, 2, 3].set(99.0)
        flat, _, _ = flatten_head_outputs(marked, box_p, jnp.zeros((1, 3, 4, A, 8)))
        idx = int(jnp.argmax(flat[0, :, 0]))
        assert idx == (1 * 4 + 2) * A + 3

    def test_train_mode_runs_with_batchstats_and_droppath(self, cfg):
        model = build_model(cfg, train_mode=True)
        lidar, mp = _inputs(cfg)
        variables = model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, lidar, mp, train=True
        )
        assert "batch_stats" in variables
        out, updates = model.apply(
            variables, lidar, mp, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.key(2)},
        )
        assert "batch_stats" in updates
        assert jnp.isfinite(out[0]).all()

    def test_vit_jit_forward_deterministic(self, cfg):
        model = build_model(cfg)
        lidar, mp = _inputs(cfg)
        params = model.init(jax.random.key(0), lidar, mp)
        f = jax.jit(lambda p, a, b: model.apply(p, a, b))
        o1 = f(params, lidar, mp)
        o2 = f(params, lidar, mp)
        for a, b in zip(o1, o2):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestAttention:
    def test_reference_attention_matches_naive(self, rng):
        b, h, t, d = 2, 3, 17, 8
        q = jnp.asarray(rng.normal(0, 1, (b, h, t, d)).astype(np.float32))
        k = jnp.asarray(rng.normal(0, 1, (b, h, t, d)).astype(np.float32))
        v = jnp.asarray(rng.normal(0, 1, (b, h, t, d)).astype(np.float32))
        got = np.asarray(reference_attention(q, k, v))
        qn, kn, vn = map(np.asarray, (q, k, v))
        logits = np.einsum("bhtd,bhsd->bhts", qn, kn) / np.sqrt(d)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p = p / p.sum(-1, keepdims=True)
        want = np.einsum("bhts,bhsd->bhtd", p, vn)
        np.testing.assert_allclose(got, want, atol=1e-5)
