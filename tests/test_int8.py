"""Int8 serving path: quantized dense and the full model's W8A8 MLPs.

The reference has no quantized inference (torch fp32, model_vit.py); this
path is a new serving capability — tests bound the W8A8 quantization error
against the float oracles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from intentbev.ops.int8 import int8_dense, quantize_cols, quantize_rows


class TestInt8Primitives:
    def test_quantize_roundtrip(self, rng):
        x = jnp.asarray(rng.normal(0, 2, (64, 384)).astype(np.float32))
        q, s = quantize_rows(x)
        back = np.asarray(q, np.float32) * np.asarray(s)
        err = np.abs(back - np.asarray(x)).max()
        assert err <= np.abs(np.asarray(x)).max() / 127.0 + 1e-6
        assert q.dtype == jnp.int8

    def test_int8_dense_close_to_f32(self, rng):
        x = jnp.asarray(rng.normal(0, 1, (256, 384)).astype(np.float32))
        w = jnp.asarray(rng.normal(0, 0.05, (384, 1536)).astype(np.float32))
        b = jnp.asarray(rng.normal(0, 0.1, (1536,)).astype(np.float32))
        got = np.asarray(int8_dense(x, w, b))
        want = np.asarray(x @ w + b)
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert rel < 0.02, rel

    def test_per_channel_weight_scales(self, rng):
        w = np.zeros((8, 4), np.float32)
        w[:, 0] = 100.0
        w[:, 1] = 0.001
        q, s = quantize_cols(jnp.asarray(w))
        # both channels survive at full int8 resolution
        assert int(np.abs(np.asarray(q))[:, 0].max()) == 127
        assert int(np.abs(np.asarray(q))[:, 1].max()) == 127


class TestInt8Model:
    def test_tiny_vit_int8_close_to_f32(self, rng):
        from intentbev.configs import tiny_test_config
        from intentbev.models import build_model

        cfg = tiny_test_config()
        g = cfg.grid
        lidar = jnp.asarray(
            rng.normal(0, 1, (1, g.height_px, g.width_px, g.lidar_total_channels))
            .astype(np.float32))
        mp = jnp.asarray(
            rng.normal(0, 1, (1, g.height_px, g.width_px, g.map_channels))
            .astype(np.float32))
        model = build_model(cfg)
        variables = model.init(jax.random.key(0), lidar, mp)
        cls_f, box_f, int_f = model.apply(variables, lidar, mp)

        cfg8 = dataclasses.replace(
            cfg, vit=dataclasses.replace(cfg.vit, serving_int8=True))
        model8 = build_model(cfg8)
        cls_8, box_8, int_8 = model8.apply(variables, lidar, mp)

        for a, b_ in [(cls_f, cls_8), (box_f, box_8), (int_f, int_8)]:
            a, b_ = np.asarray(a).ravel(), np.asarray(b_).ravel()
            cos = np.sum(a * b_) / (np.linalg.norm(a) * np.linalg.norm(b_) + 1e-9)
            assert cos > 0.99, cos
