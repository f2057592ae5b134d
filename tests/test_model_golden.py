"""The plain-JAX models against outputs frozen from the previous Flax
implementation (tests/fixtures/models_golden.npz).

The fixture holds, for the default ViT, the default CNN and both families
of ``tiny_test_config``: the sorted ``path shape dtype`` list of the
variables; and for the tiny configs the eval-mode and train-mode outputs
and the updated ``batch_stats`` for parameters drawn by
:func:`seeded_leaf` and inputs drawn from ``default_rng(1234)``. The
train-mode case runs with ``drop_path_rate=0`` (stochastic depth draws its
own keys; its gate is tested in test_models.py).
"""

import dataclasses
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from intentbev.configs import default_cnn_config, default_vit_config, tiny_test_config
from intentbev.models import build_model

GOLDEN = np.load(Path(__file__).parent / "fixtures" / "models_golden.npz")


def seeded_leaf(path: str, shape) -> np.ndarray:
    """Deterministic, well-scaled values for one variable, keyed by path."""
    r = np.random.default_rng(zlib.crc32(path.encode()))
    name = path.rsplit("/", 1)[-1]
    if name == "kernel":
        a = r.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
    elif name == "scale":
        a = 1.0 + 0.1 * r.normal(size=shape)
    elif name == "var":
        a = r.uniform(0.5, 1.5, shape)
    else:
        a = 0.1 * r.normal(size=shape)
    return a.astype(np.float32)


def _path(p) -> str:
    return "/".join(getattr(k, "key", str(k)) for k in p)


def _flat(tree) -> dict:
    return {_path(p): a for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _cfg(name):
    tiny = tiny_test_config()
    return {
        "vit_default": default_vit_config(),
        "cnn_default": default_cnn_config(),
        "vit_tiny": tiny,
        "cnn_tiny": dataclasses.replace(tiny, model_family="cnn"),
    }[name]


def _golden_case(family):
    tiny = tiny_test_config()
    cfg = dataclasses.replace(
        tiny, model_family=family,
        vit=dataclasses.replace(tiny.vit, drop_path_rate=0.0))
    g = cfg.grid
    r = np.random.default_rng(1234)
    lidar = r.normal(0, 1, (2, g.height_px, g.width_px, g.lidar_total_channels))
    mp = r.normal(0, 1, (2, g.height_px, g.width_px, g.map_channels))
    model = build_model(cfg, train_mode=True)
    shapes = model.init(jax.random.key(0))
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(seeded_leaf(_path(p), a.shape)), shapes)
    return cfg, model, variables, (jnp.asarray(lidar, jnp.float32),
                                   jnp.asarray(mp, jnp.float32))


@pytest.mark.parametrize("name", ["vit_default", "cnn_default", "vit_tiny", "cnn_tiny"])
def test_variable_tree_matches(name):
    cfg = _cfg(name)
    model = build_model(cfg, train_mode=True)
    v = jax.eval_shape(lambda k: model.init({"params": k, "dropout": k}, train=True),
                       jax.random.key(0))
    got = sorted(f"{k} {tuple(a.shape)} {a.dtype}" for k, a in _flat(v).items())
    assert got == list(GOLDEN[f"tree/{name}"])


@pytest.mark.parametrize("family", ["vit", "cnn"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_outputs_match(family, mode):
    cfg, model, variables, (lidar, mp) = _golden_case(family)
    if mode == "eval":
        out = build_model(cfg).apply(variables, lidar, mp)
    else:
        out, _ = model.apply(variables, lidar, mp, train=True,
                             mutable=["batch_stats"],
                             rngs={"dropout": jax.random.key(9)})
    for i, o in enumerate(out):
        np.testing.assert_allclose(np.asarray(o), GOLDEN[f"{family}/{mode}/{i}"],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["vit", "cnn"])
def test_updated_batch_stats_match(family):
    _, model, variables, (lidar, mp) = _golden_case(family)
    _, upd = model.apply(variables, lidar, mp, train=True,
                         mutable=["batch_stats"],
                         rngs={"dropout": jax.random.key(9)})
    got = _flat(upd["batch_stats"])
    want = {k.split("/new_stats/", 1)[1]: GOLDEN[k] for k in GOLDEN.files
            if k.startswith(f"{family}/new_stats/")}
    assert sorted(got) == sorted(want)
    for k, a in got.items():
        np.testing.assert_allclose(np.asarray(a), want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
