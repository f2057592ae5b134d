"""The in-repo checkpoint writer/reader (intentbev/checkpoint.py)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from intentbev.checkpoint import (
    STATE_FILE,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from intentbev.configs import config_to_dict, tiny_test_config


def _train_state():
    from intentbev.models import build_model
    from intentbev.train import init_train_state, make_optimizer

    cfg = tiny_test_config()
    model = build_model(cfg, train_mode=True)
    tx = make_optimizer(cfg)
    s = init_train_state(model, cfg, tx, jax.random.key(0))
    return cfg, {"params": s.params, "batch_stats": s.batch_stats,
                 "opt_state": s.opt_state, "step": s.step,
                 "loop": {"lr": np.float32(1e-4), "epoch": np.int32(2)}}


def _equal(a, b):
    return all(jax.tree.leaves(jax.tree.map(
        lambda x, y: bool(np.array_equal(np.asarray(x), np.asarray(y))), a, b)))


def test_roundtrip_with_abstract_state(tmp_path):
    cfg, state = _train_state()
    save_checkpoint(tmp_path, 7, state, cfg)
    restored, cfg2 = load_checkpoint(tmp_path, jax.eval_shape(lambda: state))
    assert cfg2 == cfg
    assert jax.tree.structure(restored) == jax.tree.structure(state)
    assert _equal(restored, state)


def test_roundtrip_without_abstract_gives_nested_dicts(tmp_path):
    cfg, state = _train_state()
    save_checkpoint(tmp_path, 1, state, cfg)
    restored, _ = load_checkpoint(tmp_path)
    assert _equal(restored["params"], state["params"])
    assert _equal(restored["batch_stats"], state["batch_stats"])
    assert int(restored["loop"]["epoch"]) == 2


def test_layout_and_config_json(tmp_path):
    cfg, state = _train_state()
    path = save_checkpoint(tmp_path, 42, state, cfg)
    assert path == tmp_path.absolute() / "step_00000042"
    with np.load(path / STATE_FILE) as z:
        assert "params/backbone/vit_lidar/block0/attn/qkv/kernel" in z.files
    assert json.loads((tmp_path / "config.json").read_text()) == config_to_dict(cfg)


def test_keeps_newest_three_and_latest_step(tmp_path):
    cfg, state = _train_state()
    assert latest_step(tmp_path) is None
    for step in (5, 10, 15, 20):
        save_checkpoint(tmp_path, step, state, cfg)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000010", "step_00000015", "step_00000020"]
    assert latest_step(tmp_path) == 20


def test_unfinished_write_is_not_a_step(tmp_path):
    """A step directory appears only by rename; leftovers of an
    interrupted write are ignored and replaced."""
    cfg, state = _train_state()
    (tmp_path / ".tmp_step_00000009").mkdir()
    assert latest_step(tmp_path) is None
    save_checkpoint(tmp_path, 9, state, cfg)
    assert latest_step(tmp_path) == 9
    assert not (tmp_path / ".tmp_step_00000009").exists()


def test_bf16_leaf_restores_dtype(tmp_path):
    cfg = tiny_test_config()
    state = {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)}
    save_checkpoint(tmp_path, 1, state, cfg)
    restored, _ = load_checkpoint(tmp_path, jax.eval_shape(lambda: state))
    assert restored["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(restored["w"], np.float32),
                                  np.asarray(state["w"], np.float32))


def test_missing_leaf_raises(tmp_path):
    cfg = tiny_test_config()
    save_checkpoint(tmp_path, 1, {"a": np.zeros(2)}, cfg)
    with pytest.raises(KeyError):
        load_checkpoint(tmp_path, {"a": np.zeros(2), "b": np.zeros(1)})


def test_explicit_step_and_missing_dir(tmp_path):
    cfg = tiny_test_config()
    save_checkpoint(tmp_path, 1, {"a": np.ones(2)}, cfg)
    save_checkpoint(tmp_path, 2, {"a": np.full(2, 2.0)}, cfg)
    old, _ = load_checkpoint(tmp_path, step=1)
    np.testing.assert_array_equal(old["a"], np.ones(2))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "nothing")


def test_config_json_with_removed_vit_switches_still_loads(tmp_path):
    """config.json files written before the kernel switches were removed
    carry keys the dataclass no longer has; they are ignored."""
    cfg = tiny_test_config()
    save_checkpoint(tmp_path, 1, {"a": np.zeros(1)}, cfg)
    d = json.loads((tmp_path / "config.json").read_text())
    d["vit"].update(use_flash_attention=True, use_fused_layernorm=True,
                    fuse_ln_chain=True, fwd_kv_chunk=1152, unsafe_softmax=True)
    (tmp_path / "config.json").write_text(json.dumps(d))
    _, loaded = load_checkpoint(tmp_path)
    assert loaded == cfg
