"""Checkpoints as flattened ``.npz`` files with a self-describing config.

Layout of a checkpoint directory::

    <ckpt_dir>/config.json              the full ExperimentConfig
    <ckpt_dir>/step_00000500/state.npz  one array per leaf, keyed by its
                                        tree path ("params/backbone/...")

Each step directory is written under a temporary name and renamed into
place, so a reader never sees a half-written step; the newest ``keep``
steps are retained.

The reference checkpoint embeds ``backbone_cfg`` so eval can rebuild the
exact model and anchor stride (train_vit.py:206-211, eval_cnn.py:63-79);
that contract is kept: every checkpoint stores the full ExperimentConfig.
Unlike the reference — which writes a single file only after the LAST epoch
(SURVEY.md §5 'checkpoint/resume') — checkpoints are written every N steps
and carry optimizer state, so mid-training resume actually works.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .configs import ExperimentConfig, config_from_dict, config_to_dict

STATE_FILE = "state.npz"


def _key(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            parts.append(str(k))
    return "/".join(parts)


def _to_numpy(x) -> np.ndarray:
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:  # npz has no bf16; restored by dtype
        a = a.astype(np.float32)
    return a


def flatten_state(state: Any) -> dict[str, np.ndarray]:
    """Pytree -> {"a/b/c": array}; dict keys, namedtuple fields and
    sequence indices all become path components."""
    return {_key(p): _to_numpy(leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(state)}


def _unflatten_dicts(arrays: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for k, a in arrays.items():
        node = out
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


def save_checkpoint(
    ckpt_dir: str | Path,
    step: int,
    state: dict,
    config: ExperimentConfig,
    keep: int = 3,
) -> Path:
    """state: pytree (params / batch_stats / opt_state / ...)."""
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    np.savez(tmp / STATE_FILE, **flatten_state(state))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    cfg_tmp = ckpt_dir / ".config.json.tmp"
    cfg_tmp.write_text(json.dumps(config_to_dict(config), indent=2))
    os.replace(cfg_tmp, ckpt_dir / "config.json")
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: Path, keep: int) -> None:
    for old in sorted(ckpt_dir.glob("step_*"))[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = sorted(Path(ckpt_dir).glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def load_checkpoint(
    ckpt_dir: str | Path, abstract_state: Any | None = None, step: int | None = None
) -> tuple[Any, ExperimentConfig]:
    """Returns (state pytree, embedded ExperimentConfig).

    With ``abstract_state`` (any pytree of the saved structure, arrays or
    ShapeDtypeStructs) the state comes back in that structure and those
    dtypes, and a missing leaf raises KeyError; without it, as nested
    dicts keyed by path component.
    """
    ckpt_dir = Path(ckpt_dir).absolute()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    config = config_from_dict(json.loads((ckpt_dir / "config.json").read_text()))
    with np.load(ckpt_dir / f"step_{step:08d}" / STATE_FILE) as z:
        arrays = {k: z[k] for k in z.files}
    if abstract_state is None:
        return _unflatten_dicts(arrays), config
    leaves, treedef = jax.tree_util.tree_flatten_with_path(abstract_state)
    restored = []
    for p, leaf in leaves:
        a = arrays[_key(p)]
        dtype = getattr(leaf, "dtype", None)
        restored.append(a.astype(dtype) if dtype is not None else a)
    return jax.tree_util.tree_unflatten(treedef, restored), config
