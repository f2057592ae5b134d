from typing import Any

import jax.numpy as jnp

from ..configs import ExperimentConfig
from .blocks import ensure_nhwc
from .cnn import IntentNetCNN
from .heads import flatten_head_outputs
from .layers import Model
from .vit import IntentNetViT, ViTEncoder

_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def build_model(cfg: ExperimentConfig, *, train_mode: bool = False) -> Any:
    """Instantiate the configured model family (reference entry scripts pick
    IntentNetCNN vs IntentNetViT; train_cnn.py:36-40, train_vit.py:33-50)."""
    dtype = _DTYPES[cfg.train.compute_dtype] if train_mode else jnp.float32
    if cfg.model_family == "cnn":
        return IntentNetCNN(cfg.cnn, cfg.heads, dtype=dtype)
    if cfg.model_family == "vit":
        return IntentNetViT(
            cfg.vit, cfg.heads,
            remat=cfg.train.remat_vit_blocks and train_mode,
            dtype=dtype,
        )
    raise ValueError(f"unknown model family {cfg.model_family!r}")


__all__ = [
    "ensure_nhwc",
    "IntentNetCNN",
    "IntentNetViT",
    "Model",
    "ViTEncoder",
    "flatten_head_outputs",
    "build_model",
]
