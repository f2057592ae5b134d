"""Shared residual building blocks (NHWC).

One BasicBlock implementation — the reference duplicates it in
``model_cnn.py:14-33`` and ``model_vit.py:19-34``. Layout is NHWC
(channels-last).

BatchNorm statistics live in the ``batch_stats`` tree and are updated
when ``train=True``, mirroring torch BatchNorm2d semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .layers import (
    batch_norm,
    child_key,
    conv,
    init_batch_norm,
    init_conv,
    init_kaiming_out,
)


def init_basic_block(key, c_in: int, planes: int, stride: int = 1,
                     kernel_size: int = 3) -> tuple[dict, dict]:
    """ResNet BasicBlock: conv-BN-ReLU x2 + identity/projection shortcut.

    Reference: model_cnn.py:14-33 (kernel size configurable; the stream
    stages use k=5, fusion uses k=3 — model_cnn.py:58-75).
    """
    def conv_p(name, k, ci):
        return init_conv(child_key(key, name), k, ci, planes,
                         kernel_init=init_kaiming_out, bias=False)

    params, stats = {}, {}
    params["conv1"] = conv_p("conv1", kernel_size, c_in)
    params["bn1"], stats["bn1"] = init_batch_norm(planes)
    params["conv2"] = conv_p("conv2", kernel_size, planes)
    params["bn2"], stats["bn2"] = init_batch_norm(planes)
    if stride != 1 or c_in != planes:
        params["proj_conv"] = conv_p("proj_conv", 1, c_in)
        params["proj_bn"], stats["proj_bn"] = init_batch_norm(planes)
    return params, stats


def basic_block(p: dict, s: dict, x: jnp.ndarray, *, stride: int, dtype,
                train: bool) -> tuple[jnp.ndarray, dict]:
    # torch-style symmetric padding ((k-1)//2 each side, reference
    # model_cnn.py:7-9), NOT "SAME": for stride-2 convs SAME pads
    # asymmetrically (e.g. (1, 2) for k=5), sampling a half-pixel-shifted
    # grid — forwards could never match reference weights
    # (tools: intentbev.import_torch). Identical to SAME at stride 1.
    pad = (p["conv1"]["kernel"].shape[0] - 1) // 2
    padding = ((pad, pad), (pad, pad))
    new = {}
    y = conv(p["conv1"], x, dtype, stride=stride, padding=padding)
    y, new["bn1"] = batch_norm(p["bn1"], s["bn1"], y, dtype, train=train)
    y = jax.nn.relu(y)
    y = conv(p["conv2"], y, dtype, padding=padding)
    y, new["bn2"] = batch_norm(p["bn2"], s["bn2"], y, dtype, train=train)
    identity = x
    if "proj_conv" in p:
        identity = conv(p["proj_conv"], x, dtype, stride=stride, padding="VALID")
        identity, new["proj_bn"] = batch_norm(
            p["proj_bn"], s["proj_bn"], identity, dtype, train=train)
    return jax.nn.relu(y + identity), new


def init_residual_stage(key, c_in: int, planes: int, num_blocks: int,
                        stride: int = 1, kernel_size: int = 3
                        ) -> tuple[dict, dict]:
    """A stack of BasicBlocks; the first carries the stride/projection.

    Reference ``_make_layer`` (model_cnn.py:86-100).
    """
    params, stats = {}, {}
    for i in range(num_blocks):
        params[f"block{i}"], stats[f"block{i}"] = init_basic_block(
            child_key(key, f"block{i}"), c_in if i == 0 else planes, planes,
            stride if i == 0 else 1, kernel_size)
    return params, stats


@jax.named_scope("residual_stage")
def residual_stage(p: dict, s: dict, x: jnp.ndarray, *, stride: int, dtype,
                   train: bool) -> tuple[jnp.ndarray, dict]:
    new = {}
    for i in range(len(p)):
        x, new[f"block{i}"] = basic_block(
            p[f"block{i}"], s[f"block{i}"], x, stride=stride if i == 0 else 1,
            dtype=dtype, train=train)
    return x, new


def ensure_nhwc(x: jnp.ndarray, channels: int) -> jnp.ndarray:
    """Accept NCHW (the reference's torch layout) or NHWC and return NHWC."""
    if x.ndim != 4:
        raise ValueError(f"expected rank-4 BEV tensor, got shape {x.shape}")
    if x.shape[-1] == channels:
        return x
    if x.shape[1] == channels:
        return jnp.transpose(x, (0, 2, 3, 1))
    raise ValueError(
        f"neither axis 1 nor axis 3 matches expected channels={channels}: {x.shape}"
    )
