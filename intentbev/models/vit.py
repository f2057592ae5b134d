"""IntentNetViT: two-stream Vision Transformer backbone + heads.

First-party ViT equivalent to timm's ``vit_small_patch8_224`` as used by the
reference (model_vit.py:62-74): patch-embed conv (8x8 stride 8), CLS token,
learned position embeddings over 1 + 50*90 = 4501 tokens, 12 pre-LN blocks
of MHSA(6 heads, 384) + MLP(x4), stochastic depth (drop-path) linearly
scaled over depth, final LayerNorm. Per stream the patch tokens are passed
through an adapter LN -> Linear(384 -> 192) -> GELU and reshaped to a
(B, 50, 90, 192) feature map (model_vit.py:82-83,116-121); the two streams
concat to 384 channels and run through a stride-1 residual fusion stage to
512 channels (model_vit.py:85-92), giving total stride 8 = patch size.

Details:
- attention runs through :func:`intentbev.ops.dot_product_attention` on the
  qkv projection's [B, T, H, D] layout; the implementation follows the
  compute dtype (cuDNN flash attention for bf16 on the GPU, the dense XLA
  softmax otherwise — ops/attention.py);
- layout is NHWC; compute dtype is configurable (bf16 by default in
  training) with LayerNorm statistics, softmax and logits in f32;
- blocks can be wrapped in ``jax.checkpoint`` (remat) to trade FLOPs for
  device memory during training;
- the LiDAR input may arrive as host-built placement chunks
  (ops.voxel_embed.VoxelChunks), which are placed into the dense BEV on
  device before the patch-embed conv.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import HeadConfig, ViTBackboneConfig
from ..ops.attention import dot_product_attention, padded_seq_len
from ..ops.int8 import int8_dense
from .blocks import ensure_nhwc, init_residual_stage, residual_stage
from .heads import apply_heads, init_heads
from .layers import (
    Model,
    child_key,
    conv,
    dense,
    gelu,
    init_conv,
    init_dense,
    init_layer_norm,
    init_trunc02,
    layer_norm,
)


def init_encoder_block(key, d: int, mlp_ratio: float, qkv_bias: bool) -> dict:
    hidden = int(d * mlp_ratio)

    def lin(name, i, o, bias=True):
        return init_dense(child_key(key, name), i, o,
                          kernel_init=init_trunc02, bias=bias)

    return {
        "norm1": init_layer_norm(d),
        "attn": {"qkv": lin("qkv", d, 3 * d, qkv_bias), "proj": lin("proj", d, d)},
        "norm2": init_layer_norm(d),
        "mlp": {"fc1": lin("fc1", d, hidden), "fc2": lin("fc2", hidden, d)},
    }


@jax.named_scope("attention")
def attention(p: dict, x: jnp.ndarray, num_heads: int, dtype,
              kv_len: int | None = None) -> jnp.ndarray:
    """qkv projection -> multi-head attention -> output projection.
    ``kv_len``: real token count when ``x`` carries a padded tail."""
    b, t, d = x.shape
    qkv = dense(p["qkv"], x, dtype).reshape(b, t, 3, num_heads, d // num_heads)
    out = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                kv_len=kv_len)
    return dense(p["proj"], out.reshape(b, t, d), dtype)


@jax.named_scope("mlp")
def mlp(p: dict, x: jnp.ndarray, dtype, int8: bool = False) -> jnp.ndarray:
    """fc1 -> GELU -> fc2. ``int8``: both matmuls through the W8A8 serving
    path (ops.int8), inference only."""
    if int8:
        y = int8_dense(x, p["fc1"]["kernel"], p["fc1"]["bias"],
                       out_dtype=jnp.float32)
        return int8_dense(gelu(y), p["fc2"]["kernel"], p["fc2"]["bias"],
                          out_dtype=dtype)
    return dense(p["fc2"], gelu(dense(p["fc1"], x, dtype)), dtype)


def encoder_block(p: dict, x: jnp.ndarray, gate: jnp.ndarray | None, *,
                  num_heads: int, dtype, int8: bool = False,
                  kv_len: int | None = None) -> jnp.ndarray:
    """Pre-LN transformer block. ``gate``: per-sample stochastic-depth
    factor [B, T] (0 or 1/keep) applied to both residual branches."""
    def gated(y):
        return y if gate is None else y * gate[..., None].astype(y.dtype)

    h = layer_norm(p["norm1"], x, dtype)
    x = x + gated(attention(p["attn"], h, num_heads, dtype, kv_len))
    h = layer_norm(p["norm2"], x, dtype)
    return x + gated(mlp(p["mlp"], h, dtype, int8))


def drop_path_gate(key, rate: float, shape: tuple[int, int]) -> jnp.ndarray:
    """Per-sample stochastic-depth gate (0 or 1/keep), broadcast over
    tokens — same distribution as timm DropPath."""
    keep = 1.0 - rate
    mask = jax.random.bernoulli(key, keep, (shape[0], 1))
    return jnp.broadcast_to(mask.astype(jnp.float32) / keep, shape)


class ViTEncoder(Model):
    """Patch embed + CLS + pos embed + transformer stack + final LN.

    Returns all tokens [B, 1+N, D] after the final LayerNorm (the
    equivalent of timm ``forward_features``, model_vit.py:119).
    """

    def __init__(self, cfg: ViTBackboneConfig, in_channels: int,
                 remat: bool = False, dtype: Any = jnp.float32):
        self.cfg = cfg
        self.in_channels = in_channels
        self.remat = remat
        self.dtype = dtype

    def init_variables(self, key) -> tuple[dict, dict]:
        cfg = self.cfg
        d = cfg.embed_dim
        p = {
            "patch_embed": init_conv(
                child_key(key, "patch_embed"), cfg.patch_size,
                self.in_channels, d, kernel_init=init_trunc02),
            "cls_token": init_trunc02(
                child_key(key, "cls_token"), (1, 1, d), jnp.float32),
            "pos_embed": init_trunc02(
                child_key(key, "pos_embed"), (1, 1 + cfg.num_patches, d),
                jnp.float32),
            "norm": init_layer_norm(d),
        }
        for i in range(cfg.depth):
            p[f"block{i}"] = init_encoder_block(
                child_key(key, f"block{i}"), d, cfg.mlp_ratio, cfg.qkv_bias)
        return p, {}

    def forward(self, params, stats, x_nhwc, *, train: bool = False,
                dropout_key=None):
        cfg, dt = self.cfg, self.dtype
        p = cfg.patch_size
        b, h, w, _ = x_nhwc.shape
        assert h % p == 0 and w % p == 0, f"grid {h}x{w} not divisible by patch {p}"
        d = cfg.embed_dim
        with jax.named_scope("patch_embed"):
            tokens = conv(params["patch_embed"], x_nhwc, dt, stride=p,
                          padding="VALID").reshape(b, -1, d)
        cls = jnp.broadcast_to(params["cls_token"], (b, 1, d)).astype(tokens.dtype)
        tokens = jnp.concatenate([cls, tokens], axis=1)
        tokens = tokens + params["pos_embed"].astype(tokens.dtype)
        # pad the token axis once for the whole stack where the attention
        # route needs it (ops.attention.padded_seq_len); padded rows are
        # per-token dead lanes, masked out of every attention's keys
        real_len = tokens.shape[1]
        t_run = padded_seq_len(real_len, dt)
        if t_run != real_len:
            tokens = jnp.pad(tokens, ((0, 0), (0, t_run - real_len), (0, 0)))

        use_gates = train and cfg.drop_path_rate > 0.0
        if use_gates and dropout_key is None:
            raise ValueError("train=True with drop_path_rate > 0 needs "
                             "rngs={'dropout': key}")
        block = functools.partial(
            encoder_block, num_heads=cfg.num_heads, dtype=dt,
            int8=cfg.serving_int8,
            kv_len=real_len if t_run != real_len else None)
        if self.remat:
            block = jax.checkpoint(block)
        dp_rates = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
        for i in range(cfg.depth):
            gate = None
            if use_gates and dp_rates[i] > 0.0:
                gate = drop_path_gate(jax.random.fold_in(dropout_key, i),
                                      float(dp_rates[i]), tokens.shape[:2])
            tokens = block(params[f"block{i}"], tokens, gate)
        return layer_norm(params["norm"], tokens[:, :real_len], dt), stats


class IntentNetViT(Model):
    """Reference model_vit.py:38-185; same 3-tensor output contract as CNN.

    Parameter tree: ``backbone/{vit_lidar, vit_map}`` (ViTEncoder),
    ``backbone/adapter_{lidar,map}_{norm,proj}``, ``backbone/fusion``
    (residual stage, BatchNorm), ``det_head``, ``intention_head``.
    """

    def __init__(self, cfg: ViTBackboneConfig, head_cfg: HeadConfig,
                 remat: bool = False, dtype: Any = jnp.float32):
        self.cfg = cfg
        self.head_cfg = head_cfg
        self.remat = remat
        self.dtype = dtype
        self.encoders = {
            name: ViTEncoder(cfg, c, remat=remat, dtype=dtype)
            for name, c in (("lidar", cfg.lidar_input_channels),
                            ("map", cfg.map_input_channels))
        }

    def init_variables(self, key) -> tuple[dict, dict]:
        cfg = self.cfg
        kb = child_key(key, "backbone")
        bp = {}
        for name, enc in self.encoders.items():
            bp[f"vit_{name}"], _ = enc.init_variables(child_key(kb, f"vit_{name}"))
            bp[f"adapter_{name}_norm"] = init_layer_norm(cfg.embed_dim)
            bp[f"adapter_{name}_proj"] = init_dense(
                child_key(kb, f"adapter_{name}_proj"), cfg.embed_dim,
                cfg.adapter_out_channels, kernel_init=init_trunc02)
        bp["fusion"], fusion_stats = init_residual_stage(
            child_key(kb, "fusion"), 2 * cfg.adapter_out_channels,
            cfg.fusion_planes, cfg.fusion_layers, cfg.fusion_stride,
            cfg.fusion_kernel_size)
        params = {"backbone": bp,
                  **init_heads(key, cfg.fusion_planes, self.head_cfg)}
        return params, {"backbone": {"fusion": fusion_stats}}

    def forward(self, params, stats, lidar_bev, map_bev, *, train: bool = False,
                dropout_key=None):
        from ..ops.voxel_embed import VoxelChunks, voxel_fill_bev

        cfg, dt = self.cfg, self.dtype
        if isinstance(lidar_bev, VoxelChunks):
            # host-built placement chunks: place them into the dense BEV
            # on device, then the same patch-embed conv as below
            lidar_bev = voxel_fill_bev(
                lidar_bev, cfg.img_size, cfg.lidar_input_channels,
                cfg.patch_size, dtype=dt)
        inputs = {
            "lidar": ensure_nhwc(lidar_bev, cfg.lidar_input_channels).astype(dt),
            "map": ensure_nhwc(map_bev, cfg.map_input_channels).astype(dt),
        }
        bp = params["backbone"]
        gh, gw = cfg.grid_size
        feats = []
        for name, enc in self.encoders.items():
            key = (None if dropout_key is None
                   else child_key(dropout_key, f"vit_{name}"))
            tokens, _ = enc.forward(bp[f"vit_{name}"], {}, inputs[name],
                                    train=train, dropout_key=key)
            # adapter LN -> Linear -> GELU on the patch tokens, CLS
            # stripped (model_vit.py:82-83,119)
            h = layer_norm(bp[f"adapter_{name}_norm"], tokens[:, 1:], dt)
            h = gelu(dense(bp[f"adapter_{name}_proj"], h, dt))
            feats.append(h.reshape(h.shape[0], gh, gw, cfg.adapter_out_channels))
        fused, fusion_stats = residual_stage(
            bp["fusion"], stats["backbone"]["fusion"],
            jnp.concatenate(feats, axis=-1), stride=cfg.fusion_stride,
            dtype=dt, train=train)
        out = apply_heads(params, fused, self.head_cfg, dt)
        return out, {"backbone": {"fusion": fusion_stats}}
