"""Import reference PyTorch checkpoints into intentbev parameter trees.

The migration path for users of the reference repo: a checkpoint saved by
``train_cnn.py`` (``{epoch, model_state_dict, optimizer_state_dict,
backbone_cfg}``, reference train_cnn.py:188-197) converts into an intentbev
checkpoint (flattened ``.npz``, intentbev.checkpoint) that
``intentbev-eval`` consumes directly. The mapping is
exact — ``tests/test_weight_import.py`` asserts the imported IntentNetCNN
forward matches the reference network's output (rtol 1e-3 — f32
accumulation-order noise only) on shared weights.

Layout conversions:
- torch Conv2d weight [out, in, kh, kw]  -> conv kernel [kh, kw, in, out]
- torch Linear weight [out, in]          -> dense kernel [in, out]
- torch BatchNorm2d weight/bias          -> BatchNorm scale/bias (params)
  running_mean/running_var               -> batch_stats mean/var
- torch LayerNorm weight/bias            -> scale/bias

Name map (reference model tree -> intentbev param tree):
- ``backbone.{lidar,map}_stage{k}.{i}.*`` -> ``backbone/{lidar,map}_stage{k}/block{i}/*``
- ``....downsample.0/1``                  -> ``..../proj_conv, proj_bn``
- ``backbone.fusion_block.{i}.*``         -> ``backbone/fusion/block{i}/*``
- ``det_head.conv``, ``intention_head.conv`` -> same names
- ViT non-timm parts (model_vit.py:82-92): ``adapter_{lidar,map}.0/1`` ->
  ``backbone/adapter_{lidar,map}_norm / _proj``; ``fusion_block.{i}`` ->
  ``backbone/fusion/block{i}``.

The per-anchor channel order needs NO permutation: torch's
``view(B, A, P, H, W)`` (heads.py:22) and intentbev's NHWC
``reshape(B, H, W, A, P)`` both read conv output channel ``a * P + p``.

ViT checkpoints import fully: intentbev's ViT encoder is structurally
timm-compatible (patch-embed conv, CLS token, pos_embed, pre-LN blocks with
packed qkv, final LN — models/vit.py), so the timm ``vit_small_patch8_224``
interiors map over mechanically (``import_vit_encoder``); timm itself is
not needed, only its state_dict schema. ``tests/test_weight_import.py``
proves the mapping against a hand-written torch twin reproducing timm's
documented block math (tests/vit_twin.py).
"""

from __future__ import annotations

import argparse
from typing import Any, Mapping

import numpy as np

from .configs import CNNBackboneConfig, ExperimentConfig


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()  # torch tensor


def conv_kernel(w) -> np.ndarray:
    """torch [out, in, kh, kw] -> [kh, kw, in, out]."""
    return np.transpose(_np(w), (2, 3, 1, 0))


def dense_kernel(w) -> np.ndarray:
    """torch [out, in] -> [in, out]."""
    return np.transpose(_np(w), (1, 0))


def _bn(sd: Mapping[str, Any], prefix: str) -> tuple[dict, dict]:
    params = {
        "scale": _np(sd[f"{prefix}.weight"]).astype(np.float32),
        "bias": _np(sd[f"{prefix}.bias"]).astype(np.float32),
    }
    stats = {
        "mean": _np(sd[f"{prefix}.running_mean"]).astype(np.float32),
        "var": _np(sd[f"{prefix}.running_var"]).astype(np.float32),
    }
    return params, stats


def _basic_block(sd: Mapping[str, Any], prefix: str) -> tuple[dict, dict]:
    """One reference BasicBlock (model_cnn.py:14-33) -> intentbev BasicBlock."""
    params: dict = {}
    stats: dict = {}
    params["conv1"] = {"kernel": conv_kernel(sd[f"{prefix}.conv1.weight"])}
    params["bn1"], stats["bn1"] = _bn(sd, f"{prefix}.bn1")
    params["conv2"] = {"kernel": conv_kernel(sd[f"{prefix}.conv2.weight"])}
    params["bn2"], stats["bn2"] = _bn(sd, f"{prefix}.bn2")
    if f"{prefix}.downsample.0.weight" in sd:
        params["proj_conv"] = {
            "kernel": conv_kernel(sd[f"{prefix}.downsample.0.weight"])
        }
        params["proj_bn"], stats["proj_bn"] = _bn(sd, f"{prefix}.downsample.1")
    return params, stats


def _stage(sd: Mapping[str, Any], prefix: str, num_blocks: int) -> tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    for i in range(num_blocks):
        params[f"block{i}"], stats[f"block{i}"] = _basic_block(sd, f"{prefix}.{i}")
    return params, stats


def _head_conv(sd: Mapping[str, Any], prefix: str) -> dict:
    return {
        "conv": {
            "kernel": conv_kernel(sd[f"{prefix}.conv.weight"]),
            "bias": _np(sd[f"{prefix}.conv.bias"]).astype(np.float32),
        }
    }


def import_cnn_state_dict(
    sd: Mapping[str, Any],
    cfg: CNNBackboneConfig = CNNBackboneConfig(),
) -> dict:
    """Reference ``IntentNetCNN.state_dict()`` -> ``{"params", "batch_stats"}``
    for :class:`intentbev.models.IntentNetCNN` (model_cnn.py:125-150)."""
    backbone_p: dict = {}
    backbone_s: dict = {}
    for stream in ("lidar", "map"):
        for k in range(1, 4):
            name = f"{stream}_stage{k}"
            backbone_p[name], backbone_s[name] = _stage(
                sd, f"backbone.{name}", cfg.num_blocks_per_stage
            )
    backbone_p["fusion"], backbone_s["fusion"] = _stage(
        sd, "backbone.fusion_block", cfg.fusion_layers
    )
    params = {
        "backbone": backbone_p,
        "det_head": _head_conv(sd, "det_head"),
        "intention_head": _head_conv(sd, "intention_head"),
    }
    return {"params": params, "batch_stats": {"backbone": backbone_s}}


def _ln_params(sd: Mapping[str, Any], prefix: str) -> dict:
    return {
        "scale": _np(sd[f"{prefix}.weight"]).astype(np.float32),
        "bias": _np(sd[f"{prefix}.bias"]).astype(np.float32),
    }


def _linear(sd: Mapping[str, Any], prefix: str) -> dict:
    return {
        "kernel": dense_kernel(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]).astype(np.float32),
    }


def vit_encoder_depth(sd: Mapping[str, Any], prefix: str) -> int:
    """Number of transformer blocks under ``{prefix}.blocks.N`` in a timm
    ViT state_dict."""
    depth = 0
    while f"{prefix}.blocks.{depth}.norm1.weight" in sd:
        depth += 1
    return depth


def import_vit_encoder(sd: Mapping[str, Any], prefix: str) -> dict:
    """One timm ``VisionTransformer`` state_dict subtree -> the param tree
    of :class:`intentbev.models.vit.ViTEncoder`.

    The timm schema (reference model_vit.py:62-74 builds
    ``vit_small_patch8_224``): ``patch_embed.proj`` conv, ``cls_token``,
    ``pos_embed`` over 1+N tokens, ``blocks.N.{norm1, attn.qkv, attn.proj,
    norm2, mlp.fc1, mlp.fc2}``, final ``norm``. intentbev's encoder is
    structurally identical (CLS + learned pos-embed + pre-LN blocks with
    packed qkv + final LN), and the packed-qkv feature order matches: timm
    reshapes the 3D-wide projection as (3, heads, head_dim) — q first,
    head-major — exactly how models/vit.py ``attention`` reshapes it to
    [B, T, 3, H, D], so the weight moves over with only the torch
    [out,in] -> [in,out] transpose.
    """
    p: dict = {
        "patch_embed": {
            "kernel": conv_kernel(sd[f"{prefix}.patch_embed.proj.weight"]),
            "bias": _np(sd[f"{prefix}.patch_embed.proj.bias"]).astype(np.float32),
        },
        "cls_token": _np(sd[f"{prefix}.cls_token"]).astype(np.float32),
        "pos_embed": _np(sd[f"{prefix}.pos_embed"]).astype(np.float32),
        "norm": _ln_params(sd, f"{prefix}.norm"),
    }
    depth = vit_encoder_depth(sd, prefix)
    if depth == 0:
        raise KeyError(f"no transformer blocks found under {prefix}.blocks")
    for i in range(depth):
        b = f"{prefix}.blocks.{i}"
        p[f"block{i}"] = {
            "norm1": _ln_params(sd, f"{b}.norm1"),
            "attn": {
                "qkv": _linear(sd, f"{b}.attn.qkv"),
                "proj": _linear(sd, f"{b}.attn.proj"),
            },
            "norm2": _ln_params(sd, f"{b}.norm2"),
            "mlp": {
                "fc1": _linear(sd, f"{b}.mlp.fc1"),
                "fc2": _linear(sd, f"{b}.mlp.fc2"),
            },
        }
    return p


def import_vit_state_dict(sd: Mapping[str, Any], fusion_layers: int = 2) -> dict:
    """Full reference ``IntentNetViT.state_dict()`` (model_vit.py:145-185)
    -> ``{"params", "batch_stats"}`` for :class:`intentbev.models.IntentNetViT`.

    Covers BOTH timm interiors (``backbone.vit_lidar`` / ``backbone.vit_map``,
    via :func:`import_vit_encoder`) and the reference-defined components
    (adapters, fusion, heads, via :func:`import_vit_nontimm`).
    """
    out = import_vit_nontimm(sd, fusion_layers=fusion_layers)
    for stream in ("lidar", "map"):
        out["params"]["backbone"][f"vit_{stream}"] = import_vit_encoder(
            sd, f"backbone.vit_{stream}")
    return out


def vit_config_from_state_dict(
    sd: Mapping[str, Any],
    base,
    num_heads: int | None = None,
    model_name: str = "vit_small_patch8_224",
) -> Any:
    """Derive a :class:`ViTBackboneConfig` whose shapes match a reference
    ViT state_dict. Everything except the head count is read off the
    weights (patch/embed/depth/in-chans/grid from ``patch_embed.proj`` and
    ``pos_embed``); the head count is invisible in the weights, so it comes
    from the timm model-name table (the reference stores the name in its
    checkpoint ``backbone_cfg``, model_vit.py:149-150) or an explicit
    override."""
    import dataclasses

    # embed_dim / head-count table for the timm families the reference can
    # name (model_vit.py:42-43 default + the obvious size variants)
    name_heads = {"vit_tiny": 3, "vit_small": 6, "vit_base": 12}
    if num_heads is None:
        for fam, h in name_heads.items():
            if model_name.startswith(fam):
                num_heads = h
                break
        else:
            raise SystemExit(
                f"cannot infer the attention head count from model name "
                f"{model_name!r}; pass --num_heads")

    w = _np(sd["backbone.vit_lidar.patch_embed.proj.weight"])
    embed_dim, in_ch, p, _ = w.shape
    n_tokens = _np(sd["backbone.vit_lidar.pos_embed"]).shape[1] - 1
    map_in = _np(sd["backbone.vit_map.patch_embed.proj.weight"]).shape[1]
    depth = vit_encoder_depth(sd, "backbone.vit_lidar")
    adapter_out = _np(sd["backbone.adapter_lidar.1.weight"]).shape[0]
    fc1 = _np(sd["backbone.vit_lidar.blocks.0.mlp.fc1.weight"]).shape[0]

    gh, gw = base.img_size[0] // p, base.img_size[1] // p
    if gh * gw != n_tokens:
        raise SystemExit(
            f"pos_embed carries {n_tokens} patch tokens but img_size "
            f"{base.img_size} / patch {p} gives {gh}x{gw}={gh * gw}; "
            "pass the img_size the checkpoint was trained at")
    if embed_dim % num_heads:
        raise SystemExit(
            f"embed_dim {embed_dim} not divisible by num_heads {num_heads}")
    return dataclasses.replace(
        base,
        lidar_input_channels=in_ch,
        map_input_channels=map_in,
        patch_size=p,
        embed_dim=embed_dim,
        depth=depth,
        num_heads=num_heads,
        mlp_ratio=fc1 / embed_dim,
        adapter_out_channels=adapter_out,
    )


def import_vit_nontimm(sd: Mapping[str, Any], fusion_layers: int = 2) -> dict:
    """The ViT model's reference-defined (non-timm) components
    (model_vit.py:82-92, heads.py:6-43): adapters, fusion stage, heads.

    Returns partial ``{"params", "batch_stats"}`` trees to be merged over an
    intentbev ``IntentNetViT`` init (the ViT encoder interiors stay
    intentbev-native; timm weights have no counterpart here).
    """
    backbone_p: dict = {}
    backbone_s: dict = {}
    for stream in ("lidar", "map"):
        ln_w = _np(sd[f"backbone.adapter_{stream}.0.weight"]).astype(np.float32)
        ln_b = _np(sd[f"backbone.adapter_{stream}.0.bias"]).astype(np.float32)
        backbone_p[f"adapter_{stream}_norm"] = {"scale": ln_w, "bias": ln_b}
        backbone_p[f"adapter_{stream}_proj"] = {
            "kernel": dense_kernel(sd[f"backbone.adapter_{stream}.1.weight"]),
            "bias": _np(sd[f"backbone.adapter_{stream}.1.bias"]).astype(np.float32),
        }
    backbone_p["fusion"], backbone_s["fusion"] = _stage(
        sd, "backbone.fusion_block", fusion_layers
    )
    params = {
        "backbone": backbone_p,
        "det_head": _head_conv(sd, "det_head"),
        "intention_head": _head_conv(sd, "intention_head"),
    }
    return {"params": params, "batch_stats": {"backbone": backbone_s}}


def merge_trees(base: dict, overlay: dict) -> dict:
    """Deep-merge ``overlay`` into a copy of ``base`` (leaves replaced)."""
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_trees(out[k], v)
        else:
            out[k] = v
    return out


def import_reference_checkpoint(
    ckpt_path: str,
    out_dir: str,
    model_family: str = "cnn",
    num_heads: int | None = None,
) -> str:
    """Convert a reference ``torch.save`` checkpoint file into an intentbev
    checkpoint directory consumable by ``intentbev-eval``."""
    import dataclasses

    import torch

    from .checkpoint import save_checkpoint

    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = raw.get("model_state_dict", raw) if isinstance(raw, dict) else raw
    epoch = int(raw.get("epoch", 0)) if isinstance(raw, dict) else 0
    backbone_cfg = raw.get("backbone_cfg", {}) if isinstance(raw, dict) else {}

    cfg = ExperimentConfig(model_family=model_family)
    if model_family == "cnn":
        state = import_cnn_state_dict(sd, cfg.cnn)
    else:
        base = cfg.vit
        if backbone_cfg.get("img_size"):
            base = dataclasses.replace(
                base, img_size=tuple(backbone_cfg["img_size"]))
        vit_cfg = vit_config_from_state_dict(
            sd, base, num_heads=num_heads,
            model_name=backbone_cfg.get(
                "vit_model_name_lidar", "vit_small_patch8_224"),
        )
        for key, field_name in (
            ("fusion_block_planes", "fusion_planes"),
            ("fusion_block_layers", "fusion_layers"),
            ("fusion_block_kernel_size", "fusion_kernel_size"),
            ("fusion_block_stride", "fusion_stride"),
        ):
            if key in backbone_cfg:
                vit_cfg = dataclasses.replace(
                    vit_cfg, **{field_name: backbone_cfg[key]})
        # keep the embedded grid consistent with the imported model's input
        # contract (the checkpoint is self-describing: eval rebuilds model
        # AND loader geometry from it, reference eval_vit.py:60-86)
        grid = cfg.grid
        in_ch = vit_cfg.lidar_input_channels
        if in_ch != grid.lidar_total_channels:
            if in_ch % grid.lidar_height_channels == 0:
                grid = dataclasses.replace(
                    grid, lidar_sweeps=in_ch // grid.lidar_height_channels)
            else:
                grid = dataclasses.replace(
                    grid, lidar_height_channels=in_ch, lidar_sweeps=1)
        grid = dataclasses.replace(
            grid, height_px=vit_cfg.img_size[0], width_px=vit_cfg.img_size[1],
            map_channels=vit_cfg.map_input_channels)
        cfg = dataclasses.replace(cfg, vit=vit_cfg, grid=grid)
        state = import_vit_state_dict(sd, fusion_layers=vit_cfg.fusion_layers)
    path = save_checkpoint(out_dir, step=epoch, state=state, config=cfg)
    return str(path)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Import a reference PyTorch checkpoint into an "
        "intentbev checkpoint (see docs/MIGRATION.md)."
    )
    p.add_argument("ckpt", help="reference .pth file (train_*.py output)")
    p.add_argument("out_dir", help="intentbev checkpoint directory to create")
    p.add_argument("--model", default="cnn", choices=["cnn", "vit"])
    p.add_argument(
        "--num_heads", type=int, default=None,
        help="attention head count when the timm model name in the "
        "checkpoint is not one of the known vit_{tiny,small,base} families "
        "(the head count is not recoverable from the weights)")
    args = p.parse_args(argv)
    path = import_reference_checkpoint(
        args.ckpt, args.out_dir, args.model, num_heads=args.num_heads)
    print(f"imported -> {path}")


if __name__ == "__main__":
    main()
