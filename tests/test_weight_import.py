"""Torch->intentbev weight import differentials against the ACTUAL reference nets.

The strongest parity proof available without the reference's trained weights:
random-initialise the reference's own torch models, import their weights via
``intentbev.import_torch``, and assert the intentbev forward reproduces the
torch forward numerically.

- IntentNetCNN (model_cnn.py:125-150) is pure torch: full-model forward
  differential, default channel widths.
- IntentNetViT's interior is timm (absent here), but everything the
  reference DEFINES — adapter LN->Linear->GELU (model_vit.py:82-83), fusion
  BasicBlock stack (model_vit.py:125-132), detection/intention heads
  (heads.py:6-43), and the token->feature-map reshape (model_vit.py:116-122)
  — is assembled from the reference's modules and compared end to end.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ref_modules import load_ref
from vit_twin import TwinViT, build_twin_intentnet_vit

from intentbev.configs import (
    CNNBackboneConfig,
    HeadConfig,
    ViTBackboneConfig,
)
from intentbev.import_torch import (
    import_cnn_state_dict,
    import_vit_encoder,
    import_vit_nontimm,
    import_vit_state_dict,
)


def _randomize_torch_model(model: torch.nn.Module, seed: int) -> None:
    """Perturb every parameter and BN running stat so constant-init params
    (BN scale=1/bias=0, head biases) can't mask mapping mistakes."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.3 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=gen))


SMALL_CNN = dict(
    lidar_input_channels=12,
    map_input_channels=9,
    lidar_planes=(16, 24, 32),
    map_planes=(8, 8, 16),
    fusion_planes=48,
)


def _build_pair(cfg: CNNBackboneConfig, seed: int):
    """(reference torch IntentNetCNN, imported intentbev variables)."""
    ref_cnn = load_ref("model_cnn")
    torch.manual_seed(seed)
    tmodel = ref_cnn.IntentNetCNN(backbone_cfg=dict(
        lidar_input_channels=cfg.lidar_input_channels,
        map_input_channels=cfg.map_input_channels,
        lidar_s1_planes=cfg.lidar_planes[0],
        lidar_s2_planes=cfg.lidar_planes[1],
        lidar_s3_planes=cfg.lidar_planes[2],
        map_s1_planes=cfg.map_planes[0],
        map_s2_planes=cfg.map_planes[1],
        map_s3_planes=cfg.map_planes[2],
        fusion_block_planes=cfg.fusion_planes,
        fusion_block_layers=cfg.fusion_layers,
        num_blocks_per_stage=cfg.num_blocks_per_stage,
        res_block2_kernel_size=cfg.stream_kernel_size,
        fusion_block_kernel_size=cfg.fusion_kernel_size,
    ))
    _randomize_torch_model(tmodel, seed + 1)
    tmodel.eval()
    variables = import_cnn_state_dict(tmodel.state_dict(), cfg)
    return tmodel, variables


class TestCNNImport:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_full_model_forward_parity(self, seed, rng):
        """Imported IntentNetCNN forward == reference forward (rtol 1e-3)."""
        from intentbev.models import IntentNetCNN

        cfg = CNNBackboneConfig(**SMALL_CNN)
        tmodel, variables = _build_pair(cfg, seed)

        b, h, w = 2, 64, 96
        lidar = rng.normal(0, 1, (b, cfg.lidar_input_channels, h, w)).astype(np.float32)
        mapb = (rng.uniform(0, 1, (b, cfg.map_input_channels, h, w)) > 0.7).astype(np.float32)

        with torch.inference_mode():
            want = tmodel(torch.tensor(lidar), torch.tensor(mapb))

        model = IntentNetCNN(cfg, HeadConfig())
        # imported tree must be structurally identical to a fresh init
        init = model.init(jax.random.key(0), jnp.asarray(lidar), jnp.asarray(mapb))
        assert jax.tree.structure(init) == jax.tree.structure(
            jax.tree.map(jnp.asarray, variables))

        got = model.apply(variables, jnp.asarray(lidar), jnp.asarray(mapb))
        for g, t, name in zip(got, want, ["cls", "box", "intent"]):
            t = t.numpy()
            assert g.shape == t.shape, name
            np.testing.assert_allclose(
                np.asarray(g), t, rtol=1e-3, atol=2e-4, err_msg=name)

    def test_default_widths_forward_parity(self, rng):
        """Same differential at the reference's real channel widths
        (290/9 in, 160/192/224 + 32/64/96, fusion 512) on a small grid."""
        from intentbev.models import IntentNetCNN

        cfg = CNNBackboneConfig()
        tmodel, variables = _build_pair(cfg, 11)

        b, h, w = 1, 32, 48
        lidar = rng.normal(0, 1, (b, 290, h, w)).astype(np.float32)
        mapb = (rng.uniform(0, 1, (b, 9, h, w)) > 0.7).astype(np.float32)
        with torch.inference_mode():
            want = tmodel(torch.tensor(lidar), torch.tensor(mapb))
        got = IntentNetCNN(cfg, HeadConfig()).apply(
            variables, jnp.asarray(lidar), jnp.asarray(mapb))
        for g, t, name in zip(got, want, ["cls", "box", "intent"]):
            np.testing.assert_allclose(
                np.asarray(g), t.numpy(), rtol=1e-3, atol=2e-4, err_msg=name)


class _ViTTail:
    """intentbev's post-encoder pipeline (the reference-defined, non-timm
    part of IntentNetViT): per-stream adapter LN->Linear->GELU, token->map
    reshape, concat, fusion residual stage, heads, flatten. Mirrors
    models/vit.py IntentNetViT.forward's tail with the same param names so
    ``import_vit_nontimm`` trees load directly."""

    def __init__(self, adapter_out: int = 48, fusion_planes: int = 96,
                 grid_hw: tuple = (6, 8)):
        self.adapter_out = adapter_out
        self.fusion_planes = fusion_planes
        self.grid_hw = grid_hw

    def init(self, key, tokens_lidar, tokens_map):
        from intentbev.configs import HeadConfig
        from intentbev.models.blocks import init_residual_stage
        from intentbev.models.heads import init_heads
        from intentbev.models.layers import init_dense, init_layer_norm

        d = tokens_lidar.shape[-1]
        bb = {}
        for name in ("lidar", "map"):
            bb[f"adapter_{name}_norm"] = init_layer_norm(d)
            bb[f"adapter_{name}_proj"] = init_dense(key, d, self.adapter_out)
        bb["fusion"], stats = init_residual_stage(
            key, 2 * self.adapter_out, self.fusion_planes, 2, 1, 3)
        return {"params": {"backbone": bb,
                           **init_heads(key, self.fusion_planes, HeadConfig())},
                "batch_stats": {"backbone": {"fusion": stats}}}

    def apply(self, variables, tokens_lidar, tokens_map):
        from intentbev.configs import HeadConfig
        from intentbev.models.blocks import residual_stage
        from intentbev.models.heads import apply_heads
        from intentbev.models.layers import dense, gelu, layer_norm

        gh, gw = self.grid_hw
        p = variables["params"]
        bb = p["backbone"]

        def stream(tokens, name):
            h = layer_norm(bb[f"adapter_{name}_norm"], tokens, jnp.float32)
            h = gelu(dense(bb[f"adapter_{name}_proj"], h, jnp.float32))
            return h.reshape(h.shape[0], gh, gw, self.adapter_out)

        fused = jnp.concatenate(
            [stream(tokens_lidar, "lidar"), stream(tokens_map, "map")], axis=-1)
        feats, _ = residual_stage(
            bb["fusion"], variables["batch_stats"]["backbone"]["fusion"], fused,
            stride=1, dtype=jnp.float32, train=False)
        return apply_heads(p, feats, HeadConfig(), jnp.float32)


class TestViTNonTimmImport:
    def test_adapter_fusion_heads_parity(self, rng):
        """Reference-assembled torch tail (adapter per model_vit.py:82-83,
        token reshape per model_vit.py:116-122, fusion per
        model_vit.py:125-132, heads per heads.py) vs intentbev's blocks on
        imported weights."""
        ref_cnn = load_ref("model_cnn")
        ref_heads = load_ref("heads")

        gh, gw, d, a_out, fus = 6, 8, 64, 48, 96
        torch.manual_seed(5)

        class RefTail(torch.nn.Module):
            def __init__(self):
                super().__init__()
                bb = torch.nn.Module()
                bb.adapter_lidar = torch.nn.Sequential(
                    torch.nn.LayerNorm(d), torch.nn.Linear(d, a_out),
                    torch.nn.GELU())
                bb.adapter_map = torch.nn.Sequential(
                    torch.nn.LayerNorm(d), torch.nn.Linear(d, a_out),
                    torch.nn.GELU())
                # reference _make_fusion_layer == _make_layer semantics
                bb.fusion_block = ref_cnn.CNNBackbone._make_layer(
                    None, ref_cnn.BasicBlock, fus, 2, stride=1,
                    current_inplanes=2 * a_out, kernel_size_for_block=3)
                self.backbone = bb
                self.det_head = ref_heads.DetectionHead(in_channels=fus)
                self.intention_head = ref_heads.IntentionHead(in_channels=fus)

            def forward(self, tl, tm):
                def stream(t, adapter):
                    at = adapter(t)  # [B, N, C]
                    b_, n_, c_ = at.shape
                    return at.permute(0, 2, 1).contiguous().view(b_, c_, gh, gw)

                fused = torch.cat(
                    [stream(tl, self.backbone.adapter_lidar),
                     stream(tm, self.backbone.adapter_map)], dim=1)
                feats = self.backbone.fusion_block(fused)
                cls_l, box_p = self.det_head(feats)
                int_l = self.intention_head(feats)
                b_ = feats.shape[0]
                return (cls_l.reshape(b_, -1, 1), box_p.reshape(b_, -1, 6),
                        int_l.reshape(b_, -1, 8))

        tmodel = RefTail()
        _randomize_torch_model(tmodel, 6)
        tmodel.eval()

        variables = import_vit_nontimm(tmodel.state_dict(), fusion_layers=2)

        b, n = 2, gh * gw
        tl = rng.normal(0, 1, (b, n, d)).astype(np.float32)
        tm = rng.normal(0, 1, (b, n, d)).astype(np.float32)
        with torch.inference_mode():
            want = tmodel(torch.tensor(tl), torch.tensor(tm))

        tail = _ViTTail(adapter_out=a_out, fusion_planes=fus, grid_hw=(gh, gw))
        init = tail.init(jax.random.key(0), jnp.asarray(tl), jnp.asarray(tm))
        assert jax.tree.structure(init) == jax.tree.structure(
            jax.tree.map(jnp.asarray, variables))

        got = tail.apply(variables, jnp.asarray(tl), jnp.asarray(tm))
        for g, t, name in zip(got, want, ["cls", "box", "intent"]):
            np.testing.assert_allclose(
                np.asarray(g), t.numpy(), atol=1e-4, err_msg=name)


class TestMergeIntoViT:
    def test_vit_nontimm_overlay_on_real_model(self, rng):
        """``import_vit_nontimm`` + ``merge_trees`` over a real IntentNetViT
        init: the reference-defined params land at the right paths and the
        full model still runs."""
        from intentbev.configs import tiny_test_config
        from intentbev.models import build_model
        from intentbev.import_torch import merge_trees

        ref_cnn = load_ref("model_cnn")
        ref_heads = load_ref("heads")
        cfg = tiny_test_config()
        v = cfg.vit  # embed 32, adapter_out 16, fusion 32, fusion_layers 1

        torch.manual_seed(9)
        tail = torch.nn.Module()
        bb = torch.nn.Module()
        bb.adapter_lidar = torch.nn.Sequential(
            torch.nn.LayerNorm(v.embed_dim),
            torch.nn.Linear(v.embed_dim, v.adapter_out_channels),
            torch.nn.GELU())
        bb.adapter_map = torch.nn.Sequential(
            torch.nn.LayerNorm(v.embed_dim),
            torch.nn.Linear(v.embed_dim, v.adapter_out_channels),
            torch.nn.GELU())
        bb.fusion_block = ref_cnn.CNNBackbone._make_layer(
            None, ref_cnn.BasicBlock, v.fusion_planes, v.fusion_layers,
            stride=v.fusion_stride, current_inplanes=2 * v.adapter_out_channels,
            kernel_size_for_block=v.fusion_kernel_size)
        tail.backbone = bb
        tail.det_head = ref_heads.DetectionHead(in_channels=v.fusion_planes)
        tail.intention_head = ref_heads.IntentionHead(in_channels=v.fusion_planes)
        _randomize_torch_model(tail, 10)

        overlay = import_vit_nontimm(tail.state_dict(),
                                     fusion_layers=v.fusion_layers)

        model = build_model(cfg)
        g = cfg.grid
        lidar = jnp.asarray(rng.normal(
            0, 1, (1, g.height_px, g.width_px, g.lidar_total_channels)), jnp.float32)
        mapb = jnp.zeros((1, g.height_px, g.width_px, g.map_channels), jnp.float32)
        init = model.init(jax.random.key(0), lidar, mapb)

        merged = {
            "params": merge_trees(dict(init["params"]), overlay["params"]),
            "batch_stats": merge_trees(
                dict(init.get("batch_stats", {})), overlay["batch_stats"]),
        }
        # same structure as the init; adapter weights actually replaced
        assert jax.tree.structure(init) == jax.tree.structure(
            jax.tree.map(jnp.asarray, merged))
        np.testing.assert_allclose(
            np.asarray(merged["params"]["backbone"]["adapter_lidar_proj"]["kernel"]),
            tail.backbone.adapter_lidar[1].weight.detach().numpy().T, atol=1e-6)

        out = model.apply(merged, lidar, mapb)
        assert all(np.isfinite(np.asarray(o)).all() for o in out)


TWIN_DIMS = dict(
    img_size=(32, 48), patch=8, embed_dim=32, depth=2, num_heads=2,
    mlp_ratio=4.0)


def _twin_vit_cfg(lidar_ch=12, map_ch=9, adapter_out=16, fusion=32):
    d = TWIN_DIMS
    return ViTBackboneConfig(
        lidar_input_channels=lidar_ch,
        map_input_channels=map_ch,
        img_size=d["img_size"],
        patch_size=d["patch"],
        embed_dim=d["embed_dim"],
        depth=d["depth"],
        num_heads=d["num_heads"],
        mlp_ratio=d["mlp_ratio"],
        adapter_out_channels=adapter_out,
        fusion_planes=fusion,
        fusion_layers=2,
    )


class TestViTEncoderImport:
    """timm-schema ViT interior -> intentbev ViTEncoder (the round-5 gap:
    the reference's FLAGSHIP trained artifact is the timm ViT,
    model_vit.py:62-74)."""

    def test_encoder_forward_parity(self, rng):
        from intentbev.models.vit import ViTEncoder

        d = TWIN_DIMS
        in_ch = 12
        torch.manual_seed(31)
        twin = TwinViT(d["img_size"], d["patch"], in_ch, d["embed_dim"],
                       d["depth"], d["num_heads"], d["mlp_ratio"])
        _randomize_torch_model(twin, 32)
        twin.eval()

        # prefix the state_dict like the full model would
        sd = {f"backbone.vit_lidar.{k}": v
              for k, v in twin.state_dict().items()}
        tree = import_vit_encoder(sd, "backbone.vit_lidar")

        cfg = _twin_vit_cfg(lidar_ch=in_ch)
        enc = ViTEncoder(cfg, in_channels=in_ch)
        x = rng.normal(0, 1, (2, in_ch, *d["img_size"])).astype(np.float32)
        x_nhwc = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))

        init = enc.init(jax.random.key(0), x_nhwc)
        variables = {"params": tree}
        assert jax.tree.structure(init) == jax.tree.structure(
            jax.tree.map(jnp.asarray, variables))

        with torch.inference_mode():
            want = twin.forward_features(torch.tensor(x)).numpy()
        got = np.asarray(enc.apply(variables, x_nhwc))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)

    def test_qkv_packing_order(self, rng):
        """The packed-qkv feature order (q first, head-major within each
        of q/k/v) must survive the import: perturb ONE head's key rows in
        torch and check the intentbev output changes only through that
        head's attention (i.e. outputs differ — a wrong packing would map
        the perturbation into v or another head and still differ, so
        additionally check against the twin's own perturbed forward)."""
        from intentbev.models.vit import ViTEncoder

        d = TWIN_DIMS
        in_ch = 12
        torch.manual_seed(41)
        twin = TwinViT(d["img_size"], d["patch"], in_ch, d["embed_dim"],
                       d["depth"], d["num_heads"], d["mlp_ratio"])
        _randomize_torch_model(twin, 42)
        twin.eval()
        # perturb k-rows of head 1 in block 0: rows D + head_dim..2*head_dim
        D, H = d["embed_dim"], d["num_heads"]
        hd = D // H
        with torch.no_grad():
            twin.blocks[0].attn.qkv.weight[D + hd: D + 2 * hd] += 0.5

        sd = {f"backbone.vit_lidar.{k}": v
              for k, v in twin.state_dict().items()}
        tree = import_vit_encoder(sd, "backbone.vit_lidar")
        cfg = _twin_vit_cfg(lidar_ch=in_ch)
        enc = ViTEncoder(cfg, in_channels=in_ch)
        x = rng.normal(0, 1, (1, in_ch, *d["img_size"])).astype(np.float32)
        with torch.inference_mode():
            want = twin.forward_features(torch.tensor(x)).numpy()
        got = np.asarray(enc.apply(
            {"params": tree}, jnp.asarray(np.transpose(x, (0, 2, 3, 1)))))
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


class TestViTFullImport:
    def _build_pair(self, seed):
        ref_cnn = load_ref("model_cnn")
        ref_heads = load_ref("heads")
        d = TWIN_DIMS
        torch.manual_seed(seed)
        twin = build_twin_intentnet_vit(
            ref_cnn, ref_heads,
            img_size=d["img_size"], patch=d["patch"], lidar_chans=12,
            map_chans=9, embed_dim=d["embed_dim"], depth=d["depth"],
            num_heads=d["num_heads"], adapter_out=16, fusion_planes=32,
            fusion_layers=2, fusion_stride=1, mlp_ratio=d["mlp_ratio"])
        _randomize_torch_model(twin, seed + 1)
        twin.eval()
        variables = import_vit_state_dict(twin.state_dict(), fusion_layers=2)
        return twin, variables

    def test_full_model_forward_parity(self, rng):
        """Imported IntentNetViT forward == the torch twin (timm math +
        reference tail) to < 1e-3 — the round-5 'done' bar."""
        from intentbev.models import IntentNetViT

        twin, variables = self._build_pair(51)
        cfg = _twin_vit_cfg()
        lidar = rng.normal(0, 1, (2, 12, *TWIN_DIMS["img_size"])).astype(np.float32)
        mapb = (rng.uniform(0, 1, (2, 9, *TWIN_DIMS["img_size"])) > 0.7
                ).astype(np.float32)
        with torch.inference_mode():
            want = twin(torch.tensor(lidar), torch.tensor(mapb))

        model = IntentNetViT(cfg, HeadConfig())
        init = model.init(jax.random.key(0), jnp.asarray(lidar), jnp.asarray(mapb))
        assert jax.tree.structure(init) == jax.tree.structure(
            jax.tree.map(jnp.asarray, variables))

        got = model.apply(variables, jnp.asarray(lidar), jnp.asarray(mapb))
        for g, t, name in zip(got, want, ["cls", "box", "intent"]):
            t = t.numpy()
            assert g.shape == t.shape, name
            assert np.max(np.abs(np.asarray(g) - t)) < 1e-3, name

    def test_flagship_size_schema_maps(self):
        """The REAL vit_small_patch8_224 schema at full reference size
        (290/9 in-chans, 400x720, embed 384, depth 12) imports into a tree
        structurally identical to IntentNetViT's init (shape-only via
        eval_shape — no full-size forward on CPU)."""
        from intentbev.configs import ExperimentConfig
        from intentbev.models import build_model

        ref_cnn = load_ref("model_cnn")
        ref_heads = load_ref("heads")
        torch.manual_seed(61)
        twin = build_twin_intentnet_vit(
            ref_cnn, ref_heads,
            img_size=(400, 720), patch=8, lidar_chans=290, map_chans=9,
            embed_dim=384, depth=12, num_heads=6, adapter_out=192,
            fusion_planes=512, fusion_layers=2, fusion_stride=1)
        variables = import_vit_state_dict(twin.state_dict(), fusion_layers=2)

        cfg = ExperimentConfig(model_family="vit")
        model = build_model(cfg)
        g = cfg.grid
        init = jax.eval_shape(
            model.init, jax.random.key(0),
            jax.ShapeDtypeStruct(
                (1, g.height_px, g.width_px, g.lidar_total_channels),
                jnp.float32),
            jax.ShapeDtypeStruct(
                (1, g.height_px, g.width_px, g.map_channels), jnp.float32))
        got_shapes = jax.tree.map(lambda a: tuple(a.shape), variables)
        want_shapes = jax.tree.map(lambda a: tuple(a.shape), init)
        assert got_shapes == want_shapes


class TestImportCLI:
    def test_reference_checkpoint_roundtrip(self, tmp_path, rng):
        """reference torch.save file -> intentbev-import-torch -> intentbev
        checkpoint that load_checkpoint restores with the same weights."""
        from intentbev.checkpoint import load_checkpoint
        from intentbev.import_torch import main as import_main

        cfg = CNNBackboneConfig()
        tmodel, variables = _build_pair(cfg, 21)
        pth = tmp_path / "intentnet_cnn_final.pth"
        torch.save({
            "epoch": 9,
            "model_state_dict": tmodel.state_dict(),
            "optimizer_state_dict": {},
            "backbone_cfg": {},
        }, pth)

        out_dir = tmp_path / "imported"
        import_main([str(pth), str(out_dir), "--model", "cnn"])

        state, exp_cfg = load_checkpoint(out_dir)
        assert exp_cfg.model_family == "cnn"
        np.testing.assert_allclose(
            state["params"]["backbone"]["lidar_stage1"]["block0"]["conv1"]["kernel"],
            variables["params"]["backbone"]["lidar_stage1"]["block0"]["conv1"]["kernel"],
            atol=0)
        np.testing.assert_allclose(
            state["batch_stats"]["backbone"]["fusion"]["block1"]["bn2"]["var"],
            variables["batch_stats"]["backbone"]["fusion"]["block1"]["bn2"]["var"],
            atol=0)

    def test_vit_checkpoint_roundtrip_and_eval_equivalence(
            self, tmp_path, rng):
        """reference ViT torch.save file -> ``intentbev-import-torch
        --model vit`` -> intentbev checkpoint; the imported checkpoint and a
        natively-saved checkpoint of the same weights give IDENTICAL eval
        metrics on a synthetic split (the round-5 'done' bar)."""
        import dataclasses

        from intentbev.checkpoint import load_checkpoint, save_checkpoint
        from intentbev.configs import GridConfig, tiny_test_config
        from intentbev.data.synthetic import write_synthetic_log
        from intentbev.evaluate import evaluate
        from intentbev.import_torch import main as import_main
        from intentbev.precompute_labels import run as precompute_run

        ref_cnn = load_ref("model_cnn")
        ref_heads = load_ref("heads")
        torch.manual_seed(71)
        # twin at the tiny-eval geometry: grid 64x96, 4 z-slices x 3 sweeps
        twin = build_twin_intentnet_vit(
            ref_cnn, ref_heads,
            img_size=(64, 96), patch=8, lidar_chans=12, map_chans=9,
            embed_dim=32, depth=2, num_heads=2, adapter_out=16,
            fusion_planes=32, fusion_layers=2, fusion_stride=1)
        _randomize_torch_model(twin, 72)
        twin.eval()
        variables = import_vit_state_dict(twin.state_dict(), fusion_layers=2)

        pth = tmp_path / "intentnet_vit_final.pth"
        torch.save({
            "epoch": 3,
            "model_state_dict": twin.state_dict(),
            "optimizer_state_dict": {},
            "backbone_cfg": {
                "vit_model_name_lidar": "vit_small_patch8_224",
                "img_size": (64, 96),
                "fusion_block_planes": 32,
                "fusion_block_layers": 2,
                "fusion_block_stride": 1,
            },
        }, pth)

        imported_dir = tmp_path / "imported_vit"
        import_main([str(pth), str(imported_dir), "--model", "vit",
                     "--num_heads", "2"])

        state, got_cfg = load_checkpoint(imported_dir)
        assert got_cfg.model_family == "vit"
        v = got_cfg.vit
        assert (v.embed_dim, v.depth, v.num_heads, v.patch_size) == (32, 2, 2, 8)
        assert v.img_size == (64, 96) and v.lidar_input_channels == 12
        np.testing.assert_array_equal(
            state["params"]["backbone"]["vit_lidar"]["block0"]["attn"]["qkv"]["kernel"],
            variables["params"]["backbone"]["vit_lidar"]["block0"]["attn"]["qkv"]["kernel"])

        # the eval config: tiny grid matching the synthetic fixture
        cfg = tiny_test_config()
        grid = GridConfig(height_px=64, width_px=96,
                          lidar_height_channels=4, lidar_sweeps=3)
        vit_cfg = dataclasses.replace(
            _twin_vit_cfg(lidar_ch=12, map_ch=9, adapter_out=16, fusion=32),
            img_size=(64, 96))
        cfg = dataclasses.replace(cfg, model_family="vit", grid=grid,
                                  vit=vit_cfg)

        native_dir = tmp_path / "native_vit"
        save_checkpoint(str(native_dir), step=3, state=variables, config=cfg)

        split = tmp_path / "val"
        split.mkdir()
        write_synthetic_log(split, log_id="importeval01", num_frames=6,
                            seed=7)
        precompute_run(str(tmp_path), ["val"], force=True)

        m_imp = evaluate(str(imported_dir), str(split), cfg_override=cfg,
                         num_workers=1, log_fn=lambda *_: None)
        m_nat = evaluate(str(native_dir), str(split), cfg_override=cfg,
                         num_workers=1, log_fn=lambda *_: None)
        assert m_imp == m_nat
        assert m_imp["num_samples"] > 0
