"""On-card smoke check: intentbev's serving and training paths on one GPU.

    python chip_smoke.py             # phases (a)-(d) on one card
    python chip_smoke.py --cards 4   # phase (e) only, on four cards

Phases, each of which fails the run on any error:

  (a) device     the default backend is a GPU;
  (b) ops        the attention route against ``reference_attention`` (f32,
                 HIGHEST) at [8, 4501, 6, 64] bf16, output and dq/dk/dv;
                 chunk placement at 400x720x290, batch 8, 16384 points per
                 sweep, bit-equal in bf16 to ``voxelize_packed`` on the raw
                 points; the full-width ViT forward in bf16 (cuDNN route) against the same
                 params in f32 on the XLA route at HIGHEST precision;
  (c) serving    ``StreamingInferencer`` on the default ViT (points and
                 chunks transports, which must agree) and CNN, batch 8,
                 three batches each, finite detections;
  (d) training   three full-width ViT ``make_train_step`` steps at batch 8
                 (points transport) with the compiled memory analysis, one
                 chunks-transport step, two CNN steps, and a checkpoint
                 save/load round trip;
  (e) 4 cards    the sharded AdamW train step on (4,1) and (2,2) meshes
                 (loss, Adam moments and their shardings) and
                 ``StreamingInferencer`` on a (4,1) mesh against one card.

Every bf16 phase asserts that its compiled program calls cuDNN's fused
attention. Weights are random from fixed seeds. The last stdout line is
``{"ok": true, "device": {...}}``; nothing is printed there on failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
BATCH = 8
POINTS_PER_SWEEP = 16384
NUM_CHUNKS = 640  # chunk capacity per band for the serving transport
ATTN_SHAPE = (8, 4501, 6, 64)  # [B, T, H, D] of one flagship stream
CUDNN_FWD = "__cudnn$fmhaSoftmax"
CUDNN_BWD = "__cudnn$fmhaSoftmaxBackward"


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in f64 on the host."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def require(ok, msg) -> None:
    """Fail the run (an explicit raise, kept under ``python -O``)."""
    if not ok:
        raise AssertionError(msg)


def check(name: str, value: float, limit: float, what: str) -> None:
    log(f"  {name}: {what} = {value:.3e} (limit {limit:.0e})")
    require(value <= limit, f"{name}: {what} {value:.3e} > {limit:.0e}")


def assert_cudnn(compiled_text: str, name: str, backward: bool = False) -> None:
    n_fwd = compiled_text.count(CUDNN_FWD + '"')
    n_bwd = compiled_text.count(CUDNN_BWD)
    log(f"  {name}: cuDNN fused-attention calls fwd={n_fwd} bwd={n_bwd}")
    require(n_fwd and (n_bwd or not backward),
            f"{name}: compiled program has no cuDNN fused attention")


def timed(fn, *args, iters: int = 5) -> float:
    """Mean wall ms per call after one warm call; ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def random_points(rng, batch: int, sweeps: int, p: int) -> tuple[np.ndarray, np.ndarray]:
    """Uniform points over the full grid's metric range, integral
    intensities (AV2 reflectance is uint8)."""
    pts = np.zeros((batch, sweeps, p, 4), np.float32)
    pts[..., 0] = rng.uniform(-20, 60, pts.shape[:3])
    pts[..., 1] = rng.uniform(-72, 72, pts.shape[:3])
    pts[..., 2] = rng.uniform(-2, 3.7, pts.shape[:3])
    pts[..., 3] = rng.integers(0, 256, pts.shape[:3]).astype(np.float32)
    return pts, np.ones((batch, sweeps, p), bool)


def random_map(rng, batch: int, grid) -> np.ndarray:
    return (rng.uniform(0, 1, (batch, grid.height_px, grid.width_px,
                               grid.map_channels)) < 0.05).astype(np.uint8)


def build_chunks(pts, valid, grid, patch, num_chunks=None):
    from intentbev.ops.voxel_embed import (
        build_voxel_chunks, pack_chunk_transport, stack_voxel_chunks)

    samples = []
    for i in range(pts.shape[0]):
        c, _ = build_voxel_chunks(pts[i], valid[i], grid, patch,
                                  num_chunks=num_chunks)
        samples.append(c)
    return pack_chunk_transport(stack_voxel_chunks(samples))


def calibrate_batch_stats(model, grid, variables, points, valid, map_bev):
    """Set BatchNorm running statistics to those of one real batch.

    Random weights with the initial running statistics (mean 0, var 1)
    normalise nothing in eval mode: on 0-255 LiDAR intensities the CNN's
    activations grow block after block until the box decode's exp()
    overflows. One train-mode forward gives new = 0.9 * old + 0.1 * batch
    per statistic, from which the batch statistics follow exactly.
    """
    import jax

    from intentbev.bev.rasterize import decode_map_transport
    from intentbev.bev.voxelize import voxelize_packed

    def batch_stats(v, p, ok, mp):
        lidar = jax.vmap(lambda pp, vv: voxelize_packed(pp, vv, grid))(p, ok)
        mp = decode_map_transport(mp, grid.map_channels, lidar.dtype)
        _, upd = model.apply(v, lidar, mp, train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.key(SEED)})
        return jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1,
                            upd["batch_stats"], v["batch_stats"])

    stats = jax.jit(batch_stats)(variables, points, valid, map_bev)
    return {**variables, "batch_stats": stats}


def init_variables(model, grid, key):
    import jax
    import jax.numpy as jnp

    lidar = jnp.zeros((1, grid.height_px, grid.width_px, grid.lidar_total_channels))
    mp = jnp.zeros((1, grid.height_px, grid.width_px, grid.map_channels))
    return jax.jit(lambda k: model.init({"params": k, "dropout": k}, lidar, mp,
                                        train=True))(key)


# --------------------------------------------------------------------------
# (b) ops at real widths
# --------------------------------------------------------------------------

def phase_attention() -> None:
    import jax
    import jax.numpy as jnp

    from intentbev.ops.attention import (
        attention_implementation, dot_product_attention, padded_seq_len,
        reference_attention)

    b, t, h, d = ATTN_SHAPE
    route = attention_implementation(jnp.bfloat16)
    t_run = padded_seq_len(t, jnp.bfloat16)
    log(f"(b1) attention [{b},{t},{h},{d}] bf16: route={route}, run at "
        f"T={t_run} with kv_len={t} (as the ViT runs it)")
    require(route == "cudnn", route)
    k0, k1, k2, k3 = jax.random.split(jax.random.key(SEED), 4)
    q, k, v, do = (jax.random.normal(kk, (b, t, h, d), jnp.bfloat16)
                   for kk in (k0, k1, k2, k3))

    def attend(q, k, v):
        pad = ((0, 0), (0, t_run - t), (0, 0), (0, 0))
        out = dot_product_attention(jnp.pad(q, pad), jnp.pad(k, pad),
                                    jnp.pad(v, pad), kv_len=t)
        return out[:, :t]

    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(attend, q, k, v)
        return (out,) + vjp(do)

    def ref_fwd_bwd(q, k, v, do):
        def f(q, k, v):
            bhtd = lambda x: jnp.swapaxes(x.astype(jnp.float32), 1, 2)  # noqa: E731
            o = reference_attention(bhtd(q), bhtd(k), bhtd(v),
                                    precision=jax.lax.Precision.HIGHEST)
            return jnp.swapaxes(o, 1, 2)
        out, vjp = jax.vjp(f, q.astype(jnp.float32), k.astype(jnp.float32),
                           v.astype(jnp.float32))
        return (out,) + vjp(do.astype(jnp.float32))

    step = jax.jit(fwd_bwd)
    assert_cudnn(step.lower(q, k, v, do).compile().as_text(), "attention",
                 backward=True)
    got = step(q, k, v, do)
    want = jax.jit(ref_fwd_bwd)(q, k, v, do)
    log("  tolerance: max|got-ref|/max|ref|, ref = f32 inputs upcast from the "
        "same bf16, precision=HIGHEST; bf16 output rounding alone is 2^-8")
    for name, g, w, lim in zip(("out", "dq", "dk", "dv"), got, want,
                               (2e-2, 5e-2, 5e-2, 5e-2)):
        check(f"attention {name}", rel_err(g, w), lim, "rel max err")
    del got, want
    fwd = jax.jit(attend)
    log(f"  time: fwd {timed(fwd, q, k, v):.3f} ms, fwd+bwd "
        f"{timed(step, q, k, v, do):.3f} ms (wall, mean of 5)")


def phase_placement() -> None:
    import jax
    import jax.numpy as jnp

    from intentbev.bev.voxelize import voxelize_packed
    from intentbev.configs import default_vit_config
    from intentbev.ops.voxel_embed import voxel_fill_bev

    cfg = default_vit_config()
    g = cfg.grid
    c = g.lidar_total_channels
    log(f"(b2) chunk placement {g.height_px}x{g.width_px}x{c}, batch {BATCH}, "
        f"{POINTS_PER_SWEEP} points/sweep x {g.lidar_sweeps} sweeps, bf16")
    pts, valid = random_points(np.random.default_rng(SEED), BATCH,
                               g.lidar_sweeps, POINTS_PER_SWEEP)
    t0 = time.perf_counter()
    chunks = build_chunks(pts, valid, g, cfg.vit.patch_size)
    log(f"  host chunk build: {(time.perf_counter() - t0) * 1e3:.1f} ms for "
        f"{BATCH} samples, chunks/band max {int(np.max(chunks.count))}")
    chunks = jax.device_put(chunks)
    pts_d, valid_d = jax.device_put((pts, valid))

    place = jax.jit(lambda ch: voxel_fill_bev(
        ch, (g.height_px, g.width_px), c, cfg.vit.patch_size, dtype=jnp.bfloat16))
    scatter = jax.jit(lambda p, v: jax.vmap(
        lambda pp, vv: voxelize_packed(pp, vv, g, out_dtype=jnp.bfloat16))(p, v))
    diff = jax.jit(lambda a, b: (jnp.sum(a != b), jnp.sum(b != 0)))
    n_diff, n_cells = (int(x) for x in diff(place(chunks), scatter(pts_d, valid_d)))
    log(f"  tolerance: bit equality in bf16 against voxelize_packed on the raw "
        f"points: {n_cells} non-zero cells, {n_diff} differ")
    require(n_diff == 0 and n_cells > 0, (n_diff, n_cells))
    log(f"  time: placement {timed(place, chunks):.3f} ms, scatter-max "
        f"voxelizer {timed(scatter, pts_d, valid_d):.3f} ms (wall, mean of 5)")


def phase_vit_forward() -> None:
    import jax
    import jax.numpy as jnp

    from intentbev.bev.voxelize import voxelize_packed
    from intentbev.configs import default_vit_config
    from intentbev.models import IntentNetViT
    from intentbev.ops.attention import attention_implementation

    cfg = default_vit_config()
    g = cfg.grid
    b = 2
    log(f"(b3) full-width ViT forward, batch {b}: bf16 route="
        f"{attention_implementation(jnp.bfloat16)} vs f32 route="
        f"{attention_implementation(jnp.float32)} at HIGHEST")
    m16 = IntentNetViT(cfg.vit, cfg.heads, dtype=jnp.bfloat16)
    m32 = IntentNetViT(cfg.vit, cfg.heads, dtype=jnp.float32)
    variables = init_variables(m32, g, jax.random.key(SEED))
    rng = np.random.default_rng(SEED + 1)
    pts, valid = random_points(rng, b, g.lidar_sweeps, POINTS_PER_SWEEP)
    lidar = jax.jit(jax.vmap(lambda p, v: voxelize_packed(p, v, g)))(pts, valid)
    mp = jnp.asarray(random_map(rng, b, g), jnp.float32)

    f16 = jax.jit(lambda v, l, m: m16.apply(v, l, m))
    assert_cudnn(f16.lower(variables, lidar, mp).compile().as_text(), "vit bf16")
    got = f16(variables, lidar, mp)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, l, m: m32.apply(v, l, m))(variables, lidar, mp)
    log("  tolerance: ||bf16 - f32|| / ||f32|| per output (24 bf16 blocks; "
        "bf16 keeps 8 mantissa bits)")
    for name, a, w in zip(("cls", "box", "intent"), got, want):
        a, w = np.asarray(a, np.float64), np.asarray(w, np.float64)
        require(np.isfinite(a).all(), f"non-finite {name} logits")
        check(f"vit {name} logits", float(np.linalg.norm(a - w) / np.linalg.norm(w)),
              5e-2, "rel L2 err")


# --------------------------------------------------------------------------
# (c) serving
# --------------------------------------------------------------------------

def phase_serving() -> None:
    import jax

    from intentbev.configs import default_cnn_config, default_vit_config
    from intentbev.models import build_model
    from intentbev.ops.attention import attention_implementation
    from intentbev.parallel import StreamingInferencer

    for cfg in (default_vit_config(), default_cnn_config()):
        g = cfg.grid
        model = build_model(cfg)
        rng = np.random.default_rng(SEED + 5)
        variables = calibrate_batch_stats(
            model, g, init_variables(model, g, jax.random.key(SEED)),
            *random_points(rng, 2, g.lidar_sweeps, POINTS_PER_SWEEP),
            random_map(rng, 2, g))
        transports = ("points", "chunks") if cfg.model_family == "vit" else ("points",)
        dets = {}
        for transport in transports:
            route = (attention_implementation(model.dtype)
                     if cfg.model_family == "vit" else "n/a")
            log(f"(c) serving {cfg.model_family} transport={transport} "
                f"dtype={np.dtype(model.dtype).name} attention route={route}")
            inf = StreamingInferencer(cfg, variables, transport=transport,
                                      num_chunks=NUM_CHUNKS)
            rng = np.random.default_rng(SEED + 7)
            dets[transport] = []
            for i in range(3):
                pts, valid = random_points(rng, BATCH, g.lidar_sweeps, POINTS_PER_SWEEP)
                mp = random_map(rng, BATCH, g)
                t0 = time.perf_counter()
                with jax.default_matmul_precision("highest"):
                    det = inf(pts, valid, mp)
                dt = (time.perf_counter() - t0) * 1e3
                require(np.isfinite(det.scores).all()
                        and np.isfinite(det.boxes_xywha).all(), "non-finite detections")
                log(f"  batch {i}: {int(det.valid.sum())} detections, "
                    f"{dt:.1f} ms wall (first includes compile)")
                dets[transport].append(det)
        if len(transports) == 2:
            # both transports build the same BEV (phase b2); only the two
            # compiled programs' f32 rounding differs
            log("  tolerance: chunks vs points transport, same points, both "
                "at HIGHEST precision: valid masks equal, scores within 1e-4")
            for a, b in zip(dets["points"], dets["chunks"]):
                np.testing.assert_array_equal(a.valid, b.valid)
                check("transport scores", float(np.max(np.abs(
                    np.asarray(a.scores) - np.asarray(b.scores)))), 1e-4, "max abs diff")


# --------------------------------------------------------------------------
# (d) training
# --------------------------------------------------------------------------

def train_batch(cfg, rng, transport: str = "points"):
    from intentbev.train import chunk_patch_for

    g = cfg.grid
    gmax = cfg.loss.max_gt_boxes
    pts, valid = random_points(rng, BATCH, g.lidar_sweeps, POINTS_PER_SWEEP)
    gt = np.zeros((BATCH, gmax, 5), np.float32)
    gt_valid = np.zeros((BATCH, gmax), bool)
    n = min(12, gmax)
    gt[:, :n, 0] = rng.uniform(0, 40, (BATCH, n))
    gt[:, :n, 1] = rng.uniform(-30, 30, (BATCH, n))
    gt[:, :n, 2] = 2.0
    gt[:, :n, 3] = 4.5
    gt[:, :n, 4] = rng.uniform(-np.pi, np.pi, (BATCH, n))
    gt_valid[:, :n] = True
    batch = {
        "map_bev": random_map(rng, BATCH, g),
        "gt_boxes": gt,
        "gt_intentions": rng.integers(0, 8, (BATCH, gmax)).astype(np.int32),
        "gt_valid": gt_valid,
        "aug_params": np.tile(np.asarray([[1.0, 0.0, 1.0]], np.float32), (BATCH, 1)),
    }
    if transport == "chunks":
        batch["chunks"] = build_chunks(pts, valid, g, chunk_patch_for(cfg),
                                       num_chunks=NUM_CHUNKS)
    else:
        batch["points"], batch["points_valid"] = pts, valid
    return batch


def run_train(cfg, steps: int, label: str, rng, check_memory: bool = False):
    import jax
    import jax.numpy as jnp

    from intentbev.boxes.anchors import generate_anchors
    from intentbev.models import build_model
    from intentbev.ops.attention import attention_implementation
    from intentbev.train import init_train_state, make_optimizer, make_train_step

    model = build_model(cfg, train_mode=True)
    route = (attention_implementation(model.dtype)
             if cfg.model_family == "vit" else "n/a")
    log(f"(d) train {label}: {cfg.model_family} batch {BATCH} transport="
        f"{cfg.train.transport} dtype={cfg.train.compute_dtype} attention "
        f"route={route}")
    tx = make_optimizer(cfg)
    anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
    step = make_train_step(model, cfg, anchors, tx)
    state = init_train_state(model, cfg, tx, jax.random.key(SEED))
    batch = jax.device_put(train_batch(cfg, rng, cfg.train.transport))
    key = jax.random.key(SEED + 1)
    t0 = time.perf_counter()
    compiled = step.lower(state, batch, key).compile()
    log(f"  compile {time.perf_counter() - t0:.1f} s")
    if cfg.model_family == "vit" and cfg.train.compute_dtype == "bfloat16":
        assert_cudnn(compiled.as_text(), f"train {label}", backward=True)
    if check_memory:
        ma = compiled.memory_analysis()
        limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit", 0)
        total = (ma.temp_size_in_bytes + ma.argument_size_in_bytes
                 + ma.output_size_in_bytes - ma.alias_size_in_bytes)
        log(f"  memory_analysis: temp {ma.temp_size_in_bytes / 2**30:.2f} GiB, "
            f"args {ma.argument_size_in_bytes / 2**30:.2f} GiB, out "
            f"{ma.output_size_in_bytes / 2**30:.2f} GiB, alias "
            f"{ma.alias_size_in_bytes / 2**30:.2f} GiB -> {total / 2**30:.2f} GiB "
            f"of the {limit / 2**30:.2f} GiB JAX may use")
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, key)
        loss = float(metrics["loss"])
        log(f"  step {i + 1}: loss {loss:.4f}, {(time.perf_counter() - t0) * 1e3:.1f} ms wall")
        require(np.isfinite(loss), loss)
    require(int(state.step) == steps, int(state.step))
    if check_memory:
        peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0)
        log(f"  peak_bytes_in_use {peak / 2**30:.2f} GiB")
    return state


def phase_training() -> None:
    import jax

    from intentbev.checkpoint import load_checkpoint, save_checkpoint
    from intentbev.configs import default_cnn_config, default_vit_config

    rng = np.random.default_rng(SEED + 11)
    vit = default_vit_config()
    state = run_train(vit, 3, "vit points", rng, check_memory=True)

    ckpt = {"params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "step": state.step}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 3, ckpt, vit)
        restored, cfg2 = load_checkpoint(d, jax.eval_shape(lambda: ckpt))
    same = jax.tree.map(lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))),
                        ckpt, restored)
    require(all(jax.tree.leaves(same)) and cfg2 == vit, "checkpoint round trip")
    log(f"(d) checkpoint round trip: {len(jax.tree.leaves(ckpt))} leaves "
        "restored bit-equal, config equal")
    del state, ckpt, restored

    chunks_cfg = dataclasses.replace(
        vit, train=dataclasses.replace(vit.train, transport="chunks"))
    run_train(chunks_cfg, 1, "vit chunks", rng)
    run_train(default_cnn_config(), 2, "cnn points", rng)


# --------------------------------------------------------------------------
# (e) four cards
# --------------------------------------------------------------------------

def adam_moments(opt_state):
    """(mu, nu) of the one Adam state inside ``make_optimizer``'s state."""
    import jax
    import optax

    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    (adam,) = [s for s in jax.tree.leaves(opt_state, is_leaf=is_adam) if is_adam(s)]
    return adam.mu, adam.nu


def tree_rel_err(got, want) -> float:
    """||got - want|| / ||want|| over all leaves, in f64 on the host."""
    import jax

    num = den = 0.0
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        num += float(np.sum((a - b) ** 2))
        den += float(np.sum(b ** 2))
    return float(np.sqrt(num / max(den, 1e-300)))


def sharded_vs_single(cfg, batch: dict, meshes) -> None:
    """One AdamW train step on one card vs on each (data, model) mesh.

    Compared: the loss; Adam's first moment mu = (1 - b1) * grad, i.e. the
    gradient, and its second moment nu = (1 - b2) * grad^2; and the
    shardings: every parameter spans more than one card, and mu and nu of
    each parameter are sharded as the parameter is. A missing all-reduce
    or a batch split wrongly changes the gradient by O(1); the limits
    leave f32 reduction-order noise (different per-card batch and
    collective order) room. The parameter update is not compared: Adam's
    first step is lr * g / (|g| + eps), about lr * sign(g), which that
    noise flips wherever g is near zero.
    """
    import jax
    import jax.numpy as jnp

    from intentbev.boxes.anchors import generate_anchors
    from intentbev.configs import MeshConfig
    from intentbev.models import build_model
    from intentbev.parallel import (
        create_mesh, local_batch_slice, make_sharded_train_step, shard_train_state)
    from intentbev.train import init_train_state, make_optimizer, make_train_step

    model = build_model(cfg, train_mode=True)
    tx = make_optimizer(cfg)
    anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
    key = jax.random.key(SEED + 1)
    init = jax.device_get(init_train_state(model, cfg, tx, jax.random.key(SEED)))
    with jax.default_matmul_precision("highest"):
        s1, m1 = make_train_step(model, cfg, anchors, tx)(
            jax.device_put(init, jax.devices()[0]), batch, key)
    loss1 = float(m1["loss"])
    mu1, nu1 = jax.device_get(adam_moments(s1.opt_state))
    del s1
    for dp, mp in meshes:
        mcfg = dataclasses.replace(cfg, mesh=MeshConfig(data_parallel=dp, model_parallel=mp))
        mesh = create_mesh(mcfg.mesh)
        state = shard_train_state(init, mesh, mcfg)
        step = make_sharded_train_step(model, mcfg, anchors, tx, mesh)(state)
        with jax.default_matmul_precision("highest"):
            sn, mn = step(state, local_batch_slice(batch, mesh, mcfg.mesh), key)
        params = jax.tree.leaves(sn.params)
        mu, nu = adam_moments(sn.opt_state)
        on_one = sum(len(p.sharding.device_set) == 1 for p in params)
        misplaced = sum(
            not m.sharding.is_equivalent_to(p.sharding, p.ndim)
            for moments in (mu, nu)
            for m, p in zip(jax.tree.leaves(moments), params, strict=True))
        split = sum(not p.sharding.is_fully_replicated for p in params)
        log(f"(e) mesh ({dp},{mp}): loss {float(mn['loss']):.6f} vs single "
            f"{loss1:.6f}; {len(params)} parameters, {split} split over "
            f"'model', {on_one} on one card; moments sharded unlike their "
            f"parameter: {misplaced}")
        check(f"mesh ({dp},{mp}) loss", abs(float(mn["loss"]) - loss1) / abs(loss1),
              1e-4, "rel err")
        check(f"mesh ({dp},{mp}) Adam mu (gradient)", tree_rel_err(mu, mu1), 1e-2,
              "||d mu|| / ||mu||")
        check(f"mesh ({dp},{mp}) Adam nu", tree_rel_err(nu, nu1), 2e-2,
              "||d nu|| / ||nu||")
        require(on_one == 0 and misplaced == 0 and (split > 0) == (mp > 1),
                f"mesh ({dp},{mp}) shardings: {on_one} on one card, "
                f"{misplaced} moments misplaced, {split} split")
        del state, sn


def streaming_vs_single(cfg, points, valid, map_bev, mesh_shape) -> None:
    import jax

    from intentbev.configs import MeshConfig
    from intentbev.models import build_model
    from intentbev.parallel import StreamingInferencer, create_mesh

    model = build_model(cfg)
    variables = init_variables(model, cfg.grid, jax.random.key(SEED))
    dp, mp = mesh_shape
    mcfg = dataclasses.replace(cfg, mesh=MeshConfig(data_parallel=dp, model_parallel=mp))
    with jax.default_matmul_precision("highest"):
        one = StreamingInferencer(mcfg, variables, mesh=create_mesh(
            MeshConfig(data_parallel=1), devices=jax.devices()[:1]))(points, valid, map_bev)
        many = StreamingInferencer(mcfg, variables)(points, valid, map_bev)
    np.testing.assert_array_equal(one.valid, many.valid)
    np.testing.assert_allclose(one.scores, many.scores, atol=1e-3)
    log(f"(e) StreamingInferencer mesh {mesh_shape} == one card "
        f"({int(many.valid.sum())} detections; scores within 1e-3)")


def phase_multi(cfg=None) -> None:
    import jax

    from intentbev.configs import default_vit_config

    if cfg is None:
        vit = default_vit_config()
        # full widths, one block per stream and f32, so both sides fit one
        # card at batch 8, compile quickly and compare at HIGHEST precision
        cfg = dataclasses.replace(
            vit, vit=dataclasses.replace(vit.vit, depth=1),
            train=dataclasses.replace(vit.train, compute_dtype="float32"))
    n = len(jax.devices())
    require(n == 4, f"--cards 4 needs 4 devices, found {n}")
    rng = np.random.default_rng(SEED + 21)
    batch = train_batch(cfg, rng)
    sharded_vs_single(cfg, batch, [(4, 1), (2, 2)])
    streaming_vs_single(cfg, batch["points"], batch["points_valid"],
                        batch["map_bev"], (4, 1))


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="4: run only the four-card phase (e)")
    args = p.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(here, "intentbev", "__init__.py")):
        print(f"no intentbev package beside {__file__}: run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from intentbev.utils.compile_cache import enable_compilation_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()!r}", file=sys.stderr)
        return 2
    enable_compilation_cache()
    log(smi)  # the card's name and power limit, as nvidia-smi reports them
    devices = jax.devices()
    log(f"(a) jax {jax.__version__}, devices: {devices}")
    t_start = time.perf_counter()
    if args.cards == 4:
        phase_multi()
    else:
        for fn in (phase_attention, phase_placement, phase_vit_forward,
                   phase_serving, phase_training):
            t0 = time.perf_counter()
            fn()
            log(f"  [{fn.__name__}: {time.perf_counter() - t0:.1f} s]")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
