"""Training-step benchmark at full scale.

Times the single-program jitted train step (device voxelize + augment +
fwd/bwd + AdamW) on resident random data — the same step train.py runs —
and prints ms/step + samples/s:

    python tools/bench_train.py [--model cnn] [--transport chunks] [--trace]
"""

from __future__ import annotations

import argparse
import time


def main():
    from intentbev.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--points_per_sweep", type=int, default=16384)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--model", default="vit", choices=["vit", "cnn"])
    p.add_argument("--trace", action="store_true",
                   help="profile the timed steps and print top op groups")
    p.add_argument("--top", type=int, default=18)
    p.add_argument("--transport", default="points",
                   choices=["points", "chunks"],
                   help="'chunks' feeds host-built augmented voxel chunks "
                        "(TrainConfig.transport='chunks') so the device "
                        "step skips the scatter-max voxelizer")
    args = p.parse_args()

    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from intentbev.boxes.anchors import generate_anchors
    from intentbev.configs import default_cnn_config, default_vit_config
    from intentbev.models import build_model
    from intentbev.train import init_train_state, make_optimizer, make_train_step

    cfg = default_vit_config() if args.model == "vit" else default_cnn_config()
    if args.model == "vit":
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train,
                                           remat_vit_blocks=args.remat))
    if args.transport != cfg.train.transport:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train,
                                           transport=args.transport))
    g = cfg.grid
    model = build_model(cfg, train_mode=True)
    tx = make_optimizer(cfg)
    state = init_train_state(model, cfg, tx, jax.random.key(0))
    anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
    step = make_train_step(model, cfg, anchors, tx)

    B, S, P, G = args.batch, g.lidar_sweeps, args.points_per_sweep, cfg.loss.max_gt_boxes
    r = np.random.default_rng(0)
    pts = np.zeros((B, S, P, 4), np.float32)
    pts[..., 0] = r.uniform(-20, 60, (B, S, P))
    pts[..., 1] = r.uniform(-70, 70, (B, S, P))
    pts[..., 2] = r.uniform(-2, 3.7, (B, S, P))
    pts[..., 3] = r.uniform(0, 255, (B, S, P))
    gtb = np.zeros((B, G, 5), np.float32)
    gtb[..., 0] = r.uniform(0, 50, (B, G)); gtb[..., 1] = r.uniform(-30, 30, (B, G))
    gtb[..., 2] = 2.0; gtb[..., 3] = 4.5
    if args.transport == "chunks":
        from intentbev.ops.voxel_embed import (build_voxel_chunks,
                                               pack_chunk_transport,
                                               stack_voxel_chunks)
        from intentbev.train import chunk_patch_for

        patch = chunk_patch_for(cfg)
        t0 = time.perf_counter()
        chunks = pack_chunk_transport(stack_voxel_chunks([
            build_voxel_chunks(
                pts[b], np.ones((S, P), bool), g, patch,
                num_chunks=cfg.train.chunk_capacity, on_overflow="drop")[0]
            for b in range(B)
        ]))
        print(f"host chunk build: {(time.perf_counter() - t0) * 1000:.1f} "
              f"ms/batch-{B} (loader-thread work, overlaps device compute)")
        inputs = {"chunks": jax.tree_util.tree_map(jnp.asarray, chunks)}
    else:
        inputs = {"points": jnp.asarray(pts),
                  "points_valid": jnp.ones((B, S, P), bool)}
    batch = {
        **inputs,
        "map_bev": jnp.asarray(
            (r.uniform(0, 1, (B, g.height_px, g.width_px, g.map_channels))
             < 0.05).astype(np.float32)),
        "gt_boxes": jnp.asarray(gtb),
        "gt_intentions": jnp.zeros((B, G), jnp.int32),
        "gt_valid": jnp.ones((B, G), bool),
        "aug_params": jnp.tile(jnp.asarray([[1.0, 0.0, 1.0]], jnp.float32), (B, 1)),
    }
    batch = jax.device_put(batch)
    rng = jax.random.key(1)

    # compile + 2 warm steps (donated state: rebind each call)
    t0 = time.perf_counter()
    state, m = step(state, batch, rng)
    jax.block_until_ready(m)
    print(f"compile+first step: {time.perf_counter() - t0:.1f}s")
    state, m = step(state, batch, rng)
    jax.block_until_ready(m)

    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, m = step(state, batch, rng)
    jax.block_until_ready(m)
    dt = (time.perf_counter() - t0) / args.steps
    print(f"train step: {dt * 1000:.1f} ms/batch-{B} "
          f"({B / dt:.1f} samples/s), loss={float(m['loss']):.4f}")

    if args.trace:
        import os
        import sys
        import tempfile

        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from profile_step import parse

        trace_dir = tempfile.mkdtemp(prefix="ibtrain_")
        with jax.profiler.trace(trace_dir):
            for _ in range(args.steps):
                state, m = step(state, batch, rng)
            jax.block_until_ready(m)
        parse(trace_dir, args.steps, args.top)  # device lanes, by scope


if __name__ == "__main__":
    main()
