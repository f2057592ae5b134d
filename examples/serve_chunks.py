"""Sustained offline serving on the chunk-transport path.

Drives ``StreamingInferencer(transport="chunks")`` with a real
producer/consumer pipeline: a host thread builds placement chunks (C++
``ib_build_chunks``) for upcoming frames while the device runs the current
batch. Reports three numbers:

- host chunk-build rate (the transport-prep cost, samples/s),
- device-only inference rate (inputs pre-staged on device),
- sustained pipeline rate (frames in -> detections out, wall clock,
  including host->device transfer).

    python examples/serve_chunks.py --batches 8 --batch 8
"""

from __future__ import annotations

import argparse
import queue
import threading
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--points_per_sweep", type=int, default=16384)
    p.add_argument("--tiny", action="store_true",
                   help="tiny config (for CPU smoke runs)")
    p.add_argument("--iters", type=int, default=10,
                   help="device-only timing iterations")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from intentbev.configs import default_vit_config, tiny_test_config
    from intentbev.models import build_model
    from intentbev.parallel import StreamingInferencer

    cfg = tiny_test_config() if args.tiny else default_vit_config()
    g = cfg.grid
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    lidar0 = jnp.zeros((1, g.height_px, g.width_px, g.lidar_total_channels))
    map0 = jnp.zeros((1, g.height_px, g.width_px, g.map_channels))
    variables = jax.jit(model.init)(jax.random.key(0), lidar0, map0)

    inf = StreamingInferencer(cfg, variables, transport="chunks")
    B, S, P = args.batch, g.lidar_sweeps, args.points_per_sweep

    def random_batch(seed):
        r = np.random.default_rng(seed)
        pts = np.zeros((B, S, P, 4), np.float32)
        pts[..., 0] = r.uniform(-g.x_range_m / 4, g.x_range_m * 3 / 4, pts.shape[:3])
        pts[..., 1] = r.uniform(-g.y_range_m / 2, g.y_range_m / 2, pts.shape[:3])
        pts[..., 2] = r.uniform(g.z_min, g.z_max - 0.1, pts.shape[:3])
        pts[..., 3] = r.uniform(0, 255, pts.shape[:3])
        pv = np.ones((B, S, P), bool)
        # bit-packed u8 map transport (the loader's production encoding;
        # decode_map_transport unpacks on device) — 18x fewer H2D bytes
        # than f32, which matters wherever host->device bandwidth is the
        # sustained-pipeline limiter
        from intentbev.bev.rasterize import pack_map_channels
        mp = pack_map_channels(
            r.uniform(0, 1, (B, g.height_px, g.width_px, g.map_channels))
            < 0.05)
        return pts, pv, mp

    # --- host chunk-build rate ---
    pts0, pv0, mp0 = random_batch(0)
    inf.build_chunks(pts0, pv0)  # warm the native lib
    t0 = time.perf_counter()
    chunks0 = inf.build_chunks(pts0, pv0)
    t_build = time.perf_counter() - t0
    print(f"host chunk build: {t_build / B * 1000:.1f} ms/sample "
          f"({B / t_build:.0f} samples/s on this host)")

    # --- device-only rate (inputs staged, chained like bench.py) ---
    det = inf.infer_chunks(chunks0, mp0)  # compile + warm
    staged = jax.device_put(chunks0)
    mp_dev = jax.device_put(jnp.asarray(mp0))
    iters = args.iters
    t0 = time.perf_counter()
    det_dev = None
    for _ in range(iters):
        det_dev = inf.infer_chunks(staged, mp_dev, blocking=False)
    inf.fetch(det_dev)  # sync: same-stream, so this drains all iters
    dt = time.perf_counter() - t0
    print(f"device inference: {B * iters / dt:.1f} frames/s "
          f"(queued dispatch; one detection fetch at the end)")

    # --- sustained pipeline: producer thread builds, consumer infers ---
    q: queue.Queue = queue.Queue(maxsize=2)

    def producer():
        for i in range(args.batches):
            pts, pv, mp = random_batch(i + 1)
            q.put((inf.build_chunks(pts, pv), mp))
        q.put(None)

    threading.Thread(target=producer, daemon=True).start()
    n = 0
    det = None  # double-buffer: fetch batch i while i+1 computes
    t0 = time.perf_counter()
    while True:
        item = q.get()
        if item is None:
            break
        chunks, mp = item
        det_dev = inf.infer_chunks(chunks, mp, blocking=False)
        if det is not None:
            inf.fetch(det)
        det = det_dev
        n += B
    det = inf.fetch(det)
    dt = time.perf_counter() - t0
    print(f"sustained pipeline: {n / dt:.1f} frames/s over {n} frames "
          f"(incl. host build + host->device transfer)")
    print(f"last batch: {int(det.valid.sum())} detections across {B} frames")


if __name__ == "__main__":
    main()
