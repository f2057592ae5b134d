"""Device profile of one serving or training step, by op group and scope.

Runs N steps of the chosen path timed, then traced under
``jax.profiler.trace`` with XLA's CUDA-graph command buffers off (so every
kernel keeps its HLO op name), and prints, from the trace's device lanes:

- device busy time per step and the idle share of the traced window;
- time per model scope (``jax.named_scope`` names the model sets:
  chunk_placement, voxelize_packed, layer_norm, attention, mlp, ...), from
  each kernel's op name (the compiled HLO's metadata, saved beside the
  trace as hlo.txt);
- the top kernel groups by device time.

    python tools/profile_step.py --model vit --transport chunks --steps 6
    python tools/profile_step.py --model vit --train --steps 4
    python tools/profile_step.py --model cnn --steps 6
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# scope names set in the model code, most specific first
SCOPES = ("chunk_placement", "voxelize_packed", "attention", "mlp",
          "layer_norm", "patch_embed", "residual_stage", "heads",
          "postprocess", "loss", "optimizer")


def _inputs(cfg, batch: int, transport: str):
    import numpy as np

    g = cfg.grid
    r = np.random.default_rng(0)
    s, p = g.lidar_sweeps, 16384
    pts = np.zeros((batch, s, p, 4), np.float32)
    pts[..., 0] = r.uniform(-20, 60, pts.shape[:3])
    pts[..., 1] = r.uniform(-72, 72, pts.shape[:3])
    pts[..., 2] = r.uniform(-2, 3.7, pts.shape[:3])
    pts[..., 3] = r.integers(0, 256, pts.shape[:3])
    valid = np.ones(pts.shape[:3], bool)
    mp = (r.uniform(0, 1, (batch, g.height_px, g.width_px, g.map_channels))
          < 0.05).astype(np.uint8)
    out = {"map_bev": mp}
    if transport == "chunks":
        from intentbev.ops.voxel_embed import (
            build_voxel_chunks, pack_chunk_transport, stack_voxel_chunks)
        from intentbev.train import chunk_patch_for

        out["chunks"] = pack_chunk_transport(stack_voxel_chunks([
            build_voxel_chunks(pts[i], valid[i], g, chunk_patch_for(cfg),
                               num_chunks=cfg.train.chunk_capacity,
                               on_overflow="drop")[0]
            for i in range(batch)]))
    else:
        out["points"], out["points_valid"] = pts, valid
    return out


def build_step(args):
    """(run, hlo_text): ``run()`` executes one step of the chosen path;
    ``hlo_text`` is its compiled HLO, whose op metadata names each
    kernel's source scope."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from intentbev.bev.rasterize import decode_map_transport
    from intentbev.bev.voxelize import voxelize_packed
    from intentbev.boxes.anchors import generate_anchors
    from intentbev.boxes.nms import batched_postprocess
    from intentbev.configs import default_cnn_config, default_vit_config
    from intentbev.models import build_model
    from intentbev.ops.voxel_embed import voxel_fill_bev
    from intentbev.train import (
        chunk_patch_for, init_train_state, make_optimizer, make_train_step)

    cfg = default_cnn_config() if args.model == "cnn" else default_vit_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, transport=args.transport))
    g = cfg.grid
    model = build_model(cfg, train_mode=True)  # bf16 compute
    tx = make_optimizer(cfg)
    anchors = jnp.asarray(generate_anchors(g, cfg.anchors))
    state = init_train_state(model, cfg, tx, jax.random.key(0))
    data = _inputs(cfg, args.batch, args.transport)

    if args.train:
        gmax = cfg.loss.max_gt_boxes
        gt = np.zeros((args.batch, gmax, 5), np.float32)
        gt[:, :8] = [10.0, 2.0, 2.0, 4.5, 0.3]
        gt_valid = np.zeros((args.batch, gmax), bool)
        gt_valid[:, :8] = True
        batch = jax.device_put({
            **data, "gt_boxes": gt, "gt_valid": gt_valid,
            "gt_intentions": np.zeros(gt_valid.shape, np.int32),
            "aug_params": np.tile(np.float32([[1.0, 0.0, 1.0]]), (args.batch, 1)),
        })
        key = jax.random.key(1)
        step = make_train_step(model, cfg, anchors, tx).lower(
            state, batch, key).compile()
        holder = {"state": state}

        def run():
            holder["state"], m = step(holder["state"], batch, key)
            return m

        return run, step.as_text()

    variables = {"params": state.params, "batch_stats": state.batch_stats}
    ev = cfg.eval
    data = jax.device_put(data)

    @jax.jit
    def serve(variables, data):
        mp = decode_map_transport(data["map_bev"], g.map_channels, jnp.bfloat16)
        if "chunks" in data:
            lidar = voxel_fill_bev(data["chunks"], (g.height_px, g.width_px),
                                   g.lidar_total_channels, chunk_patch_for(cfg))
        else:
            lidar = jax.vmap(lambda p, v: voxelize_packed(
                p, v, g, out_dtype=jnp.bfloat16))(data["points"], data["points_valid"])
        cls_l, box_d, int_l = model.apply(variables, lidar, mp)
        with jax.named_scope("postprocess"):
            return batched_postprocess(
                cls_l, box_d, int_l, anchors,
                confidence_threshold=ev.confidence_threshold,
                nms_iou_threshold=ev.nms_iou_threshold,
                max_pre_nms=ev.max_pre_nms, max_detections=ev.max_detections)

    compiled = serve.lower(variables, data).compile()
    return (lambda: compiled(variables, data)), compiled.as_text()


def hlo_op_names(hlo_text: str) -> dict[str, str]:
    """Instruction name -> metadata op_name, from compiled HLO text."""
    return dict(re.findall(
        r'^\s*(?:ROOT )?%?([\w.\-]+) = .*?metadata=\{[^}]*op_name="([^"]+)"',
        hlo_text, flags=re.M))


def _op_name(event: dict, op_names: dict[str, str]) -> str:
    """The source op name of a kernel: the trace's own ``tf_op`` when it
    has one, else the compiled HLO's metadata for the kernel's HLO op.
    Kernels replayed from a CUDA graph report ``hlo_op`` "command_buffer";
    XLA names their kernels after the fused instruction, "." -> "_"."""
    args = event.get("args", {})
    tf_op = str(args.get("tf_op", ""))
    if "/" in tf_op:
        return tf_op
    hlo_op = str(args.get("hlo_op", ""))
    if hlo_op and hlo_op != "command_buffer" and hlo_op in op_names:
        return op_names[hlo_op]
    name = event.get("name", "")
    return op_names.get(name) or op_names.get(re.sub(r"_(\d+)$", r".\1", name), "")


def _scope_of(text: str) -> str:
    for s in SCOPES:
        # forward ops carry ".../mlp/...", under autodiff "jvp(mlp)" and
        # "transpose(jvp(mlp))"
        if re.search(rf"(^|[/(]){s}([/)]|$)", text):
            return s
    return "other"


def parse(trace_dir: str, steps: int, top: int) -> dict:
    """Device metrics from the newest trace under ``trace_dir``; scopes come
    from ``<trace_dir>/hlo.txt`` (the step's compiled HLO) where present."""
    hlo = Path(trace_dir) / "hlo.txt"
    op_names = hlo_op_names(hlo.read_text()) if hlo.is_file() else {}
    paths = glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                      recursive=True)
    assert paths, f"no trace files under {trace_dir}"
    path = max(paths, key=os.path.getmtime)
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    # device lanes: processes named like "/device:GPU:0 ..."
    dev_pids = {e["pid"] for e in events
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and "/device:" in e.get("args", {}).get("name", "")}
    kernels = [e for e in events
               if e.get("ph") == "X" and e.get("pid") in dev_pids
               and e.get("dur") and not e.get("name", "").startswith(
                   ("XLA Modules", "Steps", "XLA Ops", "TensorFlow"))]
    assert kernels, f"no device events in {path}"
    groups = collections.defaultdict(float)
    counts = collections.defaultdict(int)
    scopes = collections.defaultdict(float)
    unscoped = collections.defaultdict(float)
    intervals = []
    for e in kernels:
        dur = float(e["dur"])  # us
        base = re.sub(r"[._]?\d+$", "", e.get("name", ""))
        groups[base] += dur
        counts[base] += 1
        op = _op_name(e, op_names)
        scope = _scope_of(op)
        scopes[scope] += dur
        if scope == "other":
            unscoped[(op or e.get("name", ""))[:120]] += dur
        intervals.append((float(e["ts"]), float(e["ts"]) + dur))
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    total = sum(groups.values())
    out = {
        "trace": path,
        "device_busy_ms_per_step": busy / 1000 / steps,
        "idle_share": 1.0 - busy / window,
        "kernel_ms_per_step": total / 1000 / steps,
        "scopes_ms_per_step": {k: v / 1000 / steps for k, v in
                               sorted(scopes.items(), key=lambda kv: -kv[1])},
        "unscoped_top_ms_per_step": {
            k: v / 1000 / steps for k, v in
            sorted(unscoped.items(), key=lambda kv: -kv[1])[:8]},
    }
    print(json.dumps(out), flush=True)
    print(f"{'kernel group':<60} {'ms/step':>9} {'calls/step':>11}")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{name[:60]:<60} {us / 1000 / steps:>9.3f} "
              f"{counts[name] / steps:>11.1f}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="vit", choices=["cnn", "vit"])
    p.add_argument("--transport", default="points", choices=["points", "chunks"])
    p.add_argument("--train", action="store_true",
                   help="profile the training step instead of serving")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--trace_dir", default=None)
    p.add_argument("--parse_only", default=None,
                   help="skip running; parse this trace dir")
    args = p.parse_args(argv)
    if args.parse_only:
        parse(args.parse_only, args.steps, args.top)
        return
    # Kernels replayed from a CUDA graph (XLA's command buffers) reach the
    # trace with hlo_op "command_buffer"; launched one by one, each keeps
    # its HLO op name, which hlo.txt maps to the model's named scope.
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()
    import jax

    from intentbev.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    fn, hlo_text = build_step(args)
    jax.block_until_ready(fn())  # warm
    t0 = time.perf_counter()
    outs = [fn() for _ in range(args.steps)]
    jax.block_until_ready(outs)
    dt = (time.perf_counter() - t0) / args.steps
    print(json.dumps({"what": f"{args.model} {'train' if args.train else 'serve'} "
                              f"{args.transport}", "batch": args.batch,
                      "wall_ms_per_step": dt * 1000,
                      "device": jax.devices()[0].device_kind}), flush=True)
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="ibprof_")
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    (Path(trace_dir) / "hlo.txt").write_text(hlo_text)
    with jax.profiler.trace(trace_dir):
        outs = [fn() for _ in range(args.steps)]
        jax.block_until_ready(outs)
    parse(trace_dir, args.steps, args.top)


if __name__ == "__main__":
    main()
