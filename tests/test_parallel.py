"""Distributed tests on the virtual 8-device CPU mesh (SURVEY §4 item 3):
pjit sharding compiles + executes, DP+TP parity vs single-device step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from intentbev.configs import MeshConfig, tiny_test_config
from intentbev.boxes.anchors import generate_anchors
from intentbev.models import build_model
from intentbev.parallel import (
    batch_sharding,
    create_mesh,
    make_sharded_train_step,
    param_shardings,
    shard_train_state,
)
from intentbev.train import init_train_state, make_optimizer, make_train_step


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 fake CPU devices"
)


def _make_batch(cfg, batch=8, seed=0):
    g = cfg.grid
    rng = np.random.default_rng(seed)
    S, P, G = g.lidar_sweeps, 256, cfg.loss.max_gt_boxes
    pts = np.zeros((batch, S, P, 4), np.float32)
    pts[..., 0] = rng.uniform(-10, 12, (batch, S, P))
    pts[..., 1] = rng.uniform(-9, 9, (batch, S, P))
    pts[..., 2] = rng.uniform(-1.5, 1.5, (batch, S, P))
    pts[..., 3] = rng.uniform(0, 255, (batch, S, P))
    gtb = np.zeros((batch, G, 5), np.float32)
    gtv = np.zeros((batch, G), bool)
    for b in range(batch):
        gtb[b, 0] = [5.0, 1.0, 2.0, 4.5, 0.0]
        gtv[b, 0] = True
    return {
        "points": pts,
        "points_valid": np.ones((batch, S, P), bool),
        "map_bev": rng.uniform(0, 1, (batch, g.height_px, g.width_px, g.map_channels)).astype(np.float32),
        "gt_boxes": gtb,
        "gt_intentions": np.zeros((batch, G), np.int32),
        "gt_valid": gtv,
        "aug_params": np.tile(np.array([[1.0, 0.0, 1.0]], np.float32), (batch, 1)),
    }


class TestMesh:
    def test_create_mesh_shapes(self):
        mesh = create_mesh(MeshConfig(model_parallel=2))
        assert mesh.devices.shape == (4, 2)
        assert mesh.axis_names == ("data", "model")

    def test_bad_divisibility(self):
        with pytest.raises(ValueError):
            create_mesh(MeshConfig(model_parallel=3))


class TestShardingRules:
    def test_vit_param_specs(self):
        cfg = tiny_test_config()
        model = build_model(cfg)
        g = cfg.grid
        lidar = jnp.zeros((1, g.height_px, g.width_px, g.lidar_total_channels))
        mp = jnp.zeros((1, g.height_px, g.width_px, g.map_channels))
        params = model.init(jax.random.key(0), lidar, mp)["params"]
        mesh = create_mesh(MeshConfig(model_parallel=2))
        shardings = param_shardings(params, mesh, cfg.mesh)
        blk = shardings["backbone"]["vit_lidar"]["block0"]
        assert blk["attn"]["qkv"]["kernel"].spec == jax.sharding.PartitionSpec(None, "model")
        assert blk["attn"]["proj"]["kernel"].spec == jax.sharding.PartitionSpec("model", None)
        assert blk["mlp"]["fc1"]["kernel"].spec == jax.sharding.PartitionSpec(None, "model")
        assert blk["mlp"]["fc2"]["kernel"].spec == jax.sharding.PartitionSpec("model", None)
        # conv / norm / head params replicated
        assert shardings["det_head"]["conv"]["kernel"].spec == jax.sharding.PartitionSpec()


class TestShardedStep:
    def test_adam_moments_sharded_like_params(self):
        """mu and nu of a tensor-parallel weight are split like the weight
        itself, before and after a step; counters stay replicated."""
        import optax

        cfg = dataclasses.replace(tiny_test_config(), mesh=MeshConfig(model_parallel=2))
        model = build_model(cfg, train_mode=True)
        tx = make_optimizer(cfg)
        state = init_train_state(model, cfg, tx, jax.random.key(0))
        mesh = create_mesh(cfg.mesh)
        anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
        sharded = shard_train_state(state, mesh, cfg)
        step = make_sharded_train_step(model, cfg, anchors, tx, mesh)(sharded)
        after, _ = step(sharded, jax.device_put(_make_batch(cfg),
                                                batch_sharding(mesh, cfg.mesh)),
                        jax.random.key(1))
        for st in (sharded, after):
            adam = [s for s in jax.tree.leaves(
                st.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState)]
            assert len(adam) == 1
            p_leaves = jax.tree.leaves(st.params)
            for moments in (adam[0].mu, adam[0].nu):
                for m, p in zip(jax.tree.leaves(moments), p_leaves, strict=True):
                    assert m.sharding.is_equivalent_to(p.sharding, p.ndim)
            qkv = st.params["backbone"]["vit_lidar"]["block0"]["attn"]["qkv"]["kernel"]
            assert qkv.sharding.spec == jax.sharding.PartitionSpec(None, "model")
            assert adam[0].count.sharding.is_fully_replicated

    @pytest.mark.parametrize("model_parallel", [1, 2])
    def test_dp_tp_step_runs_and_matches_single_device(self, model_parallel):
        cfg = tiny_test_config()
        # deterministic: no augmentation randomness differences — single- and
        # multi-device steps share the same rng and the same batch
        cfg = dataclasses.replace(
            cfg,
            mesh=MeshConfig(model_parallel=model_parallel),
            augment=dataclasses.replace(
                cfg.augment, flip_prob=0, rotate_prob=0, scale_prob=0, dropout_prob=0
            ),
        )
        model = build_model(cfg, train_mode=True)
        tx = make_optimizer(cfg)
        state = init_train_state(model, cfg, tx, jax.random.key(0))
        anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
        batch = _make_batch(cfg)
        rng = jax.random.key(42)

        # single-device reference
        ref_step = make_train_step(model, cfg, anchors, tx)
        state_ref = jax.tree.map(jnp.copy, state)
        state_ref, metrics_ref = ref_step(state_ref, jax.device_put(batch), rng)

        # sharded
        mesh = create_mesh(cfg.mesh)
        sharded_state = shard_train_state(state, mesh, cfg)
        compile_for = make_sharded_train_step(model, cfg, anchors, tx, mesh)
        step = compile_for(sharded_state)
        b_shard = batch_sharding(mesh, cfg.mesh)
        batch_dev = jax.device_put(batch, b_shard)
        new_state, metrics = step(sharded_state, batch_dev, rng)

        np.testing.assert_allclose(
            float(metrics["loss"]), float(metrics_ref["loss"]), rtol=2e-4
        )
        np.testing.assert_allclose(
            float(metrics["num_pos_anchors"]), float(metrics_ref["num_pos_anchors"])
        )
        # a step actually happened and params changed identically-ish
        p_ref = jax.tree.leaves(state_ref.params)[0]
        p_new = jax.tree.leaves(new_state.params)[0]
        np.testing.assert_allclose(np.asarray(p_new), np.asarray(p_ref), atol=5e-4)

    def test_intention_weights_respected_in_sharded_step(self):
        """--distributed + --use_intention_weights must match single-device
        (weights silently dropped in the sharded step was a real bug)."""
        cfg = tiny_test_config()
        cfg = dataclasses.replace(
            cfg,
            mesh=MeshConfig(model_parallel=1),
            loss=dataclasses.replace(cfg.loss, apply_intention_downsampling=False),
            augment=dataclasses.replace(
                cfg.augment, flip_prob=0, rotate_prob=0, scale_prob=0, dropout_prob=0
            ),
        )
        model = build_model(cfg, train_mode=True)
        tx = make_optimizer(cfg)
        state = init_train_state(model, cfg, tx, jax.random.key(0))
        anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
        batch = _make_batch(cfg)
        rng = jax.random.key(42)
        w = jnp.asarray(np.linspace(0.01, 0.5, 8, dtype=np.float32))

        ref_step = make_train_step(model, cfg, anchors, tx, intention_weights=w)
        _, metrics_ref = ref_step(jax.tree.map(jnp.copy, state),
                                  jax.device_put(batch), rng)

        mesh = create_mesh(cfg.mesh)
        sharded_state = shard_train_state(state, mesh, cfg)
        step = make_sharded_train_step(
            model, cfg, anchors, tx, mesh, intention_weights=w
        )(sharded_state)
        batch_dev = jax.device_put(batch, batch_sharding(mesh, cfg.mesh))
        _, metrics = step(sharded_state, batch_dev, rng)
        np.testing.assert_allclose(
            float(metrics["intent_loss"]), float(metrics_ref["intent_loss"]),
            rtol=2e-4,
        )

        # and the weights actually change the loss vs the unweighted step
        # (the first step donated its input state, so re-shard a fresh one)
        sharded_state2 = shard_train_state(
            init_train_state(model, cfg, tx, jax.random.key(0)), mesh, cfg
        )
        step_nw = make_sharded_train_step(model, cfg, anchors, tx, mesh)(sharded_state2)
        _, metrics_nw = step_nw(sharded_state2, batch_dev, rng)
        assert abs(float(metrics_nw["intent_loss"]) - float(metrics["intent_loss"])) > 1e-6

    def test_second_step_reuses_compile(self):
        cfg = tiny_test_config()
        cfg = dataclasses.replace(cfg, mesh=MeshConfig(model_parallel=2))
        model = build_model(cfg, train_mode=True)
        tx = make_optimizer(cfg)
        state = init_train_state(model, cfg, tx, jax.random.key(0))
        anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
        mesh = create_mesh(cfg.mesh)
        sharded = shard_train_state(state, mesh, cfg)
        step = make_sharded_train_step(model, cfg, anchors, tx, mesh)(sharded)
        batch = jax.device_put(_make_batch(cfg), batch_sharding(mesh, cfg.mesh))
        s1, m1 = step(sharded, batch, jax.random.key(0))
        s2, m2 = step(s1, batch, jax.random.key(0))
        assert np.isfinite(float(m2["loss"]))
        assert int(np.asarray(s2.step)) == 2


class TestDriverDryrun:
    """The driver-facing __graft_entry__.dryrun_multichip contract."""

    def test_dryrun_inprocess(self):
        # conftest gives this process 8 virtual CPU devices -> in-process path
        import sys, os
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        from __graft_entry__ import dryrun_multichip
        dryrun_multichip(8)

    def test_dryrun_subprocess_bootstrap(self):
        # The path taken on a host with fewer devices than the mesh: the dry
        # run re-execs itself in a child that forces a CPU mesh.
        import sys, os
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        from __graft_entry__ import _dryrun_subprocess
        _dryrun_subprocess(8)


class TestShardedEval:
    def test_8device_eval_matches_single_device(self):
        """SURVEY §2.2 'on-device eval collectives': AP/confusion accumulated
        over a data-sharded batch must equal the single-device result."""
        from intentbev.evaluate import make_eval_step
        from intentbev.parallel.sharding import replicated

        cfg = tiny_test_config()
        model = build_model(cfg)
        g = cfg.grid
        lidar0 = jnp.zeros((1, g.height_px, g.width_px, g.lidar_total_channels))
        map0 = jnp.zeros((1, g.height_px, g.width_px, g.map_channels))
        variables = model.init(jax.random.key(0), lidar0, map0)
        anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
        batch = _make_batch(cfg, batch=8)
        sample_valid = np.ones((8,), bool)

        step_1d, init_1d = make_eval_step(model, cfg, anchors)
        acc_ref, _ = step_1d(variables, batch, sample_valid, init_1d())

        mesh = create_mesh(MeshConfig(model_parallel=1))
        step_8d, init_8d = make_eval_step(model, cfg, anchors, mesh=mesh)
        b_shard = batch_sharding(mesh, cfg.mesh)
        acc, _ = step_8d(
            jax.device_put(variables, replicated(mesh)),
            jax.device_put(batch, b_shard),
            jax.device_put(sample_valid, b_shard),
            init_8d(),
        )
        np.testing.assert_allclose(
            np.asarray(acc.ap_sum), np.asarray(acc_ref.ap_sum), rtol=1e-5)
        assert int(acc.num_samples) == int(acc_ref.num_samples) == 8
        np.testing.assert_array_equal(
            np.asarray(acc.confusion), np.asarray(acc_ref.confusion))


class TestMultiHostSharding:
    """Pure per-process input sharding (parallel.mesh.shard_sequences_for_process)."""

    def test_disjoint_equal_deterministic(self):
        from intentbev.parallel.mesh import shard_sequences_for_process

        seqs = [f"s{i}" for i in range(23)]
        shards = [
            shard_sequences_for_process(seqs, p, 4, 8) for p in range(4)
        ]
        lens = [len(s) for s, _ in shards]
        # truncated to a COMMON per-process length (23 // 4 == 5)
        assert lens == [5, 5, 5, 5]
        all_items = [x for s, _ in shards for x in s]
        assert len(set(all_items)) == len(all_items)  # disjoint
        assert all(bs == 2 for _, bs in shards)
        # deterministic
        again, _ = shard_sequences_for_process(seqs, 2, 4, 8)
        assert again == shards[2][0]

    def test_errors(self):
        from intentbev.parallel.mesh import shard_sequences_for_process

        with pytest.raises(ValueError, match="divisible"):
            shard_sequences_for_process(list(range(10)), 0, 3, 8)
        with pytest.raises(ValueError, match="out of range"):
            shard_sequences_for_process(list(range(10)), 3, 3, 9)
        with pytest.raises(ValueError, match="process_count"):
            shard_sequences_for_process(list(range(10)), 0, 0, 8)

    def test_single_process_identity(self):
        from intentbev.parallel.mesh import shard_sequences_for_process

        seqs = list(range(7))
        local, bs = shard_sequences_for_process(seqs, 0, 1, 8)
        assert local == seqs and bs == 8


class TestFlagshipShapeMultichip:
    """Multi-device validation at FLAGSHIP shapes: the
    tiny-config dryrun proves plumbing; these prove the full-size programs
    actually lower + compile under the production shardings."""

    def test_aot_compile_full_size_dp_tp_train_step(self):
        """AOT lower+compile (no run) of the full 400x720 / 290-ch /
        22,500-anchor DP x TP (4,2) train step on the 8-device mesh,
        with abstract (ShapeDtypeStruct) inputs so no full-size arrays are
        ever materialized. ~85 s XLA CPU compile."""
        from intentbev.configs import default_vit_config
        from intentbev.train import init_train_state, make_optimizer

        cfg = default_vit_config()
        cfg = dataclasses.replace(cfg, mesh=MeshConfig(model_parallel=2))
        model = build_model(cfg, train_mode=True)
        tx = make_optimizer(cfg)
        mesh = create_mesh(cfg.mesh, devices=jax.devices()[:8])
        anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
        state_sd = jax.eval_shape(
            lambda: init_train_state(model, cfg, tx, jax.random.key(0)))

        g = cfg.grid
        B, S, P, G = 8, g.lidar_sweeps, 2048, cfg.loss.max_gt_boxes
        sd = jax.ShapeDtypeStruct
        batch_sd = {
            "points": sd((B, S, P, 4), jnp.float32),
            "points_valid": sd((B, S, P), jnp.bool_),
            "map_bev": sd((B, g.height_px, g.width_px, g.map_channels), jnp.float32),
            "gt_boxes": sd((B, G, 5), jnp.float32),
            "gt_intentions": sd((B, G), jnp.int32),
            "gt_valid": sd((B, G), jnp.bool_),
            "aug_params": sd((B, 3), jnp.float32),
        }
        step = make_sharded_train_step(model, cfg, anchors, tx, mesh)(state_sd)
        compiled = step.lower(state_sd, batch_sd, jax.random.key(0)).compile()
        # sanity: the compiled program exists and reports memory use
        mem = compiled.memory_analysis()
        if mem is not None:
            assert mem.temp_size_in_bytes > 0

    def test_16device_streaming_inference_dryrun(self):
        """BASELINE config 5 (streaming inference across devices): a 16-device
        data-parallel StreamingInferencer mesh compiles and executes one
        batch. Needs 16 virtual devices, so it re-execs in a subprocess
        (conftest pins this process to 8)."""
        import os
        import subprocess
        import sys as _sys
        from pathlib import Path

        code = """
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np
from intentbev.configs import MeshConfig, tiny_test_config
from intentbev.models import build_model
from intentbev.parallel import StreamingInferencer, create_mesh
import dataclasses, jax.numpy as jnp

assert len(jax.devices()) == 16, jax.devices()
cfg = tiny_test_config()
cfg = dataclasses.replace(cfg, mesh=MeshConfig(model_parallel=1))
mesh = create_mesh(cfg.mesh, devices=jax.devices())
assert mesh.devices.shape == (16, 1), mesh.devices.shape
g = cfg.grid
model = build_model(cfg)
lidar0 = jnp.zeros((1, g.height_px, g.width_px, g.lidar_total_channels))
map0 = jnp.zeros((1, g.height_px, g.width_px, g.map_channels))
variables = model.init(jax.random.key(0), lidar0, map0)
inf = StreamingInferencer(cfg, variables, mesh=mesh)
assert inf.batch_multiple == 16
B, S, P = 16, g.lidar_sweeps, 128
r = np.random.default_rng(0)
pts = np.zeros((B, S, P, 4), np.float32)
pts[..., 0] = r.uniform(0, 10, (B, S, P)); pts[..., 1] = r.uniform(-5, 5, (B, S, P))
pts[..., 2] = r.uniform(-1, 1, (B, S, P)); pts[..., 3] = r.uniform(0, 255, (B, S, P))
mp = r.uniform(0, 1, (B, g.height_px, g.width_px, g.map_channels)).astype(np.float32)
det = inf(pts, np.ones((B, S, P), bool), mp)
assert det.boxes_xywha.shape == (B, cfg.eval.max_detections, 5)
assert np.isfinite(det.scores).all()
print('STREAM16 OK', det.valid.sum())

# flagship grid shapes: AOT lower+compile the
# FULL-SIZE (400x720/290ch) streaming program on the same 16-device mesh
# with abstract inputs (CPU execution of 16 full forwards would dominate
# the suite; the compile proves the program, __graft_entry__ prints the
# driver-visible line)
from intentbev.configs import default_vit_config
fcfg = default_vit_config()
fcfg = dataclasses.replace(fcfg, mesh=MeshConfig(model_parallel=1))
fmesh = create_mesh(fcfg.mesh, devices=jax.devices())
fmodel = build_model(fcfg)
fg = fcfg.grid
sd = jax.ShapeDtypeStruct
fvars = jax.eval_shape(
    fmodel.init, jax.random.key(0),
    sd((1, fg.height_px, fg.width_px, fg.lidar_total_channels), jnp.float32),
    sd((1, fg.height_px, fg.width_px, fg.map_channels), jnp.float32))
finf = StreamingInferencer(fcfg, fvars, mesh=fmesh)
compiled = finf.aot_compile(16)
assert compiled is not None
print('STREAM16 FLAGSHIP COMPILE OK')
"""
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
        env["PYTHONPATH"] = str(Path(__file__).parent.parent)
        r = subprocess.run([_sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        assert "STREAM16 OK" in r.stdout
        assert "STREAM16 FLAGSHIP COMPILE OK" in r.stdout


class TestMultiHostExecution:
    def test_two_process_cpu_smoke(self, tmp_path):
        """REAL 2-process jax.distributed run (gloo CPU collectives, 2x2
        virtual devices): per-process loaders feed disjoint sequence shards
        through local_batch_slice into one sharded train step. Both
        processes must report the identical psum-reduced global loss."""
        import subprocess
        import sys as _sys
        from pathlib import Path

        from intentbev.data.synthetic import write_synthetic_log
        from intentbev.precompute_labels import run as precompute_run

        root = tmp_path / "train"
        root.mkdir()
        for i in range(2):
            write_synthetic_log(root, log_id=f"mhlog{i:04d}aaaa", num_frames=8,
                                points_per_sweep=600, seed=i)
        precompute_run(str(tmp_path), ["train"], force=True)

        worker = Path(__file__).parent / "multihost_worker.py"
        env = {k: v for k, v in __import__("os").environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        env["PYTHONPATH"] = str(Path(__file__).parent.parent)
        port = "12417"
        procs = [
            subprocess.Popen(
                [_sys.executable, str(worker), str(p), port, str(root)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env,
            )
            for p in range(2)
        ]
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
        for p, out in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        losses = []
        for out in outs:
            lines = [l for l in out.splitlines() if l.startswith("MHLOSS")]
            assert lines, out[-2000:]
            losses.append(float(lines[0].split()[2]))
        assert np.isfinite(losses[0])
        # same global loss on both processes => the collective really ran
        # over both processes' disjoint local data
        assert abs(losses[0] - losses[1]) < 1e-6, losses
