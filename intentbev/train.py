"""Training CLI + jitted train step for IntentNetCNN / IntentNetViT.

Equivalent of reference ``train_cnn.py`` / ``train_vit.py`` rebuilt as
ONE compiled XLA program per step containing device-side voxelization,
augmentation, the model forward/backward, loss, and the optimizer update;
the host only feeds packed point tensors (prefetched and double-buffered)
and reads back five scalars per log interval.

Reference training regime for parity (train_vit.py:19-23, 130-131):
batch 8, 10 epochs, AdamW lr 1e-4 wd 1e-4, ReduceLROnPlateau(factor 0.1,
patience 3) stepped per epoch on the mean loss; NaN batches skipped
(train_vit.py:161-169 — here the loss's internal NaN guard zeroes the
update instead, and a debug flag enables jax.debug_nans).

Usage:
    intentbev-train --data_dir /path/av2/sensor/train --model vit \
        --out_dir ./runs/vit [--epochs 10] [--batch_size 8] [--tiny-smoke]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .bev.augment import batched_augment_bev
from .bev.rasterize import decode_map_transport
from .bev.voxelize import dequantize_points, voxelize_packed
from .boxes.anchors import generate_anchors
from .checkpoint import save_checkpoint
from .configs import (
    ExperimentConfig,
    default_cnn_config,
    default_vit_config,
    tiny_test_config,
)
from .data.argoverse import ArgoverseSampleLoader, ScenarioValidator, build_sequence_index
from .data.pipeline import batch_iterator, device_prefetch
from .losses import detection_intention_loss
from .models import build_model


class TrainState(NamedTuple):
    params: Any
    batch_stats: Any
    opt_state: Any
    step: jnp.ndarray


def make_optimizer(cfg: ExperimentConfig) -> optax.GradientTransformation:
    """AdamW with an injectable learning rate (host-driven plateau decay)."""
    return optax.inject_hyperparams(
        lambda learning_rate: optax.adamw(
            learning_rate, weight_decay=cfg.train.weight_decay
        )
    )(learning_rate=cfg.train.learning_rate)


class PlateauScheduler:
    """ReduceLROnPlateau(mode=min, factor, patience) semantics
    (reference train_vit.py:131, stepped per epoch on mean loss)."""

    def __init__(self, base_lr: float, factor: float, patience: int):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr

    def start_phase(self, lr: float) -> None:
        """Begin an explicit finetune phase (``--resume_lr``): set the new
        LR and reset plateau tracking. The phase (often new data, as in
        curriculum continuation) must establish its own best — keeping a
        lower best from the previous phase reads every epoch as a plateau
        and decays the LR to nothing within ~20 epochs (observed:
        2e-5 -> 2e-10, docs/TRAINING.md)."""
        self.lr = float(lr)
        self.best = float("inf")
        self.bad_epochs = 0

    def state(self) -> dict:
        """Checkpointable state (resume must not reset LR/plateau tracking)."""
        return {
            "lr": np.float32(self.lr),
            "best": np.float32(self.best),
            "bad_epochs": np.int32(self.bad_epochs),
        }

    def restore(self, d: dict) -> None:
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.bad_epochs = int(d["bad_epochs"])


def set_learning_rate(opt_state, lr: float):
    """Write the injected hyperparam in-place (pytree-functional)."""
    hp = dict(opt_state.hyperparams)
    hp["learning_rate"] = jnp.asarray(lr, dtype=jnp.float32)
    return opt_state._replace(hyperparams=hp)


def init_train_state(
    model, cfg: ExperimentConfig, tx: optax.GradientTransformation, rng: jax.Array
) -> TrainState:
    g = cfg.grid
    lidar = jnp.zeros((1, g.height_px, g.width_px, g.lidar_total_channels))
    mp = jnp.zeros((1, g.height_px, g.width_px, g.map_channels))
    # jit the init: one program instead of one dispatch per initialiser
    variables = jax.jit(
        lambda r, l, m: model.init({"params": r, "dropout": r}, l, m, train=True)
    )(rng, lidar, mp)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    return TrainState(
        params=params,
        batch_stats=batch_stats,
        opt_state=tx.init(params),
        step=jnp.zeros((), dtype=jnp.int32),
    )


def compute_intention_class_weights(
    sequences, loader, num_classes: int = 8,
    max_sequences: int | None = 2048, num_workers: int = 4,
) -> np.ndarray:
    """Inverse-frequency intention class weights from training GT.

    Reference train_vit.py:92-115: counts over all GT labels, smoothed +1,
    weights = total/counts, normalised to sum 1. Used by the loss only when
    downsampling is off (train_vit.py:121).

    The reference pays a full-dataset counting pass through its DataLoader
    (train_cnn.py:78-88) — hours before step 1 on real AV2 Train Part 1.
    Here the pass is bounded: an even-stride sample of ``max_sequences``
    sequences (pass None for the full set), loaded by a thread pool (the
    loader serializes pyarrow reads internally, so concurrent loads are
    safe). Class *frequencies* converge long before the full pass does.
    """
    from concurrent.futures import ThreadPoolExecutor

    if max_sequences is not None and len(sequences) > max_sequences:
        idx = np.linspace(0, len(sequences) - 1, max_sequences).astype(np.int64)
        sequences = [sequences[i] for i in idx]

    counts = np.zeros(num_classes, dtype=np.int64)

    def count_one(seq) -> np.ndarray:
        s = loader.load(seq)
        if s is None:
            return np.zeros(num_classes, dtype=np.int64)
        labels = s.gt_intentions[s.gt_valid]
        labels = labels[(labels >= 0) & (labels < num_classes)]
        return np.bincount(labels, minlength=num_classes).astype(np.int64)

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for c in pool.map(count_one, sequences):
            counts += c
    total = counts.sum()
    if total == 0:
        return np.ones(num_classes, dtype=np.float32) / num_classes
    weights = total / (counts + 1.0)
    return (weights / weights.sum()).astype(np.float32)


def _augmented_inputs(batch, rng_aug, aug_cfg, grid, compute_dtype,
                      chunk_patch: int = 8):
    """Voxelize + augment inside the jitted step; returns
    (lidar_bev, map_bev, gt_boxes, gt_intentions).

    Point-space path (batch carries ``aug_params`` from batch_iterator):
    the host already rasterized the map at the augmented pose, so the
    device only rotates/flips/scales the RAW POINTS (a 2x2 matmul) before
    voxelization and applies patch dropout — no 299-channel bilinear image
    warp. Legacy image-space path kept for batches without aug_params
    (pre-voxelized callers).

    Chunk-transport path (batch carries ``chunks`` from batch_iterator
    transport='chunks'): the host ALREADY augmented the points and built
    deduplicated placement chunks, so the BEV fills by a scatter-add over
    unique cells (ops.voxel_embed.voxel_fill_bev) and only the GT
    transform runs here.
    """
    from .bev.augment import augment_points_gt, dropout_keep_mask

    map_in = decode_map_transport(batch["map_bev"], grid.map_channels, compute_dtype)
    if "chunks" in batch:
        import jax.numpy as jnp

        from .bev.augment import augment_gt
        from .ops.voxel_embed import voxel_fill_bev

        lidar = voxel_fill_bev(
            batch["chunks"], (grid.height_px, grid.width_px),
            grid.lidar_total_channels, chunk_patch, dtype=compute_dtype)
        gt_boxes, gt_intents = jax.vmap(augment_gt)(
            batch["gt_boxes"], batch["gt_intentions"], batch["gt_valid"],
            batch["aug_params"])
        keys = jax.random.split(rng_aug, lidar.shape[0])
        keep = jax.vmap(
            lambda k: dropout_keep_mask(k, aug_cfg, grid.height_px, grid.width_px)
        )(keys)[..., None]
        lidar = lidar * keep.astype(lidar.dtype)
        map_bev = map_in * keep.astype(map_in.dtype)
        return lidar, map_bev, gt_boxes, gt_intents

    # transport decode: bit-packed/u8 map -> compute dtype, i16 cm points
    # -> f32 (bev.voxelize / bev.rasterize transport encodings — the batch
    # crosses host->device every step, so it ships in compact dtypes).
    # No-op for f32 callers.
    points_in = dequantize_points(batch["points"])
    if "aug_params" in batch:
        pts, gt_boxes, gt_intents = jax.vmap(augment_points_gt)(
            points_in, batch["gt_boxes"], batch["gt_intentions"],
            batch["gt_valid"], batch["aug_params"],
        )
        lidar = jax.vmap(
            lambda p, v: voxelize_packed(p, v, grid, out_dtype=compute_dtype)
        )(pts, batch["points_valid"])
        keys = jax.random.split(rng_aug, lidar.shape[0])
        keep = jax.vmap(
            lambda k: dropout_keep_mask(k, aug_cfg, grid.height_px, grid.width_px)
        )(keys)[..., None]
        lidar = lidar * keep.astype(lidar.dtype)
        map_bev = map_in * keep.astype(map_in.dtype)
        return lidar, map_bev, gt_boxes, gt_intents

    lidar = jax.vmap(
        lambda p, v: voxelize_packed(p, v, grid, out_dtype=compute_dtype)
    )(points_in, batch["points_valid"])
    aug = batched_augment_bev(
        lidar, map_in, batch["gt_boxes"], batch["gt_intentions"],
        batch["gt_valid"], rng_aug, aug_cfg, grid,
    )
    return aug.lidar_bev, aug.map_bev, aug.gt_boxes, aug.gt_intentions


def chunk_patch_for(cfg: ExperimentConfig) -> int:
    """Band geometry of the train chunk transport: the ViT's patch size
    (shared with the serving transport) or the CNN constant."""
    from .ops.voxel_embed import CNN_CHUNK_PATCH

    return (cfg.vit.patch_size if cfg.model_family == "vit"
            else CNN_CHUNK_PATCH)


def train_step_fn(model, cfg: ExperimentConfig, anchors: jnp.ndarray, tx,
                  intention_weights: jnp.ndarray | None = None):
    """The train step ``(state, batch, rng) -> (state, metrics)``, not yet
    compiled: :func:`make_train_step` jits it for one device and
    ``parallel.train_dp`` with mesh shardings.

    batch fields (device arrays): points [B,S,P,4], points_valid [B,S,P],
    map_bev [B,H,W,9], gt_boxes [B,G,5], gt_intentions [B,G], gt_valid [B,G]
    — or ``chunks`` (VoxelChunks) in place of points/points_valid on the
    chunk train transport (TrainConfig.transport='chunks').
    """
    grid, aug_cfg, loss_cfg = cfg.grid, cfg.augment, cfg.loss
    chunk_patch = chunk_patch_for(cfg)
    compute_dtype = jnp.bfloat16 if cfg.train.compute_dtype == "bfloat16" else jnp.float32

    def train_step(state: TrainState, batch, rng: jax.Array):
        rng = jax.random.fold_in(rng, state.step)
        rng_aug, rng_loss, rng_drop = jax.random.split(rng, 3)
        lidar, map_bev, gt_boxes, gt_intents = _augmented_inputs(
            batch, rng_aug, aug_cfg, grid, compute_dtype,
            chunk_patch=chunk_patch,
        )

        def loss_fn(params):
            # both model families carry BatchNorm statistics
            (cls_l, box_d, int_l), upd = model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                lidar, map_bev, train=True,
                mutable=["batch_stats"], rngs={"dropout": rng_drop},
            )
            with jax.named_scope("loss"):
                loss_out = detection_intention_loss(
                    cls_l, box_d, int_l, anchors,
                    gt_boxes, gt_intents, batch["gt_valid"],
                    loss_cfg, rng_loss,
                    intention_class_weights=intention_weights,
                )
            return loss_out["loss"], (loss_out, upd["batch_stats"])

        (_, (loss_out, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params)
        with jax.named_scope("optimizer"):
            updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
            new_params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            params=new_params,
            batch_stats=new_bs,
            opt_state=new_opt_state,
            step=state.step + 1,
        )
        metrics = {k: loss_out[k] for k in
                   ("loss", "cls_loss", "box_loss", "intent_loss", "num_pos_anchors")}
        return new_state, metrics

    return train_step


def make_train_step(model, cfg: ExperimentConfig, anchors: jnp.ndarray, tx,
                    intention_weights: jnp.ndarray | None = None):
    """The single-program jitted train step on one device (the state is
    donated); see :func:`train_step_fn` for the batch fields."""
    return jax.jit(train_step_fn(model, cfg, anchors, tx, intention_weights),
                   donate_argnums=(0,))


def train(
    cfg: ExperimentConfig,
    data_dir: str,
    out_dir: str,
    num_workers: int = 4,
    max_steps: int | None = None,
    log_fn=print,
    use_intention_weights: bool = False,
    resume: bool = False,
    resume_lr: float | None = None,
    distributed: bool = False,
    max_points_per_sweep: int = 65536,
) -> dict:
    """Full training loop; returns final epoch metrics.

    ``distributed=True`` runs the DP(xTP) sharded step over a
    jax.sharding.Mesh of all visible devices (parallel.train_dp); the
    global batch must be divisible by the data-axis size. Multi-host jobs
    call ``parallel.mesh.initialize_distributed()`` before this.
    """
    model = build_model(cfg, train_mode=True)
    tx = make_optimizer(cfg)
    rng = jax.random.key(cfg.train.seed)
    state = init_train_state(model, cfg, tx, rng)

    scenarios = ScenarioValidator(data_dir).find_valid_scenarios()
    if not scenarios:
        raise ValueError(f"No valid scenarios found in {data_dir}")
    sequences = build_sequence_index(scenarios, cfg.grid.lidar_sweeps)
    if not sequences:
        raise ValueError(f"No valid sequences in {data_dir}")
    log_fn(f"{len(scenarios)} logs, {len(sequences)} sequences")

    loader = ArgoverseSampleLoader(
        cfg.grid, max_gt=cfg.loss.max_gt_boxes, verbose=False,
        max_points_per_sweep=max_points_per_sweep,
    )

    intention_weights = None
    if use_intention_weights and not cfg.loss.apply_intention_downsampling:
        # the counting pass is bounded but still minutes of loader work;
        # resumed runs would pay it at EVERY resume, so the result is
        # cached in out_dir keyed by the dataset identity
        cache_file = Path(out_dir) / "intent_weights.json"
        cache_key = {"data_dir": str(Path(data_dir).absolute()),
                     "n_sequences": len(sequences)}
        w = None
        if cache_file.exists():
            import json

            cached = json.loads(cache_file.read_text())
            if cached.get("key") == cache_key:
                w = np.asarray(cached["weights"], dtype=np.float32)
                log_fn(f"intention class weights (cached): {np.round(w, 4)}")
        if w is None:
            import json

            log_fn("computing intention class weights from training GT...")
            w = compute_intention_class_weights(sequences, loader)
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            cache_file.write_text(json.dumps(
                {"key": cache_key, "weights": [float(x) for x in w]}))
            log_fn(f"intention class weights: {np.round(w, 4)}")
        intention_weights = jnp.asarray(w)
    elif use_intention_weights:
        log_fn(
            "Warning: intention weights requested but downsampling is on; "
            "weights are ignored by the loss (reference train_vit.py:89-91)"
        )

    scheduler = PlateauScheduler(
        cfg.train.learning_rate, cfg.train.plateau_factor, cfg.train.plateau_patience
    )
    start_epoch = 0
    step_count = 0
    resume_skip = 0
    if resume:
        from .checkpoint import latest_step, load_checkpoint

        if latest_step(out_dir) is not None:
            abstract = {
                "params": state.params, "batch_stats": state.batch_stats,
                "opt_state": state.opt_state, "step": state.step,
                "loop": {"lr": np.zeros((), np.float32),
                         "best": np.zeros((), np.float32),
                         "bad_epochs": np.zeros((), np.int32),
                         "epoch": np.zeros((), np.int32),
                         "epoch_batch": np.zeros((), np.int32)},
            }
            restored, _ = load_checkpoint(out_dir, abstract)
            state = TrainState(
                params=restored["params"], batch_stats=restored["batch_stats"],
                opt_state=restored["opt_state"], step=restored["step"],
            )
            # Faithful resume: LR / plateau tracking / epoch accounting
            # continue where they stopped (reference regime is per-epoch
            # plateau decay, train_vit.py:131 — resetting LR to base on
            # resume would silently change the schedule). The data iterator
            # position IS saved (loop.epoch_batch = batches consumed in the
            # in-progress epoch): a mid-epoch resume fast-forwards the
            # deterministically seeded iterator to where it stopped instead
            # of replaying or skipping the rest of that epoch.
            scheduler.restore(restored["loop"])
            start_epoch = int(restored["loop"]["epoch"])
            resume_skip = int(restored["loop"]["epoch_batch"])
            step_count = int(np.asarray(state.step))
            if resume_lr is not None:
                # explicit finetune phase: new LR + plateau-tracking reset
                scheduler.start_phase(resume_lr)
            state = state._replace(
                opt_state=set_learning_rate(state.opt_state, scheduler.lr))
            log_fn(
                f"resumed from step {step_count} (epoch {start_epoch} "
                f"batch {resume_skip}, lr {scheduler.lr:.2e}, "
                f"best {scheduler.best:.4f})"
            )

    anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
    mesh = None
    batch_to_device = jax.device_put
    local_batch_size = cfg.train.batch_size
    local_sequences = sequences
    if distributed:
        from .parallel import (
            create_mesh, local_batch_slice, make_sharded_train_step,
            shard_train_state,
        )

        mesh = create_mesh(cfg.mesh)
        data_dim = mesh.devices.shape[0]
        if cfg.train.batch_size % data_dim != 0:
            raise ValueError(
                f"batch_size {cfg.train.batch_size} not divisible by the "
                f"data axis ({data_dim} of mesh {mesh.devices.shape})"
            )
        nproc = jax.process_count()
        if nproc > 1:
            # Multi-host DCN: each process loads only ITS slice of the
            # global batch (parallel.mesh.shard_sequences_for_process);
            # local_batch_slice assembles the global sharded array via
            # jax.make_array_from_process_local_data. Caveat: a process
            # whose loader DROPS a failed sample mid-epoch still desyncs —
            # real-data multi-host runs should precompute labels so loads
            # are infallible.
            from .parallel.mesh import shard_sequences_for_process

            pid = jax.process_index()
            local_sequences, local_batch_size = shard_sequences_for_process(
                sequences, pid, nproc, cfg.train.batch_size
            )
            log_fn(
                f"multi-host: process {pid}/{nproc}, "
                f"{len(local_sequences)} local sequences, "
                f"local batch {local_batch_size}"
            )
        log_fn(f"distributed: mesh {mesh.devices.shape} (data x model)")
        state = shard_train_state(state, mesh, cfg)
        train_step = make_sharded_train_step(
            model, cfg, anchors, tx, mesh, intention_weights
        )(state)
        batch_to_device = lambda b: local_batch_slice(b, mesh, cfg.mesh)  # noqa: E731
    else:
        train_step = make_train_step(model, cfg, anchors, tx, intention_weights)
    out_path = Path(out_dir)
    from .utils.profiling import MetricsLogger

    mlog = MetricsLogger(out_path / "metrics.jsonl")
    last_metrics: dict = {}
    t_start = time.time()
    start_step = step_count  # rate accounting: steps THIS process ran

    def ckpt_state(epoch: int, epoch_batch: int = 0) -> dict:
        # epoch_batch = batches already consumed in the in-progress epoch
        # (0 = epoch boundary); resume fast-forwards the seeded iterator to it
        return {
            "params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "step": state.step,
            "loop": {**scheduler.state(), "epoch": np.int32(epoch),
                     "epoch_batch": np.int32(epoch_batch)},
        }

    epoch = start_epoch - 1  # final-save accounting if the loop body never runs
    skip = 0
    n_batches = 0
    interrupted = False  # True when max_steps stops the loop mid-epoch
    for epoch in range(start_epoch, cfg.train.num_epochs):
        skip = resume_skip if epoch == start_epoch else 0
        it = batch_iterator(
            local_sequences, loader, local_batch_size, shuffle=True,
            seed=cfg.train.seed + epoch, num_workers=num_workers, drop_last=True,
            augment=cfg.augment, skip_batches=skip,
            transport=cfg.train.transport,
            chunk_patch=chunk_patch_for(cfg),
            chunk_capacity=cfg.train.chunk_capacity,
        )
        accum = {"loss": 0.0, "cls_loss": 0.0, "box_loss": 0.0, "intent_loss": 0.0}
        n_batches = 0
        # Metric handles stay ON DEVICE between log syncs: a per-step
        # float()/item() would block the loop on every step's results
        # (each a host<->device sync), killing async dispatch run-ahead —
        # the reference pays exactly this with its per-batch .item() pulls
        # (train_vit.py:175-178). The pending list is drained into the
        # host-side accum at each log_every_steps sync (whose device_get
        # blocks anyway), so it stays bounded at log_every_steps entries
        # instead of growing for a whole epoch.
        pending_metrics: list = []

        def drain_pending() -> None:
            nonlocal pending_metrics
            for g in jax.device_get(pending_metrics):
                for k in accum:
                    accum[k] += float(g[k])
            pending_metrics = []

        for batch in device_prefetch(iter(it), size=2, put=batch_to_device):
            bdict = batch._asdict()
            state, metrics = train_step(state, bdict, rng)
            step_count += 1
            n_batches += 1
            pending_metrics.append(metrics)
            if step_count % cfg.train.log_every_steps == 0:
                m = {k: float(v) for k, v in jax.device_get(metrics).items()}
                drain_pending()
                # resumed runs: count only the steps this process executed —
                # dividing the GLOBAL step by this process's elapsed time
                # inflated the reported rate after every resume
                rate = ((step_count - start_step) * cfg.train.batch_size
                        / (time.time() - t_start))
                mlog.log(step_count, samples_per_sec=rate, **m)
                log_fn(
                    f"epoch {epoch + 1} step {step_count} "
                    f"loss {m['loss']:.4f} (cls {m['cls_loss']:.3f} "
                    f"box {m['box_loss']:.3f} int {m['intent_loss']:.3f}) "
                    f"#pos {m['num_pos_anchors']:.0f} "
                    f"[{rate:.1f} samples/s]"
                )
            if step_count % cfg.train.checkpoint_every_steps == 0:
                # step_count is the GLOBAL step (initialised from the
                # restored step on resume) so checkpoint names keep sorting
                # after the pre-resume ones and _prune never deletes newer
                # progress.
                save_checkpoint(
                    out_path, step_count, ckpt_state(epoch, skip + n_batches), cfg)
            if max_steps is not None and step_count >= max_steps:
                interrupted = True
                break
        if n_batches:
            drain_pending()
            last_metrics = {k: v / n_batches for k, v in accum.items()}
            if interrupted:
                # mid-epoch stop: do NOT step the plateau scheduler on a
                # partial-epoch mean — runs split into --max_steps
                # segments would otherwise consume plateau patience
                # faster than the per-epoch regime the scheduler models.
                # The epoch finishes (and steps the scheduler) after
                # resume.
                log_fn(
                    f"epoch {epoch + 1} interrupted at batch {skip + n_batches}: "
                    f"avg loss {last_metrics['loss']:.4f} (partial)"
                )
            else:
                new_lr = scheduler.step(last_metrics["loss"])
                state = state._replace(
                    opt_state=set_learning_rate(state.opt_state, new_lr))
                log_fn(
                    f"epoch {epoch + 1} done: avg loss {last_metrics['loss']:.4f} "
                    f"lr {new_lr:.1e}"
                )
        if interrupted:
            break

    # mid-epoch stop: record the intra-epoch position so resume continues
    # exactly there (epoch index NOT advanced); clean stop: epoch boundary
    save_checkpoint(
        out_path, step_count,
        ckpt_state(epoch if interrupted else epoch + 1,
                   (skip + n_batches) if interrupted else 0),
        cfg)
    log_fn(f"saved final checkpoint at step {step_count} to {out_path}")
    return last_metrics


def main(argv=None):
    from .utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", default="./runs/intentbev")
    p.add_argument("--model", choices=["vit", "cnn"], default="vit")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--max_points_per_sweep", type=int, default=65536,
                   help="per-sweep point capacity of the packed transport "
                        "tensor (points beyond it are evenly subsampled); "
                        "lower it to the dataset's real sweep size to cut "
                        "host->device bytes")
    p.add_argument("--tiny-smoke", action="store_true",
                   help="tiny config for CI smoke runs on synthetic logs")
    p.add_argument("--debug_nans", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --out_dir")
    p.add_argument("--resume_lr", type=float, default=None,
                   help="with --resume: override the restored learning "
                        "rate (explicit finetune phase; plain resume keeps "
                        "the checkpointed schedule)")
    p.add_argument("--use_intention_weights", action="store_true")
    p.add_argument("--no_intention_downsampling", action="store_true")
    p.add_argument("--transport", choices=["points", "chunks"], default=None,
                   help="train input transport: 'chunks' builds augmented "
                        "voxel chunks on the host (C++ builder) so the "
                        "device step skips the scatter-max voxelizer "
                        "(TrainConfig.transport)")
    p.add_argument("--distributed", action="store_true",
                   help="DP(xTP) sharded training over all visible devices")
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--platform", default=None,
                   help="force a jax platform (e.g. cpu for the 8-fake-"
                        "device mesh)")
    args = p.parse_args(argv)

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import dataclasses

    if args.tiny_smoke:
        cfg = tiny_test_config()
        cfg = dataclasses.replace(cfg, model_family=args.model)
    else:
        cfg = default_vit_config() if args.model == "vit" else default_cnn_config()
    tr = cfg.train
    if args.epochs is not None:
        tr = dataclasses.replace(tr, num_epochs=args.epochs)
    if args.batch_size is not None:
        tr = dataclasses.replace(tr, batch_size=args.batch_size)
    if args.learning_rate is not None:
        tr = dataclasses.replace(tr, learning_rate=args.learning_rate)
    if args.transport is not None:
        tr = dataclasses.replace(tr, transport=args.transport)
    cfg = dataclasses.replace(cfg, train=tr)
    if args.no_intention_downsampling:
        cfg = dataclasses.replace(
            cfg, loss=dataclasses.replace(cfg.loss, apply_intention_downsampling=False)
        )
    if args.model_parallel != 1:
        from .configs import MeshConfig

        cfg = dataclasses.replace(
            cfg, mesh=MeshConfig(model_parallel=args.model_parallel)
        )

    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)

    train(cfg, args.data_dir, args.out_dir,
          num_workers=args.num_workers, max_steps=args.max_steps,
          use_intention_weights=args.use_intention_weights,
          resume=args.resume, resume_lr=args.resume_lr,
          distributed=args.distributed,
          max_points_per_sweep=args.max_points_per_sweep)


if __name__ == "__main__":
    main()
