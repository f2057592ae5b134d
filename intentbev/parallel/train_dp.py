"""Sharded (DP x TP) training step via jit + NamedSharding.

One compiled program: batch arrives sharded over 'data', parameters are
replicated over 'data' and (optionally) sharded over 'model'; XLA inserts
the gradient all-reduce (NCCL on GPUs). BatchNorm batch statistics reduce over
the full (global) batch dimension automatically under GSPMD — the mean
over a data-sharded axis lowers to a cross-device psum.

This is the component the reference lacks entirely (SURVEY.md §2.2:
"DP: absent ... Communication backend: absent").
"""

from __future__ import annotations

import jax

from ..configs import ExperimentConfig
from ..train import TrainState, train_step_fn
from .sharding import batch_sharding, param_shardings, replicated


def state_shardings(state: TrainState, mesh, cfg: ExperimentConfig) -> TrainState:
    """Shardings of a TrainState: parameters by the mesh rules, optimizer
    moments (subtrees shaped like the parameters, e.g. Adam's mu and nu)
    like their parameters, everything else replicated."""
    p_shard = param_shardings(state.params, mesh, cfg.mesh)
    rep = replicated(mesh)
    params_def = jax.tree.structure(state.params)

    def like_params(x) -> bool:
        return jax.tree.structure(x) == params_def

    return TrainState(
        params=p_shard,
        batch_stats=jax.tree.map(lambda _: rep, state.batch_stats),
        opt_state=jax.tree.map(
            lambda x: p_shard if like_params(x) else rep, state.opt_state,
            is_leaf=lambda x: like_params(x) or hasattr(x, "shape"),
        ),
        step=rep,
    )


def shard_train_state(state: TrainState, mesh, cfg: ExperimentConfig) -> TrainState:
    """Place an (unsharded) TrainState according to the mesh rules."""
    return jax.device_put(state, state_shardings(state, mesh, cfg))


def make_sharded_train_step(model, cfg: ExperimentConfig, anchors, tx, mesh,
                            intention_weights=None):
    """Like train.make_train_step but with explicit in/out shardings.

    ``intention_weights``: optional [num_intentions] class weights — same
    contract as the single-device step (reference train_vit.py:92-121);
    silently dropping them under --distributed would diverge from
    single-device behaviour.
    """
    b_shard = batch_sharding(mesh, cfg.mesh)
    rep = replicated(mesh)
    step_fn = train_step_fn(model, cfg, anchors, tx, intention_weights)

    if cfg.train.transport == "chunks":
        from ..ops.voxel_embed import VoxelChunks

        batch_shardings = {
            "chunks": VoxelChunks(*([b_shard] * 5)),
            "map_bev": b_shard, "gt_boxes": b_shard,
            "gt_intentions": b_shard, "gt_valid": b_shard,
            "aug_params": b_shard,
        }
    else:
        batch_shardings = {
            "points": b_shard, "points_valid": b_shard, "map_bev": b_shard,
            "gt_boxes": b_shard, "gt_intentions": b_shard, "gt_valid": b_shard,
            "aug_params": b_shard,
        }

    def compile_for(state: TrainState):
        ss = state_shardings(state, mesh, cfg)
        return jax.jit(
            step_fn,
            in_shardings=(ss, batch_shardings, rep),
            out_shardings=(ss, jax.tree.map(lambda _: rep, {
                "loss": 0, "cls_loss": 0, "box_loss": 0,
                "intent_loss": 0, "num_pos_anchors": 0})),
            donate_argnums=(0,),
        )

    return compile_for
