"""Sharding rules: batch over 'data', ViT attention/MLP weights over 'model'.

The 4501-token, 384-dim ViT fits on one chip, so TP is an escape hatch
rather than a parity need (SURVEY.md §2.2) — but the rules are real and the
multi-chip dry run exercises them: under jit, GSPMD propagates these
parameter shardings through the matmuls and inserts the all-reduces
(attention proj and MLP fc2 contract over the sharded dimension -> psum
over 'model'); gradients all-reduce over 'data' because parameters are
replicated along it.
"""

from __future__ import annotations

from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..configs import MeshConfig


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, cfg: MeshConfig) -> NamedSharding:
    """Leading (batch) dim sharded over the data axis."""
    return NamedSharding(mesh, P(cfg.data_axis))


def _param_spec(path: tuple[str, ...], leaf, model_axis: str) -> P:
    """Tensor-parallel partition spec for one parameter, by tree path."""
    names = [getattr(k, "key", str(k)) for k in path]
    joined = "/".join(names)
    ndim = getattr(leaf, "ndim", 0)

    # ViT attention: qkv kernel (d, 3d) -> shard output (head) dim;
    # proj kernel (d, d) -> shard input (head) dim, output replicated
    # (contraction over sharded dim => psum inserted by GSPMD).
    if "attn" in joined:
        if "qkv" in joined:
            if ndim == 2:
                return P(None, model_axis)
            if ndim == 1:
                return P(model_axis)
        if "proj" in joined:
            if ndim == 2:
                return P(model_axis, None)
            return P()
    # ViT MLP: fc1 (d, hidden) -> shard hidden; fc2 (hidden, d) -> shard input.
    if "mlp" in joined:
        if "fc1" in joined:
            if ndim == 2:
                return P(None, model_axis)
            if ndim == 1:
                return P(model_axis)
        if "fc2" in joined:
            if ndim == 2:
                return P(model_axis, None)
            return P()
    # Everything else (convs, norms, heads, adapters, embeddings): replicated
    # over 'model', always replicated over 'data'.
    return P()


def param_shardings(params: Any, mesh: Mesh, cfg: MeshConfig) -> Any:
    """NamedSharding pytree matching ``params`` (TP rules; DP replication)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, _param_spec(path, leaf, cfg.model_axis)
        ),
        params,
    )
