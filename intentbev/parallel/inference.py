"""Streaming multi-sweep inference across a device mesh (driver config 5).

Batch-sharded inference over the ('data',) mesh axis with voxelization,
forward, decode and NMS all on device; only the fixed-size detection
structs (max_detections boxes/scores/intents per frame) are fetched to
host. The reference pulls every intermediate tensor to CPU per sample
(eval_cnn.py:150-192).
"""

from __future__ import annotations

from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..bev.rasterize import decode_map_transport
from ..bev.voxelize import dequantize_points, voxelize_packed
from ..boxes.anchors import generate_anchors
from ..boxes.nms import Detections, batched_postprocess
from ..configs import ExperimentConfig
from ..models import build_model
from .mesh import create_mesh, local_batch_slice
from .sharding import batch_sharding, replicated


class StreamingInferencer:
    """Compile-once, feed-forever detector over a device mesh.

    Usage:
        inf = StreamingInferencer(cfg, variables)          # builds mesh
        for batch in stream:                               # host batches
            det = inf(batch)                               # Detections (host)
    """

    def __init__(self, cfg: ExperimentConfig, variables, mesh=None,
                 transport: str = "points", num_chunks: int = 512):
        """``transport``:

        - "points" (default): ship packed points; voxelize on device
          (training-identical dense-BEV path).
        - "chunks": build deduplicated voxel placement chunks on the host
          (C++ ``ib_build_chunks``); the device places them into the BEV
          with a scatter-add (ops.voxel_embed) instead of the scatter-max
          voxelizer. The ``__call__`` API is unchanged; ``num_chunks`` fixes the chunk
          capacity so the program compiles once (overfull bands drop
          their rarest-window cells — raise it if the data needs more).
        """
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else create_mesh(cfg.mesh)
        self.model = build_model(cfg)
        self.transport = transport
        self.num_chunks = num_chunks
        anchors = jnp.asarray(generate_anchors(cfg.grid, cfg.anchors))
        rep = replicated(self.mesh)
        # abstract variables (ShapeDtypeStructs) are accepted for AOT
        # compile-only validation (aot_compile) — nothing to device_put
        self._abstract = any(
            isinstance(leaf, jax.ShapeDtypeStruct)
            for leaf in jax.tree.leaves(variables)
        )
        self.variables = (
            variables if self._abstract else jax.device_put(variables, rep)
        )
        self._b_shard = batch_sharding(self.mesh, cfg.mesh)
        grid, ev = cfg.grid, cfg.eval
        mdt = getattr(self.model, "dtype", jnp.float32)

        def postprocess(cls_l, box_d, int_l):
            return batched_postprocess(
                cls_l, box_d, int_l, anchors,
                confidence_threshold=ev.confidence_threshold,
                nms_iou_threshold=ev.nms_iou_threshold,
                max_pre_nms=ev.max_pre_nms,
                max_detections=ev.max_detections,
            )

        def infer(variables, points, points_valid, map_bev):
            lidar = jax.vmap(lambda p, v: voxelize_packed(p, v, grid))(
                dequantize_points(points), points_valid
            )
            cls_l, box_d, int_l = self.model.apply(
                variables, lidar,
                decode_map_transport(map_bev, grid.map_channels, lidar.dtype),
            )
            return postprocess(cls_l, box_d, int_l)

        def infer_chunks(variables, chunks, map_bev):
            # the model decodes the compact transport (u16 slot|channel,
            # u8 values — ops.voxel_embed.pack_chunk_transport) in program
            cls_l, box_d, int_l = self.model.apply(
                variables, chunks,
                decode_map_transport(map_bev, grid.map_channels, mdt),
            )
            return postprocess(cls_l, box_d, int_l)

        det_shard = Detections(
            boxes_xywha=self._b_shard, scores=self._b_shard,
            intentions=self._b_shard, valid=self._b_shard,
            num_conf=self._b_shard, num_kept=self._b_shard,
        )
        if transport == "chunks":
            from ..ops.voxel_embed import VoxelChunks

            chunk_shard = VoxelChunks(*([self._b_shard] * 5))
            self._infer = jax.jit(
                infer_chunks,
                in_shardings=(rep, chunk_shard, self._b_shard),
                out_shardings=det_shard,
            )
        else:
            self._infer = jax.jit(
                infer,
                in_shardings=(rep, self._b_shard, self._b_shard, self._b_shard),
                out_shardings=det_shard,
            )

    @property
    def batch_multiple(self) -> int:
        """Global batch must be a multiple of the data-axis size."""
        return self.mesh.devices.shape[0]

    def aot_compile(self, global_batch: int | None = None,
                    points_per_sweep: int = 2048):
        """Lower + compile the streaming program at the given global batch
        with abstract inputs (no full-size arrays materialized) — the
        flagship-shape multi-device validation path (BASELINE config 5:
        streaming inference across a mesh at full grid size).
        Returns the compiled executable; works with abstract ``variables``
        (pass ``jax.eval_shape`` of the init to the constructor)."""
        g = self.cfg.grid
        b = global_batch if global_batch is not None else self.batch_multiple
        if b % self.batch_multiple:
            raise ValueError(
                f"global batch {b} not a multiple of {self.batch_multiple}")
        sd = jax.ShapeDtypeStruct
        var_sd = (self.variables if self._abstract
                  else jax.eval_shape(lambda v: v, self.variables))
        map_sd = sd((b, g.height_px, g.width_px, g.map_channels), jnp.float32)
        if self.transport == "chunks":
            from ..ops.voxel_embed import CAP, rows_per_program

            patch = self.cfg.vit.patch_size
            nb = g.height_px // (rows_per_program(g.height_px, patch) * patch)
            nc = self.num_chunks
            from ..ops.voxel_embed import VoxelChunks

            # compact transport dtypes (pack_chunk_transport on real AV2
            # data: u16 slot|channel, u8 integral intensities)
            chunks_sd = VoxelChunks(
                wid=sd((b, nb, nc), jnp.int32),
                sl=sd((b, nb, nc, 1, CAP), jnp.uint16),
                ch=sd((b, nb, nc, 1, 0), jnp.int16),
                val=sd((b, nb, nc, 1, CAP), jnp.uint8),
                count=sd((b, nb), jnp.int32),
            )
            lowered = self._infer.lower(var_sd, chunks_sd, map_sd)
        else:
            s = g.lidar_sweeps
            lowered = self._infer.lower(
                var_sd,
                sd((b, s, points_per_sweep, 4), jnp.float32),
                sd((b, s, points_per_sweep), jnp.bool_),
                map_sd,
            )
        return lowered.compile()

    def build_chunks(self, points, points_valid):
        """Host side of the chunk transport (callable from loader threads
        so chunk building overlaps device inference).

        The transport ships COMPACT (ops.voxel_embed.pack_chunk_transport):
        slot+channel packed into one u16 per cell, values as u8 when the
        source intensities are integral 0-255 (AV2's are uint8, so exact
        on real data) — decoded to i32/f32 inside the jitted program.
        Cuts the chunk transfer from 3.95 to ~1.7 MB/sample, which
        matters wherever the host->device link is the sustained-rate
        limiter."""
        from ..ops.voxel_embed import (build_voxel_chunks,
                                       pack_chunk_transport,
                                       stack_voxel_chunks)

        pts = np.asarray(points)
        if pts.dtype == np.int16:  # i16-cm transport (quantize_points_cm)
            pts = pts.astype(np.float32) * np.asarray(
                [0.01, 0.01, 0.01, 1.0], np.float32)
        vld = np.asarray(points_valid)
        chunks = stack_voxel_chunks([
            build_voxel_chunks(
                pts[i], vld[i], self.cfg.grid,
                self.cfg.vit.patch_size, num_chunks=self.num_chunks,
                on_overflow="drop",
            )[0]
            for i in range(pts.shape[0])
        ])
        return pack_chunk_transport(chunks)

    def infer_chunks(self, chunks, map_bev, blocking: bool = True) -> Detections:
        """Run pre-built placement chunks (transport='chunks' only).

        ``blocking=False`` returns DEVICE-resident Detections immediately
        after dispatch (XLA runs async); call :meth:`fetch` on the result
        when you need host arrays. A double-buffered serving loop submits
        batch i+1 before fetching batch i, overlapping device compute
        with the detection readback — on hosts where the readback has
        nontrivial latency this is the difference between serialized and
        pipelined sustained throughput."""
        if self.transport != "chunks":
            raise ValueError(
                "infer_chunks requires StreamingInferencer(..., "
                f"transport='chunks'); this instance was built with "
                f"transport={self.transport!r}")
        args = local_batch_slice(
            {"chunks": chunks, "map_bev": map_bev}, self.mesh, self.cfg.mesh,
        )
        det = self._infer(self.variables, args["chunks"], args["map_bev"])
        return self.fetch(det) if blocking else det

    @staticmethod
    def fetch(det: Detections) -> Detections:
        """Device Detections (from ``blocking=False``) -> host numpy."""
        return jax.tree.map(np.asarray, det)

    def __call__(self, points, points_valid, map_bev) -> Detections:
        if self.transport == "chunks":
            return self.infer_chunks(
                self.build_chunks(points, points_valid), map_bev)
        args = local_batch_slice(
            {"points": points, "points_valid": points_valid, "map_bev": map_bev},
            self.mesh, self.cfg.mesh,
        )
        det = self._infer(
            self.variables, args["points"], args["points_valid"], args["map_bev"]
        )
        return jax.tree.map(np.asarray, det)

    def stream(self, batches: Iterator) -> Iterator[Detections]:
        for batch in batches:
            yield self(batch["points"], batch["points_valid"], batch["map_bev"])
