"""The 2-D (sequence x model) mesh sweep.

The counterpart of `havac_tpu/parallel/swar_dist2d.py`. The model
collection is cut into contiguous groups of whole models
(:func:`partition_models`), one group a model-axis column of the mesh, and
each group runs its own sequence-axis wavefront over the same database:
``ssv_sweep.cu`` launched once per active (group, seq shard, step), with
the group's own row states and seams. Nothing moves along the model axis:
the groups are independent because the cuts fall on model boundaries and
model isolation (``reset_rows``, see `ops/reference.py`) stops every DP
chain at a model start. The 2-D mesh therefore requires isolate-models
semantics; the engine enforces it.

The step loop, launches, pulls, regrows and resolution are the 1-D sweep's
(:class:`~havac_tpu_torch.parallel.swar_dist.SwarDistributedSweep`, one
group there). Every group takes the same steps, T = max_g S_g + D_seq - 1,
without padding: a group with fewer row chunks, or an empty one (more
groups than models), idles once its wavefront has passed, launching and
exchanging nothing. Of the JAX sweep's TPU workarounds (groups padded to
one chunk count so every device compiles one program, column chunks for a
tile budget, the record cap and its retry, the monolithic scan, the record
decode) none crosses over: the kernel emits exact hit keys.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from havac_tpu_torch.engine.pipeline import FIRST_KEY_CAP, raw_pairs
from havac_tpu_torch.hits.decode import ResolvedHits
from havac_tpu_torch.parallel.multihost import ShardMesh
from havac_tpu_torch.parallel.swar_dist import SwarDistributedSweep, _Front


def partition_models(prefix_sums: np.ndarray, num_groups: int) -> List[int]:
    """Split the concatenated model stream into ``num_groups`` contiguous
    groups of whole models, balancing total rows. Returns the group-start
    model indices (length num_groups + 1, first 0, last n_models); a group
    is empty when two bounds repeat (more groups than models)."""
    prefix = np.asarray(prefix_sums, dtype=np.int64)
    total = int(prefix[-1])
    n_models = len(prefix) - 1
    bounds = [0]
    for g in range(1, num_groups):
        target = total * g // num_groups
        m = int(np.searchsorted(prefix, target, side="left"))
        m = max(bounds[-1], min(m, n_models))
        bounds.append(m)
    bounds.append(n_models)
    return bounds


class Swar2DSweep(SwarDistributedSweep):
    """The 2-D sweep of ``codes`` (L,) uint8 over a mesh with a seq axis
    ``seq_axis`` and a model axis ``model_axis``
    (:func:`~havac_tpu_torch.parallel.multihost.sequence_model_mesh`), in
    row chunks of ``rows_per_step`` (any R >= 1) within each model group.

    ``prof`` and the counters are the 1-D sweep's; after a run ``bounds``
    holds the group-start model indices. ``database`` and ``phmm_prefix``
    resolve the hits as the engine needs them (:meth:`sweep`)."""

    def __init__(self, codes: np.ndarray, mesh: ShardMesh,
                 seq_axis: str = "seq", model_axis: str = "model",
                 rows_per_step: int = 128, key_cap: int = FIRST_KEY_CAP,
                 database=None, phmm_prefix: Optional[np.ndarray] = None
                 ) -> None:
        if mesh.model_axis != model_axis:
            raise ValueError(f"mesh has no model axis {model_axis!r} "
                             f"({mesh.axis_names})")
        self.model_axis = model_axis
        self.D_model = mesh.shape[model_axis]
        self.bounds: List[int] = []
        self._setup(codes, mesh, seq_axis, rows_per_step, key_cap, database,
                    phmm_prefix)
        self.D_seq = self.D

    def _snapshot(self, fronts: List[_Front]) -> tuple:
        """Every group's row states (D_model, D_seq, W) int32 and the seams
        its shards take next (D_model, D_seq, R+1) int32, this process's
        shards filled and the rest zero (JAX's full 2-D carries in one
        process)."""
        istate = np.zeros((self.D_model, self.D_seq, self.shard_width),
                          dtype=np.int32)
        seams = np.zeros((self.D_model, self.D_seq, self.R + 1),
                         dtype=np.int32)
        for m, f in enumerate(fronts):
            for k, x in zip(f.shards, f.state):
                istate[m, k] = x.cpu().numpy()
            seams[m, f.shards.start:f.shards.stop] = f.exchange.state()
        return istate, seams

    def _restore(self, fronts: List[_Front], istate: np.ndarray,
                 seams: np.ndarray, t: int) -> None:
        for m, f in enumerate(fronts):
            f.state = [torch.from_numpy(np.ascontiguousarray(
                istate[m, k], dtype=np.int32)).to(d)
                for k, d in zip(f.shards, f.devices)]
            f.exchange.load(seams[m, f.shards.start:f.shards.stop], t)

    def run(self, scores: np.ndarray, prefix_sums: np.ndarray,
            reset_rows: Optional[np.ndarray] = None, abort_event=None,
            progress=None, checkpoint_cb=None, resume=None,
            ckpt_every: int = 8) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Sweep the (P, card) int8 scores, whose models end at
        ``prefix_sums`` (the cut points); exact global (rows, positions) of
        this process's shards, sorted by (row, position), or None when
        aborted. ``reset_rows`` defaults to isolating every model (which 2-D
        exactness requires); each group's first row resets either way.
        ``progress(step, T)`` follows every step of the common T;
        ``checkpoint_cb(t_next, istate (D_model, D_seq, W) int32, seams
        (D_model, D_seq, R+1) int32, rows, positions)`` runs every
        ``ckpt_every`` steps strictly inside the run, and ``resume`` is
        ``(t_next, istate, seams, rows, positions)`` from such a call."""
        out = self.sweep(scores, prefix_sums, reset_rows, abort_event,
                         progress, checkpoint_cb, resume, ckpt_every)
        return None if out is None else raw_pairs(out[1], ordered=True)

    def sweep(self, scores: np.ndarray, prefix_sums: np.ndarray,
              reset_rows: Optional[np.ndarray] = None, abort_event=None,
              progress=None, checkpoint_cb=None, resume=None,
              ckpt_every: int = 8
              ) -> Optional[Tuple[Optional[ResolvedHits], List[np.ndarray]]]:
        """:meth:`run`, returning (resolved hits or None without a
        database, raw hit parts as :func:`~havac_tpu_torch.engine.pipeline.
        raw_pairs` takes them)."""
        prefix = np.asarray(prefix_sums, dtype=np.int64)
        P = scores.shape[0]
        if prefix.ndim != 1 or prefix.size < 2 or int(prefix[-1]) != P:
            raise ValueError(f"prefix sums end at {prefix[-1:]}, not at the "
                             f"{P} score rows")
        if reset_rows is None:
            reset = np.zeros(P, dtype=bool)
            reset[prefix[:-1]] = True
        else:
            reset = np.array(reset_rows, dtype=bool)
        self.bounds = partition_models(prefix, self.D_model)
        rows = [(int(prefix[a]), int(prefix[b]))
                for a, b in zip(self.bounds, self.bounds[1:])]
        for r0, r1 in rows:
            if r1 > r0:
                reset[r0] = True  # a group's start is always a model start
        out = self._sweep(scores, reset, rows, abort_event, progress,
                          checkpoint_cb, resume, ckpt_every)
        return None if out is None else out[1]
