"""Row-chunk-at-a-time mesh sweeps: the JAX engine_dist surface.

The counterpart of `havac_tpu/parallel/engine_dist.py`. There the XLA
wavefront with an on-device compaction was its own implementation, kept by
the JAX engine only as a guard for SWAR geometry; here both entry points
are thin wrappers over the one mesh sweep
(:class:`~havac_tpu_torch.parallel.swar_dist.SwarDistributedSweep`).
Chaining across row chunks needs no state of its own: each shard's row
state stays on its device between calls, and the kernel's carry contract
(``final_carry[0] = init_state[L-1]``) hands the left shard's last row to
the next call's first row as part of the seam.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from havac_tpu_torch.engine.pipeline import FIRST_KEY_CAP, raw_pairs
from havac_tpu_torch.ops.common import hit_sort_order, round_up
from havac_tpu_torch.parallel.multihost import ShardMesh
from havac_tpu_torch.parallel.swar_dist import SwarDistributedSweep


class DistributedSweep:
    """A mesh sweep called once per row chunk (``sweep_rows``), the shards'
    row states chained on their devices from one call to the next.
    ``launches``, ``steps`` and ``regrows`` count the kernel launches
    (regrows apart), wavefront steps and key-buffer regrows of every call
    so far."""

    def __init__(self, codes: np.ndarray, mesh: ShardMesh, axis: str = "seq",
                 rows_per_step: int = 128, rows_per_call: int = 1024,
                 hit_capacity: int = FIRST_KEY_CAP) -> None:
        self.R = int(rows_per_step)
        self.rows_per_call = round_up(max(1, int(rows_per_call)), self.R)
        self.hit_capacity = hit_capacity
        self._sweep = SwarDistributedSweep(codes, mesh, axis, self.R,
                                           key_cap=hit_capacity)
        self.launches = self.steps = self.regrows = 0
        self.reset()

    def reset(self) -> None:
        """Forget the chain: the next call starts from zero row states."""
        self._state = None

    def sweep_rows(self, scores: np.ndarray, row_offset: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Sweep one row chunk (<= rows_per_call rows) that follows the
        previous call's; returns its global hits (rows from
        ``row_offset``), sorted, this process's shards only."""
        if scores.shape[0] > self.rows_per_call:
            raise ValueError("row chunk exceeds rows_per_call")
        _, parts = self._sweep.sweep(scores, init_state=self._state)
        self._state = self._sweep.final_state
        self.launches += self._sweep.launches
        self.steps += self._sweep.steps
        self.regrows += self._sweep.regrows
        rows, pos = raw_pairs(parts, ordered=True)
        return rows + int(row_offset), pos

    def sweep_all(self, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The whole collection in row chunks of ``rows_per_call`` from
        the chain's start; exact global hits sorted by (row, position)."""
        self.reset()
        all_rows, all_pos = [], []
        for r0 in range(0, scores.shape[0], self.rows_per_call):
            rows, pos = self.sweep_rows(scores[r0:r0 + self.rows_per_call],
                                        r0)
            all_rows.append(rows)
            all_pos.append(pos)
        rows = np.concatenate(all_rows) if all_rows else np.empty(0, np.int64)
        pos = np.concatenate(all_pos) if all_pos else np.empty(0, np.int64)
        order = hit_sort_order(rows, pos)
        return rows[order], pos[order]


def ssv_distributed(symbols: np.ndarray, scores: np.ndarray, mesh: ShardMesh,
                    axis: str = "seq", rows_per_step: int = 128,
                    rows_per_call: int = 1024,
                    hit_capacity: int = FIRST_KEY_CAP
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot: the whole collection in row chunks of ``rows_per_call``;
    exact global hits sorted by (row, position)."""
    return DistributedSweep(symbols, mesh, axis, rows_per_step,
                            rows_per_call, hit_capacity).sweep_all(scores)
