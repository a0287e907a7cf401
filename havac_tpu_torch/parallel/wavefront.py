"""The 1-D wavefront: its schedule, one step of it, and the seam exchange.

The counterpart of `havac_tpu/parallel/wavefront.py`. The database is cut
into D contiguous shards and the models into S row chunks of R rows (the
last chunk may be shorter). At step t, shard g sweeps row chunk s = t - g
over its whole width with one launch of the sweep kernel
(`havac_tpu_torch/csrc/ssv_sweep.cu`); the launch's final carry, (R+1)
int32, is the seam shard g+1 takes as its initial carry at step t+1, and
its final state is shard g's row state for its next chunk. The run takes
T = S + D - 1 steps; shard g idles for the first g and the last D-1-g.

The kernel's carry contract makes the seam exact with no bookkeeping:
``final_carry[0]`` is the launch's ``init_state[L-1]`` (the previous row
chunk's last row at the shard's last position) and ``final_carry[j+1]`` is
row j's state there, which are the diagonal inputs of the next shard's
first position for the chunk's rows 0..R-1 (the JAX package's "the
receiver's icarry is exactly the arriving seam"). Shard 0 takes zeros, the
global left edge.

A seam reaches a shard of the same process as the producer's tensor
(moved with ``.to()`` when the devices differ). To a shard of another
process it travels by ``isend`` / ``irecv``: as a CUDA tensor under NCCL,
and under gloo, which sends host memory only, copied to the host and back
explicitly (the ``seam`` phase). The group's backend decides; nothing
switches it. Each step posts its receive before its sends and waits for
both before the next step, and a shard idle at a step neither sends nor
receives, so no process waits on one that waits on it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from havac_tpu_torch.parallel.multihost import ShardMesh


@dataclass(frozen=True)
class Schedule:
    """Which row chunk each shard sweeps at each step."""

    D: int  # shards
    P: int  # model rows
    R: int  # rows a step

    @property
    def S(self) -> int:
        return -(-self.P // self.R)

    @property
    def T(self) -> int:
        return self.S + self.D - 1

    def chunk(self, g: int, t: int) -> Optional[int]:
        """The row chunk shard ``g`` sweeps at step ``t``, or None when it
        idles."""
        s = t - g
        return s if 0 <= s < self.S else None

    def rows(self, s: int) -> Tuple[int, int]:
        r0 = s * self.R
        return r0, min(self.P, r0 + self.R)


class SeamExchange:
    """The seams of one process's shards ``first .. last``: for each shard,
    the (rows+1) int32 carry it takes at its next launch."""

    def __init__(self, mesh: ShardMesh, schedule: Schedule, first: int,
                 prof: Dict[str, float]) -> None:
        self.mesh = mesh
        self.schedule = schedule
        self.first = first
        self.last = first + mesh.shards_per_process - 1
        self.prof = prof
        self._host = mesh.backend == "gloo"
        self.inbox: Dict[int, torch.Tensor] = {}
        self._recv: Optional[Tuple[int, torch.Tensor, object]] = None
        self._sends: List[Tuple[object, torch.Tensor]] = []

    def _device(self, g: int) -> torch.device:
        return self.mesh.devices[g - self.first]

    def seam(self, g: int, rows: int) -> torch.Tensor:
        """The seam shard ``g`` takes now for a chunk of ``rows`` rows."""
        dev = self._device(g)
        seam = self.inbox.pop(g, None)
        if seam is None:  # shard 0: the global left edge
            return torch.zeros(rows + 1, dtype=torch.int32, device=dev)
        if seam.shape[0] != rows + 1:
            raise RuntimeError(f"shard {g}: seam of {seam.shape[0]} for a "
                               f"chunk of {rows} rows")
        return seam if seam.device == dev else seam.to(dev)

    def post(self, t: int) -> None:
        """Before step ``t``'s launches: post the receive of the seam the
        process's first shard takes at step t+1, which the left process
        sends at step t."""
        g = self.first
        s = self.schedule.chunk(g, t + 1)
        if g == 0 or s is None:
            return
        r0, r1 = self.schedule.rows(s)
        dev = torch.device("cpu") if self._host else self._device(g)
        buf = torch.empty(r1 - r0 + 1, dtype=torch.int32, device=dev)
        src = self.mesh.global_rank(self.mesh.rank - 1)
        self._recv = (g, buf, dist.irecv(buf, src=src, group=self.mesh.group,
                                         tag=t))

    def send(self, g: int, t: int, carry: torch.Tensor) -> None:
        """After shard ``g``'s launch at step ``t``: its final carry is the
        seam shard g+1 takes at step t+1."""
        if g + 1 == self.schedule.D:
            return
        if g + 1 <= self.last:
            self.inbox[g + 1] = carry  # held until g+1's launch is enqueued
            return
        if self._host:
            t0 = time.perf_counter()
            carry = carry.cpu()
            self.prof["seam"] += time.perf_counter() - t0
        dst = self.mesh.global_rank(self.mesh.rank + 1)
        self._sends.append((dist.isend(carry, dst=dst, group=self.mesh.group,
                                       tag=t), carry))

    def finish(self) -> None:
        """End of a step: wait for its send and its receive; the received
        seam waits in the inbox for the first shard's next launch."""
        t0 = time.perf_counter()
        for work, _ in self._sends:
            work.wait()
        self._sends.clear()
        if self._recv is not None:
            g, buf, work = self._recv
            self._recv = None
            work.wait()
            self.inbox[g] = buf.to(self._device(g)) if self._host else buf
        self.prof["seam"] += time.perf_counter() - t0

    def state(self) -> np.ndarray:
        """The inbox as (shards, R+1) int32, zero-padded: the seams the
        process's shards take at the next step (a checkpoint's part)."""
        out = np.zeros((self.last - self.first + 1, self.schedule.R + 1),
                       dtype=np.int32)
        for g, seam in self.inbox.items():
            out[g - self.first, :seam.shape[0]] = seam.cpu().numpy()
        return out

    def load(self, seams: np.ndarray, t: int) -> None:
        """Restore :meth:`state` for a run resumed at step ``t``."""
        for g in range(max(1, self.first), self.last + 1):
            s = self.schedule.chunk(g, t)
            if s is not None:
                r0, r1 = self.schedule.rows(s)
                self.inbox[g] = torch.from_numpy(np.ascontiguousarray(
                    seams[g - self.first, :r1 - r0 + 1], dtype=np.int32)
                ).to(self._device(g))


def wavefront_step(t: int, schedule: Schedule, exchange: SeamExchange,
                   launch: Callable[[int, int, torch.Tensor], torch.Tensor]
                   ) -> int:
    """Step ``t`` on one process's shards: post the receive of the next
    step's seam, launch each active shard with its seam (``launch(g, s,
    seam)`` enqueues shard g's sweep of row chunk s and returns its final
    carry) and pass its final carry on, then complete the step's exchange.
    Shards launch from the last down, so each takes its seam before its left
    neighbour's new carry replaces it (and the one that sends to the next
    process goes first). Returns the launches made."""
    exchange.post(t)
    n = 0
    for g in range(exchange.last, exchange.first - 1, -1):
        s = schedule.chunk(g, t)
        if s is None:
            continue
        r0, r1 = schedule.rows(s)
        exchange.send(g, t, launch(g, s, exchange.seam(g, r1 - r0)))
        n += 1
    exchange.finish()
    return n


def ssv_wavefront(symbols: np.ndarray, scores: np.ndarray, mesh: ShardMesh,
                  axis: str = "seq", rows_per_step: int = 512
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The exact sharded sweep; returns (hit_rows, hit_positions) sorted by
    (row, position), hits past the end of ``symbols`` (shard padding)
    dropped. In a multi-process mesh, this process's shards' hits."""
    from havac_tpu_torch.parallel.swar_dist import SwarDistributedSweep

    return SwarDistributedSweep(symbols, mesh, axis,
                                rows_per_step=rows_per_step).run(scores)
