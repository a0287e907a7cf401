"""The wavefront: its schedule, one step of it, and the seam exchange.

The counterpart of `havac_tpu/parallel/wavefront.py`. The database is cut
into D contiguous seq shards and a model group's rows into S row chunks of
R rows (the last chunk may be shorter). At step t, seq shard k sweeps row
chunk s = t - k over its whole width with one launch of the sweep kernel
(`havac_tpu_torch/csrc/ssv_sweep.cu`); the launch's final carry, (R+1)
int32, is the seam shard k+1 takes as its initial carry at step t+1, and
its final state is shard k's row state for its next chunk. A group's
wavefront takes S + D - 1 steps; shard k idles for the first k and the last
D-1-k. On a 2-D mesh every model group runs its own wavefront down its own
column of shards, with its own row states and seams, in the same steps: a
group with fewer chunks (or none) idles at the end, and nothing crosses the
model axis.

The kernel's carry contract makes the seam exact with no bookkeeping:
``final_carry[0]`` is the launch's ``init_state[L-1]`` (the previous row
chunk's last row at the shard's last position) and ``final_carry[j+1]`` is
row j's state there, which are the diagonal inputs of the next shard's
first position for the chunk's rows 0..R-1 (the JAX package's "the
receiver's icarry is exactly the arriving seam"). Shard 0 takes zeros, the
global left edge.

A process's shards of a group are a contiguous run of seq shards (possibly
empty; :meth:`~havac_tpu_torch.parallel.multihost.ShardMesh.local_shards`),
so only the run's first shard receives from another process and only its
last sends to one: the process :meth:`~havac_tpu_torch.parallel.multihost.
ShardMesh.owner` names. A seam reaches a shard of the same process as the
producer's tensor (moved with ``.to()`` when the devices differ). To a
shard of another process it travels by ``isend`` / ``irecv``: as a CUDA
tensor under NCCL, and under gloo, which sends host memory only, copied to
the host and back explicitly (the ``seam`` phase). The group's backend
decides; nothing switches it. Each step posts every group's receive before
any send and waits for all of them before the next step, groups in the
same order on every process, and a shard idle at a step neither sends nor
receives, so no process waits on one that waits on it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from havac_tpu_torch.engine.trace import span
from havac_tpu_torch.parallel.multihost import ShardMesh


@dataclass(frozen=True)
class Schedule:
    """Which row chunk each seq shard sweeps at each step, for one model
    group's P rows (P may be 0: the group idles throughout)."""

    D: int  # seq shards
    P: int  # the group's model rows
    R: int  # rows a step

    @property
    def S(self) -> int:
        return -(-self.P // self.R)

    @property
    def T(self) -> int:
        return self.S + self.D - 1

    def chunk(self, k: int, t: int) -> Optional[int]:
        """The row chunk seq shard ``k`` sweeps at step ``t``, or None when
        it idles."""
        s = t - k
        return s if 0 <= s < self.S else None

    def rows(self, s: int) -> Tuple[int, int]:
        r0 = s * self.R
        return r0, min(self.P, r0 + self.R)


class SeamExchange:
    """The seams of one process's shards of model group ``model``: for each
    of its seq shards, the (rows+1) int32 carry it takes at its next
    launch. The host copies and waits of the exchange are ``prof``'s
    ``seam`` (span ``havac.seam`` of run ``request``)."""

    def __init__(self, mesh: ShardMesh, schedule: Schedule,
                 prof: Dict[str, float], model: int = 0,
                 request: int = 0) -> None:
        self.mesh = mesh
        self.schedule = schedule
        self.model = model
        self.shards = mesh.local_shards(model)
        self.first = self.shards.start
        self.last = self.shards.stop - 1
        self.prof = prof
        self.request = request
        self._host = mesh.backend == "gloo"
        self.inbox: Dict[int, torch.Tensor] = {}
        self._recv: Optional[Tuple[int, torch.Tensor, object]] = None
        self._sends: List[Tuple[object, torch.Tensor]] = []

    def _device(self, k: int) -> torch.device:
        return self.mesh.device(k, self.model)

    def _tag(self, t: int) -> int:
        return t * self.mesh.model_parallel + self.model

    def _peer(self, k: int) -> int:
        return self.mesh.global_rank(self.mesh.owner(k, self.model))

    def seam(self, k: int, rows: int) -> torch.Tensor:
        """The seam shard ``k`` takes now for a chunk of ``rows`` rows."""
        dev = self._device(k)
        seam = self.inbox.pop(k, None)
        if seam is None:  # shard 0: the global left edge
            return torch.zeros(rows + 1, dtype=torch.int32, device=dev)
        if seam.shape[0] != rows + 1:
            raise RuntimeError(f"shard {k}: seam of {seam.shape[0]} for a "
                               f"chunk of {rows} rows")
        return seam if seam.device == dev else seam.to(dev)

    def post(self, t: int) -> None:
        """Before step ``t``'s launches: post the receive of the seam the
        process's first shard takes at step t+1, which the process holding
        the shard before it sends at step t."""
        k = self.first
        if not self.shards or k == 0:
            return
        s = self.schedule.chunk(k, t + 1)
        if s is None:
            return
        r0, r1 = self.schedule.rows(s)
        dev = torch.device("cpu") if self._host else self._device(k)
        buf = torch.empty(r1 - r0 + 1, dtype=torch.int32, device=dev)
        self._recv = (k, buf, dist.irecv(buf, src=self._peer(k - 1),
                                         group=self.mesh.group,
                                         tag=self._tag(t)))

    def send(self, k: int, t: int, carry: torch.Tensor) -> None:
        """After shard ``k``'s launch at step ``t``: its final carry is the
        seam shard k+1 takes at step t+1."""
        if k + 1 == self.schedule.D:
            return
        if k + 1 <= self.last:
            self.inbox[k + 1] = carry  # held until k+1's launch is enqueued
            return
        if self._host:
            with self._span():
                carry = carry.cpu()
        self._sends.append((dist.isend(carry, dst=self._peer(k + 1),
                                       group=self.mesh.group,
                                       tag=self._tag(t)), carry))

    def finish(self) -> None:
        """End of a step: wait for its send and its receive; the received
        seam waits in the inbox for the first shard's next launch."""
        with self._span():
            for work, _ in self._sends:
                work.wait()
            self._sends.clear()
            if self._recv is not None:
                k, buf, work = self._recv
                self._recv = None
                work.wait()
                self.inbox[k] = buf.to(self._device(k)) if self._host else buf

    def _span(self) -> span:
        return span("havac.seam", self.prof, "seam", request=self.request)

    def state(self) -> np.ndarray:
        """The inbox as (shards, R+1) int32, zero-padded: the seams the
        process's shards take at the next step (a checkpoint's part)."""
        out = np.zeros((len(self.shards), self.schedule.R + 1),
                       dtype=np.int32)
        for k, seam in self.inbox.items():
            out[k - self.first, :seam.shape[0]] = seam.cpu().numpy()
        return out

    def load(self, seams: np.ndarray, t: int) -> None:
        """Restore :meth:`state` for a run resumed at step ``t``."""
        for k in self.shards:
            s = self.schedule.chunk(k, t)
            if k > 0 and s is not None:
                r0, r1 = self.schedule.rows(s)
                self.inbox[k] = torch.from_numpy(np.ascontiguousarray(
                    seams[k - self.first, :r1 - r0 + 1], dtype=np.int32)
                ).to(self._device(k))


def wavefront_step(t: int, exchanges: Sequence[SeamExchange],
                   launch: Callable[[int, int, int, torch.Tensor],
                                    torch.Tensor]) -> int:
    """Step ``t`` on one process's shards of every model group (one
    exchange a group, in the same order on every process): post every
    group's receive of the next step's seam, launch each active shard with
    its seam (``launch(j, k, s, seam)`` enqueues seq shard k's sweep of row
    chunk s of the group of ``exchanges[j]`` and returns its final carry)
    and pass its final carry on, then complete every exchange. A group's
    shards launch from the last down, so each takes its seam before its
    left neighbour's new carry replaces it (and the one that sends to the
    next process goes first). Returns the launches made."""
    for ex in exchanges:
        ex.post(t)
    n = 0
    for j, ex in enumerate(exchanges):
        for k in reversed(ex.shards):
            s = ex.schedule.chunk(k, t)
            if s is None:
                continue
            r0, r1 = ex.schedule.rows(s)
            ex.send(k, t, launch(j, k, s, ex.seam(k, r1 - r0)))
            n += 1
    for ex in exchanges:
        ex.finish()
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
