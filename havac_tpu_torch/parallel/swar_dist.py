"""The mesh sweep: the sweep kernel per shard and step of the 1-D wavefront.

The counterpart of `havac_tpu/parallel/swar_dist.py` `SwarDistributedSweep`.
Each process stages its own shards of the database (equal shards of
``ceil(L / D)`` positions, the last padded with code 0) on their devices,
and for each step of the wavefront (:mod:`havac_tpu_torch.parallel.
wavefront`) launches ``ssv_sweep.cu`` once per active shard, with the row
state chained on the device and the seams passed between shards. The hit
keys of every launch cross to pinned host memory, regrow exactly when the
key buffer was too small, and are sorted and resolved in a collector pool:
the pipelined sweep's machinery (`engine/pipeline.py`
:class:`~havac_tpu_torch.engine.pipeline.KeyedLaunches`). Inside the key
bounds the kernel writes global keys (rows from the chunk's first row,
positions from the shard's first); past them, chunk-local keys that the
host widens.

Of the JAX sweep's TPU workarounds none crosses over: there is no
monolithic scan, superstep or pull batch, no delta16 records, no column
chunks for a tile budget and no record-cap retry (the kernel counts its
keys exactly). Abort is honored between steps, and in a multi-process mesh
the processes agree on it once a step (every process must take the same
steps, or the seams would deadlock). Each process returns its own shards'
hits.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from havac_tpu_torch.engine.pipeline import (FIRST_KEY_CAP, LOOKAHEAD,
                                             ChunkHits, KeyedLaunches,
                                             _merge_resolved, _POS_MASK,
                                             keys_from_pairs, raw_pairs)
from havac_tpu_torch.hits.decode import ResolvedHits
from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.parallel.multihost import (ShardMesh, all_reduce_max,
                                                host_local_codes,
                                                local_row_range, shard_width)
from havac_tpu_torch.parallel.wavefront import (SeamExchange, Schedule,
                                                wavefront_step)


class SwarDistributedSweep(KeyedLaunches):
    """The 1-D wavefront sweep of ``codes`` (L,) uint8 over ``mesh[axis]``
    in row chunks of ``rows_per_step`` (any R >= 1).

    ``database`` and ``phmm_prefix``, when given, resolve the hits as the
    engine needs them (:meth:`sweep`); :meth:`run` returns raw global
    (rows, positions) either way. ``prof`` charges the host's time to
    ``dispatch`` (enqueueing steps, the exchange apart), ``sync`` (the
    processes' agreement on abort), ``seam`` (the exchange's host copies
    and waits) and, as on the main path, ``ready_wait`` (waiting on the
    device), ``fetch``, ``regrow``, ``sort`` and ``resolve``."""

    def __init__(self, codes: np.ndarray, mesh: ShardMesh, axis: str = "seq",
                 rows_per_step: int = 128, key_cap: int = FIRST_KEY_CAP,
                 database=None, phmm_prefix: Optional[np.ndarray] = None
                 ) -> None:
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r} ({mesh.axis_names})")
        if int(rows_per_step) < 1:
            raise ValueError("rows_per_step must be at least 1")
        self.mesh = mesh
        self.axis = axis
        self.R = int(rows_per_step)
        self.D = mesh.shape[axis]
        self.L = int(codes.shape[0])
        if self.L == 0:
            raise ValueError("empty database")
        self.shard_width = shard_width(self.L, mesh, axis)
        self.first, end = local_row_range(self.D, mesh, axis)
        self.shards = range(self.first, end)
        self._init_keys(database, phmm_prefix, key_cap)
        self.lookahead = LOOKAHEAD
        self.prof: Dict[str, float] = dict.fromkeys(
            ("dispatch", "sync", "ready_wait", "fetch", "regrow", "sort",
             "resolve", "seam"), 0.0)
        self.launches = 0
        self.steps = 0
        if any(d.type == "cuda" for d in mesh.devices):
            ssv_cuda.build()

        # Each process stages only its own shards' symbols.
        local, _ = host_local_codes(codes, mesh, axis)
        W = self.shard_width
        padded = np.zeros(W * len(self.shards), dtype=np.uint8)
        padded[:local.shape[0]] = local
        self._max_code = int(codes.max())
        self._codes_dev = [
            torch.from_numpy(padded[i * W:(i + 1) * W]).to(dev)
            for i, dev in enumerate(mesh.devices)]
        self.final_state: Optional[List[torch.Tensor]] = None

    # ------------------------------------------------------------ helpers

    def _staged(self, scores: np.ndarray, reset_rows, schedule: Schedule):
        """Each row chunk's scores and reset rows, once per device."""
        out = {}
        for dev in dict.fromkeys(self.mesh.devices):
            chunks = []
            for s in range(schedule.S):
                r0, r1 = schedule.rows(s)
                sc = torch.from_numpy(np.ascontiguousarray(
                    scores[r0:r1], dtype=np.int8)).to(dev)
                rr = (None if reset_rows is None else torch.from_numpy(
                    np.ascontiguousarray(reset_rows[r0:r1], dtype=np.int32)
                ).to(dev))
                chunks.append((sc, rr))
            out[dev] = chunks
        return out

    def _aborted(self, abort_event) -> bool:
        """Whether any process was asked to stop (one all-reduce a step)."""
        flag = abort_event is not None and abort_event.is_set()
        t0 = time.perf_counter()
        agreed = bool(all_reduce_max(self.mesh, int(flag)))
        self.prof["sync"] += time.perf_counter() - t0
        return agreed

    def _resolve_shard(self, keys: np.ndarray, r0: int, lo: int) -> ChunkHits:
        """``_resolve_chunk`` with the shard padding past the database's
        end dropped (the last shards only)."""
        if lo + self.shard_width > self.L:
            pos = (keys & _POS_MASK).astype(np.int64)
            keys = keys[pos + (0 if self.keyform else lo) < self.L]
        return self._resolve_chunk(keys, r0, lo)

    def _resume_hits(self, rows: np.ndarray, pos: np.ndarray) -> ChunkHits:
        rows = np.asarray(rows, dtype=np.int64)
        pos = np.asarray(pos, dtype=np.int64)
        if self.keyform:
            return self._resolve_chunk(keys_from_pairs(rows, pos))
        return self._resolve_pairs(rows, pos)

    # ---------------------------------------------------------------- run

    def run(self, scores: np.ndarray,
            reset_rows: Optional[np.ndarray] = None, abort_event=None,
            progress=None, checkpoint_cb=None, resume=None,
            ckpt_every: int = 8) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Sweep the (P, card) int8 scores; exact global (rows, positions)
        of this process's shards, sorted by (row, position), or None when
        aborted. The JAX sweep's contract: ``reset_rows`` (bool (P,))
        isolates models; ``abort_event`` is honored between steps;
        ``progress(step, T)`` follows every step; ``checkpoint_cb(t_next,
        istate (shards, W) int32, first shard, seams (shards, R+1) int32,
        first shard, rows, positions)`` runs every ``ckpt_every`` steps
        strictly inside the run, and ``resume`` is ``(t_next, istate,
        seams, rows, positions)`` from such a call."""
        out = self.sweep(scores, reset_rows, abort_event, progress,
                         checkpoint_cb, resume, ckpt_every)
        return None if out is None else raw_pairs(out[1], ordered=True)

    def sweep(self, scores: np.ndarray,
              reset_rows: Optional[np.ndarray] = None, abort_event=None,
              progress=None, checkpoint_cb=None, resume=None,
              ckpt_every: int = 8,
              init_state: Optional[Sequence[torch.Tensor]] = None
              ) -> Optional[Tuple[Optional[ResolvedHits], List[np.ndarray]]]:
        """:meth:`run`, returning (resolved hits or None without a
        database, raw hit parts as :func:`~havac_tpu_torch.engine.pipeline.
        raw_pairs` takes them). ``init_state``, the shards' row states to
        start from (zeros by default), chains one sweep onto the last
        (:class:`~havac_tpu_torch.parallel.engine_dist.DistributedSweep`);
        :attr:`final_state` holds them after the run."""
        P, card = scores.shape
        if P == 0:
            raise ValueError("empty model collection")
        if self._max_code >= card:
            raise ValueError(f"symbol code {self._max_code} >= alphabet "
                             f"cardinality {card}")
        schedule = Schedule(self.D, P, self.R)
        self.launches = self.steps = self.regrows = 0
        self.keyform = self._fits_keys(self.D * self.shard_width, P)
        self.schedule = schedule
        devs = self.mesh.devices
        W = self.shard_width
        exchange = SeamExchange(self.mesh, schedule, self.first, self.prof)
        # The sweep's streams do not wait on the caller's by themselves:
        # each first waits for the work queued on its device so far (the
        # caller's ``init_state`` among it), and everything the sweep fills
        # on a device is made on the sweep's stream there.
        streams = {d: torch.cuda.Stream(device=d)
                   for d in dict.fromkeys(devs) if d.type == "cuda"}
        for d, stream in streams.items():
            stream.wait_stream(torch.cuda.current_stream(d))
        with contextlib.ExitStack() as ctx, \
                ThreadPoolExecutor(max_workers=4) as pool:
            for stream in streams.values():
                ctx.enter_context(torch.cuda.stream(stream))
            staged = self._staged(scores, reset_rows, schedule)
            start_t, resumed = 0, None
            state = (list(init_state) if init_state is not None else
                     [torch.zeros(W, dtype=torch.int32, device=d)
                      for d in devs])
            if resume is not None:
                start_t, istate, seams, rows0, pos0 = resume
                state = [torch.from_numpy(np.ascontiguousarray(
                    istate[i], dtype=np.int32)).to(d)
                    for i, d in enumerate(devs)]
                exchange.load(seams, start_t)
                resumed = (rows0, pos0)
            results = self._run_steps(pool, schedule, staged, exchange, state,
                                      start_t, resumed, abort_event, progress,
                                      checkpoint_cb, ckpt_every, streams)
        if results is None:
            return None
        self.final_state = state
        t0 = time.perf_counter()
        resolved = (None if self._database is None
                    else _merge_resolved(results))
        self.prof["sort"] += time.perf_counter() - t0
        return resolved, [r.keys for r in results]

    def _run_steps(self, pool, schedule: Schedule, staged, exchange,
                   state: List[torch.Tensor], start_t: int, resumed,
                   abort_event, progress, checkpoint_cb, ckpt_every: int,
                   streams) -> Optional[List[ChunkHits]]:
        futures: List = []
        results: List[ChunkHits] = []
        pend: List[Tuple[int, object]] = []  # (step, launched chunk)
        if resumed is not None:
            futures.append(pool.submit(self._resume_hits, *resumed))
        T, W = schedule.T, self.shard_width

        def drain(before: int) -> None:
            while pend and pend[0][0] < before:
                p = pend.pop(0)[1]
                futures.append(pool.submit(self._resolve_shard, self._pull(p),
                                           p.r0, p.lo))

        for t in range(start_t, T):
            if self._aborted(abort_event):
                for stream in streams.values():
                    stream.synchronize()
                for f in futures:
                    f.result()
                return None
            t0, seam0 = time.perf_counter(), self.prof["seam"]

            def launch(g: int, s: int, seam: torch.Tensor) -> torch.Tensor:
                i = g - self.first
                sc, rr = staged[self.mesh.devices[i]][s]
                p = self._enqueue((self._codes_dev[i], sc, rr, state[i],
                                   seam), schedule.rows(s)[0], g * W)
                state[i] = p.out.final_state
                pend.append((t, p))
                return p.out.final_carry

            self.launches += wavefront_step(t, schedule, exchange, launch)
            self.steps += 1
            self.prof["dispatch"] += (time.perf_counter() - t0
                                      - (self.prof["seam"] - seam0))
            drain(t + 1 - self.lookahead)
            if progress is not None:
                progress(t + 1, T)
            if (checkpoint_cb is not None and t + 1 < T
                    and (t + 1 - start_t) % ckpt_every == 0):
                drain(T)
                results += [f.result() for f in futures]
                futures.clear()
                istate = np.stack([x.cpu().numpy() for x in state])
                rows, pos = raw_pairs([r.keys for r in results])
                checkpoint_cb(t + 1, istate, self.first, exchange.state(),
                              self.first, rows, pos)
        drain(T)
        return results + [f.result() for f in futures]
