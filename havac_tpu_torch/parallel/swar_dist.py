"""The mesh sweep: the sweep kernel per shard and step of the wavefront.

The counterpart of `havac_tpu/parallel/swar_dist.py` `SwarDistributedSweep`,
and the step loop the 2-D sweep
(:class:`~havac_tpu_torch.parallel.swar_dist2d.Swar2DSweep`) shares. Each
process stages its own shards of the database (equal seq shards of
``ceil(L / D)`` positions, the last padded with code 0) on their devices,
and for each step of the wavefront (:mod:`havac_tpu_torch.parallel.
wavefront`) launches ``ssv_sweep.cu`` once per active shard of every model
group, with each group's row states chained on the device and its seams
passed between its shards. A 1-D mesh is one group holding every row. The
hit keys of every launch cross to pinned host memory, regrow exactly when
the key buffer was too small, and are sorted and resolved in a collector
pool: the pipelined sweep's machinery (`engine/pipeline.py`
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
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from havac_tpu_torch.engine.pipeline import (FIRST_KEY_CAP, LOOKAHEAD,
                                             ChunkHits, KeyedLaunches,
                                             _merge_resolved, _POS_MASK,
                                             keys_from_pairs, raw_pairs,
                                             reset_counts)
from havac_tpu_torch.engine.trace import span
from havac_tpu_torch.hits.decode import ResolvedHits
from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.parallel.multihost import (ShardMesh, all_reduce_max,
                                                host_local_codes, shard_width)
from havac_tpu_torch.parallel.wavefront import (SeamExchange, Schedule,
                                                wavefront_step)


@dataclass
class _Front:
    """One model group's wavefront on this process's shards of it."""

    row0: int  # the group's first global row
    exchange: SeamExchange
    devices: List[torch.device]  # one a local seq shard, in order
    state: List[torch.Tensor]  # the row state of each local seq shard
    # {device: [(scores, reset rows, their count) a row chunk]}
    staged: dict

    @property
    def schedule(self) -> Schedule:
        return self.exchange.schedule

    @property
    def shards(self) -> range:
        return self.exchange.shards


class SwarDistributedSweep(KeyedLaunches):
    """The 1-D wavefront sweep of ``codes`` (L,) uint8 over ``mesh[axis]``
    in row chunks of ``rows_per_step`` (any R >= 1).

    ``database`` and ``phmm_prefix``, when given, resolve the hits as the
    engine needs them (:meth:`sweep`); :meth:`run` returns raw global
    (rows, positions) either way. ``prof`` charges the host's time, span
    by span (`engine/trace.py`), to ``sync`` (``havac.sync``: the
    processes' agreement on abort), ``seam`` (``havac.seam``: the
    exchange's host copies and waits) and, as on the main path,
    ``dispatch`` (``havac.launch``, one a shard and step, counted in
    ``launches``, its hit windows with a reset row in ``reset_windows``),
    ``ready_wait``
    (waiting on the device), ``fetch``, ``regrow``, ``sort``, ``resolve``,
    ``resolve_wait`` and ``tail`` (``tail_merge`` and ``tail_gather``),
    and counts the tail's placed segments in ``tail_segments``
    (``launched_ahead`` stays 0: a mesh run is never launched ahead of
    another, `engine/api.py` ``scan_files``).
    ``request`` is the engine's index of the run. After a run,
    ``launches``, ``steps`` and ``regrows`` count it, ``groups`` holds each
    model group's (first row, rows, row chunks S) and ``T`` the steps of
    the whole wavefront."""

    def __init__(self, codes: np.ndarray, mesh: ShardMesh, axis: str = "seq",
                 rows_per_step: int = 128, key_cap: int = FIRST_KEY_CAP,
                 database=None, phmm_prefix: Optional[np.ndarray] = None
                 ) -> None:
        if mesh.model_parallel > 1:
            raise ValueError("a mesh with a model axis runs Swar2DSweep")
        self._setup(codes, mesh, axis, rows_per_step, key_cap, database,
                    phmm_prefix)

    def _setup(self, codes: np.ndarray, mesh: ShardMesh, axis: str,
               rows_per_step: int, key_cap: int, database, phmm_prefix
               ) -> None:
        if axis not in mesh.shape or axis != mesh.axis:
            raise ValueError(f"mesh has no seq axis {axis!r} "
                             f"({mesh.axis_names})")
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
        self.shards = mesh.seq_shards()
        self.first = self.shards.start
        self._init_keys(database, phmm_prefix, key_cap)
        self.lookahead = LOOKAHEAD
        self.prof: Dict[str, float] = dict.fromkeys(
            ("dispatch", "sync", "ready_wait", "fetch", "regrow", "sort",
             "resolve", "seam", "resolve_wait", "tail", "tail_merge",
             "tail_gather"), 0.0)
        self.prof["tail_segments"] = self.prof["launches"] = 0
        self.prof["reset_windows"] = self.prof["launched_ahead"] = 0
        self.launches = 0
        self.steps = 0
        self.groups: List[Tuple[int, int, int]] = []
        self.T = 0
        if any(d.type == "cuda" for d in mesh.devices):
            ssv_cuda.load_library()

        # Each process stages only its own seq shards' symbols, once on
        # each device that holds one of their shards.
        local, _ = host_local_codes(codes, mesh, axis)
        W = self.shard_width
        padded = np.zeros(W * len(self.shards), dtype=np.uint8)
        padded[:local.shape[0]] = local
        self._max_code = int(codes.max())
        self._codes_dev: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        for m in range(mesh.model_parallel):
            for k in mesh.local_shards(m):
                dev = mesh.device(k, m)
                if (k, dev) not in self._codes_dev:
                    i = k - self.first
                    self._codes_dev[k, dev] = torch.from_numpy(
                        padded[i * W:(i + 1) * W]).to(dev)
        self.final_state: Optional[List[torch.Tensor]] = None

    # ------------------------------------------------------------ helpers

    def _staged(self, scores: np.ndarray, reset_rows, row0: int,
                schedule: Schedule, devices: Sequence[torch.device]):
        """Each row chunk's scores, reset rows and
        :func:`~havac_tpu_torch.engine.pipeline.reset_counts` of the group
        whose first row is ``row0``, once per device."""
        out = {}
        for dev in dict.fromkeys(devices):
            chunks = []
            for s in range(schedule.S):
                r0, r1 = (row0 + r for r in schedule.rows(s))
                sc = torch.from_numpy(np.ascontiguousarray(
                    scores[r0:r1], dtype=np.int8)).to(dev)
                rr = (None if reset_rows is None else torch.from_numpy(
                    np.ascontiguousarray(reset_rows[r0:r1], dtype=np.int32)
                ).to(dev))
                chunks.append((sc, rr, reset_counts(
                    None if reset_rows is None else reset_rows[r0:r1])))
            out[dev] = chunks
        return out

    def _aborted(self, abort_event) -> bool:
        """Whether any process was asked to stop (one all-reduce a step)."""
        flag = abort_event is not None and abort_event.is_set()
        with span("havac.sync", self.prof, "sync", request=self.request):
            return bool(all_reduce_max(self.mesh, int(flag)))

    def _resolve_shard(self, keys: np.ndarray,
                       rect: Tuple[int, int, int, int]) -> ChunkHits:
        """``_resolve_chunk`` with the shard padding past the database's
        end dropped (the last shards only); ``rect`` is the launch's row
        block and shard."""
        lo = rect[2]
        if lo + self.shard_width > self.L:
            pos = (keys & _POS_MASK).astype(np.int64)
            keys = keys[pos + (0 if self.keyform else lo) < self.L]
        return self._resolve_chunk(keys, rect)

    def _resume_hits(self, rows: np.ndarray, pos: np.ndarray) -> ChunkHits:
        rows = np.asarray(rows, dtype=np.int64)
        pos = np.asarray(pos, dtype=np.int64)
        if self.keyform:
            return self._resolve_chunk(keys_from_pairs(rows, pos))
        return self._resolve_pairs(rows, pos)

    def _snapshot(self, fronts: List[_Front]) -> tuple:
        """The checkpoint's state: the process's shards' row states
        (shards, W) int32 and their first shard, and the seams they take
        next (shards, R+1) int32 and their first shard."""
        f = fronts[0]
        istate = np.stack([x.cpu().numpy() for x in f.state])
        return istate, self.first, f.exchange.state(), self.first

    def _restore(self, fronts: List[_Front], istate: np.ndarray,
                 seams: np.ndarray, t: int) -> None:
        """Load :meth:`_snapshot`'s arrays for a run resumed at step t."""
        f = fronts[0]
        f.state = [torch.from_numpy(np.ascontiguousarray(
            istate[i], dtype=np.int32)).to(d) for i, d in enumerate(f.devices)]
        f.exchange.load(seams, t)

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
        out = self._sweep(scores, reset_rows, [(0, scores.shape[0])],
                          abort_event, progress, checkpoint_cb, resume,
                          ckpt_every, init_state)
        if out is None:
            return None
        fronts, hits = out
        self.final_state = fronts[0].state
        return hits

    def _sweep(self, scores: np.ndarray, reset_rows, bounds, abort_event,
               progress, checkpoint_cb, resume, ckpt_every: int,
               init_state=None):
        """The wavefronts of the model groups whose global rows are
        ``bounds`` [(r0, r1), ...], one group a column of the mesh, in the
        same steps. Returns the groups' fronts and (resolved hits or None,
        raw hit parts), or None when aborted."""
        P, card = scores.shape
        if P == 0:
            raise ValueError("empty model collection")
        if self._max_code >= card:
            raise ValueError(f"symbol code {self._max_code} >= alphabet "
                             f"cardinality {card}")
        schedules = [Schedule(self.D, r1 - r0, self.R) for r0, r1 in bounds]
        self.launches = self.steps = self.regrows = 0
        self.keyform = self._fits_keys(self.D * self.shard_width, P)
        self.groups = [(r0, sc.P, sc.S) for (r0, _), sc in zip(bounds,
                                                                 schedules)]
        self.T = max(sc.T for sc in schedules)
        W = self.shard_width
        # The sweep's streams do not wait on the caller's by themselves:
        # each first waits for the work queued on its device so far (the
        # caller's ``init_state`` among it), and everything the sweep fills
        # on a device is made on the sweep's stream there.
        streams = {d: torch.cuda.Stream(device=d)
                   for d in dict.fromkeys(self.mesh.devices)
                   if d.type == "cuda"}
        for d, stream in streams.items():
            stream.wait_stream(torch.cuda.current_stream(d))
        with contextlib.ExitStack() as ctx, \
                ThreadPoolExecutor(max_workers=4) as pool:
            for stream in streams.values():
                ctx.enter_context(torch.cuda.stream(stream))
            fronts = []
            for m, ((r0, _), sched) in enumerate(zip(bounds, schedules)):
                ex = SeamExchange(self.mesh, sched, self.prof, m,
                                  self.request)
                devs = [self.mesh.device(k, m) for k in ex.shards]
                state = (list(init_state) if init_state is not None else
                         [torch.zeros(W, dtype=torch.int32, device=d)
                          for d in devs])
                fronts.append(_Front(r0, ex, devs, state, self._staged(
                    scores, reset_rows, r0, sched, devs)))
            start_t, resumed = 0, None
            if resume is not None:
                start_t, istate, seams, rows0, pos0 = resume
                self._restore(fronts, istate, seams, start_t)
                resumed = (rows0, pos0)
            results = self._run_steps(pool, fronts, start_t, resumed,
                                      abort_event, progress, checkpoint_cb,
                                      ckpt_every, streams)
        if results is None:
            return None
        resolved = (None if self._database is None
                    else _merge_resolved(results, self.prof, self.request))
        return fronts, (resolved, [r.keys for r in results])

    def _run_steps(self, pool, fronts: List[_Front], start_t: int, resumed,
                   abort_event, progress, checkpoint_cb, ckpt_every: int,
                   streams) -> Optional[List[ChunkHits]]:
        futures: List = []
        results: List[ChunkHits] = []
        pend: List[Tuple[int, object]] = []  # (step, launched chunk)
        if resumed is not None:
            futures.append(pool.submit(self._resume_hits, *resumed))
        T, W = self.T, self.shard_width
        exchanges = [f.exchange for f in fronts]

        def drain(before: int) -> None:
            while pend and pend[0][0] < before:
                p = pend.pop(0)[1]
                futures.append(pool.submit(self._resolve_shard, self._pull(p),
                                           p.rect))

        for t in range(start_t, T):
            if self._aborted(abort_event):
                for stream in streams.values():
                    stream.synchronize()
                for f in futures:
                    f.result()
                return None

            def launch(j: int, k: int, s: int, seam: torch.Tensor
                       ) -> torch.Tensor:
                f = fronts[j]
                i = k - f.shards.start
                dev = f.devices[i]
                sc, rr, resets = f.staged[dev][s]
                p = self._enqueue((self._codes_dev[k, dev], sc, rr,
                                   f.state[i], seam),
                                  f.row0 + f.schedule.rows(s)[0], k * W,
                                  (k, s), resets)
                f.state[i] = p.out.final_state
                pend.append((t, p))
                return p.out.final_carry

            self.launches += wavefront_step(t, exchanges, launch)
            self.steps += 1
            drain(t + 1 - self.lookahead)
            if progress is not None:
                progress(t + 1, T)
            if (checkpoint_cb is not None and t + 1 < T
                    and (t + 1 - start_t) % ckpt_every == 0):
                drain(T)
                results += self._wait_resolved(futures)
                futures.clear()
                rows, pos = raw_pairs([r.keys for r in results])
                checkpoint_cb(t + 1, *self._snapshot(fronts), rows, pos)
        drain(T)
        return results + self._wait_resolved(futures)
