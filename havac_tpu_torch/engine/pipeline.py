"""Pipelined single-device sweep: hit resolution overlaps the device sweep.

The counterpart of `havac_tpu/engine/pipeline.py` `PipelinedSweep`. The
sequence database and the score rows are staged on the device once; the
(column chunk x row chunk) grid is swept in column-major order, each chunk
one launch of the sweep kernel (`ops/ssv_cuda.py`), with the row state
chained down a column and the boundary-carry column chained across columns,
both kept on the device. Up to ``lookahead`` chunks are in flight on one
CUDA stream; each chunk's hit count and key buffer cross to pinned host
memory by asynchronous copies, and a collector pool sorts and resolves the
keys (`havac_tpu_torch.native.resolve_keys_native`) while the device sweeps later
chunks. The launches, pulls, regrows and resolution are
:class:`KeyedLaunches`, which the mesh sweep
(`havac_tpu_torch/parallel/swar_dist.py`) shares. Every host phase is a
span (`engine/trace.py`): its seconds go to ``prof`` and, under a
profiler, its name to the trace.

After the last chunk, the tail (:func:`_merge_resolved`) joins the
per-chunk tables into one ordered by (row, position). Each launch's hits
lie in the (row, position) rectangle it swept, so where the rectangles
are disjoint the order follows from the geometry: every (chunk, row)
segment is placed by its count and copied there in one threaded native
pass. Hits without such rectangles (a resumed mesh sweep, pairs past the
key bounds) take a comparison merge.

The kernel emits its own hit keys and an exact count, so the JAX engine's
dirty-tile drain, record compaction, pull batching and learned record caps
have no counterpart here: a chunk whose count exceeds the key buffer is
launched once more with a buffer of exactly that size, and the buffer size
for later chunks grows to fit.

Keys hold global (row, position) pairs inside the bounds ``KEY_ROWS``,
``KEY_POSITIONS`` and ``KEY_SEQUENCE``. Past any of them, as the reference
does, the chunks are launched with chunk-local keys, the collector widens
them by the chunk's first row and position, and hits travel as int64
(row, position) pairs resolved by ``resolve_block_with_keys``.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from havac_tpu_torch import native
from havac_tpu_torch.engine.trace import span
from havac_tpu_torch.hits.decode import ResolvedHits, resolve_block_with_keys
from havac_tpu_torch.ops.common import round_up
from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.ops.ssv_torch import KEY_POS_BITS, MAX_POS, MAX_ROW

_POS_MASK = np.uint64((1 << KEY_POS_BITS) - 1)
# The u64 hit key (row << 38) | pos holds global coordinates while the
# collection has fewer rows, the database fewer positions and every sequence
# fewer symbols than these (the native key resolver keeps sequence positions
# in 32 bits). Past any of them the kernel emits chunk-local keys and the
# host resolves int64 (row, position) pairs, as the reference does.
KEY_ROWS = MAX_ROW
KEY_POSITIONS = MAX_POS
KEY_SEQUENCE = 1 << 31
# Chunks in flight: while the host pulls and resolves chunk i, chunks i+1
# and i+2 are queued on the device.
LOOKAHEAD = 3
# First per-chunk key buffer (8 MiB); a chunk with more hits runs once more
# with an exact buffer and later chunks get room for 1.25x that count.
FIRST_KEY_CAP = 1 << 20
_RESOLVED_FIELDS = ("sequence_index", "sequence_position", "phmm_index",
                    "phmm_position")


def keys_from_pairs(rows: np.ndarray, pos: np.ndarray) -> np.ndarray:
    return ((np.asarray(rows).astype(np.uint64) << np.uint64(KEY_POS_BITS))
            | np.asarray(pos).astype(np.uint64))


def pairs_from_keys(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return ((keys >> np.uint64(KEY_POS_BITS)).astype(np.int64),
            (keys & _POS_MASK).astype(np.int64))


def raw_pairs(parts: List[np.ndarray], ordered: bool = False
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Global (rows, positions) of raw hit parts as :meth:`PipelinedSweep.run`
    returns them: uint64 keys, or (n, 2) int64 (row, position) pairs past the
    key bounds. ``ordered`` sorts them by (row, position)."""
    parts = [p for p in parts if p.shape[0]]
    if not parts:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    if parts[0].ndim == 1:
        keys = np.concatenate(parts)
        return pairs_from_keys(np.sort(keys) if ordered else keys)
    pairs = np.concatenate(parts)
    if ordered:
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    return pairs[:, 0].copy(), pairs[:, 1].copy()


@dataclass
class _Pending:
    """One launched chunk whose hits have not reached the host yet."""

    r0: int  # the chunk's first global row and position: the keys are
    lo: int  # chunk-local past the key bounds
    chunk: Tuple[int, int]  # (column chunk, row chunk), for the spans
    # (symbols, scores, reset_rows, init_state, init_carry): for a regrow
    inputs: tuple
    out: ssv_cuda.SweepBuffers
    host_keys: Optional[torch.Tensor]  # pinned, CUDA only
    host_count: Optional[torch.Tensor]
    event: Optional["torch.cuda.Event"]

    @property
    def rect(self) -> Tuple[int, int, int, int]:
        """The global rows [r0, r1) and positions [lo, hi) swept."""
        sym, scores = self.inputs[:2]
        return (self.r0, self.r0 + scores.shape[0], self.lo,
                self.lo + sym.shape[0])


@dataclass
class ChunkHits:
    """A chunk's hits on the host: every hit (sorted) and the resolved
    table of the kept ones (separator/padding hits dropped). Hits are
    global uint64 keys, or (n, 2) int64 (row, position) pairs past the key
    bounds. A sweep with no database resolves nothing (``resolved`` and
    ``kept_keys`` None).

    ``rect`` is the rectangle of global rows [r0, r1) and positions [lo,
    hi) that holds every hit, the launch's; ``row_offs`` (r1 - r0 + 1,)
    bounds each of its rows in ``kept_keys``. Both are None where the hits
    fill no rectangle (a resumed mesh sweep's staircase of steps) or are
    pairs; the tail then merges by comparison."""

    keys: np.ndarray  # sorted by (row, position)
    resolved: Optional[ResolvedHits]
    kept_keys: Optional[np.ndarray]  # sorted by (row, position)
    rect: Optional[Tuple[int, int, int, int]] = None
    row_offs: Optional[np.ndarray] = None


def reset_counts(reset_rows: Optional[np.ndarray]) -> Tuple[int, int]:
    """A launch's reset rows (model starts) and the hit windows that hold
    one: ``ssv_cuda.WINDOW_ROWS`` rows from the launch's first row, aligned
    as an interior block's tiles are. Only those windows run the kernel's
    per-row reset test."""
    if reset_rows is None:
        return 0, 0
    r = np.asarray(reset_rows) != 0
    win = ssv_cuda.WINDOW_ROWS
    padded = np.zeros(-(-r.size // win) * win, bool)
    padded[:r.size] = r
    return (int(np.count_nonzero(r)),
            int(np.count_nonzero(padded.reshape(-1, win).any(axis=1))))


class KeyedLaunches:
    """Sweep-kernel launches whose hit keys cross to the host and are
    resolved there: what the pipelined sweep and the mesh sweep
    (`havac_tpu_torch/parallel/swar_dist.py`) share.

    :meth:`_enqueue` launches one chunk on the current stream of its
    tensors' device and starts the asynchronous copy of its count and keys
    into pinned host memory; :meth:`_pull` waits for them and, when the
    count exceeded the key buffer, launches the chunk once more from its
    retained inputs with a buffer of exactly that size (later chunks get
    room for 1.25x the count); :meth:`_resolve_chunk` sorts the keys and
    resolves them, in a collector pool. The host's time goes to ``prof``'s
    ``dispatch`` (span ``havac.launch``, counted in ``launches``; a regrow's
    relaunch is not; its hit windows with a reset row are summed in
    ``reset_windows``), ``ready_wait`` and ``fetch``
    (``havac.pull``), ``regrow`` (``havac.regrow``), ``sort`` and
    ``resolve`` (``havac.sort``, ``havac.resolve``: thread-seconds summed
    over the pool) and ``resolve_wait`` (``havac.resolve_wait``). Each span
    carries ``request``, the engine's index of the run."""

    def _init_keys(self, database, phmm_prefix, key_cap: int,
                   request: int = 0) -> None:
        self.request = request
        self.key_cap = max(1, int(key_cap))
        self.regrows = 0
        self._database = database
        self._prefix = (None if phmm_prefix is None
                        else np.asarray(phmm_prefix, dtype=np.int64))
        self._tables = (None if database is None else
                        (np.asarray(database.starts, dtype=np.int64),
                         np.asarray(database.lengths, dtype=np.int64),
                         self._prefix))
        self._native = native if native.available() else None
        self._prof_lock = threading.Lock()
        self._pinned: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def _fits_keys(self, L: int, P: int) -> bool:
        """Whether keys can hold global coordinates for ``P`` rows over
        ``L`` positions of the database (``keyform``)."""
        lengths = (self._tables[1] if self._tables is not None
                   else np.empty(0, np.int64))
        return (P < KEY_ROWS and L < KEY_POSITIONS
                and not (lengths.size and int(lengths.max()) >= KEY_SEQUENCE))

    def _host_buffers(self, cap: int):
        while self._pinned:
            keys, count = self._pinned.pop()
            if keys.shape[0] == cap:
                return keys, count
        return (torch.empty(cap, dtype=torch.int64, pin_memory=True),
                torch.empty(1, dtype=torch.int64, pin_memory=True))

    def _enqueue(self, inputs: tuple, r0: int, lo: int,
                 chunk: Tuple[int, int],
                 resets: Tuple[int, int] = (0, 0)) -> _Pending:
        """Launch one chunk: ``inputs`` = (symbols, scores, reset_rows,
        init_state, init_carry) on one device; (r0, lo) its first global
        row and position; ``chunk`` its (column chunk, row chunk);
        ``resets`` its :func:`reset_counts`, the model starts among its
        rows that reset the chain and the hit windows that hold one."""
        dev = inputs[0].device
        L, (P, card) = inputs[0].shape[0], inputs[1].shape
        self.prof["launches"] += 1
        self.prof["reset_windows"] += resets[1]
        with span("havac.launch", self.prof, "dispatch",
                  request=self.request, column_chunk=chunk[0],
                  row_chunk=chunk[1], symbols=L, rows=P, card=card,
                  resets=resets[0], reset_windows=resets[1],
                  key_cap=self.key_cap):
            out = ssv_cuda.SweepBuffers.empty(L, P, self.key_cap, dev)
            self._launch(inputs, r0, lo, out)
            host_keys = host_count = event = None
            if dev.type == "cuda":
                host_keys, host_count = self._host_buffers(out.cap)
                host_count.copy_(out.count, non_blocking=True)
                host_keys.copy_(out.keys, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
        return _Pending(r0, lo, chunk, inputs, out, host_keys, host_count,
                        event)

    def _launch(self, inputs: tuple, r0: int, lo: int,
                out: ssv_cuda.SweepBuffers) -> None:
        sym, scores, reset, istate, icarry = inputs
        if not self.keyform:
            r0 = lo = 0  # chunk-local keys, widened on the host
        ssv_cuda.launch(sym, scores, istate, icarry, reset, r0, lo, out)

    def _pull(self, p: _Pending) -> np.ndarray:
        """The chunk's keys on the host (unordered); regrows on overflow.
        ``havac.pull`` waits for the chunk (``ready_wait``), then reads its
        count and, unless the chunk regrows, its keys (``fetch``)."""
        chunk = dict(request=self.request, column_chunk=p.chunk[0],
                     row_chunk=p.chunk[1])
        with span("havac.pull", self.prof, "fetch", **chunk) as s:
            if p.event is not None:
                p.event.synchronize()
            s.split("ready_wait")
            count = p.host_count if p.host_count is not None else p.out.count
            n = int(count[0])
            if n <= p.out.cap:
                src = p.host_keys if p.host_keys is not None else p.out.keys
                keys = src[:n].numpy().view(np.uint64).copy()
                if p.host_keys is not None:
                    self._pinned.append((p.host_keys, p.host_count))
                return keys
        # The key buffer was too small: launch the chunk again with a buffer
        # of exactly the count, and size later chunks' buffers to fit.
        with span("havac.regrow", self.prof, "regrow", **chunk):
            self.regrows += 1
            self.key_cap = max(self.key_cap, round_up(n + n // 4, 1 << 16))
            sym, scores = p.inputs[:2]
            out = ssv_cuda.SweepBuffers.empty(sym.shape[0], scores.shape[0],
                                              n, sym.device)
            self._launch(p.inputs, p.r0, p.lo, out)
            keys = out.keys.cpu().numpy().view(np.uint64).copy()
            if int(out.count.cpu()[0]) != n:
                raise RuntimeError("hit count changed on relaunch")
        return keys

    def _resolve_chunk(self, keys: np.ndarray,
                       rect: Optional[Tuple[int, int, int, int]] = None, *,
                       nthreads: int = 1, presorted: bool = False
                       ) -> ChunkHits:
        """Collector-pool work item: sort the chunk's keys in place, then
        resolve them to local coordinates (separator/padding hits dropped)
        on ``nthreads`` native threads, and bound each row of ``rect`` in
        the kept keys. ``rect`` (r0, r1, lo, hi) is the launch's rectangle,
        which holds the keys; past the key bounds the keys are chunk-local
        and (r0, lo) widens them. ``presorted`` keys skip the sort
        (`tools/hostbench.py` times the work item both ways)."""
        if not self.keyform:
            r0, lo = (0, 0) if rect is None else (rect[0], rect[2])
            rows, pos = pairs_from_keys(keys)
            return self._resolve_pairs(rows + r0, pos + lo)
        with self._pool_span("havac.sort", "sort"):
            if not presorted:
                keys.sort()
        res = kept = row_offs = None
        with self._pool_span("havac.resolve", "resolve"):
            if self._database is not None and self._native is not None:
                starts, lengths, prefix = self._tables
                si, sp, mi, mp, kept = self._native.resolve_keys_native(
                    keys, starts, lengths, prefix, nthreads=nthreads)
                res = ResolvedHits(si, sp, mi, mp)
            elif self._database is not None:
                rows, pos = pairs_from_keys(keys)
                res, kr, kp = resolve_block_with_keys(
                    rows, pos, self._database, self._prefix)
                kept = keys_from_pairs(kr, kp)
            if kept is not None and rect is not None:
                row_offs = np.searchsorted(kept, np.arange(
                    rect[0], rect[1] + 1, dtype=np.uint64) << np.uint64(
                        KEY_POS_BITS))
        return ChunkHits(keys, res, kept, rect if row_offs is not None
                         else None, row_offs)

    def _resolve_pairs(self, rows: np.ndarray, pos: np.ndarray) -> ChunkHits:
        """``_resolve_chunk`` past the key bounds: global int64 pairs."""
        with self._pool_span("havac.sort", "sort"):
            order = np.lexsort((pos, rows))
            rows, pos = rows[order], pos[order]
        res = kept = None
        with self._pool_span("havac.resolve", "resolve"):
            if self._database is not None:
                res, kr, kp = resolve_block_with_keys(
                    rows, pos, self._database, self._prefix)
                kept = np.stack([kr, kp], axis=1)
        return ChunkHits(np.stack([rows, pos], axis=1), res, kept)

    def _pool_span(self, name: str, key: str) -> span:
        """A collector-pool phase: the pool's threads share ``prof``."""
        return span(name, self.prof, key, self._prof_lock,
                    request=self.request)

    def _wait_resolved(self, futures: List) -> List[ChunkHits]:
        """The pool's results, in order (``havac.resolve_wait``)."""
        with span("havac.resolve_wait", self.prof, "resolve_wait",
                  request=self.request):
            return [f.result() for f in futures]


def collector(database, phmm_prefix) -> KeyedLaunches:
    """The collector pool's resolver outside a sweep: global keys over
    ``database`` and ``phmm_prefix``, resolved by
    :meth:`KeyedLaunches._resolve_chunk` as a sweep resolves them."""
    c = KeyedLaunches()
    c._init_keys(database, phmm_prefix, FIRST_KEY_CAP)
    c.keyform = True
    c.prof = dict.fromkeys(("sort", "resolve"), 0.0)
    return c


class PipelinedSweep(KeyedLaunches):
    """Chunked (column x row) sweep over ``codes`` (L,) uint8 against
    ``scores`` (P, card) int8 on ``device``, for the engine's run
    ``request``. Staging the database and the score rows on the device is
    ``prof``'s ``stage`` (span ``havac.stage``)."""

    def __init__(self, codes: np.ndarray, scores: np.ndarray,
                 chunk_symbols: int, chunk_rows: int, device,
                 database, phmm_prefix: np.ndarray,
                 reset_rows: Optional[np.ndarray] = None,
                 key_cap: int = FIRST_KEY_CAP, request: int = 0) -> None:
        self.prof: Dict[str, float] = dict.fromkeys(
            ("stage", "dispatch", "gate_wait", "ready_wait", "fetch",
             "regrow", "sort", "resolve", "drain", "resolve_wait", "tail",
             "tail_merge", "tail_gather"), 0.0)
        self.prof["tail_segments"] = self.prof["launches"] = 0
        self.prof["reset_windows"] = self.prof["launched_ahead"] = 0
        with span("havac.stage", self.prof, "stage", request=request):
            self.device = torch.device(device)
            if self.device.type == "cuda":
                ssv_cuda.load_library()
            self.L = int(codes.shape[0])
            self.P, card = scores.shape
            if self.L == 0 or self.P == 0:
                raise ValueError("empty database or model collection")
            if int(codes.max()) >= card:
                raise ValueError(f"symbol code {int(codes.max())} >= "
                                 f"alphabet cardinality {card}")
            self._init_keys(database, phmm_prefix, key_cap, request)
            self.keyform = self._fits_keys(self.L, self.P)
            self.chunk = max(1, min(int(chunk_symbols), (1 << 31) - 1))
            self.n_col = -(-self.L // self.chunk)
            self.n_row = -(-self.P // max(1, int(chunk_rows)))
            self.rchunk = -(-self.P // self.n_row)
            self.lookahead = LOOKAHEAD

            # Stage the database and the per-row-chunk score rows once.
            self._codes_dev = torch.from_numpy(
                np.ascontiguousarray(codes, dtype=np.uint8)).to(self.device)
            self._scores_dev: List[torch.Tensor] = []
            self._reset_dev: List[Optional[torch.Tensor]] = []
            # reset rows and hit windows with one, a row chunk
            self._resets: List[Tuple[int, int]] = []
            for ri in range(self.n_row):
                r0, r1 = self.row_range(ri)
                self._resets.append(reset_counts(
                    None if reset_rows is None else reset_rows[r0:r1]))
                self._scores_dev.append(torch.from_numpy(
                    np.ascontiguousarray(scores[r0:r1], dtype=np.int8)
                ).to(self.device))
                self._reset_dev.append(None if reset_rows is None else
                                       torch.from_numpy(np.ascontiguousarray(
                                           reset_rows[r0:r1], dtype=np.int32)
                                       ).to(self.device))

    # ------------------------------------------------------------ geometry

    def row_range(self, ri: int) -> Tuple[int, int]:
        r0 = ri * self.rchunk
        return r0, min(self.P, r0 + self.rchunk)

    def col_range(self, ci: int) -> Tuple[int, int]:
        lo = ci * self.chunk
        return lo, min(self.L, lo + self.chunk)

    # ---------------------------------------------------------------- run

    def run(self, abort_event=None,
            progress: Optional[Callable[[int], None]] = None,
            checkpoint_cb=None, resume=None, stream=None,
            launched: Optional[Callable[[], None]] = None
            ) -> Optional[Tuple[ResolvedHits, List[np.ndarray], float]]:
        """Full sweep; returns (resolved, raw key parts, sweep seconds), or
        None when aborted. ``resolved`` is ordered by (row, position); each
        raw part holds one chunk's hits, sorted: uint64 keys, or (n, 2) int64
        (row, position) pairs past the key bounds (:func:`raw_pairs`).

        ``checkpoint_cb(next_ci, carries (n_row, rchunk+1) int32, rows,
        positions)`` runs after every column chunk but the last, with the
        pipeline drained; ``resume`` is such a payload to continue from —
        the JAX engine's pipelined checkpoint form.

        The launches go to ``stream`` (CUDA; a new stream when None): sweeps
        that share one run their kernels in the order they were enqueued,
        never two at once. ``launched()`` runs once the last launch is
        enqueued, before the drain and the tail."""
        if stream is None and self.device.type == "cuda":
            stream = torch.cuda.Stream(device=self.device)
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        wall = {"sweep": 0.0}
        with span(None, wall, "sweep"), ctx, \
                ThreadPoolExecutor(max_workers=4) as pool:
            out = self._run(pool, abort_event, progress, checkpoint_cb,
                            resume, stream, launched)
        if out is None:
            return None
        return out[0], out[1], wall["sweep"]

    def _run(self, pool, abort_event, progress, checkpoint_cb, resume,
             stream, launched):
        dev = self.device
        futures: List = []
        results: List[ChunkHits] = []
        pend: List[_Pending] = []
        prev_carry: Dict[int, torch.Tensor] = {}
        start_ci = 0
        if resume is not None:
            start_ci, carries, rows0, pos0 = resume
            for ri in range(self.n_row):
                r0, r1 = self.row_range(ri)
                prev_carry[ri] = torch.from_numpy(np.ascontiguousarray(
                    carries[ri][:r1 - r0 + 1], dtype=np.int32)).to(dev)
            rows0 = np.asarray(rows0, dtype=np.int64)
            pos0 = np.asarray(pos0, dtype=np.int64)
            # The done column chunks: every row, the leading positions.
            rect = (0, self.P, 0, start_ci * self.chunk)
            if pos0.size and not (0 <= pos0.min() and pos0.max() < rect[3]):
                rect = None
            futures.append(
                pool.submit(self._resolve_chunk, keys_from_pairs(rows0, pos0),
                            rect=rect)
                if self.keyform else
                pool.submit(self._resolve_pairs, rows0, pos0))
        done = start_ci * self.n_row

        def drain_one():
            p = pend.pop(0)
            futures.append(pool.submit(self._resolve_chunk, self._pull(p),
                                       p.rect))

        for ci in range(start_ci, self.n_col):
            lo, hi = self.col_range(ci)
            istate = torch.zeros(hi - lo, dtype=torch.int32, device=dev)
            col_carry: Dict[int, torch.Tensor] = {}
            for ri in range(self.n_row):
                if abort_event is not None and abort_event.is_set():
                    if stream is not None:
                        stream.synchronize()
                    for f in futures:
                        f.result()
                    return None
                r0, r1 = self.row_range(ri)
                icarry = prev_carry.get(ri)
                if icarry is None:
                    icarry = torch.zeros(r1 - r0 + 1, dtype=torch.int32,
                                         device=dev)
                p = self._enqueue((self._codes_dev[lo:hi],
                                   self._scores_dev[ri], self._reset_dev[ri],
                                   istate, icarry), r0, lo, (ci, ri),
                                  self._resets[ri])
                pend.append(p)
                with span(None, self.prof, "gate_wait"):
                    while len(pend) >= self.lookahead:
                        drain_one()
                istate = p.out.final_state  # chain row state down the column
                col_carry[ri] = p.out.final_carry  # and the carry across
                done += 1
                if progress is not None:
                    progress(done)
            prev_carry = col_carry
            if checkpoint_cb is not None and ci + 1 < self.n_col:
                while pend:
                    drain_one()
                results += self._wait_resolved(futures)
                futures.clear()
                carries = np.zeros((self.n_row, self.rchunk + 1), np.int32)
                for ri, c in prev_carry.items():
                    carries[ri, :c.shape[0]] = c.cpu().numpy()
                rows_s, pos_s = raw_pairs([r.keys for r in results])
                checkpoint_cb(ci + 1, carries, rows_s, pos_s)
        if launched is not None:
            launched()
        with span(None, self.prof, "drain"):
            while pend:
                drain_one()
            results += self._wait_resolved(futures)
        resolved = (None if self._database is None
                    else _merge_resolved(results, self.prof, self.request))
        return resolved, [r.keys for r in results]


def _merge_resolved(results: List[ChunkHits], prof: Dict[str, float],
                    request: int) -> ResolvedHits:
    """One table ordered by raw (row, position) key from per-chunk tables
    that are each ordered already. The whole is ``prof``'s ``tail``.

    Where every chunk with hits carries its rectangle and any two
    rectangles are disjoint in rows or in positions, the order is the
    geometry's: row by row, the chunks that cover the row in order of
    their first position. :func:`_placement` turns the chunks' row counts
    into (chunk, row) segments and their output offsets
    (``havac.tail.merge``, ``tail_merge``), and the four columns are copied
    there in one threaded native pass (``havac.tail.gather``,
    ``tail_gather``); ``tail_segments`` counts the segments, a row that
    one chunk alone covers taking its whole run of such rows as one.
    Otherwise, as for hits past the key bounds or a resumed mesh sweep,
    the kept keys are merged by comparison (``tail_merge``) and the
    columns gathered through that order (``tail_gather``), and no segment
    is counted."""
    with span(None, prof, "tail"):
        parts = [r for r in results if r.kept_keys.size]
        if not parts:
            return ResolvedHits(*(np.empty(0, dtype=np.int64),) * 4)
        with span("havac.tail.merge", prof, "tail_merge", request=request):
            plan = _placement(parts) if native.available() else None
            order = _merge_order(parts) if plan is None else None
        runs = [[getattr(r.resolved, f) for f in _RESOLVED_FIELDS]
                for r in parts]
        nseg = 0 if plan is None else int(plan[0].shape[0])
        prof["tail_segments"] += nseg
        with span("havac.tail.gather", prof, "tail_gather", request=request,
                  segments=nseg):
            if plan is not None:
                cols = native.place_i32_native(runs, *plan, nthreads=8)
            else:
                cols = [np.concatenate(c) for c in zip(*runs)]
                if order is not None:
                    cols = [c[order] for c in cols]
        return ResolvedHits(*cols)


def _merge_order(parts: List[ChunkHits]) -> Optional[np.ndarray]:
    """The order of the concatenated kept keys by comparison: a k-way merge
    of the sorted runs, a lexsort of pairs; None for one run."""
    if len(parts) == 1:
        return None
    keys = np.concatenate([r.kept_keys for r in parts])
    if keys.ndim == 2:  # (row, position) pairs
        return np.lexsort((keys[:, 1], keys[:, 0]))
    offs = np.cumsum([0] + [r.kept_keys.size for r in parts])
    order = native.merge_runs_u64_native(keys, offs, nthreads=8)
    return np.argsort(keys, kind="stable") if order is None else order


def _placement(parts: List[ChunkHits]
               ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Segments that place the chunks' tables in (row, position) order by
    their rectangles alone: (run, source offset) a segment, in output
    order, and the output offsets (nseg + 1,). None unless every chunk has
    a rectangle that holds its rows' counts and the rectangles of any two
    chunks that share a row are disjoint in positions."""
    if any(r.rect is None for r in parts):
        return None
    r0, r1, lo, hi = np.array([r.rect for r in parts], dtype=np.int64).T
    if any(int(r.row_offs[0]) != 0 or int(r.row_offs[-1]) != r.kept_keys.size
           for r in parts):
        return None
    runs, srcs, lens = [], [], []
    edges = np.unique(np.concatenate([r0, r1]))
    for b0, b1 in zip(edges[:-1].tolist(), edges[1:].tolist()):
        cover = np.flatnonzero((r0 <= b0) & (r1 >= b1))
        if not cover.size:
            continue
        cover = cover[np.argsort(lo[cover], kind="stable")]
        if (hi[cover[:-1]] > lo[cover[1:]]).any():
            return None
        # Row offsets of each covering chunk over rows [b0, b1]: (rows+1, m).
        offs = np.stack([parts[j].row_offs[b0 - r0[j]:b1 - r0[j] + 1]
                         for j in cover], axis=1).astype(np.int64)
        if cover.size == 1:  # one chunk covers these rows: one segment
            offs = offs[[0, -1]]
        runs.append(np.broadcast_to(cover, offs[1:].shape).ravel())
        srcs.append(offs[:-1].ravel())
        lens.append((offs[1:] - offs[:-1]).ravel())
    seg_run, seg_src, seg_len = (np.concatenate(a) for a in (runs, srcs,
                                                             lens))
    keep = seg_len > 0
    seg_dst = np.zeros(int(keep.sum()) + 1, dtype=np.int64)
    np.cumsum(seg_len[keep], out=seg_dst[1:])
    return seg_run[keep], seg_src[keep], seg_dst

