"""Public driver API — the PyTorch counterpart of `havac_tpu.engine.Havac`.

Same surface and errors as the JAX engine's single-device path: construct
with a p-value and an explicit ``device``, load a pHMM collection and a
sequence database, run the SSV sweep (synchronously, or asynchronously with
state polling and abort), then read resolved hits as (sequence_index,
position_in_sequence, phmm_index, position_in_phmm) columns.

The backend follows the device: on a CUDA device (``backend == "cuda"``)
the sweep runs the hand-written Hopper kernel
(`havac_tpu_torch/csrc/ssv_sweep.cu`); on the CPU (``"torch"``) it runs the
plain PyTorch version. Neither falls back to the other, and
``device="cuda"`` without CUDA raises. With ``mesh=`` (a
:class:`~havac_tpu_torch.parallel.multihost.ShardMesh` whose devices agree
with ``device``) the sweep is the 1-D wavefront of
`havac_tpu_torch/parallel/swar_dist.py`: the database in D shards, one
kernel launch per shard and step, abort and checkpoints between steps; in a
multi-process mesh each process reports its own shards' hits. A mesh with a
``model`` axis larger than 1 runs the 2-D sweep of
`havac_tpu_torch/parallel/swar_dist2d.py` (model groups, each a wavefront
of its own), which requires ``isolate_models=True``.
"""

from __future__ import annotations

import enum
import functools
import itertools
import logging
import os
import queue
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from havac_tpu_torch import native
from havac_tpu_torch.hits.decode import ResolvedHits
from havac_tpu_torch.hits.verify import HitVerificationError, verify_hits
from havac_tpu_torch.io.fasta import (SequenceDatabase,
                                augment_with_reverse_complement,
                                load_fasta_database)
from havac_tpu_torch.io.hmm import (ProfileHmm, model_length_prefix_sums, read_hmm,
                              read_hmm_text)
from havac_tpu_torch.ops.common import round_up
from havac_tpu_torch.scoring.reprojection import project_models
from havac_tpu_torch.engine.pipeline import (FIRST_KEY_CAP, PipelinedSweep,
                                             raw_pairs)
from havac_tpu_torch.engine.trace import span
from havac_tpu_torch.parallel.multihost import all_gather_int
from havac_tpu_torch.parallel.swar_dist import SwarDistributedSweep
from havac_tpu_torch.parallel.swar_dist2d import Swar2DSweep

DEFAULT_P_VALUE = 0.02  # the reference CLI's default
SCAN_PRODUCER_THREAD = "havac-scan-producer"
SWEEP_THREAD = "havac-sweep"  # a run's thread: staging, launches, tail

log = logging.getLogger("havac_tpu_torch.engine")


class HavacRunState(enum.Enum):
    """Run lifecycle (the JAX engine's states)."""

    IDLE = "idle"
    RUNNING = "running"
    COMPLETED = "completed"
    ABORTED = "aborted"
    ERROR = "error"


class HavacUsageError(RuntimeError):
    """API misuse (run before load, hits before completion, ...)."""


def _qualname(obj) -> str:
    return f"{type(obj).__module__}.{type(obj).__qualname__}"


@dataclass
class RunStats:
    """Phase timing and throughput of one run."""

    num_chunks: int = 0
    cells: int = 0
    sweep_seconds: float = 0.0
    num_raw_hits: int = 0
    # Chunks whose hit count overflowed the key buffer and ran once more.
    overflow_retries: int = 0
    # A request's host phases from the API layer down, in seconds:
    # ``scan_files``' ``encode`` (the producer's parse and encode of the
    # file), ``encode_wait`` and ``hits``; the sweep's ``stage``, the
    # pipeline's (`engine/pipeline.py`) or the mesh's phases. Each is a
    # span of `engine/trace.py`; ``sort`` and ``resolve`` are summed over
    # the collector pool's threads. Three are counts: ``tail_segments``,
    # the segments the tail placed, ``launches``, the chunks launched, and
    # ``reset_windows``, their hit windows that hold a model start; and
    # ``launched_ahead``, the launches enqueued before ``scan_files``
    # yielded the previous file (0 for a run of its own).
    pipeline_prof: Optional[Dict[str, float]] = None
    num_unverified: int = 0  # populated when verify_hits=True
    # Whether the native host core resolved this run's hits (False: the
    # numpy host path did). None until a run completes.
    native_active: Optional[bool] = None
    chunk_geometry: Optional[Dict[str, int]] = None

    @property
    def gcups(self) -> float:
        return self.cells / self.sweep_seconds / 1e9 if self.sweep_seconds else 0.0


@dataclass(eq=False)
class _Run:
    """One run: the database it sweeps, its request index, and what it
    leaves (state, error, hits, stats). Runs carry their own state, so a
    scan can sweep one file while the caller reads the last. ``launched``
    (its last launch is enqueued) and ``done`` are set under ``wake``, which
    a scan waits on; a run ``after`` another stages at once and launches
    once that one has launched or ended."""

    database: Optional[SequenceDatabase] = None
    n_forward: int = 0
    request: int = -1
    state: HavacRunState = HavacRunState.IDLE
    stream: Optional["torch.cuda.Stream"] = None  # None: the sweep's own
    wake: threading.Condition = field(default_factory=threading.Condition)
    after: Optional["_Run"] = None
    sweep: Optional[PipelinedSweep] = None  # warmed for this database
    thread: Optional[threading.Thread] = None
    error: Optional[BaseException] = None
    raw_keys: List[np.ndarray] = field(default_factory=list)
    raw: Optional[Tuple[np.ndarray, np.ndarray]] = None
    resolved: Optional[ResolvedHits] = None
    stats: RunStats = field(default_factory=RunStats)
    verification: object = None
    chunks_done: int = 0
    chunks_total: int = 0
    launched: bool = False
    done: bool = False
    launched_ahead: int = 0

    def mark(self, flag: str) -> None:
        with self.wake:
            setattr(self, flag, True)
            self.wake.notify_all()


class Havac:
    """SSV search engine on one device, or on a mesh of shards.

    Usage::

        engine = Havac(p_value=0.02, device="cuda")
        engine.load_phmm("models.hmm")
        engine.load_sequence("db.fasta")
        engine.run()                      # or run_async(); wait()
        hits = engine.hits()              # ResolvedHits columns

    ``chunk_symbols`` x ``chunk_rows`` is one kernel launch; any sizes are
    valid, and hits do not depend on them. ``pad_multiple`` pads the encoded
    database (with hashed symbols, as the JAX engine pads to its kernel
    block width); padding hits appear in :meth:`raw_hits` only.

    ``mesh`` shards the database over ``mesh.shape[mesh_axis]`` shards and
    sweeps the models in row chunks of ``dist_rows_per_step`` (any R >= 1)
    as a wavefront; ``dist_hit_capacity`` is each launch's first key
    buffer. A mesh with a ``model`` axis of D_model > 1
    (:func:`~havac_tpu_torch.parallel.multihost.sequence_model_mesh`) cuts
    the collection into D_model groups of whole models, each swept by its
    own wavefront; it requires ``isolate_models=True`` (``run`` raises
    :class:`HavacUsageError` without it) and checkpoints in one process
    only. R defaults to 1,024, not the JAX engine's 128: on an H100 a
    step of 128 rows costs the host about as long to dispatch and pull as
    the kernel takes, and the sweep runs at half the rate. The JAX engine's ``dist_step_dispatch=False`` (one uncancelable
    dispatch) is refused: every step is its own set of launches.
    """

    def __init__(
        self,
        p_value: float = DEFAULT_P_VALUE,
        *,
        device: Union[str, torch.device],
        chunk_symbols: int = 1 << 24,
        chunk_rows: int = 8160,
        pad_multiple: int = 1,
        strand: str = "forward",
        isolate_models: bool = False,
        seed: int = 0x5A5A,
        checkpoint_path: Optional[str] = None,
        verify_hits: bool = False,
        mesh=None,
        mesh_axis: str = "seq",
        dist_rows_per_step: int = 1024,
        dist_hit_capacity: int = FIRST_KEY_CAP,
        dist_step_dispatch: bool = True,
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise HavacUsageError("CUDA is not available on this machine")
            self.backend = "cuda"
        elif self.device.type == "cpu":
            self.backend = "torch"
        else:
            raise HavacUsageError(
                f"unsupported device {self.device}: cuda or cpu")
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.dist_rows_per_step = int(dist_rows_per_step)
        self.dist_hit_capacity = int(dist_hit_capacity)
        if mesh is not None:
            self._check_mesh(dist_step_dispatch)
        self.p_value = float(p_value)
        self.chunk_symbols = max(1, int(chunk_symbols))
        self.chunk_rows = max(1, int(chunk_rows))
        self.pad_multiple = max(1, int(pad_multiple))
        if strand not in ("forward", "both"):
            raise HavacUsageError("strand must be 'forward' or 'both'")
        self.strand = strand
        self.isolate_models = isolate_models
        self.reset_rows: Optional[np.ndarray] = None
        self.seed = seed
        self.checkpoint_path = checkpoint_path
        self.resumed_chunks = 0
        self.verify_hits = verify_hits
        self.alphabet = "dna"

        self.models: Optional[List[ProfileHmm]] = None
        self.scores: Optional[np.ndarray] = None
        self.phmm_prefix: Optional[np.ndarray] = None
        self.database: Optional[SequenceDatabase] = None
        # Seconds of the last load_phmm's halves: "parse" and "project".
        self.load_prof: Dict[str, float] = {}

        self._state_lock = threading.Lock()
        self._abort_event = threading.Event()
        # The run the caller sees: its state, progress, stats and hits.
        self._run = _Run()
        self._warm_sweep: Optional[PipelinedSweep] = None
        # Index of the latest run: every span of a run carries it.
        self._request = -1

    # ------------------------------------------------------------------ load

    def load_phmm(self, src: Union[str, ProfileHmm, Sequence[ProfileHmm]],
                  is_text: bool = False) -> "Havac":
        """Load and reproject a pHMM collection: a path, .hmm text
        (``is_text=True``), a ProfileHmm, or a sequence of them.
        ``load_prof`` holds the seconds of the parse and the projection."""
        self.load_prof = {"parse": 0.0, "project": 0.0}
        if isinstance(src, str):
            with span("havac.load.parse", self.load_prof, "parse"):
                models = read_hmm_text(src) if is_text else read_hmm(src)
        elif isinstance(src, ProfileHmm):
            models = [src]
        else:
            models = [src] if hasattr(src, "match_scores") else list(src)
            foreign = [m for m in models if hasattr(m, "match_scores")
                       and not isinstance(m, ProfileHmm)]
            if foreign:
                raise HavacUsageError(
                    f"{_qualname(foreign[0])} is not havac_tpu_torch's "
                    "ProfileHmm: carry models across with "
                    "havac_tpu_torch.convert.profile_hmms_from_reference")
        if not models:
            raise HavacUsageError("no models to load")
        cards = {m.alphabet_cardinality for m in models}
        if len(cards) > 1:
            raise HavacUsageError(
                f"mixed alphabets in one collection: cardinalities {sorted(cards)}")
        card = cards.pop()
        if card == 20:
            if self.mesh is not None:
                raise HavacUsageError(
                    "amino models are supported on the single-device engine "
                    "only (the mesh wavefront is nucleotide-only, as in the "
                    "JAX engine)")
            if self.strand == "both":
                raise HavacUsageError(
                    "strand='both' (reverse complement) is meaningless for "
                    "amino sequences")
            self.alphabet = "amino"
        elif card != 4:
            raise HavacUsageError(
                f"model {models[0].name!r} has alphabet cardinality {card}; "
                "supported: 4 (dna/rna) and 20 (amino)")
        else:
            self.alphabet = "dna"
        self.models = models
        with span("havac.load.project", self.load_prof, "project"):
            self.scores = project_models(models, self.p_value)
        self.phmm_prefix = model_length_prefix_sums(models)
        self._warm_sweep = None
        self.reset_rows = None
        if self.isolate_models:
            self.reset_rows = np.zeros(self.scores.shape[0], dtype=bool)
            self.reset_rows[self.phmm_prefix[:-1]] = True
        log.info("loaded %d models, %d total positions (p=%g): parse "
                 "%.3f s, project %.3f s", len(models),
                 self.scores.shape[0], self.p_value,
                 self.load_prof["parse"], self.load_prof["project"])
        return self

    def load_sequence(self, src: Union[str, SequenceDatabase],
                      is_text: bool = False) -> "Havac":
        """Load and encode a FASTA database (path, or text with
        ``is_text=True``), or take an encoded SequenceDatabase."""
        self.database, self._n_forward = self._encode(src, is_text)
        log.info("loaded %d sequences, %d positions (padded %d)",
                 self.database.num_sequences,
                 int(self.database.lengths.sum()),
                 self.database.padded_length)
        self._warm_sweep = None
        return self

    def _encode(self, src: Union[str, SequenceDatabase],
                is_text: bool = False) -> Tuple[SequenceDatabase, int]:
        """The database to sweep for ``src`` (encoded in the loaded models'
        alphabet, reverse complements appended for strand='both') and its
        number of forward records."""
        if isinstance(src, SequenceDatabase):
            db = src
        elif hasattr(src, "codes"):
            raise HavacUsageError(
                f"{_qualname(src)} is not havac_tpu_torch's SequenceDatabase: "
                "carry it across with "
                "havac_tpu_torch.convert.database_from_reference")
        else:
            db = load_fasta_database(
                src, pad_multiple=self.pad_multiple, seed=self.seed,
                is_text=is_text, alphabet=self.alphabet)
        if getattr(db, "alphabet", "dna") != self.alphabet:
            raise HavacUsageError(
                f"database alphabet {db.alphabet!r} does not match the "
                f"loaded models ({self.alphabet!r}); call load_phmm before "
                "load_sequence so the encoder matches")
        n_forward = db.num_sequences
        if self.strand == "both":
            db = augment_with_reverse_complement(
                db, pad_multiple=self.pad_multiple)
        return db, n_forward

    def warmup(self) -> "Havac":
        """Build (or load) the sweep kernel and stage the database and the
        scores on the device now, so the next :meth:`run` starts sweeping
        at once. Call after :meth:`load_phmm` and :meth:`load_sequence`.
        A no-op on a mesh, as in the JAX engine."""
        if self.scores is None or self.database is None:
            raise HavacUsageError(
                "load_phmm + load_sequence before warmup()")
        if self.mesh is None:
            self._warm_sweep = self._build_sweep()
        return self

    def _codes(self, database: Optional[SequenceDatabase] = None
               ) -> np.ndarray:
        """The swept symbols: the codes of ``database`` (default: the
        loaded one) zero-padded to a multiple of ``pad_multiple`` (as the
        JAX engine pads to its block width)."""
        codes = (self.database if database is None else database).codes
        if codes.shape[0] % self.pad_multiple:
            codes = np.pad(codes, (0, round_up(codes.shape[0],
                                               self.pad_multiple)
                                   - codes.shape[0]))
        return codes

    def _build_sweep(self, run: Optional[_Run] = None) -> PipelinedSweep:
        """The sweep of ``run``'s database (default: the loaded one, for
        :meth:`warmup`)."""
        db, request = ((self.database, self._request) if run is None
                       else (run.database, run.request))
        return PipelinedSweep(
            self._codes(db), self.scores, self.chunk_symbols,
            self.chunk_rows, self.device, db, self.phmm_prefix,
            reset_rows=self.reset_rows, request=request)

    def scan_files(self, fasta_paths: Sequence[str], prefetch: int = 1
                   ) -> Iterator[Tuple[str, ResolvedHits]]:
        """Streaming scan over many FASTA files; yields ``(path,
        ResolvedHits)`` per file.

        A producer thread parses and encodes file i+1 (up to ``prefetch``
        files ahead) while file i sweeps on the device. Each file is an
        independent database: the DP carry does not flow across files, and
        hit coordinates are local to the yielded file. A producer error is
        raised here, on the consumer side. Closing the generator early stops
        the producer: its queue puts give up once the consumer is gone.
        Files are encoded in the loaded models' alphabet.

        On one device without ``checkpoint_path``, file i+1's sweep is
        staged as soon as the producer hands it over, and its launches
        start once file i's last launch is enqueued: file i's drain, tail
        and ``hits()`` then run on the host while file i+1's launches keep
        the device busy. The scan's sweeps share one CUDA stream, so two
        files' kernels run in turn, never at once. Each run carries its own state: at each yield
        ``stats``, ``database`` and :meth:`hits` are the yielded file's. A
        file whose sweep fails raises at the ``next()`` that asks for it;
        closing the generator aborts a sweep in flight and joins its
        thread. A mesh or checkpointed scan sweeps one file at a time.

        Each file's ``stats.pipeline_prof`` adds the API layer's phases:
        ``encode`` (span ``havac.encode``, on the producer), ``encode_wait``
        (the consumer's wait for the file, ``havac.encode_wait``) and
        ``hits`` (``havac.hits``), and the count ``launched_ahead``: the
        file's launches enqueued before the previous file was yielded. File
        i is request ``r + i`` of the spans, r the index of the scan's
        first run."""
        if self.scores is None:
            raise HavacUsageError("load_phmm must be called before scan_files")
        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        stop = threading.Event()
        wake = threading.Condition()  # a put, a launch phase's end, a run's
        end = object()
        first = self._request + 1
        overlap = self.mesh is None and not self.checkpoint_path
        stream = (torch.cuda.Stream(device=self.device)
                  if self.device.type == "cuda" and self.mesh is None
                  else None)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                except queue.Full:
                    continue
                with wake:
                    wake.notify_all()
                return True
            return False

        def producer():
            try:
                for i, path in enumerate(fasta_paths):
                    if stop.is_set():
                        return
                    prof = {"encode": 0.0}
                    with span("havac.encode", prof, "encode",
                              request=first + i):
                        db, n_forward = self._encode(path)
                    if not put((path, db, n_forward, prof)):
                        return
            except Exception as exc:  # raised on the consumer side
                put((None, exc, 0, None))
            finally:
                put(end)

        def take(i: int, block: bool):
            wait = {"encode_wait": 0.0}
            with span("havac.encode_wait", wait, "encode_wait",
                      request=first + i):
                item = q.get() if block else q.get_nowait()
            if item is not end and item[0] is not None:
                item[3].update(wait, hits=0.0)
            return item

        def begin(item, after: Optional[_Run] = None):
            path, db, n_forward, prof = item
            return path, prof, self._begin(db, n_forward, publish=not overlap,
                                           stream=stream, wake=wake,
                                           after=after)

        thread = threading.Thread(target=producer, daemon=True,
                                  name=SCAN_PRODUCER_THREAD)
        thread.start()
        self._warm_sweep = None  # a warmed sweep staged other codes
        taken = None  # the next file's queue item, taken early
        ahead = None  # (path, prof, run) of the next file, started early
        run = None
        try:
            for i in itertools.count():
                if ahead is not None:
                    (path, prof, run), ahead = ahead, None
                else:
                    item = taken if taken is not None else take(i, True)
                    taken = None
                    if item is end:
                        break
                    if item[0] is None:
                        raise item[1]
                    path, prof, run = begin(item)
                if overlap:
                    with wake:
                        wake.wait_for(lambda: run.done or not q.empty())
                    if not q.empty():
                        taken = take(i + 1, False)
                        if taken is not end and taken[0] is not None:
                            ahead, taken = begin(taken, after=run), None
                run.thread.join()
                with self._state_lock:
                    self._show(run)
                if run.error is not None:
                    raise run.error
                with span("havac.hits", prof, "hits", request=run.request):
                    hits = self.hits()
                self.stats.pipeline_prof.update(
                    prof, launched_ahead=run.launched_ahead)
                if ahead is not None:
                    ahead[2].launched_ahead = ahead[2].chunks_done
                yield path, hits
                del hits  # hold no answer through the next file's run
        finally:
            stop.set()
            for r in (run, ahead[2] if ahead else None):
                if r is not None and r.thread.is_alive():
                    self._abort_event.set()
                    with wake:  # a run waiting to launch sees the abort
                        wake.notify_all()
                    r.thread.join()
            while not q.empty():  # unblock a producer waiting on put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    # ------------------------------------------------------------------- run

    @property
    def state(self) -> HavacRunState:
        with self._state_lock:
            return self._run.state

    @property
    def progress(self) -> float:
        r = self._run
        return r.chunks_done / r.chunks_total if r.chunks_total else 0.0

    @property
    def stats(self) -> RunStats:
        """Phase timing and throughput of the run the caller sees."""
        return self._run.stats

    @property
    def verification(self):
        """The run's ``VerificationReport`` (``verify_hits=True``)."""
        return self._run.verification

    def run(self) -> "Havac":
        """Synchronous sweep."""
        self.run_async()
        self.wait()
        if self._run.error is not None:
            raise self._run.error
        return self

    def run_async(self) -> "Havac":
        """Start the sweep on a worker thread and return immediately."""
        if self.scores is None or self.database is None:
            raise HavacUsageError("load_phmm and load_sequence must be called before run")
        self._begin(self.database, self._n_forward, publish=True,
                    warm=True)
        return self

    def _begin(self, database: SequenceDatabase, n_forward: int, *,
               publish: bool, warm: bool = False, stream=None,
               wake: Optional[threading.Condition] = None,
               after: Optional[_Run] = None) -> _Run:
        """Start a run of ``database`` on its own thread, as the next
        request. ``publish`` makes it the run the caller sees at once;
        ``scan_files`` shows a run started ahead only when it yields the
        run's file. ``warm`` hands the run the sweep :meth:`warmup` built;
        ``after``, the run whose last launch its launches follow."""
        with self._state_lock:
            if publish and self._run.state == HavacRunState.RUNNING:
                raise HavacUsageError("a run is already in flight")
            self._request += 1
            r = _Run(database, n_forward, self._request,
                     HavacRunState.RUNNING, stream,
                     wake or threading.Condition(), after)
            if warm:
                r.sweep, self._warm_sweep = self._warm_sweep, None
            if publish:
                self._show(r)
        self._abort_event.clear()
        r.thread = threading.Thread(target=self._run_loop, args=(r,),
                                    daemon=True, name=SWEEP_THREAD)
        r.thread.start()
        return r

    def _show(self, r: _Run) -> None:
        """Make ``r`` the run the caller sees (under ``_state_lock``)."""
        self._run = r
        self.database, self._n_forward = r.database, r.n_forward

    def _end(self, r: _Run, state: HavacRunState,
             error: Optional[BaseException] = None) -> None:
        """The run's last step, on its thread: its final state."""
        with self._state_lock:
            r.error = error
            r.state = state
        r.mark("done")

    def wait(self, timeout: Optional[float] = None) -> HavacRunState:
        """Block until the sweep finishes (or ``timeout`` seconds pass)."""
        thread = self._run.thread
        if thread is not None:
            thread.join(timeout)
        return self.state

    def abort(self) -> None:
        """Request cancellation; takes effect at the next chunk boundary."""
        self._abort_event.set()

    # ------------------------------------------------------------------ hits

    def _sorted_raw(self, r: _Run) -> Tuple[np.ndarray, np.ndarray]:
        with self._state_lock:
            if r.raw is None:
                r.raw = raw_pairs(r.raw_keys, ordered=True)
                r.raw_keys = []
            return r.raw

    def raw_hits(self) -> Tuple[np.ndarray, np.ndarray]:
        """Unresolved global (phmm_row, sequence_position) hit coordinates,
        sorted by (row, position), padding and separator hits included."""
        self._require_completed()
        return self._sorted_raw(self._run)

    def hits(self) -> ResolvedHits:
        """Resolved hits ordered by (row, position): padding/separator hits
        dropped, model coordinates recovered via prefix sums. With
        strand="both", minus-strand hits are reported in forward
        coordinates with strand '-'."""
        self._require_completed()
        r = self._run
        resolved = r.resolved
        if self.strand == "both":
            n = r.n_forward
            minus = resolved.sequence_index >= n
            idx = np.where(minus, resolved.sequence_index - n,
                           resolved.sequence_index)
            lens = r.database.lengths[resolved.sequence_index]
            pos = np.where(minus, lens - 1 - resolved.sequence_position,
                           resolved.sequence_position)
            resolved = ResolvedHits(
                sequence_index=idx,
                sequence_position=pos,
                phmm_index=resolved.phmm_index,
                phmm_position=resolved.phmm_position,
                strand=np.where(minus, "-", "+").astype("U1"),
            )
        return resolved

    def verify(self, initial_bound: int = 64, sample: Optional[int] = None):
        """Re-derive raw hits by bounded re-SSV (exact); returns a
        ``VerificationReport``. ``sample`` verifies that many hits drawn
        without replacement (a numpy Generator seeded from ``seed``)
        instead of all of them."""
        self._require_completed()
        rows, positions = self._sorted_raw(self._run)
        if sample is not None and sample < rows.shape[0]:
            rng = np.random.default_rng(self.seed)
            pick = np.sort(rng.choice(rows.shape[0], size=sample,
                                      replace=False))
            rows, positions = rows[pick], positions[pick]
        return self._verify_raw(rows, positions, self._run.database,
                                initial_bound)

    def _verify_raw(self, rows, positions, database,
                    initial_bound: int = 64):
        codes = self._codes(database)
        if positions.size and int(positions.max()) >= codes.shape[0]:
            codes = np.pad(codes,
                           (0, int(positions.max()) + 1 - codes.shape[0]))
        return verify_hits(rows, positions, codes, self.scores,
                           reset_rows=self.reset_rows,
                           initial_bound=initial_bound)

    def _maybe_verify(self, r: _Run) -> None:
        r.stats.native_active = native.available()
        if not self.verify_hits:
            return
        rows, positions = self._sorted_raw(r)
        report = self._verify_raw(rows, positions, r.database)
        r.verification = report
        r.stats.num_unverified = report.num_hits - report.num_verified
        if not report.all_verified:
            raise HitVerificationError(report, rows, positions)

    def _require_completed(self) -> None:
        with self._state_lock:
            state, error = self._run.state, self._run.error
        if state == HavacRunState.ERROR and error is not None:
            raise error
        if state != HavacRunState.COMPLETED:
            raise HavacUsageError(
                f"hits requested in state {state.value}; run must complete first")

    # ------------------------------------------------------------- internals

    def _check_mesh(self, step_dispatch: bool) -> None:
        mesh = self.mesh
        if not step_dispatch:
            raise HavacUsageError(
                "dist_step_dispatch=False names the JAX engine's single "
                "uncancelable mesh dispatch, a TPU workaround; the port "
                "launches every wavefront step on its own")
        if self.mesh_axis not in getattr(mesh, "shape", {}):
            raise HavacUsageError(
                f"mesh has no axis {self.mesh_axis!r}: build it with "
                "havac_tpu_torch.parallel.multihost.ShardMesh")
        bad = [str(d) for d in mesh.devices
               if d.type != self.device.type
               or (self.device.index is not None
                   and d.index != self.device.index)]
        if bad:
            raise HavacUsageError(
                f"device={self.device} does not agree with the mesh's "
                f"devices {bad}")
        if self.dist_rows_per_step < 1:
            raise HavacUsageError("dist_rows_per_step must be at least 1")

    def _run_loop(self, r: _Run) -> None:
        if self.mesh is not None:
            self._run_loop_distributed(r)
            return
        try:
            sweep = r.sweep if r.sweep is not None else self._build_sweep(r)
            r.sweep = None
            sweep.request = r.request  # warmed before this run
            r.chunks_total = sweep.n_col * sweep.n_row
            if r.after is not None:  # staged; launch after its launches
                with r.wake:
                    r.wake.wait_for(lambda: r.after.launched or r.after.done
                                    or self._abort_event.is_set())
                r.after = None  # hold none of its hits

            def progress(done):
                r.chunks_done = done

            checkpoint_cb = resume = None
            if self.checkpoint_path:
                fingerprint = self._fingerprint(sweep.L, sweep.P, sweep.chunk,
                                                sweep.rchunk)
                resume = self._load_checkpoint(fingerprint, sweep.n_row,
                                               sweep.rchunk)
                if resume is not None:
                    self.resumed_chunks = r.chunks_done = (resume[0]
                                                           * sweep.n_row)

                def checkpoint_cb(next_ci, carries, rows_s, pos_s):
                    tmp = self.checkpoint_path + ".tmp"
                    np.savez(tmp, fingerprint=np.int64(fingerprint),
                             next_ci=np.int64(next_ci), carries=carries,
                             hit_rows=rows_s, hit_positions=pos_s)
                    os.replace(tmp + ".npz"
                               if os.path.exists(tmp + ".npz") else tmp,
                               self.checkpoint_path)

            log.info("pipelined sweep: %d column x %d row chunks, backend=%s",
                     sweep.n_col, sweep.n_row, self.backend)
            result = sweep.run(self._abort_event, progress,
                               checkpoint_cb=checkpoint_cb, resume=resume,
                               stream=r.stream,
                               launched=functools.partial(r.mark, "launched"))
            if result is None:
                self._end(r, HavacRunState.ABORTED)
                return
            r.resolved, r.raw_keys, t_sweep = result
            st = r.stats
            st.overflow_retries = sweep.regrows
            st.pipeline_prof = dict(sweep.prof)
            st.num_chunks = r.chunks_total
            st.cells = sweep.L * sweep.P
            st.sweep_seconds = t_sweep
            st.num_raw_hits = sum(int(k.shape[0]) for k in r.raw_keys)
            st.chunk_geometry = {
                "n_col": sweep.n_col, "n_row": sweep.n_row,
                "chunk_symbols": sweep.chunk, "chunk_rows": sweep.rchunk,
                "key_cap": sweep.key_cap, "lookahead": sweep.lookahead,
            }
            if self.checkpoint_path and os.path.exists(self.checkpoint_path):
                os.remove(self.checkpoint_path)
            self._maybe_verify(r)
            self._end(r, HavacRunState.COMPLETED)
        except BaseException as exc:  # surfaced on run()/hits()
            self._end(r, HavacRunState.ERROR, exc)

    def _run_loop_distributed(self, r: _Run) -> None:
        try:
            P = self.scores.shape[0]
            keyed = dict(rows_per_step=self.dist_rows_per_step,
                         key_cap=self.dist_hit_capacity,
                         database=self.database,
                         phmm_prefix=self.phmm_prefix)
            if self.mesh.shape.get("model", 1) > 1:
                # 2-D (sequence x model): model groups across one axis (cut
                # at model boundaries, exact under isolation), a sequence
                # wavefront down each group's column.
                if not self.isolate_models:
                    raise HavacUsageError(
                        "2-D (sequence x model) sharding requires "
                        "isolate_models=True: model-axis cuts stop DP "
                        "chains at group boundaries")
                sweep = Swar2DSweep(self._codes(), self.mesh, self.mesh_axis,
                                    "model", **keyed)
                args = (self.scores, self.phmm_prefix, self.reset_rows)
                hooks = self._mesh2d_checkpoint_hooks(sweep, P)
            else:
                sweep = SwarDistributedSweep(self._codes(), self.mesh,
                                             self.mesh_axis, **keyed)
                args = (self.scores, self.reset_rows)
                hooks = self._mesh_checkpoint_hooks(sweep, P)
            sweep.request = r.request

            def progress(step, total):
                r.chunks_total = total
                r.chunks_done = step

            checkpoint_cb, resume, ck_path = hooks
            if resume is not None:
                r.chunks_done = resume[0]
            log.info("mesh sweep: %s, %d shards of %d positions, %d rows a "
                     "step, backend=%s", self.mesh.shape, sweep.D,
                     sweep.shard_width, sweep.R, self.backend)
            t0 = time.perf_counter()
            result = sweep.sweep(*args, abort_event=self._abort_event,
                                 progress=progress,
                                 checkpoint_cb=checkpoint_cb, resume=resume,
                                 ckpt_every=4)
            if result is None:
                self._end(r, HavacRunState.ABORTED)
                return
            if ck_path and os.path.exists(ck_path):
                os.remove(ck_path)
            self._finish_distributed(r, result, sweep, P,
                                     time.perf_counter() - t0)
        except BaseException as exc:  # surfaced on run()/hits()
            self._end(r, HavacRunState.ERROR, exc)

    def _finish_distributed(self, r: _Run, result,
                            sweep: SwarDistributedSweep, P: int,
                            t_sweep: float) -> None:
        r.resolved, r.raw_keys = result
        st = r.stats
        st.num_chunks = sweep.launches
        st.cells = r.database.padded_length * P
        st.sweep_seconds = t_sweep
        st.num_raw_hits = sum(int(k.shape[0]) for k in r.raw_keys)
        st.overflow_retries = sweep.regrows
        st.pipeline_prof = dict(sweep.prof)
        row_chunks = [S for _, _, S in sweep.groups]
        st.chunk_geometry = {
            "shards": sweep.D, "rows_per_step": sweep.R,
            "row_chunks": max(row_chunks), "steps": sweep.T,
            "launches": sweep.launches, "shard_width": sweep.shard_width,
            "key_cap": sweep.key_cap, "lookahead": sweep.lookahead,
        }
        if isinstance(sweep, Swar2DSweep):
            st.chunk_geometry.update(
                model_groups=sweep.D_model, group_bounds=list(sweep.bounds),
                group_row_chunks=row_chunks)
        self._maybe_verify(r)
        self._end(r, HavacRunState.COMPLETED)

    def _mesh_checkpoint_hooks(self, sweep: SwarDistributedSweep, P: int):
        """(checkpoint_cb, resume, path) for the mesh sweep, every 4 steps.

        Each process writes its shards' row states, the seams they take at
        the next step and its hits so far to ``checkpoint_path`` (``.pK``
        for process K when there are several), under the single-device
        fingerprint with ``mesh:{D}:{axis}:{world size}`` on top. A file of
        another run, or whose arrays have another shape, is stale: the run
        starts from step 0 with a warning. Every process must resume at the
        same step, or the seams would deadlock: they agree by an all-gather,
        and any disagreement or missing file restarts all of them."""
        if not self.checkpoint_path:
            return None, None, None
        mesh = self.mesh
        fp = self._fingerprint(self.database.padded_length, P,
                               sweep.shard_width, sweep.R)
        fp = zlib.crc32(f"mesh:{sweep.D}:{self.mesh_axis}:"
                        f"{mesh.world_size}".encode(), fp)
        path = self.checkpoint_path
        if mesh.world_size > 1:
            path += f".p{mesh.rank}"
        resume = self._load_step_checkpoint(
            path, fp, ((len(sweep.shards), sweep.shard_width),
                       (len(sweep.shards), sweep.R + 1)))
        if mesh.world_size > 1:
            ts = all_gather_int(mesh, -1 if resume is None else resume[0])
            if min(ts) < 0 or min(ts) != max(ts):
                if resume is not None:
                    log.warning("mesh checkpoint resume: the processes' "
                                "next steps disagree (%s); every process "
                                "restarts from step 0", ts)
                resume = None
        if resume is not None:
            self.resumed_chunks = resume[0]
        save = self._step_checkpoint_writer(path, fp)

        def checkpoint_cb(t_next, istate, ilo, seams, slo, rows_s, pos_s):
            del ilo, slo  # the mesh places the shards again on resume
            save(t_next, istate, seams, rows_s, pos_s)

        return checkpoint_cb, resume, path

    def _mesh2d_checkpoint_hooks(self, sweep: Swar2DSweep, P: int):
        """(checkpoint_cb, resume, path) for the 2-D mesh sweep, every 4
        steps, in one process only, as in the JAX engine: the file holds
        every group's row states (D_model, D_seq, W) and seams (D_model,
        D_seq, R+1) and the hits so far, under the single-device
        fingerprint with ``mesh2d:{D_seq}x{D_model}:{axis}`` on top. A file
        of another run, or whose arrays have another shape, is stale. A
        multi-process 2-D run gets a warning and no checkpoint."""
        if not self.checkpoint_path:
            return None, None, None
        if self.mesh.world_size > 1:
            log.warning("2-D mesh checkpointing is single-process only; "
                        "this multi-process run proceeds WITHOUT "
                        "checkpoints")
            return None, None, None
        fp = self._fingerprint(self.database.padded_length, P,
                               sweep.shard_width, sweep.R)
        fp = zlib.crc32(f"mesh2d:{sweep.D_seq}x{sweep.D_model}:"
                        f"{self.mesh_axis}".encode(), fp)
        path = self.checkpoint_path
        grid = (sweep.D_model, sweep.D_seq)
        resume = self._load_step_checkpoint(
            path, fp, (grid + (sweep.shard_width,), grid + (sweep.R + 1,)))
        if resume is not None:
            self.resumed_chunks = resume[0]
        return self._step_checkpoint_writer(path, fp), resume, path

    def _load_step_checkpoint(self, path: str, fp: int, shapes):
        """A mesh checkpoint's ``(next_t, istate, seam, hit_rows,
        hit_positions)`` when ``path`` holds one of this run (its
        fingerprint ``fp`` and its arrays' ``shapes``), else None (with a
        warning when the file exists)."""
        try:
            with np.load(path) as ck:
                if (int(ck["fingerprint"]) == fp
                        and (ck["istate"].shape, ck["seam"].shape) == shapes):
                    return (int(ck["next_t"]), ck["istate"], ck["seam"],
                            ck["hit_rows"], ck["hit_positions"])
        except FileNotFoundError:
            return None
        except (KeyError, OSError, ValueError):
            pass
        self._warn_stale_checkpoint(path)
        return None

    @staticmethod
    def _step_checkpoint_writer(path: str, fp: int):
        """save(t_next, istate, seams, rows, positions): one mesh
        checkpoint, written whole or not at all."""

        def save(t_next, istate, seams, rows_s, pos_s):
            tmp = path + ".tmp"
            np.savez(tmp, fingerprint=np.int64(fp), next_t=np.int64(t_next),
                     istate=istate, seam=seams, hit_rows=rows_s,
                     hit_positions=pos_s)
            os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                       path)

        return save

    @staticmethod
    def _warn_stale_checkpoint(path: str) -> None:
        log.warning("checkpoint %s does not match this run's inputs or "
                    "geometry; starting from scratch — it will be "
                    "overwritten", path)

    def _fingerprint(self, L: int, P: int, chunk: int, rchunk: int) -> int:
        """The JAX engine's checkpoint fingerprint, term for term, so a
        checkpoint resumes in either engine when the chunk geometry agrees."""
        h = zlib.crc32(self.scores.tobytes())
        db_crc = getattr(self.database, "_codes_crc32", None)
        if db_crc is None:
            db_crc = zlib.crc32(np.ascontiguousarray(self.database.codes))
            self.database._codes_crc32 = db_crc
        h = zlib.crc32(db_crc.to_bytes(4, "little"), h)
        h = zlib.crc32(
            np.asarray([L, P, chunk, rchunk, self.database.padded_length],
                       dtype=np.int64).tobytes(), h)
        h = zlib.crc32(
            f"{self.strand}:{self.isolate_models}:{self.p_value}".encode(), h)
        return h

    def _load_checkpoint(self, fingerprint: int, n_row: int, rchunk: int):
        try:
            with np.load(self.checkpoint_path) as ck:
                if (int(ck["fingerprint"]) == fingerprint
                        and "carries" in ck
                        and ck["carries"].shape == (n_row, rchunk + 1)):
                    return (int(ck["next_ci"]), ck["carries"].astype(np.int32),
                            ck["hit_rows"], ck["hit_positions"])
        except FileNotFoundError:
            return None
        except (KeyError, OSError, ValueError):
            pass
        self._warn_stale_checkpoint(self.checkpoint_path)
        return None
