"""The collector pool's host work a chunk: sort and resolve its hit keys.

The counterpart of `tools/hostbench.py`, which times the JAX engine's
per-chunk record decode and resolve. The port's kernel writes u64 hit keys
``(row << 38) | pos`` and an exact count, so there is nothing to decode:
the pool's work item is `engine/pipeline.py`
``KeyedLaunches._resolve_chunk``, which sorts a chunk's keys and resolves
them with the native core (``resolve_keys_native``) to (sequence,
position, model, model position). This tool calls that work item itself,
in a ``ThreadPoolExecutor`` of ``--workers`` threads (the engine's pool
has 4), on synthetic keys over a chr22-shaped database (about 24,000
sequences, about 50 Mb) and ``--rows`` model rows, at ``--hits-per-chunk``
keys a chunk (the default, 83,000, is the JAX tool's genomic density:
about 42 M hits over 510 chunks at 150,043 model positions).

Three variants, each in ms a chunk (one JSON line, and ``--json``):
resolve on 4 native threads and on 1 with the sort, and on 1 without it
(keys handed over sorted). It runs no device code.

    python -m havac_tpu_torch.tools.hostbench
    python -m havac_tpu_torch.tools.hostbench --hits-per-chunk 20000 \\
        --json out.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from havac_tpu_torch import native
from havac_tpu_torch.engine.pipeline import collector, keys_from_pairs
from havac_tpu_torch.io.fasta import SequenceDatabase

# (label, native threads, sort in the work item)
VARIANTS = (("pool_nt4_sorted", 4, True), ("pool_nt1_sorted", 1, True),
            ("pool_nt1_unsorted", 1, False))
INPUTS = 8  # distinct key chunks, cycled over --chunks


def fake_db(rng: np.random.Generator, nseq: int = 24_000
            ) -> Tuple[SequenceDatabase, int]:
    """A chr22-shaped database's tables (no codes): ~24k sequences of
    500-4,000 positions, ~50 Mb; returns it and its concatenated length."""
    lens = rng.integers(500, 4000, size=nseq, dtype=np.int64)
    starts = np.zeros(nseq + 1, dtype=np.int64)
    np.cumsum(lens + 1, out=starts[1:])
    db = SequenceDatabase(codes=np.empty(0, dtype=np.uint8), starts=starts,
                          lengths=lens, names=[""] * nseq, seed=0)
    return db, int(starts[-1])


def model_prefix(rng: np.random.Generator, rows: int) -> np.ndarray:
    """Model start rows: ~1,400 models of 50-200 positions, stretched (as
    the JAX tool does) until they cover ``rows``."""
    prefix = np.concatenate(
        [[0], np.cumsum(rng.integers(50, 200, size=1400))]).astype(np.int64)
    return prefix * (rows // int(prefix[-1]) + 1)


def make_keys(seed: int, n: int, rows: int, total: int) -> np.ndarray:
    """``n`` unsorted u64 hit keys at uniform rows below ``rows`` and
    positions below ``total`` (separators among them)."""
    r = np.random.default_rng(seed)
    return keys_from_pairs(r.integers(0, rows, size=n),
                           r.integers(0, total, size=n))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hits-per-chunk", type=int, default=83_000,
                    help="keys a chunk (~42M genomic hits / 510 chunks at "
                    "150,043 model positions)")
    ap.add_argument("--chunks", type=int, default=64,
                    help=f"chunks a timing (cycled from {INPUTS} inputs)")
    ap.add_argument("--workers", type=int, default=4,
                    help="collector-pool width (the engine's is 4)")
    ap.add_argument("--rows", type=int, default=150_043)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not native.available():
        raise RuntimeError("the native host core is unavailable (g++ "
                           "builds it at first use)")

    rng = np.random.default_rng(0)
    db, total = fake_db(rng)
    prefix = model_prefix(rng, args.rows)
    work = collector(db, prefix)
    inputs = [make_keys(i, args.hits_per_chunk, args.rows, total)
              for i in range(INPUTS)]
    ordered = [np.sort(k) for k in inputs]
    results = {"hits_per_chunk": args.hits_per_chunk, "chunks": args.chunks,
               "workers": args.workers, "rows": args.rows, "variants": {}}
    for label, nthreads, sort in VARIANTS:
        # The work item sorts in place: each chunk gets its own copy,
        # made before the clock starts.
        src = inputs if sort else ordered
        chunks = [src[i % INPUTS].copy() for i in range(args.chunks)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=args.workers) as pool:
            out = list(pool.map(
                lambda k: work._resolve_chunk(k, nthreads=nthreads,
                                              presorted=not sort), chunks))
        per = (time.perf_counter() - t0) / args.chunks
        kept = sum(int(c.kept_keys.size) for c in out)
        results["variants"][label] = {"ms_per_chunk": per * 1e3,
                                      "kept_per_chunk": kept / args.chunks}
    print(json.dumps(results), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
