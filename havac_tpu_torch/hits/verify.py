"""Batch hit verification: bounded re-SSV of every reported hit.

The reference's live API *claims* hits are "verified via bounded reference
SSV checks" (`host/Havac.hpp:74-77`) but the implementation only exists in
the stale tree (`host/host/HitVerifier.cpp:68-113`) and is never called.
Here the claim is made true: ``Havac(verify_hits=True)`` (or ``--verify`` on
the CLI) re-derives every raw hit after the sweep by replaying the SSV
recurrence along the hit's diagonal and flags any the true recurrence does
not produce — a kernel or decode regression cannot silently ship wrong
coordinates.

Exactness via a TWO-SIDED bounded replay: the incoming state at a
mid-chain window start is unknown, and a single replay from 0 is NOT a
lower bound of the true chain once a ≥256 reset occurs inside the window
(the true chain resets to 0 while the low replay keeps climbing — a naive
verifier can falsely accept). Instead each window is replayed from both
extreme start states, 0 and 255:

  * if the high replay never takes an internal ≥256 reset (since the last
    model-isolation reset row, where both replays are forced to the exact
    value 0), the true chain is SANDWICHED: low ≤ true ≤ high at every
    step — so low_end ≥ 256 proves the hit and high_end < 256 refutes it,
    both exactly;
  * otherwise (or when the two bounds straddle the threshold) the window
    is ambiguous and escalates exponentially; at the full diagonal the
    start state is the matrix edge, which is exactly 0, so escalation
    always terminates with an exact answer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class VerificationReport:
    """Outcome of re-deriving every hit."""

    num_hits: int
    num_verified: int
    reached: np.ndarray  # per-hit decided pre-reset sum at the hit cell
    unverified_indices: np.ndarray  # indices into the input hit arrays

    @property
    def all_verified(self) -> bool:
        return self.num_verified == self.num_hits


def _replay_window(
    rows: np.ndarray,
    positions: np.ndarray,
    symbols: np.ndarray,
    scores: np.ndarray,
    reset_rows: Optional[np.ndarray],
    bound: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Two-sided replay of each hit's diagonal over the last ``bound`` steps.

    Returns (lo_final, hi_final, ambiguous, grounded): the pre-reset sums at
    the hit cell for replays starting from 0 and from 255, whether the high
    replay took an internal ≥256 reset since the last synchronization point
    (window start excluded — see module docstring), and whether the window
    start was exact (matrix edge or the step after a reset row)."""
    n = rows.shape[0]
    lo = np.zeros(n, dtype=np.int64)
    hi = np.full(n, 255, dtype=np.int64)
    lo_final = np.full(n, -(1 << 30), dtype=np.int64)
    hi_final = np.full(n, -(1 << 30), dtype=np.int64)
    ambiguous = np.zeros(n, dtype=bool)
    grounded = np.zeros(n, dtype=bool)
    T = int(min(bound, int(np.minimum(rows, positions).max()) + 1))
    for t in range(T):
        d = T - 1 - t  # distance from the hit cell along the diagonal
        jt = rows - d
        it = positions - d
        live = (jt >= 0) & (it >= 0)
        starts_here = live & ((jt == 0) | (it == 0))
        # At the matrix edge the incoming state is exactly 0: both replays
        # synchronize and the result is start-independent.
        lo = np.where(starts_here, 0, lo)
        hi = np.where(starts_here, 0, hi)
        ambiguous = np.where(starts_here, False, ambiguous)
        grounded = grounded | starts_here
        jc = np.where(live, jt, 0)
        ic = np.where(live, it, 0)
        if reset_rows is not None:
            sync = live & reset_rows[jc]
            lo = np.where(sync, 0, lo)
            hi = np.where(sync, 0, hi)
            ambiguous = np.where(sync, False, ambiguous)
            grounded = grounded | sync
        m = np.where(live, scores[jc, symbols[ic]], 0)
        s_lo = lo + m
        s_hi = hi + m
        if t == T - 1:
            lo_final = s_lo
            hi_final = s_hi
        else:
            # An internal >=256 reset on the HIGH replay breaks the
            # sandwich: the window becomes ambiguous until the next sync.
            ambiguous = ambiguous | (live & (s_hi >= 256))
        lo = np.where((s_lo < 0) | (s_lo >= 256), 0, s_lo)
        hi = np.where((s_hi < 0) | (s_hi >= 256), 0, s_hi)
    return lo_final, hi_final, ambiguous, grounded


def verify_hits(
    hit_rows: np.ndarray,
    hit_positions: np.ndarray,
    symbols: np.ndarray,
    scores: np.ndarray,
    reset_rows: Optional[np.ndarray] = None,
    initial_bound: int = 64,
    chunk: int = 1 << 20,
) -> VerificationReport:
    """Re-derive every (global row, global position) hit; exact.

    ``symbols``: the same padded 2-bit codes the sweep ran over;
    ``scores``: the concatenated (P, 4) int8 projected scores;
    ``reset_rows``: model-isolation reset rows, when the sweep used them.

    Each hit is decided by a two-sided bounded replay (module docstring):
    decided-hit iff the low replay reaches ≥256, decided-non-hit iff the
    high replay stays <256, under an unambiguous (sandwiched or grounded)
    window; undecided hits escalate to exponentially longer windows, and
    the full diagonal is always exact.
    """
    rows = np.asarray(hit_rows, dtype=np.int64)
    positions = np.asarray(hit_positions, dtype=np.int64)
    symbols = np.asarray(symbols, dtype=np.int64)
    scores = np.asarray(scores, dtype=np.int64)
    reset = (np.asarray(reset_rows, dtype=bool)
             if reset_rows is not None else None)
    n = rows.shape[0]
    reached = np.empty(n, dtype=np.int64)
    if n == 0:
        return VerificationReport(0, 0, reached, np.empty(0, dtype=np.int64))

    for lo_i in range(0, n, chunk):
        hi_i = min(n, lo_i + chunk)
        r, p = rows[lo_i:hi_i], positions[lo_i:hi_i]
        bound = initial_bound
        got = np.full(r.shape[0], -(1 << 30), dtype=np.int64)
        pending = np.arange(r.shape[0])
        while pending.size:
            g_lo, g_hi, amb, grounded = _replay_window(
                r[pending], p[pending], symbols, scores, reset, bound)
            # Decided: grounded windows are exact from the low replay;
            # un-grounded but sandwich-clean windows decide when the two
            # bounds agree on which side of the threshold the truth is.
            exact = grounded | ~amb
            accept = exact & (g_lo >= 256)
            reject = exact & (g_hi < 256) & ~grounded | grounded & (g_lo < 256)
            done = accept | reject
            got[pending[done]] = np.where(accept[done], g_lo[done],
                                          np.minimum(g_hi[done], 255))
            full = int(np.minimum(r[pending], p[pending]).max()) + 1
            pending = pending[~done]
            if not pending.size:
                break
            if bound >= full:
                # Full-diagonal replay is grounded for every hit; nothing
                # can remain undecided here.
                got[pending] = g_lo[~done]
                break
            bound = min(bound * 4, full)
        reached[lo_i:hi_i] = got

    unverified = np.nonzero(reached < 256)[0]
    return VerificationReport(
        num_hits=n,
        num_verified=int(n - unverified.size),
        reached=reached,
        unverified_indices=unverified,
    )


class HitVerificationError(RuntimeError):
    """Raised when verify_hits finds hits the recurrence does not produce."""

    def __init__(self, report: VerificationReport, rows: np.ndarray,
                 positions: np.ndarray):
        self.report = report
        examples: List[Tuple[int, int, int]] = [
            (int(rows[i]), int(positions[i]), int(report.reached[i]))
            for i in report.unverified_indices[:8]
        ]
        super().__init__(
            f"{report.num_hits - report.num_verified} of {report.num_hits} "
            f"hits failed bounded re-SSV verification (reached < 256); "
            f"first (row, position, reached): {examples}")
