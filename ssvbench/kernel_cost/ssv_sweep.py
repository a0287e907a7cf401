"""The least work of an SSV sweep, independent of how the kernel packs it.

Operations (issue slots of 32-bit thread instructions, per cell):
``OPS_PER_CELL = 1/2``. Every cell needs a lane of an add of its match
score and a floor at zero. Hopper's densest known form of that pair is the
DPX ``__viaddmax_s16x2_relu`` (two 16-bit lanes, add, max and relu in one
instruction): one slot for two cells. Every other known exact form spends
at least as much: SWAR fields of 8 to 10 bits (at most four a word) need
one instruction for the add and another for the floor; bit-sliced planes
(32 cells a word) need at least two logic instructions for each of the
eight state bits. The match select, the hit test, the diagonal shift and
the hit's record are left out, so no exact implementation can need less.

Bytes: each input read once and each output written once at its least
size: the database at ⌈log2 card⌉ bits a position (2 for the 4 nucleotide
codes, 5 for the 20 amino), the scores at one byte a row and symbol
(``card`` a row), and each hit at the fewest bytes that hold its (row,
position) pair, or a bitmap of a bit a cell where that is fewer. The add
and the floor do not depend on the alphabet: ``OPS_PER_CELL`` holds for
both.

The least time is the larger of the operations at the card's issue peak
(SMs x issue lanes x maximum SM clock) and the bytes at its memory
bandwidth (``peaks.json``).
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

OPS_PER_CELL = 0.5


def code_bits(card: int) -> int:
    """The fewest bits that hold one of ``card`` symbol codes."""
    return max(1, math.ceil(math.log2(card)))


def hit_bytes(positions: int, rows: int) -> int:
    """The fewest bytes that hold one hit's (row, position)."""
    return max(1, math.ceil(math.log2(max(2, positions * rows)) / 8))


def work(searches: Iterable[Tuple[int, int, int]], card: int = 4
         ) -> Tuple[float, float]:
    """(operations, bytes) of sweeps given as (positions, rows, hits) over
    an alphabet of ``card`` symbols."""
    ops = nbytes = 0.0
    for positions, rows, hits in searches:
        ops += OPS_PER_CELL * positions * rows
        out = min(hits * hit_bytes(positions, rows), positions * rows / 8)
        nbytes += positions * code_bits(card) / 8 + rows * card + out
    return ops, nbytes


def least_seconds(searches, peak: dict, card: int = 4) -> dict:
    """The least seconds of the work on the card of ``peak``, which bound
    binds, and both times."""
    ops, nbytes = work(searches, card)
    issue = (peak["sm_count"] * peak["issue_lanes_per_sm"]
             * peak["max_sm_clock_hz"])
    ops_s = ops / issue
    bytes_s = nbytes / peak["hbm_bytes_per_s"]
    return {"seconds": max(ops_s, bytes_s), "operations_s": ops_s,
            "bytes_s": bytes_s,
            "bound": "operations" if ops_s >= bytes_s else "bytes"}
