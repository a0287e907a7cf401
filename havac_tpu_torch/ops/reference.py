"""Golden scalar/numpy SSV reference — the oracle every kernel is tested against.

Implements exactly the reference CPU oracle softSsvThreshold256
(`test/softSsv/SoftSsv.cpp:15-67`):

    S[j][i] = S[j-1][i-1] + M[j][sym[i]]     (S[-1][*] = 0, S[*][-1] = 0)
    if S[j][i] <  0:   S[j][i] = 0           (local-alignment floor)
    if S[j][i] >= 256: S[j][i] = 0, report hit (j, i)

State values always lie in [0, 255]; match scores are int8. The only DP
dependency is diagonal, which is what every accelerated implementation (the
reference's 12,288-PE array, our vectorized kernels) exploits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class SsvResult:
    """Hits as parallel coordinate arrays, sorted by (row, position).

    ``hit_rows``  — global pHMM row index j of each hit.
    ``hit_positions`` — global sequence position i of each hit.
    ``final_row_state`` — S[P-1][*], the DP state after the last model row
        (the "horizontal" chunk boundary).
    ``final_carry`` — carry[j+1] = S[j][L-1] for j = -1..P-1, the right-edge
        boundary column (the reference's score-queue contents,
        `device/HavacHls.cpp:451-465`); shape (P+1,).
    """

    hit_rows: np.ndarray
    hit_positions: np.ndarray
    final_row_state: np.ndarray
    final_carry: np.ndarray


def ssv_reference(
    symbols: np.ndarray,
    scores: np.ndarray,
    init_row_state: Optional[np.ndarray] = None,
    init_carry: Optional[np.ndarray] = None,
    return_matrix: bool = False,
    reset_rows: Optional[np.ndarray] = None,
) -> Tuple[SsvResult, Optional[np.ndarray]]:
    """Run the SSV recurrence over the full (P rows × L positions) matrix.

    ``symbols`` uint8 (L,) of 2-bit codes; ``scores`` int8 (P, 4).
    ``init_row_state`` int (L,) = S[-1][*] (zeros for a fresh run; the previous
    chunk's final_row_state when chunking over model rows).
    ``init_carry`` int (P+1,) = S[j-1][-1] values entering from the left
    (zeros for a fresh run / global left edge; the left shard's final_carry
    when chunking over sequence positions).
    ``reset_rows`` optional bool (P,): rows where the incoming diagonal state
    is forced to zero — model-start rows under model-isolation semantics
    (the reference's concatenated stream lets chains cross model boundaries,
    `host/phmm/PhmmPreprocessor.cpp:9-31`; isolation removes that artifact
    and makes model-axis sharding cuts exact).

    Returns (SsvResult, matrix or None). The matrix (P, L) of post-update state
    values is the per-cell debug oracle (`byCellComparator` analog,
    SURVEY.md §4.2).
    """
    symbols = np.asarray(symbols, dtype=np.uint8)
    scores = np.asarray(scores, dtype=np.int8)
    L = symbols.shape[0]
    P = scores.shape[0]

    row = (
        np.zeros(L, dtype=np.int32)
        if init_row_state is None
        else np.asarray(init_row_state, dtype=np.int32).copy()
    )
    carry_in = (
        np.zeros(P + 1, dtype=np.int32)
        if init_carry is None
        else np.asarray(init_carry, dtype=np.int32)
    )
    if carry_in.shape[0] != P + 1:
        raise ValueError(f"init_carry must have shape ({P + 1},)")

    hit_rows = []
    hit_positions = []
    carry_out = np.empty(P + 1, dtype=np.int32)
    carry_out[0] = row[L - 1]
    matrix = np.empty((P, L), dtype=np.int32) if return_matrix else None

    reset = (np.zeros(P, dtype=bool) if reset_rows is None
             else np.asarray(reset_rows, dtype=bool))

    match_table = scores.astype(np.int32)  # (P, 4)
    for j in range(P):
        m = match_table[j][symbols]
        shifted = np.empty(L, dtype=np.int32)
        shifted[0] = carry_in[j]
        shifted[1:] = row[:-1]
        if reset[j]:
            # Model-isolation semantics: diagonal chains do not enter this
            # row (row j starts a new model), so the incoming state is zero.
            shifted[:] = 0
        s = shifted + m
        hit = s >= 256
        s = np.where((s < 0) | hit, 0, s)
        cols = np.nonzero(hit)[0]
        if cols.size:
            hit_rows.append(np.full(cols.size, j, dtype=np.int64))
            hit_positions.append(cols.astype(np.int64))
        row = s
        carry_out[j + 1] = row[L - 1]
        if return_matrix:
            matrix[j] = row

    if hit_rows:
        rows_arr = np.concatenate(hit_rows)
        pos_arr = np.concatenate(hit_positions)
    else:
        rows_arr = np.empty(0, dtype=np.int64)
        pos_arr = np.empty(0, dtype=np.int64)

    return (
        SsvResult(
            hit_rows=rows_arr,
            hit_positions=pos_arr,
            final_row_state=row,
            final_carry=carry_out,
        ),
        matrix,
    )


def ssv_reference_hits_set(symbols: np.ndarray, scores: np.ndarray) -> set:
    result, _ = ssv_reference(symbols, scores)
    return set(zip(result.hit_rows.tolist(), result.hit_positions.tolist()))
