"""Hit bitmap decoding and hit resolution to (sequence, model) coordinates.

Replaces the reference's hierarchical FIFO hit-filter tree + host decode
(`device/HitReporting.cpp`, `host/Havac.cpp:145-187`). Kernels emit hit
*bitmaps* (dense per strip, or compact per dirty tile); decode recovers exact
(global row, global position) pairs on the host with vectorized numpy, then
resolution maps them to (sequence_index, position_in_sequence, phmm_index,
position_in_phmm), dropping hits on separator/pad positions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from havac_tpu_torch.ops.common import hit_sort_order


def decode_dense_bitmaps(
    bitmaps: np.ndarray, rows_per_strip: int, row_offset: int = 0, pos_offset: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (S, L) int32 bitmaps → (rows, positions), sorted by (row, pos).

    Bit (K-1-k) of bitmaps[s, i] = hit at row s*K + k, position i.
    """
    bm = np.asarray(bitmaps).view(np.uint32).reshape(bitmaps.shape)
    K = rows_per_strip
    strip_idx, pos_idx = np.nonzero(bm)
    if strip_idx.size == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    words = bm[strip_idx, pos_idx]
    rows_out = []
    pos_out = []
    for k in range(K):
        mask = (words >> np.uint32(K - 1 - k)) & np.uint32(1)
        sel = mask.astype(bool)
        if sel.any():
            rows_out.append(strip_idx[sel].astype(np.int64) * K + k + row_offset)
            pos_out.append(pos_idx[sel].astype(np.int64) + pos_offset)
    rows = np.concatenate(rows_out)
    positions = np.concatenate(pos_out)
    order = hit_sort_order(rows, positions)
    return rows[order], positions[order]


def decode_hit_tiles(
    tile_ids: np.ndarray,
    tile_bitmaps: np.ndarray,
    count: int,
    num_strips: int,
    block_width: int,
    rows_per_strip: int,
    row_offset: int = 0,
    pos_offset: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Compact tiles (from the Pallas kernel) → (rows, positions).

    ``tile_ids[t] = block * num_strips + strip`` for the t-th dirty tile;
    ``tile_bitmaps[t]`` is the (block_width,) int32 bitmap of that tile (bit
    layout as in :func:`decode_dense_bitmaps`).
    """
    if count == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    ids = np.asarray(tile_ids[:count], dtype=np.int64)
    bm = np.asarray(tile_bitmaps[:count]).view(np.uint32).reshape(count, -1)
    K = rows_per_strip
    tile_idx, pos_idx = np.nonzero(bm)
    if tile_idx.size == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    words = bm[tile_idx, pos_idx]
    blocks = ids[tile_idx] // num_strips
    strips = ids[tile_idx] % num_strips
    rows_out = []
    pos_out = []
    for k in range(K):
        sel = ((words >> np.uint32(K - 1 - k)) & np.uint32(1)).astype(bool)
        if sel.any():
            rows_out.append(strips[sel] * K + k + row_offset)
            pos_out.append(blocks[sel] * block_width + pos_idx[sel] + pos_offset)
    rows = np.concatenate(rows_out)
    positions = np.concatenate(pos_out)
    order = hit_sort_order(rows, positions)
    return rows[order], positions[order]


@dataclass
class ResolvedHits:
    """Vectorized resolved hit table (columns, not per-hit objects).

    ``strand``: '+' per hit unless reverse-complement scanning produced it
    ('-'); sequence_position is always in forward-strand coordinates.
    """

    sequence_index: np.ndarray
    sequence_position: np.ndarray
    phmm_index: np.ndarray
    phmm_position: np.ndarray
    strand: np.ndarray = None

    def __post_init__(self):
        if self.strand is None:
            self.strand = np.full(self.sequence_index.shape[0], "+",
                                  dtype="U1")

    def __len__(self) -> int:
        return int(self.sequence_index.shape[0])

    def as_tuples(self):
        return list(
            zip(
                self.sequence_index.tolist(),
                self.sequence_position.tolist(),
                self.phmm_index.tolist(),
                self.phmm_position.tolist(),
            )
        )

    def as_tuples_stranded(self):
        return list(
            zip(
                self.sequence_index.tolist(),
                self.sequence_position.tolist(),
                self.phmm_index.tolist(),
                self.phmm_position.tolist(),
                self.strand.tolist(),
            )
        )


def concat_hits(parts):
    """Concatenate ResolvedHits tables."""
    parts = [p for p in parts if len(p)]
    if not parts:
        return ResolvedHits(*(np.empty(0, dtype=np.int64),) * 4)
    return ResolvedHits(
        sequence_index=np.concatenate([p.sequence_index for p in parts]),
        sequence_position=np.concatenate([p.sequence_position for p in parts]),
        phmm_index=np.concatenate([p.phmm_index for p in parts]),
        phmm_position=np.concatenate([p.phmm_position for p in parts]),
        strand=np.concatenate([p.strand for p in parts]),
    )


def resolve_hits(
    hit_rows: np.ndarray,
    hit_positions: np.ndarray,
    sequence_db,
    phmm_prefix_sums: np.ndarray,
    workers: int = 16,
) -> ResolvedHits:
    """Global (row, position) → local coordinates, dropping padding hits.

    Mirrors `Havac::getHitsFromFinishedRun` (`host/Havac.cpp:145-187`):
    sequence side via the FastaVector-style global→local map (invalid =
    separator/pad → dropped), model side via model-length prefix sums +
    binary search.

    Large hit lists resolve in thread-parallel chunks: the numpy ufuncs and
    searchsorted release the GIL, and this host's single-core memory
    bandwidth is the bottleneck (10M hits measured 7.3 s serial, 8-way
    chunks ~8x faster).
    """
    hit_rows = np.asarray(hit_rows, dtype=np.int64)
    hit_positions = np.asarray(hit_positions, dtype=np.int64)
    n = hit_rows.shape[0]
    if n:
        try:
            from havac_tpu_torch import native

            out = native.resolve_hits_native(
                hit_rows, hit_positions,
                np.asarray(sequence_db.starts, dtype=np.int64),
                np.asarray(sequence_db.lengths, dtype=np.int64),
                np.asarray(phmm_prefix_sums, dtype=np.int64))
            if out is not None:
                return ResolvedHits(sequence_index=out[0],
                                    sequence_position=out[1],
                                    phmm_index=out[2], phmm_position=out[3])
        except Exception:  # pragma: no cover - fall back to numpy
            pass
    if n < (1 << 20) or workers <= 1:
        return _resolve_block(hit_rows, hit_positions, sequence_db,
                              phmm_prefix_sums)
    from concurrent.futures import ThreadPoolExecutor

    slices = [slice(i * n // workers, (i + 1) * n // workers)
              for i in range(workers)]
    with ThreadPoolExecutor(workers) as ex:
        parts = list(ex.map(
            lambda sl: _resolve_block(hit_rows[sl], hit_positions[sl],
                                      sequence_db, phmm_prefix_sums),
            slices))
    return concat_hits(parts)


def _resolve_block(hit_rows, hit_positions, sequence_db, phmm_prefix_sums
                   ) -> ResolvedHits:
    resolved, _, _ = resolve_block_with_keys(hit_rows, hit_positions,
                                             sequence_db, phmm_prefix_sums)
    return resolved


def resolve_block_with_keys(
    hit_rows, hit_positions, sequence_db, phmm_prefix_sums
) -> Tuple[ResolvedHits, np.ndarray, np.ndarray]:
    """Single-threaded resolution that also returns the kept hits' raw
    (row, position) keys, so callers resolving chunk-by-chunk (the pipelined
    engine's collector pool) can globally order the concatenated table with
    one composite-key argsort at drain time."""
    seq_idx, seq_pos, valid = sequence_db.global_to_local(hit_positions)

    prefix = np.asarray(phmm_prefix_sums, dtype=np.int64)
    model_idx = np.searchsorted(prefix, hit_rows, side="right") - 1
    in_range = (model_idx >= 0) & (hit_rows < prefix[-1])
    model_idx_clamped = np.clip(model_idx, 0, len(prefix) - 2)
    model_pos = hit_rows - prefix[model_idx_clamped]

    keep = valid & in_range
    resolved = ResolvedHits(
        sequence_index=seq_idx[keep],
        sequence_position=seq_pos[keep],
        phmm_index=model_idx_clamped[keep],
        phmm_position=model_pos[keep],
    )
    return resolved, hit_rows[keep], hit_positions[keep]


def decode_flat_records(
    tile_ids_per_entry: np.ndarray,
    word_idx: np.ndarray,
    words: np.ndarray,
    num_strips: int,
    block_width: int,
    rows_per_strip: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Flat record decode for the unpacked kernel's tiles: entry e is bitmap
    word ``words[e]`` at in-tile position ``word_idx[e]`` of tile
    ``tile_ids_per_entry[e]`` (id = block·num_strips + strip)."""
    if words.size == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    words = np.asarray(words).view(np.uint32)
    ids = np.asarray(tile_ids_per_entry, dtype=np.int64)
    word_idx = np.asarray(word_idx, dtype=np.int64)
    K = rows_per_strip
    blocks = ids // num_strips
    strips = ids % num_strips
    rows_out, pos_out = [], []
    for k in range(K):
        sel = ((words >> np.uint32(K - 1 - k)) & np.uint32(1)).astype(bool)
        if sel.any():
            rows_out.append(strips[sel] * K + k)
            pos_out.append(blocks[sel] * block_width + word_idx[sel])
    rows = np.concatenate(rows_out)
    positions = np.concatenate(pos_out)
    order = hit_sort_order(rows, positions)
    return rows[order], positions[order]


@dataclass
class HitExplanation:
    """The diagonal chain that produced a hit (walkback re-derivation, the
    analog of multiInputTest's explainability fallback,
    `host/test/multiInputTest/multiInputTest.cpp:273-308`)."""

    hit_row: int
    hit_position: int
    chain_start_row: int  # first row of the scoring chain (state left 0)
    chain_start_position: int
    states: np.ndarray  # running DP state along the chain (last == 0, post-hit reset)
    matches: np.ndarray  # per-step match scores along the chain
    reached: int  # the pre-reset sum at the hit cell (≥ 256 for a real hit)


def explain_hit(hit_row: int, hit_position: int, symbols: np.ndarray,
                scores: np.ndarray) -> HitExplanation:
    """Re-derive one hit's diagonal chain with scalar arithmetic.

    Walks up the diagonal from (hit_row, hit_position) to the chain's origin
    (the last cell whose incoming state was 0), then replays the SSV
    recurrence forward, returning every intermediate state. ``reached`` is
    the unclamped sum at the hit cell; a genuine hit has reached ≥ 256.
    """
    symbols = np.asarray(symbols, dtype=np.int64)
    scores = np.asarray(scores, dtype=np.int64)
    j, i = int(hit_row), int(hit_position)
    steps = min(j, i) + 1

    # Forward replay from the top of the diagonal (exact, including resets);
    # record the most recent reset to locate the chain origin.
    j0, i0 = j - steps + 1, i - steps + 1
    state = 0
    start = (j0, i0)
    states, matches = [], []
    for t in range(steps):
        m = int(scores[j0 + t][symbols[i0 + t]])
        s = state + m
        if state == 0:
            start = (j0 + t, i0 + t)
            states, matches = [], []
        reached = s
        if s < 0 or s >= 256:
            state = 0
        else:
            state = s
        states.append(state)
        matches.append(m)
    return HitExplanation(
        hit_row=j, hit_position=i,
        chain_start_row=start[0], chain_start_position=start[1],
        states=np.asarray(states), matches=np.asarray(matches),
        reached=int(reached),
    )
