"""A numpy emulation of the sweep kernel's word algebra (`csrc/ssv_sweep.cu`).

The kernel keeps three DP diagonals in the 10-bit fields of one 32-bit word.
A block of ``V = threads * words`` words covers ``3 V`` diagonals from
``d0``: word ``v`` (thread ``v % threads``, its word ``v // threads``) owns
diagonals ``d0 + v``, ``d0 + V + v`` and ``d0 + 2V + v`` in fields 0, 1
and 2 (the split-block layout of the JAX package's ``pack_symbols`` /
``pack_state`` with ``W3 = V``), so a diagonal's state never leaves its
field and no row rolls the words. Per tile of ``rows`` model rows the block
stages one entry per window position, and each row reads entry ``v + k``.
The entry and the match word are

  * for card 4 the packed symbol word ``sym3[x] = s(w0 + x) |
    s(w0 + V + x) << 10 | s(w0 + 2V + x) << 20`` (0 outside the sequence)
    as its code-bit planes ``b0 = sym3 & FM`` and ``b1 = (sym3 >> 1) & FM``,
    and the match ``c + b0 e1 + b1 e2 + (b0 & b1) e3`` with the row's
    scalars ``c = m0 FM``, ``e1 = m1 - m0``, ``e2 = m2 - m0``,
    ``e3 = m3 - m2 - m1 + m0`` (``m = score + 256``), exact modulo 2^32;
  * for any other card the three codes' byte offsets into the row's tables,
    ``4 (s & 63)`` in byte f of the entry (byte 3 zero; 0 outside the
    sequence), and the match the sum of three table reads at those offsets
    from field f's table, whose entry ``code`` is ``m[code] << 10 f``
    (:func:`stage_offsets`, :func:`row_tables`, :func:`match_offsets`).

The biased update is the JAX kernel's: ``w = st + match``, ``t9 = w >> 9``,
``keep = (w >> 8) & ~t9 & FM``, ``st = w & (keep * 255)``; a hit is bit 9
of a field. A window of ``window`` rows ORs the hit bits into one word; a
warp whose lanes saw any replays the window from its saved state and
decodes the hits row by row. A window's reset rows are one mask, bit r for
its row r (:func:`window_reset_mask`): a window whose mask is 0 runs its
rows without the reset test. Blocks that touch the left triangle (a
diagonal below 0 starts at row -d with ``init_carry``), the right one (a
diagonal ends at the sequence's last position) or lie past the sequence run
a masked update: a field outside its live rows neither changes nor hits.
They mask only the staged tiles where some field enters or leaves; a tile
whose rows keep every field live runs the unmasked update.

The row dump (``dump``, a (P, L) array) runs the same body in its own
geometry (:data:`DUMP`): in the fast pass of every window each live field's
post-update state is stored at ``dump[j, d + j]``, and nothing else is.

:func:`sweep_words` follows the kernel block by block and returns what
``ops/ssv_torch.py`` ``ssv_sweep_plain`` returns; the CPU tests hold the two
(and the JAX package's layout and reference) to exact equality.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

FM = 0x00100401  # bit 0 of each 10-bit field
HM = FM << 9  # bit 9: the hit bit
FIELD = 0x3FF
U32 = 0xFFFFFFFF
MAX_CARD = 32  # entries a field's table (csrc/ssv_sweep.cu kMaxCard)
KEY_POS_BITS = 38


@dataclass(frozen=True)
class Layout:
    """The kernel's geometry: threads a block (``csrc/ssv_sweep.cu`` kWide,
    256, or kNarrow, 64), words a thread, rows a staged tile, rows a hit
    window (kWords, kRows, kWin)."""

    threads: int = 256
    words: int = 2
    rows: int = 64
    window: int = 16

    @property
    def V(self) -> int:
        return self.threads * self.words

    @property
    def span(self) -> int:
        return 3 * self.V


# The row dump's geometry (csrc/ssv_sweep.cu kDumpT, kDumpW).
DUMP = Layout(threads=128, words=1)


@dataclass
class Stats:
    """What an emulated sweep went through."""

    interior_blocks: int = 0
    edge_blocks: int = 0
    windows: int = 0
    replays: int = 0
    max_warp_row_hits: int = 0  # most hits one warp emitted in one row
    masked_tiles: int = 0  # staged tiles run with the per-field masks
    tiles: int = 0
    dump_writes: int = 0  # cells the row dump stored
    reset_windows: int = 0  # windows that ran the reset test
    interior_reset_windows: int = 0  # of them, in interior blocks


def pack3(f0, f1, f2) -> np.ndarray:
    """Three field values (each < 1024) as one word:
    f0 | f1 << 10 | f2 << 20."""
    return (np.asarray(f0, np.int64) | (np.asarray(f1, np.int64) << 10)
            | (np.asarray(f2, np.int64) << 20))


def unpack3(words) -> np.ndarray:
    """(n,) words -> (3, n) field values."""
    w = np.asarray(words, np.int64)
    return np.stack([(w >> (10 * f)) & FIELD for f in range(3)])


def stage_symbols(symbols: np.ndarray, w0: int, n: int, V: int) -> np.ndarray:
    """sym3[x] for x in [0, n): the codes at w0 + x + f V, 0 outside."""
    L = symbols.shape[0]
    x = np.arange(n, dtype=np.int64)
    fields = []
    for f in range(3):
        pos = w0 + x + f * V
        ok = (pos >= 0) & (pos < L)
        fields.append(np.where(ok, symbols[np.clip(pos, 0, L - 1)], 0))
    return pack3(*fields)


def stage_offsets(symbols: np.ndarray, w0: int, n: int, V: int
                  ) -> np.ndarray:
    """The other cards' staged entries for x in [0, n): byte f holds
    4 x (the code at w0 + x + f V, masked to 6 bits), 0 outside; byte 3
    is 0. An invalid code (up to 255) stays inside the tables' slack."""
    codes = unpack3(stage_symbols(symbols, w0, n, V))
    return sum(((codes[f] & 63) << 2) << (8 * f) for f in range(3))


def row_tables(score_row: np.ndarray) -> np.ndarray:
    """One row's tables as the kernel stages them, 32-bit entries: field f's
    table from entry 32 f, entry ``code`` = (score + 256) << 10 f; the 64
    entries of slack after the last table (the kernel's sits after the
    tile's last row) read 0 here."""
    tab = np.zeros(3 * MAX_CARD + 64, np.int64)
    biased = np.asarray(score_row, np.int64) + 256
    for f in range(3):
        tab[f * MAX_CARD:f * MAX_CARD + biased.size] = biased << (10 * f)
    return tab


def match_offsets(entries: np.ndarray, tab: np.ndarray) -> np.ndarray:
    """The match words of staged entries: the reads at field f's table
    byte offset (4 x 32 f) plus byte f of each entry (the extractions: a
    mask, a byte permute and a shift)."""
    e = np.asarray(entries, np.int64)
    offs = (e & 0xFF, (e >> 8) & 0xFF, e >> 16)
    words = [tab[(4 * MAX_CARD * f + offs[f]) // 4] for f in range(3)]
    return (words[0] + words[1] + words[2]) & U32


def window_reset_mask(reset: Optional[np.ndarray], j: int, n: int) -> int:
    """Bit r set where row j + r of the window's n rows is a reset row."""
    if reset is None:
        return 0
    return int(sum(1 << r for r in np.flatnonzero(reset[j:j + n])))


def card4_planes(sym3: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return sym3 & FM, (sym3 >> 1) & FM


def card4_scalars(score_row: np.ndarray) -> Tuple[int, int, int, int]:
    m0, m1, m2, m3 = (int(s) + 256 for s in score_row[:4])
    return ((m0 * FM) & U32, (m1 - m0) & U32, (m2 - m0) & U32,
            (m3 - m2 - m1 + m0) & U32)


def match_card4(sym3: np.ndarray, score_row: np.ndarray) -> np.ndarray:
    b0, b1 = card4_planes(sym3)
    c, e1, e2, e3 = card4_scalars(score_row)
    return (c + b0 * e1 + b1 * e2 + (b0 & b1) * e3) & U32


def match_tables(sym3: np.ndarray, score_row: np.ndarray) -> np.ndarray:
    biased = np.asarray(score_row, np.int64) + 256
    codes = unpack3(sym3)
    return pack3(*(biased[codes[f]] for f in range(3)))


def update(st: np.ndarray, match: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """The biased field update: (new state words, hit words)."""
    w = (st + match) & U32
    t9 = w >> 9
    keep = (w >> 8) & ~t9 & FM
    return w & (keep * 255), w & HM


def decode_hits(hit: np.ndarray, diag: np.ndarray, j: int, row_offset: int,
                pos_offset: int) -> np.ndarray:
    """Keys of a row's hit words; ``diag`` (3, n) holds each field's
    diagonal."""
    keys = []
    for f in range(3):
        on = ((hit >> (10 * f + 9)) & 1).astype(bool)
        pos = diag[f][on] + j
        keys.append(((j + row_offset) << KEY_POS_BITS) | (pos + pos_offset))
    return np.concatenate(keys).astype(np.int64)


def field_live(j: int, js: np.ndarray, je: np.ndarray) -> np.ndarray:
    """(n,) word masks: 0x3FF in the fields live at row j."""
    live = (j >= js) & (j < je)
    return pack3(*(np.where(live[f], FIELD, 0) for f in range(3)))


def live_run(d0: int, j: int, L: int, span: int) -> Tuple[int, int]:
    """The span positions [lo, hi) of a block's diagonals d0 + x live at
    row j (their position d0 + x + j in [0, L)): the run the row dump
    copies (csrc/ssv_sweep.cu `live_run`)."""
    lo, hi = max(0, -j - d0), min(span, max(L - j - d0, 0))
    return lo, max(lo, hi)


def sweep_words(symbols, scores, init_state, init_carry, reset_rows=None,
                row_offset: int = 0, pos_offset: int = 0,
                layout: Layout = Layout(), stats: Optional[Stats] = None,
                dump: Optional[np.ndarray] = None):
    """The kernel's sweep, block by block; returns (keys sorted, final_state,
    final_carry) as ``ssv_sweep_plain`` does. ``dump``, a (P, L) array, gets
    every live field's post-update state as the row dump stores it (pass
    ``layout=DUMP`` for the dump's geometry)."""
    sym = np.asarray(symbols, np.int64)
    sc = np.asarray(scores, np.int64)
    ist = np.asarray(init_state, np.int64)
    icr = np.asarray(init_carry, np.int64)
    reset = None if reset_rows is None else np.asarray(reset_rows) != 0
    L, (P, card) = sym.shape[0], sc.shape
    V, span = layout.V, layout.span
    stats = stats if stats is not None else Stats()
    final_state = np.zeros(L, np.int64)
    final_carry = np.zeros(P + 1, np.int64)
    final_carry[0] = ist[L - 1]
    keys = []
    v = np.arange(V, dtype=np.int64)
    warp = (v % layout.threads) // 32
    for b in range(-(-(L + P - 1) // span)):
        d0 = b * span - (P - 1)
        diag = np.stack([d0 + f * V + v for f in range(3)])  # (3, V)
        valid = diag <= L - 1
        js = np.where(diag < 0, -diag, 0)
        je = np.where(valid, np.minimum(L - diag, P), 0)
        init = np.where(diag >= 1, ist[np.clip(diag - 1, 0, L - 1)],
                        np.where(diag == 0, icr[0], 0))
        st = pack3(*np.where(valid, init, 0))
        edge = d0 < 0 or d0 + span - 1 > L - P
        if edge:
            stats.edge_blocks += 1
        else:
            stats.interior_blocks += 1
        jlo, jhi = max(0, -(d0 + span - 1)), min(P, L - d0)
        # Rows where every field is live and none enters: unmasked tiles.
        ja, jb = (1 - d0 if d0 < 0 else 0), min(P, L - (d0 + span - 1))

        def step(st, j, entry, masked, rz):
            if masked:  # inject init_carry at a negative diagonal's first row
                inj = pack3(*np.where((j == js) & (js > 0), icr[j], 0))
                st = st | inj
            cur = np.zeros_like(st) if rz else st
            match = (match_card4(entry, sc[j]) if card == 4
                     else match_offsets(entry, row_tables(sc[j])))
            nst, hit = update(cur, match)
            lm = field_live(j, js, je)
            if masked:
                nst = (nst & lm) | (st & ~lm & U32)
                hit = hit & lm
            else:
                assert (lm == pack3(FIELD, FIELD, FIELD)).all()
            return nst, hit, lm

        for j0 in range(jlo, jhi, layout.rows):
            nrows = min(layout.rows, jhi - j0)
            masked = edge and not (j0 >= ja and j0 + nrows <= jb)
            stats.tiles += 1
            stats.masked_tiles += masked
            staged = (stage_symbols if card == 4 else stage_offsets)(
                sym, d0 + j0, V + nrows - 1, V)
            for k0 in range(0, nrows, layout.window):
                n = min(layout.window, nrows - k0)
                saved, acc = st, np.zeros_like(st)
                # The window's reset rows: without one, no row tests.
                rm = window_reset_mask(reset, j0 + k0, n)
                stats.reset_windows += rm != 0
                stats.interior_reset_windows += rm != 0 and not edge
                for k in range(k0, k0 + n):
                    rz = bool((rm >> (k - k0)) & 1)
                    st, hit, lm = step(st, j0 + k, staged[v + k], masked, rz)
                    acc |= hit
                    if dump is not None:  # the fast pass stores live fields
                        j = j0 + k
                        live = []
                        for f in range(3):
                            on = ((lm >> (10 * f)) & 1).astype(bool)
                            dump[j, diag[f][on] + j] = (
                                st[on] >> (10 * f)) & 0xFF
                            stats.dump_writes += int(on.sum())
                            live.append(diag[f][on] - d0)
                        # The kernel copies the row's live run [lo, hi) of
                        # the span: the live fields are exactly that run.
                        lo, hi = live_run(d0, j, L, span)
                        np.testing.assert_array_equal(
                            np.sort(np.concatenate(live)), np.arange(lo, hi))
                stats.windows += 1
                if not acc.any():
                    continue
                # The warps that saw a hit replay the window and decode it.
                stats.replays += np.unique(warp[acc != 0]).size
                for k in range(k0, k0 + n):
                    saved, hit, _ = step(saved, j0 + k, staged[v + k], masked,
                                         bool((rm >> (k - k0)) & 1))
                    keys.append(decode_hits(hit, diag, j0 + k, row_offset,
                                            pos_offset))
                    per_lane = sum((hit >> (10 * f + 9)) & 1 for f in range(3))
                    stats.max_warp_row_hits = max(
                        stats.max_warp_row_hits,
                        int(np.bincount(warp, weights=per_lane).max()))
                assert np.array_equal(saved, st)
        vals = unpack3(st)
        for f in range(3):
            d, e, val = diag[f], je[f], vals[f]
            ok = valid[f]
            bottom = ok & (e == P)
            final_state[d[bottom] + P - 1] = val[bottom]
            right = ok & (d + e - 1 == L - 1)
            final_carry[e[right]] = val[right]
    out = (np.sort(np.concatenate(keys)) if keys
           else np.empty(0, np.int64))
    return out, final_state.astype(np.int32), final_carry.astype(np.int32)
