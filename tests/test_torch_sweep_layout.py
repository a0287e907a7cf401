"""The sweep kernel's word layout, emulated in numpy, against the plain
PyTorch sweep and the JAX package.

`havac_tpu_torch/testing/sweep_layout.py` follows `csrc/ssv_sweep.cu` block
by block: split-block fields, the staged symbol words, the card-4 bit-plane
and table match words, the biased update, the hit windows with their
replay and decode, and the per-field masks of edge blocks. Every comparison
here is exact; inputs come from numpy generators with fixed seeds. Small
layouts (8 threads, 2 words, 8-row tiles, 4-row windows) put many blocks,
tiles and windows into small inputs.
"""

import numpy as np
import pytest
import torch

from havac_tpu.ops.reference import ssv_reference
from havac_tpu.ops.ssv_swar import pack_state, pack_symbols, unpack_state
from havac_tpu_torch.ops.ssv_torch import ssv_sweep_plain
from havac_tpu_torch.testing import sweep_layout as sl

SMALL = sl.Layout(threads=8, words=2, rows=8, window=4)


def inputs(seed, L, P, card, reset=False, boundary=True, hi=90):
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, card, L).astype(np.uint8)
    sc = rng.integers(-40, hi, (P, card)).astype(np.int8)
    ist = (rng.integers(0, 256, L) if boundary else np.zeros(L)
           ).astype(np.int32)
    icr = (rng.integers(0, 256, P + 1) if boundary else np.zeros(P + 1)
           ).astype(np.int32)
    rr = (rng.random(P) < 0.15).astype(np.int32) if reset else None
    return sym, sc, ist, icr, rr


def plain(sym, sc, ist, icr, rr, row_offset=0, pos_offset=0):
    keys, state, carry = ssv_sweep_plain(
        *(torch.from_numpy(a) for a in (sym, sc, ist, icr)),
        None if rr is None else torch.from_numpy(rr), row_offset, pos_offset)
    return keys.numpy(), state.numpy(), carry.numpy()


def assert_same(got, want):
    for g, w, name in zip(got, want, ("keys", "final_state", "final_carry")):
        np.testing.assert_array_equal(g, w, err_msg=name)


# (tag, L, P, card, reset, boundary, layout)
CASES = [
    ("card4", 1000, 37, 4, False, True, SMALL),
    ("card4-reset", 901, 45, 4, True, True, SMALL),
    ("card20", 777, 50, 20, False, True, SMALL),
    ("card20-reset", 640, 33, 20, True, True, SMALL),
    ("ragged", 3 * SMALL.span + 5, 20, 4, False, True, SMALL),
    ("p-above-l", 40, 90, 4, True, True, SMALL),
    ("p-of-1", 500, 1, 4, False, True, SMALL),
    ("zero-boundary", 333, 29, 20, False, False, SMALL),
    ("wide-blocks", 2000, 70, 4, True, True, sl.Layout()),
    ("narrow-blocks", 1500, 50, 20, True, True, sl.Layout(threads=64)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulation_matches_plain(case):
    tag, L, P, card, reset, boundary, layout = case
    args = inputs(len(tag) + L, L, P, card, reset, boundary)
    stats = sl.Stats()
    got = sl.sweep_words(*args, row_offset=7, pos_offset=13, layout=layout,
                         stats=stats)
    want = plain(*args, row_offset=7, pos_offset=13)
    assert want[0].size > 0
    assert_same(got, want)
    assert stats.edge_blocks >= 1 and stats.replays >= 1
    if P < L - 3 * layout.span:
        assert stats.interior_blocks >= 1


@pytest.mark.parametrize("card", [4, 20])
def test_emulation_matches_the_jax_reference(card):
    sym, sc, ist, icr, rr = inputs(card, 1500, 41, card, reset=True)
    got = sl.sweep_words(sym, sc, ist, icr, rr, layout=SMALL)
    ref, _ = ssv_reference(sym, sc, ist, icr, reset_rows=rr)
    keys = np.sort((ref.hit_rows << 38) | ref.hit_positions)
    assert_same(got, (keys, ref.final_row_state, ref.final_carry))


def test_dense_hits_decode_every_cell():
    """Scores that hit on most cells: many hits per warp and row, a replay
    in every window; still exact."""
    sym, sc, ist, icr, _ = inputs(3, 800, 30, 4, hi=127)
    sc[:] = np.maximum(sc, 100)
    stats = sl.Stats()
    got = sl.sweep_words(sym, sc, ist, icr, layout=sl.Layout(32, 2, 8, 4),
                         stats=stats)
    want = plain(sym, sc, ist, icr, None)
    assert_same(got, want)
    assert want[0].size > 800 * 30 // 4
    assert stats.max_warp_row_hits > 32
    assert stats.replays >= stats.windows


def test_split_block_fields_are_the_jax_packing():
    """Staged symbol words and initial state words of a block are
    `pack_symbols` / `pack_state` with W3 = V; `unpack_state` reads the
    fields back."""
    layout = sl.Layout(threads=64, words=2)  # V = 128, the JAX lane width
    V = layout.V
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, 2 * layout.span).astype(np.uint8)
    for b in range(2):
        staged = sl.stage_symbols(codes, b * layout.span, V, V)
        np.testing.assert_array_equal(
            staged, pack_symbols(codes, V).reshape(2, V)[b])
    state = rng.integers(0, 256, 2 * layout.span)
    words = sl.pack3(*state.reshape(2, 3, V).transpose(1, 0, 2)).reshape(-1)
    np.testing.assert_array_equal(words, pack_state(state, V).reshape(-1))
    np.testing.assert_array_equal(
        unpack_state(words.reshape(2, 1, V)), state)
    np.testing.assert_array_equal(
        sl.unpack3(words).reshape(3, 2, V).transpose(1, 0, 2),
        state.reshape(2, 3, V))


def test_staged_words_outside_the_sequence_are_zero():
    codes = np.arange(1, 11, dtype=np.uint8) % 4
    staged = sl.stage_symbols(codes, -3, 4, 5)
    fields = sl.unpack3(staged)
    np.testing.assert_array_equal(fields[0], [0, 0, 0, codes[0]])
    np.testing.assert_array_equal(fields[1], codes[2:6])
    np.testing.assert_array_equal(fields[2], [codes[7], codes[8], codes[9], 0])


@pytest.mark.parametrize("card", [4, 5, 20, 32])
def test_match_words_are_the_biased_scores(card):
    """Card 4's bit-plane IMAD construction and the table reads of every
    other card give score + 256 in each field (5-bit codes fit a field)."""
    rng = np.random.default_rng(card)
    codes = rng.integers(0, card, (3, 500))
    row = rng.integers(-128, 128, card).astype(np.int8)
    sym3 = sl.pack3(*codes)
    want = sl.pack3(*(row.astype(np.int64)[codes] + 256))
    np.testing.assert_array_equal(sl.match_tables(sym3, row), want)
    if card == 4:
        np.testing.assert_array_equal(sl.match_card4(sym3, row), want)
        b0, b1 = sl.card4_planes(sym3)
        assert not ((b0 | b1) & ~sl.FM).any()


def test_biased_update_is_the_cell_recurrence():
    """Every (state, score) pair: the field update floors, keeps or hits as
    the recurrence does, and no field disturbs its neighbours."""
    st = np.arange(256)
    sc = np.arange(-128, 128)
    s, m = np.meshgrid(st, sc, indexing="ij")
    s, m = s.reshape(-1), m.reshape(-1)
    true = s + m
    want_state = np.where((true < 0) | (true >= 256), 0, true)
    rng = np.random.default_rng(0)
    perm = [rng.permutation(s.size) for _ in range(3)]
    words = sl.pack3(*(s[p] for p in perm))
    match = sl.pack3(*(m[p] + 256 for p in perm))
    new, hit = sl.update(words, match)
    fields = sl.unpack3(new)
    for f, p in enumerate(perm):
        np.testing.assert_array_equal(fields[f], want_state[p])
        np.testing.assert_array_equal((hit >> (10 * f + 9)) & 1,
                                      (true[p] >= 256).astype(np.int64))
    assert not (hit & ~sl.HM).any()


def test_hit_decode_and_edge_masks():
    diag = np.array([[-2, 0, 5], [10, 11, 12], [30, 31, 32]])
    hit = sl.pack3([1, 0, 1], [0, 0, 1], [1, 1, 0]) << 9
    keys = sl.decode_hits(hit, diag, 4, row_offset=100, pos_offset=1000)
    rows, pos = keys >> 38, keys & ((1 << 38) - 1)
    assert (rows == 104).all()
    assert sorted(pos.tolist()) == [1002, 1009, 1016, 1034, 1035]
    js = np.array([[3, 0, 0], [0, 0, 0], [0, 0, 0]])
    je = np.array([[9, 9, 4], [9, 9, 9], [9, 0, 9]])
    lm = sl.field_live(4, js, je)
    live = sl.unpack3(lm) == sl.FIELD
    np.testing.assert_array_equal(live, [[True, True, False],
                                         [True, True, True],
                                         [True, False, True]])
    assert not sl.field_live(2, js, je)[0] & sl.FIELD


# The row dump on the word body: (tag, L, P, card, reset rows + carry,
# non-zero init state, layout). P above the dump's 384-diagonal span puts
# whole blocks in a triangle; L below it puts one block in both.
DUMP_CASES = [
    ("card4", 1000, 45, 4, False, False, sl.DUMP),
    ("card4-reset-carry", 900, 40, 4, True, False, sl.DUMP),
    ("card20", 700, 33, 20, False, False, sl.DUMP),
    ("card20-reset-carry", 650, 30, 20, True, False, sl.DUMP),
    ("p-above-span", 1000, 450, 4, True, False, sl.DUMP),
    ("both-triangles", 150, 400, 20, True, False, sl.DUMP),
    ("init-state", 800, 60, 4, True, True, sl.DUMP),
    ("small-layout", 800, 50, 4, True, True, SMALL),
]


def dump_inputs(case):
    tag, L, P, card, carry_reset, state, _ = case
    sym, sc, ist, icr, rr = inputs(len(tag) * 7 + L, L, P, card,
                                   reset=carry_reset, boundary=True)
    if not state:
        ist[:] = 0
    if not carry_reset:
        icr[:] = 0
    return sym, sc, ist, icr, rr


def dumped(args, layout):
    """The emulated dump into a buffer of -1s, the sweep's outputs, stats."""
    sym, sc = args[0], args[1]
    dump = np.full((sc.shape[0], sym.shape[0]), -1, np.int16)
    stats = sl.Stats()
    out = sl.sweep_words(*args, row_offset=7, pos_offset=13, layout=layout,
                         stats=stats, dump=dump)
    return dump, out, stats


@pytest.mark.parametrize("case", DUMP_CASES, ids=[c[0] for c in DUMP_CASES])
def test_dump_emulation_matches_the_oracle(case):
    """Every cell stored exactly once with the oracle's state; keys, state
    and carry as an undumped sweep (and the plain version) give them."""
    args = dump_inputs(case)
    sym, sc, ist, icr, rr = args
    dump, out, stats = dumped(args, case[-1])
    _, want = ssv_reference(sym, sc, init_row_state=ist, init_carry=icr,
                            reset_rows=rr, return_matrix=True)
    np.testing.assert_array_equal(dump, want)
    assert stats.dump_writes == sym.shape[0] * sc.shape[0]
    assert_same(out, sl.sweep_words(*args, row_offset=7, pos_offset=13,
                                    layout=case[-1]))
    assert_same(out, plain(*args, row_offset=7, pos_offset=13))


@pytest.mark.parametrize("case", [c for c in DUMP_CASES if not c[5]][:6],
                         ids=[c[0] for c in DUMP_CASES if not c[5]][:6])
def test_dump_emulation_matches_dp_matrix_swar(case):
    """Card 4: the JAX package's `debug_rows` readout of its SWAR kernel
    (interpret mode, nucleotide only), with its carry column and reset
    rows; card 20: the JAX package's oracle matrix. And the port's
    `dp_matrix_oracle` where there is no carry or reset."""
    from havac_tpu.testing import percell as jax_percell
    from havac_tpu_torch.testing.percell import dp_matrix_oracle

    sym, sc, ist, icr, rr = dump_inputs(case)
    dump, _, _ = dumped((sym, sc, ist, icr, rr), case[-1])
    if sc.shape[1] == 4:
        want = jax_percell.dp_matrix_swar(
            sym, sc, init_carry=icr,
            reset_rows=None if rr is None else rr != 0, interpret=True)
    else:
        _, want = ssv_reference(sym, sc, init_carry=icr, reset_rows=rr,
                                return_matrix=True)
    np.testing.assert_array_equal(dump, want)
    if rr is None:
        np.testing.assert_array_equal(dump, dp_matrix_oracle(sym, sc))


def test_edge_blocks_mask_only_the_tiles_where_fields_enter_or_leave():
    """A block of a triangle runs the masked update only in the tiles where
    one of its fields enters or leaves; with P much larger than a block's
    span most of an edge block's tiles are unmasked, and the sweep stays
    exact."""
    layout = sl.Layout(threads=8, words=1, rows=8, window=4)  # span 24
    args = inputs(5, 600, 300, 4, reset=True)
    stats = sl.Stats()
    got = sl.sweep_words(*args, layout=layout, stats=stats)
    assert_same(got, plain(*args))
    assert stats.edge_blocks >= 20
    # At most span / rows + 2 masked tiles a block at each edge.
    assert stats.masked_tiles <= stats.edge_blocks * (layout.span //
                                                      layout.rows + 2)
    assert stats.masked_tiles < stats.tiles // 4


def test_dump_emulation_geometry_is_the_kernels():
    """The row dump's emulated geometry is the kernel's (csrc/ssv_sweep.cu
    kDumpT, kDumpW, as ops/ssv_cuda.py states them)."""
    from havac_tpu_torch.ops import ssv_cuda

    assert sl.DUMP.threads == ssv_cuda.DUMP_THREADS
    assert sl.DUMP.words == ssv_cuda.DUMP_WORDS


# The reset rows' hit windows in the kernel's own tile and window rows
# (64 and 16; 32 threads so that small inputs hold interior blocks):
# (tag, card, reset rows or a pattern, codes at card - 1).
RESET_GEOMETRY = sl.Layout(threads=32, words=2, rows=64, window=16)
RESET_CASES = [
    ("window-first-row", 20, [16, 48, 96, 160], False),
    ("window-last-row", 20, [15, 47, 111, 191], False),
    ("two-in-one-window", 20, [35, 41, 130, 131], False),
    ("tile-with-none", 20, [5, 60, 130, 150], False),
    ("chunk-row-0", 20, [0, 70], False),
    ("codes-top-card5", 5, "models", True),
    ("codes-top-card20", 20, "models", True),
    ("codes-top-card32", 32, "models", True),
]


@pytest.mark.parametrize("case", RESET_CASES, ids=[c[0] for c in RESET_CASES])
def test_reset_windows_match_plain_and_the_jax_reference(case):
    """Only the hit windows that hold a model start run the reset test,
    and the sweep stays exact: starts at a window's first and last row, two
    in one window, a tile with none, a start at the chunk's row 0, and codes
    at card - 1 for cards 5, 20 and 32 (the offsets' largest bytes). In
    interior blocks those windows are the pipeline's count (its
    ``reset_windows``), one set a block."""
    from havac_tpu_torch.engine.pipeline import reset_counts
    from havac_tpu_torch.tools.kbench import model_starts

    tag, card, rows, top = case
    L, P = 1_200, 200
    sym, sc, ist, icr, _ = inputs(len(tag) + card, L, P, card, hi=80)
    if top:
        rng = np.random.default_rng(card)
        sym[rng.random(L) < 0.5] = card - 1
    if rows == "models":
        rr = model_starts(P, 20, seed=card)
    else:
        rr = np.zeros(P, np.int32)
        rr[rows] = 1
    stats = sl.Stats()
    got = sl.sweep_words(sym, sc, ist, icr, rr, row_offset=7, pos_offset=13,
                         layout=RESET_GEOMETRY, stats=stats)
    want = plain(sym, sc, ist, icr, rr, row_offset=7, pos_offset=13)
    assert want[0].size > 0
    assert_same(got, want)
    ref, _ = ssv_reference(sym, sc, ist, icr, reset_rows=rr)
    keys = np.sort(((ref.hit_rows + 7) << 38) | (ref.hit_positions + 13))
    assert_same(got, (keys, ref.final_row_state, ref.final_carry))
    resets, windows = reset_counts(rr)
    assert resets == np.count_nonzero(rr) and 0 < windows < resets + 1
    assert stats.interior_blocks >= 2
    assert stats.interior_reset_windows == stats.interior_blocks * windows
    assert stats.reset_windows < stats.windows
    if rows != "models":
        assert windows == len({r // 16 for r in rows})


@pytest.mark.parametrize("card", [5, 20, 32])
def test_staged_offsets_select_the_biased_scores(card):
    """Other cards' staged entries hold 4 x each code in bytes 0-2 (byte 3
    zero), and three reads at those offsets from the row's field tables
    give score + 256 in each field; an invalid code (up to 255) reads
    inside the tables and their slack."""
    rng = np.random.default_rng(card)
    codes = rng.integers(0, card, 600).astype(np.uint8)
    codes[::7] = card - 1
    V = 200
    entries = sl.stage_offsets(codes, 0, V, V)
    fields = sl.unpack3(sl.stage_symbols(codes, 0, V, V))
    for f in range(3):
        np.testing.assert_array_equal((entries >> (8 * f)) & 0xFF,
                                      4 * fields[f])
    assert not (entries >> 24).any()
    row = rng.integers(-128, 128, card).astype(np.int8)
    want = sl.pack3(*(row.astype(np.int64)[fields] + 256))
    np.testing.assert_array_equal(
        sl.match_offsets(entries, sl.row_tables(row)), want)
    np.testing.assert_array_equal(sl.match_tables(sl.pack3(*fields), row),
                                  want)
    bad = sl.stage_offsets(np.full(3 * V, 255, np.uint8), 0, V, V)
    tab = sl.row_tables(row)
    assert ((4 * sl.MAX_CARD * 2 + (bad >> 16)) // 4 < tab.size).all()
