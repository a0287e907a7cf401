"""The numpy emulation of the narrow roofline kernels
(`havac_tpu_torch/testing/narrow_layout.py`: the int8 field layout of add8 /
int8mix, the packed int16 layout of add16 / int16mix, their instruction
sequences and per-pipe tallies) against the plain PyTorch versions and the
JAX tool `tools/roofline.py` in interpret mode, word for word: the tolerance
is zero. Per lane, the int8 row update and add chain are checked on every
input they can see, the int16 ones on their edges and a seeded sample,
against kernel8's and kernel_add's own int8 / int16 arithmetic. The CUDA
kernels are held to the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from havac_tpu_torch.testing import narrow_layout as NL
from havac_tpu_torch.tools import roofline as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = ("add8", "add16", "int8mix", "int16mix")


@functools.lru_cache(maxsize=None)
def jax_runner(name, ws, k):
    spec = importlib.util.spec_from_file_location(
        "jax_roofline_tool", os.path.join(ROOT, "tools", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_variant(name, ws, k, interpret=True)[0]


def emulated(name, ws, k, reps, copies=1, tally=None, planes=None):
    x = R.make_inputs(name, ws, k)
    if planes is not None:
        x = R.OpMixInputs(name, ws, k, planes, x.scores)
    got = NL.emulate(name, [p.numpy() for p in x.planes],
                     None if x.scores is None else x.scores.numpy(), ws, k,
                     reps, copies, tally)
    return x, got


@pytest.mark.parametrize("name", NARROW)
@pytest.mark.parametrize("ws", [4, 8, 12])
@pytest.mark.parametrize("k", [1, 7, 30])
@pytest.mark.parametrize("reps", [0, 1, 2, 3])
def test_emulation_equals_plain_and_jax_tool(name, ws, k, reps):
    """K = 1 and 7 keep `bits` across reps (no flush), K = 30 ends each rep
    6 rows past its last flush; 3 copies, so that at WS 4 and 8 a field
    thread's lanes cross from one copy into the next."""
    x, got = emulated(name, ws, k, reps, copies=3)
    want = R.op_mix_plain(name, x, reps).numpy()
    assert got.shape == (3, *want.shape) and got.dtype == want.dtype
    for c in range(3):
        np.testing.assert_array_equal(got[c], want)
    run = jax_runner(name, ws, k)
    np.testing.assert_array_equal(
        got[0], np.asarray(run(jnp.asarray([reps], jnp.int32))))


@pytest.mark.parametrize("name", ["int8mix", "int16mix"])
def test_select_takes_any_nonzero_plane_value(name):
    """The one-hot of the winning symbol reads a plane as != 0, whatever its
    value (the planes the tool builds hold 0 and 1 only)."""
    x = R.make_inputs(name, 8, 30)
    rng = np.random.default_rng(5)
    dt = x.planes[0].numpy().dtype
    info = np.iinfo(dt)
    planes = tuple(torch.from_numpy(
        (rng.integers(0, 2, p.shape) * rng.integers(info.min, info.max + 1,
                                                    p.shape)).astype(dt))
        for p in x.planes)
    x2, got = emulated(name, 8, 30, 2, planes=planes)
    np.testing.assert_array_equal(got[0],
                                  R.op_mix_plain(name, x2, 2).numpy())


@pytest.mark.parametrize("ws,copies,tail", [(4, 1, 32), (4, 5, 16), (8, 5, 32),
                                            (12, 5, 0), (64, 5, 16)])
def test_field_threads_cover_the_copies(ws, copies, tail):
    """48 lanes a thread over copies x WS x 512 lanes: each lane read from
    its copy's offset, written once, the last thread holding `tail` lanes
    (16 or 32; 0: a whole thread), a thread's 16-byte chunks never crossing
    an instance."""
    src, valid, dst = NL.field_index(ws, copies)
    n = ws * 512
    flat = dst[valid]
    assert np.array_equal(np.sort(flat), np.arange(n * copies))
    assert np.array_equal(src[valid], flat % n)
    assert valid[-1].sum() == (tail or NL.FIELD_LANES)
    chunks = dst.reshape(-1, 16)
    assert (chunks[:, 0] // n == chunks[:, -1] // n).all()
    lanes = np.arange(NL.FIELD_LANES)[None, :] + np.zeros((2, 1), np.int64)
    assert np.array_equal(NL.unpack_fields(NL.pack_fields(lanes)), lanes)


def kernel8_lane(u, m, dt):
    """kernel8's row for one lane in its own arithmetic: state u, match m
    (both of dtype dt) -> (new state, hit)."""
    u, m = u.astype(dt), m.astype(dt)
    with np.errstate(over="ignore"):
        sumw = (u + m).astype(dt)
    cvec = (u & m) | ((u | m) & ~sumw)
    carry_neg, msign = cvec < 0, m < 0
    reset = carry_neg ^ msign
    return np.where(reset, np.zeros_like(sumw), sumw), carry_neg & ~msign


def test_int8_row_update_on_every_state_and_score():
    """Every (state 0..255, score byte) pair: the field row (w = u + m + 256,
    hit at bit 9, keep iff bit 8 and not bit 9) == kernel8's int8 row, with
    the lanes three a word in every field position."""
    u = np.arange(256)
    for m in range(-128, 128):
        lanes = np.concatenate([u, u[:1], u[:1]])  # 258 = 86 words x 3
        f = (lanes.reshape(-1, 3) << np.array([0, 10, 20])).sum(1)[None]
        c, *d = NL.row_scalars(np.array([[[m, 0, 0, 0]]]), 1)[0, 0]
        zero = np.zeros_like(f)
        new, bits = NL.field_row(f, zero, (zero, zero, zero), int(c),
                                 [int(v) for v in d], NL.Tally())
        got_st = np.stack([(new >> (10 * j)) & 0x3FF for j in range(3)],
                          -1).reshape(-1)
        got_hit = np.stack([(bits >> (10 * j)) & 0x3FF for j in range(3)],
                           -1).reshape(-1)
        want_st, want_hit = kernel8_lane(lanes, np.full(258, m), np.int8)
        np.testing.assert_array_equal(got_st, want_st.view(np.uint8))
        np.testing.assert_array_equal(got_hit, want_hit.astype(np.int64))


def test_int8_add_chain_on_every_state_and_plane():
    """Every (s 0..255, i 0..2) pair: ((s + i) ^ s) & 0xFF in a field ==
    kernel_add's int8 (state + i1) ^ state."""
    s, i = np.meshgrid(np.arange(256), np.arange(3), indexing="ij")
    s, i = s.reshape(-1, 3), i.reshape(-1, 3)  # 768 lanes, 3 a word
    f = (s << np.array([0, 10, 20])).sum(1)[None]
    a = (i << np.array([0, 10, 20])).sum(1)[None]
    out = (((f + a) ^ f) & NL.FIELD_BYTES)
    got = np.stack([(out >> (10 * j)) & 0x3FF for j in range(3)], -1)
    with np.errstate(over="ignore"):
        want = ((s.astype(np.int8) + i.astype(np.int8)).astype(np.int8)
                ^ s.astype(np.int8))
    np.testing.assert_array_equal(got.reshape(s.shape), want.view(np.uint8))


INT16_EDGES = np.array([0, 1, 2, 255, 256, 32766, 32767, 32768, 32769,
                        65534, 65535], np.int64)


def int16_pairs(seed=3, n=4096):
    rng = np.random.default_rng(seed)
    u, m = np.meshgrid(INT16_EDGES, INT16_EDGES, indexing="ij")
    u = np.concatenate([u.reshape(-1), rng.integers(0, 1 << 16, n)])
    m = np.concatenate([m.reshape(-1), rng.integers(0, 1 << 16, n)])
    return u, m


def test_int16_row_update_on_edges_and_a_sample():
    """(state, score) on 0, 32767, 32768 (-32768), 65535 (-1) and their
    neighbours, and a seeded sample: the packed row (add.u16x2, reset and
    hit from the sign bits) == kernel8's int16 row, in both halfwords."""
    u, m = int16_pairs()
    for swap in (False, True):
        lo, hi = (u, np.roll(u, 1)) if not swap else (np.roll(u, 1), u)
        st = (lo | (hi << 16))[:, None]
        mlo, mhi = (m, np.roll(m, 7)) if not swap else (np.roll(m, 7), m)
        zero = np.zeros_like(st)
        c = (mlo | (mhi << 16))[:, None]  # the match word itself
        new, bits = NL.packed_row(st, zero, (), c, (), NL.Tally())
        for lane, uu, mm in ((0, lo, mlo), (1, hi, mhi)):
            want_st, want_hit = kernel8_lane(uu.astype(np.uint16),
                                             mm.astype(np.uint16), np.int16)
            np.testing.assert_array_equal(
                (new[:, 0] >> (16 * lane)) & 0xFFFF,
                want_st.view(np.uint16).astype(np.int64))
            np.testing.assert_array_equal((bits[:, 0] >> (16 * lane)) & 1,
                                          want_hit.astype(np.int64))


def test_int16_add_chain_on_edges_and_a_sample():
    """add.u16x2 then xor == kernel_add's int16 (state + i1) ^ state, and
    the 16x2 add is a wrapping add per halfword."""
    s, i = int16_pairs(seed=4)
    word_s, word_i = s | (np.roll(s, 1) << 16), i | (np.roll(i, 1) << 16)
    out = NL.add16x2(word_s, word_i) ^ word_s
    for lane, ss, ii in ((0, s, i), (1, np.roll(s, 1), np.roll(i, 1))):
        a, b = ss.astype(np.uint16).view(np.int16), \
            ii.astype(np.uint16).view(np.int16)
        with np.errstate(over="ignore"):
            want = ((a + b).astype(np.int16) ^ a).view(np.uint16)
        np.testing.assert_array_equal((out >> (16 * lane)) & 0xFFFF,
                                      want.astype(np.int64))
    np.testing.assert_array_equal(
        NL.add16x2(word_s, word_i) & 0xFFFF, (s + i) & 0xFFFF)


def test_min_ops_are_pinned():
    """The bounds the card's shares are read against (their derivation is
    the comment in havac_tpu_torch/tools/roofline.py)."""
    assert R.MIN_OPS["add8"] == R.MIN_OPS["add16"] == (2, 1)
    assert R.MIN_OPS["int8mix"] == R.MIN_OPS["int16mix"] == (8, 5)


@pytest.mark.parametrize("name", NARROW)
def test_tally_is_at_least_min_ops(name):
    """The emulated instructions a 32-bit word's worth of lanes and row (12
    output words a field thread, 16 a packed one) are at or above MIN_OPS,
    all and INT32-pipe only, so no design reads above 1.0 of its bound."""
    t = NL.Tally()
    emulated(name, 8, 30, 2, tally=t)
    per = t.per_word_row(NL.words_per_thread(name))
    total, logic = R.MIN_OPS[name]
    assert per["total"] >= total and per["int32"] >= logic, per
    # The design's counts, a word: the field add chain is one add and one
    # LOP3 a field word (4/3 a word), the packed one a 16x2 add and a LOP3.
    if name == "add8":
        assert per["total"] == pytest.approx(8 / 3)
        assert per["int32"] == pytest.approx(4 / 3)
    if name == "add16":
        assert (per["vadd"], per["int32"]) == (1, 1)
