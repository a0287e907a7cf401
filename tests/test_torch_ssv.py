"""The port's plain PyTorch sweep against the JAX package's SSV functions.

Every case holds `havac_tpu_torch.ops.ssv_torch.ssv_sweep_plain` (and the
device-dispatching wrapper `ssv_cuda.ssv_sweep`, which takes the plain
version for CPU tensors) to exact integer equality with the numpy oracle
`ssv_reference`, the XLA scan `ssv_scan_xla`, and the Pallas SWAR kernel
`ssv_swar` in interpret mode, on the fixtures of test_oracle.py,
test_ssv_xla.py, test_ssv_swar.py, test_amino.py and test_fuzz_parity.py.
State and carry are compared where each JAX contract defines them (SWAR:
state iff P % 30 == 0, carry iff additionally L % block_width == 0; XLA:
state iff P % rows_per_strip == 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from havac_tpu.hits.decode import decode_dense_bitmaps
from havac_tpu.ops.reference import ssv_reference
from havac_tpu.ops.ssv_swar import ROWS_PER_STRIP, ssv_swar
from havac_tpu.ops.ssv_xla import ssv_scan_xla
from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.ops.ssv_torch import ssv_sweep_plain

BW = 3072  # smallest SWAR block width


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def plain(symbols, scores, init_state=None, init_carry=None, reset=None,
          row_offset=0, pos_offset=0):
    """(rows, positions, final_state, final_carry) as numpy, hits sorted."""
    L, P = symbols.shape[0], scores.shape[0]
    ist = np.zeros(L, np.int32) if init_state is None else init_state
    icr = np.zeros(P + 1, np.int32) if init_carry is None else init_carry
    rr = None if reset is None else t(np.asarray(reset, dtype=np.int32))
    keys, state, carry = ssv_sweep_plain(
        t(symbols.astype(np.uint8)), t(scores.astype(np.int8)),
        t(ist.astype(np.int32)), t(icr.astype(np.int32)), rr,
        row_offset, pos_offset)
    k = keys.numpy()
    return k >> 38, k & ((1 << 38) - 1), state.numpy(), carry.numpy()


def random_case(seed, L, P, lo=-40, hi=120, card=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, card, size=L).astype(np.uint8),
            rng.integers(lo, hi, size=(P, card)).astype(np.int8))


def pairs(rows, pos):
    return set(zip(np.asarray(rows).tolist(), np.asarray(pos).tolist()))


def assert_matches_reference(symbols, scores, init_state=None,
                             init_carry=None, reset=None, expect_hits=True):
    want, _ = ssv_reference(symbols, scores, init_row_state=init_state,
                            init_carry=init_carry, reset_rows=reset)
    rows, pos, state, carry = plain(symbols, scores, init_state, init_carry,
                                    reset)
    np.testing.assert_array_equal(rows, want.hit_rows)
    np.testing.assert_array_equal(pos, want.hit_positions)
    np.testing.assert_array_equal(state, want.final_row_state)
    np.testing.assert_array_equal(carry, want.final_carry)
    if expect_hits:
        assert rows.size > 0


# ------------------------------------------------------------ vs ssv_reference

def _planted():
    from havac_tpu.io.fasta import encode_database
    from havac_tpu.scoring.reprojection import project_models
    from havac_tpu.testing.generator import generate_planted_fixture

    models, seqs = generate_planted_fixture(seed=7, model_length=64,
                                            sequence_length=4000)
    db = encode_database([n for n, _ in seqs], [s.encode() for _, s in seqs],
                         pad_multiple=BW)
    return db.codes, project_models(models, p_value=0.02)


REFERENCE_CASES = {
    **{f"oracle-hot-{s}": (lambda s=s: random_case(s, 97, 23))
       for s in range(5)},
    "oracle-cold": lambda: random_case(99, 97, 23, lo=-128, hi=40),
    "xla-257x64": lambda: random_case(0, 257, 64),
    "xla-1000x96": lambda: random_case(1, 1000, 96),
    "swar-ragged-2000x17": lambda: random_case(3, 2000, 17),
    "amino-2048x64": lambda: random_case(13, 2048, 64, -40, 70, card=20),
    "planted": _planted,
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_plain_matches_reference(case):
    symbols, scores = REFERENCE_CASES[case]()
    assert_matches_reference(symbols, scores,
                             expect_hits=case != "oracle-cold")


@pytest.mark.parametrize("card", [4, 20])
def test_plain_boundary_and_reset_match_reference(card):
    """Non-zero incoming row state and carry column, and isolation reset
    rows (row 0 among them)."""
    rng = np.random.default_rng(40 + card)
    symbols, scores = random_case(41 + card, 1500, 77, -40, 90, card=card)
    ist = rng.integers(0, 256, 1500).astype(np.int32)
    icr = rng.integers(0, 256, 78).astype(np.int32)
    reset = rng.random(77) < 0.1
    reset[0] = True
    assert_matches_reference(symbols, scores, ist, icr)
    assert_matches_reference(symbols, scores, ist, icr, reset)


def test_plain_key_offsets():
    symbols, scores = random_case(5, 400, 30)
    rows, pos, _, _ = plain(symbols, scores)
    r2, p2, _, _ = plain(symbols, scores, row_offset=1000, pos_offset=7)
    np.testing.assert_array_equal(r2, rows + 1000)
    np.testing.assert_array_equal(p2, pos + 7)


def test_row_and_column_chunk_chaining():
    """Cutting the matrix into a 3 x 2 grid of sweeps chained through the
    row state (down) and the carry column (across) gives the whole
    matrix's hits, state and carry: the engine's chunk contract."""
    symbols, scores = random_case(4, 301, 64)
    want, _ = ssv_reference(symbols, scores)
    cols, rws = [0, 128, 211, 301], [0, 29, 64]
    got = set()
    carry_in = np.zeros(65, np.int32)
    for c0, c1 in zip(cols, cols[1:]):
        state = np.zeros(c1 - c0, np.int32)
        carry_out = np.zeros(65, np.int32)
        for r0, r1 in zip(rws, rws[1:]):
            r, p, state, carry = plain(symbols[c0:c1], scores[r0:r1], state,
                                       carry_in[r0:r1 + 1], row_offset=r0,
                                       pos_offset=c0)
            got |= pairs(r, p)
            carry_out[r0 + 1:r1 + 1] = carry[1:]
            if r0 == 0:
                carry_out[0] = carry[0]
        carry_in = carry_out
    assert got == pairs(want.hit_rows, want.hit_positions)
    np.testing.assert_array_equal(state, want.final_row_state[211:])
    np.testing.assert_array_equal(carry_in, want.final_carry)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), L=st.integers(1, 300),
       P=st.integers(1, 40), card=st.sampled_from([4, 20]),
       boundary=st.booleans(), isolate=st.booleans())
def test_fuzz_plain_vs_reference(seed, L, P, card, boundary, isolate):
    """test_fuzz_parity.py's randomized net, at hypothesis-chosen shapes."""
    rng = np.random.default_rng(seed)
    lo = int(rng.integers(-128, -20))
    hi = int(rng.integers(lo + 10, 128))
    symbols, scores = (rng.integers(0, card, L).astype(np.uint8),
                       rng.integers(lo, hi, (P, card)).astype(np.int8))
    ist = rng.integers(0, 256, L).astype(np.int32) if boundary else None
    icr = rng.integers(0, 256, P + 1).astype(np.int32) if boundary else None
    reset = (rng.random(P) < 0.2) if isolate else None
    assert_matches_reference(symbols, scores, ist, icr, reset,
                             expect_hits=False)


# ------------------------------------------------------------- vs ssv_scan_xla

@pytest.mark.parametrize("case", ["card4", "card20", "isolate"])
def test_plain_matches_xla_scan(case):
    K = 32
    card = 20 if case == "card20" else 4
    L, P = (2048, 64) if card == 20 else (1000, 96)
    symbols, scores = random_case(13 if card == 20 else 1, L, P, -40,
                                  70 if card == 20 else 120, card=card)
    rng = np.random.default_rng(2000)
    ist = rng.integers(0, 256, L).astype(np.int32)
    icr = rng.integers(0, 256, P + 1).astype(np.int32)
    reset = None
    if case == "isolate":
        reset = rng.random(P) < 0.1
        reset[0] = True
    bitmaps, state, carry = ssv_scan_xla(
        jnp.asarray(symbols), jnp.asarray(scores), jnp.asarray(ist),
        jnp.asarray(icr),
        None if reset is None else jnp.asarray(reset.astype(np.int32)),
        rows_per_strip=K)
    rows, pos = decode_dense_bitmaps(np.asarray(bitmaps), K)
    r, p, s, c = plain(symbols, scores, ist, icr, reset)
    np.testing.assert_array_equal(r, rows)
    np.testing.assert_array_equal(p, pos)
    np.testing.assert_array_equal(s, np.asarray(state))
    np.testing.assert_array_equal(c, np.asarray(carry))
    assert r.size > 0


# ---------------------------------------------------- vs ssv_swar (interpret)

@pytest.mark.parametrize("case", ["field-seams", "multi-block-boundary",
                                  "ragged-isolate"])
def test_plain_matches_swar_kernel(case):
    """Multi-strip sweeps with chains across the SWAR field seams and block
    boundaries, non-zero boundary state, and ragged isolated sweeps."""
    rng = np.random.default_rng(17)
    ist = icr = reset = None
    if case == "field-seams":
        symbols = rng.integers(0, 4, size=2 * BW).astype(np.uint8)
        scores = np.full((2 * ROWS_PER_STRIP, 4), 5, dtype=np.int8)
    elif case == "multi-block-boundary":
        symbols, scores = random_case(2, 3 * BW, ROWS_PER_STRIP)
        ist = rng.integers(0, 256, 3 * BW).astype(np.int32)
        icr = rng.integers(0, 256, ROWS_PER_STRIP + 1).astype(np.int32)
    else:
        symbols, scores = random_case(3, 2000, 17)
        reset = rng.random(17) < 0.2
    rows, pos, state, carry = ssv_swar(
        symbols, scores, init_state=ist, init_carry=icr, block_width=BW,
        interpret=True, reset_rows=reset)
    r, p, s, c = plain(symbols, scores, ist, icr, reset)
    assert r.size > 0
    np.testing.assert_array_equal(r, rows)
    np.testing.assert_array_equal(p, pos)
    if scores.shape[0] % ROWS_PER_STRIP == 0:
        np.testing.assert_array_equal(s, state)
        if symbols.shape[0] % BW == 0:
            np.testing.assert_array_equal(c, carry)


# ------------------------------------------------ wrapper: cap, regrow, guards

def test_launch_cap_keeps_exact_count():
    """A key buffer smaller than the hit count holds the first keys and the
    exact count (the kernel's contract, emulated for CPU tensors)."""
    symbols, scores = random_case(0, 257, 64)
    out = ssv_cuda.SweepBuffers.empty(257, 64, 5, "cpu")
    ssv_cuda.launch(t(symbols), t(scores), torch.zeros(257, dtype=torch.int32),
                    torch.zeros(65, dtype=torch.int32), None, 0, 0, out)
    r, p, _, _ = plain(symbols, scores)
    assert int(out.count[0]) == r.size > 5
    np.testing.assert_array_equal(out.keys.numpy(), ((r << 38) | p)[:5])


@pytest.mark.parametrize("cap", [1, 100, 1 << 20])
def test_ssv_sweep_regrows_once_to_exact_count(cap):
    symbols, scores = random_case(1, 1000, 96)
    res = ssv_cuda.ssv_sweep(t(symbols), t(scores), cap=cap)
    r, p, s, c = plain(symbols, scores)
    assert res.count == r.size and res.regrown == (cap < r.size)
    np.testing.assert_array_equal(np.sort(res.keys.numpy()), (r << 38) | p)
    np.testing.assert_array_equal(res.final_state.numpy(), s)
    np.testing.assert_array_equal(res.final_carry.numpy(), c)


@pytest.mark.parametrize("bad", ["symbols-dtype", "scores-dtype", "card-33",
                                 "state-shape", "carry-shape", "reset-dtype",
                                 "row-key-range", "pos-key-range",
                                 "symbol-range", "meta-device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    L, P = 64, 8
    args = dict(symbols=torch.zeros(L, dtype=torch.uint8),
                scores=torch.zeros(P, 4, dtype=torch.int8),
                init_state=torch.zeros(L, dtype=torch.int32),
                init_carry=torch.zeros(P + 1, dtype=torch.int32),
                reset_rows=None, row_offset=0, pos_offset=0)
    if bad == "symbols-dtype":
        args["symbols"] = torch.zeros(L, dtype=torch.int32)
    elif bad == "scores-dtype":
        args["scores"] = torch.zeros(P, 4, dtype=torch.int32)
    elif bad == "card-33":
        args["scores"] = torch.zeros(P, 33, dtype=torch.int8)
    elif bad == "state-shape":
        args["init_state"] = torch.zeros(L + 1, dtype=torch.int32)
    elif bad == "carry-shape":
        args["init_carry"] = torch.zeros(P, dtype=torch.int32)
    elif bad == "reset-dtype":
        args["reset_rows"] = torch.zeros(P, dtype=torch.bool)
    elif bad == "row-key-range":
        args["row_offset"] = (1 << 25) - 4
    elif bad == "pos-key-range":
        args["pos_offset"] = (1 << 38) - 10
    elif bad == "symbol-range":
        args["symbols"] = torch.full((L,), 4, dtype=torch.uint8)
    elif bad == "meta-device":
        args = {k: (v.to("meta") if torch.is_tensor(v) else v)
                for k, v in args.items()}
    with pytest.raises(ValueError):
        ssv_cuda.ssv_sweep(**args)
