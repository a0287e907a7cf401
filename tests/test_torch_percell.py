"""The port's per-cell DP matrices (`havac_tpu_torch.testing.percell`)
against the JAX package's (`havac_tpu.testing.percell`), cell for cell.

Tolerance 0: the recurrence is integer. The JAX kernels run in interpret
mode, as tests/test_percell.py runs them. On the CPU the port's kernel
functions take the wrapper's CPU route (the plain version); the card tests
in tests/test_torch_cuda.py hold the kernel itself to the same matrices.
"""

import numpy as np
import pytest
import torch

from havac_tpu.ops.reference import ssv_reference
from havac_tpu.testing import percell as jax_percell
from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.testing.percell import (CellMismatch, compare_matrices,
                                             dp_matrix_kernel,
                                             dp_matrix_oracle,
                                             dp_matrix_rows, dp_matrix_torch)

PORT = [dp_matrix_torch, dp_matrix_rows, dp_matrix_kernel]


def case(seed, L, P, card=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, card, size=L).astype(np.uint8),
            rng.integers(-40, 110, size=(P, card)).astype(np.int8))


def carry_and_resets(seed, P):
    rng = np.random.default_rng(seed)
    reset = np.zeros(P, dtype=bool)
    reset[[0, P // 3, (2 * P) // 3]] = True
    return rng.integers(0, 256, size=P + 1).astype(np.int32), reset


def assert_same(expected, actual):
    assert tuple(actual.shape) == expected.shape
    assert actual.dtype == torch.uint8
    assert compare_matrices(expected, actual) == []


@pytest.fixture(scope="module")
def pallas_case():
    symbols, scores = case(2, L=1500, P=12)
    return symbols, scores, jax_percell.dp_matrix_pallas(symbols, scores,
                                                         interpret=True)


@pytest.mark.parametrize("fn", PORT, ids=lambda f: f.__name__)
def test_port_matches_dp_matrix_pallas(pallas_case, fn):
    """The unpacked kernel read out row by row (`dp_matrix_pallas`)."""
    symbols, scores, want = pallas_case
    assert_same(want, fn(symbols, scores))


@pytest.fixture(scope="module")
def swar_cases():
    """The SWAR kernel's debug_rows dump: one case with P not a strip
    multiple, one across two kernel blocks with a non-zero carry column and
    reset rows."""
    symbols, scores = case(6, L=3000, P=47)
    plain = (symbols, scores, None, None,
             jax_percell.dp_matrix_swar(symbols, scores, interpret=True))
    symbols, scores = case(8, L=4000, P=35)
    icarry, reset = carry_and_resets(8, 35)
    carried = (symbols, scores, icarry, reset,
               jax_percell.dp_matrix_swar(symbols, scores, init_carry=icarry,
                                          reset_rows=reset, interpret=True))
    return {"plain": plain, "carry-reset": carried}


@pytest.mark.parametrize("fn,which", [
    (dp_matrix_torch, "plain"), (dp_matrix_rows, "plain"),
    (dp_matrix_kernel, "plain"), (dp_matrix_torch, "carry-reset"),
    (dp_matrix_kernel, "carry-reset")],
    ids=lambda x: getattr(x, "__name__", x))
def test_port_matches_dp_matrix_swar(swar_cases, fn, which):
    symbols, scores, icarry, reset, want = swar_cases[which]
    if which == "plain":
        got = fn(symbols, scores)
    else:
        got = fn(symbols, scores, init_carry=icarry, reset_rows=reset)
    assert_same(want, got)


@pytest.mark.parametrize("card", [4, 20])
@pytest.mark.parametrize("fn", PORT, ids=lambda f: f.__name__)
def test_port_matches_oracle(fn, card):
    symbols, scores = case(11 + card, L=900, P=40, card=card)
    assert_same(dp_matrix_oracle(symbols, scores), fn(symbols, scores))


def test_row_by_row_readout_drops_the_carry_like_dp_matrix_pallas():
    """dp_matrix_rows starts every row from a zero carry (as each single-row
    Pallas dispatch does); dp_matrix_kernel takes init_carry (as
    dp_matrix_swar does). With a non-zero carry the two differ, and each
    equals its own oracle."""
    symbols, scores = case(21, L=600, P=20)
    icarry, reset = carry_and_resets(21, 20)
    _, want = ssv_reference(symbols, scores, init_carry=icarry,
                            reset_rows=reset, return_matrix=True)
    carried = dp_matrix_kernel(symbols, scores, init_carry=icarry,
                               reset_rows=reset)
    assert_same(want, carried)
    assert_same(dp_matrix_oracle(symbols, scores),
                dp_matrix_rows(symbols, scores))
    assert compare_matrices(carried, dp_matrix_rows(symbols, scores))


def test_dumped_sweep_keeps_every_other_output():
    """A sweep with a dump gives the keys, count, final state and carry of
    one without; the dump holds every cell whatever the buffer held."""
    symbols, scores = case(31, L=700, P=30)
    icarry, reset = carry_and_resets(31, 30)
    rng = np.random.default_rng(31)
    args = [torch.from_numpy(a) for a in (
        symbols, scores, rng.integers(0, 256, 700).astype(np.int32), icarry,
        reset.astype(np.int32))]
    plain = ssv_cuda.ssv_sweep(*args, row_offset=2, pos_offset=5)
    _, want = ssv_reference(symbols, scores, init_row_state=args[2].numpy(),
                            init_carry=icarry, reset_rows=reset,
                            return_matrix=True)
    for fill in (0x00, 0xFF):
        dump = torch.full((30, 700), fill, dtype=torch.uint8)
        res = ssv_cuda.ssv_sweep(*args, row_offset=2, pos_offset=5, dump=dump)
        assert res.count == plain.count > 0
        assert torch.equal(res.keys, plain.keys)
        assert torch.equal(res.final_state, plain.final_state)
        assert torch.equal(res.final_carry, plain.final_carry)
        assert_same(want, dump)


def test_dump_buffer_need_not_be_aligned():
    """The wrapper takes a contiguous (P, L) uint8 view at any offset, here
    one byte in (the kernel aligns its bulk copies by address)."""
    symbols, scores = (torch.from_numpy(a) for a in case(43, L=64, P=8))
    want = torch.empty(8, 64, dtype=torch.uint8)
    ssv_cuda.ssv_sweep(symbols, scores, dump=want)
    dump = torch.zeros(8 * 64 + 1, dtype=torch.uint8)[1:].view(8, 64)
    ssv_cuda.ssv_sweep(symbols, scores, dump=dump)
    assert torch.equal(dump, want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "transposed", "device"])
def test_wrapper_rejects_a_bad_dump_buffer(bad):
    symbols, scores = (torch.from_numpy(a) for a in case(41, L=64, P=8))
    dump = {"dtype": torch.zeros(8, 64, dtype=torch.int32),
            "shape": torch.zeros(8, 65, dtype=torch.uint8),
            "transposed": torch.zeros(64, 8, dtype=torch.uint8).t(),
            "device": torch.zeros(8, 64, dtype=torch.uint8, device="meta"),
            }[bad]
    with pytest.raises(ValueError):
        ssv_cuda.ssv_sweep(symbols, scores, dump=dump)


def test_compare_matrices_reports_first_mismatches():
    symbols, scores = case(3, L=300, P=8)
    m = dp_matrix_torch(symbols, scores)
    bad = m.clone()
    bad[4, 100] += 1
    bad[7, 2] ^= 1
    assert compare_matrices(m, bad) == [
        CellMismatch(4, 100, int(m[4, 100]), int(bad[4, 100])),
        CellMismatch(7, 2, int(m[7, 2]), int(bad[7, 2]))]
    assert len(compare_matrices(m, m ^ 1, max_report=5)) == 5
    # numpy (the JAX functions' int32 matrices) against a tensor
    assert compare_matrices(dp_matrix_oracle(symbols, scores), m) == []
    with pytest.raises(ValueError):
        compare_matrices(m, m[:-1])
