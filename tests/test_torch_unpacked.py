"""The unpacked (packing=1) Pallas kernel's paths against the port.

`havac_tpu/ops/ssv_pallas.py` `_ssv_pallas_jit` computes the recurrence of
the port's sweep one cell per int32; the port runs both through
`csrc/ssv_sweep.cu` (on the CPU here: the wrapper's plain route). Each test
holds the port to the JAX kernel in interpret mode exactly: the sweep in
hits, final row state and final carry under `ssv_pallas`'s chaining
contract, the chain state carried across with `convert.state_from_unpacked`,
and the engine against the JAX engine's packing=1 pipelined path.
"""

import numpy as np
import pytest
import torch

from havac_tpu.engine import Havac as JaxHavac
from havac_tpu.io.fasta import load_fasta_database
from havac_tpu.ops.common import SsvKernelConfig
from havac_tpu.ops.ssv_pallas import _ssv_pallas_jit, ssv_pallas
from havac_tpu.testing.generator import generate_planted_fixture
from havac_tpu_torch.convert import (database_from_reference,
                                     profile_hmms_from_reference,
                                     state_from_unpacked)
from havac_tpu_torch.engine import Havac
from havac_tpu_torch.ops import ssv_cuda

BW, K = 1024, 8
CFG = SsvKernelConfig(block_width=BW, rows_per_strip=K, max_hit_tiles=512,
                      interpret=True)


def random_case(seed, L, P):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, L).astype(np.uint8),
            rng.integers(-40, 100, (P, 4)).astype(np.int8),
            rng.integers(0, 256, L).astype(np.int32),
            rng.integers(0, 256, P + 1).astype(np.int32))


def keys_of(rows, pos):
    return np.sort((np.asarray(rows, np.int64) << 38)
                   | np.asarray(pos, np.int64))


@pytest.mark.parametrize("L,P", [(2048, 16), (3072, 24), (1500, 13),
                                 (1024, 21), (2500, 8)])
def test_sweep_matches_ssv_pallas(L, P):
    """Hits always; final row state when P is a multiple of the strip
    height, final carry when L is a multiple of the block width (the JAX
    wrapper pads to both and its edges are meaningful only then)."""
    symbols, scores, istate, icarry = random_case(L + P, L, P)
    rows, pos, state, carry = ssv_pallas(symbols, scores, istate, icarry,
                                         config=CFG)
    res = ssv_cuda.ssv_sweep(*(torch.from_numpy(a) for a in
                               (symbols, scores, istate, icarry)))
    assert rows.size > 0
    np.testing.assert_array_equal(np.sort(res.keys.numpy()),
                                  keys_of(rows, pos))
    if P % K == 0:
        np.testing.assert_array_equal(res.final_state.numpy(), state)
    if L % BW == 0:
        np.testing.assert_array_equal(res.final_carry.numpy(), carry)


def test_state_from_unpacked_resumes_the_chain():
    """The unpacked kernel sweeps the first row chunk; its (B, WS, 128)
    ostate, read by state_from_unpacked, starts the port's sweep of the
    remaining rows, and the two chunks together give the JAX hits and final
    state of the whole sweep."""
    L, P, P1 = 2048, 24, 16
    symbols, scores, istate, icarry = random_case(5, L, P)
    B, WS = L // BW, BW // 128
    ostate = _ssv_pallas_jit(
        symbols.astype(np.int8).reshape(B, WS, 128),
        scores[:P1].astype(np.int32).reshape(P1 // K, K, 4),
        istate.reshape(B, WS, 128), icarry[:P1 + 1], block_width=BW,
        rows_per_strip=K, max_hit_tiles=512, interpret=True)[0]
    ostate = np.asarray(ostate)
    assert ostate.shape == (B, WS, 128)
    state = state_from_unpacked(ostate, "cpu")
    assert state.dtype == torch.int32 and state.shape == (L,)

    rows1, pos1, state1, _ = ssv_pallas(symbols, scores[:P1], istate,
                                        icarry[:P1 + 1], config=CFG)
    np.testing.assert_array_equal(state.numpy(), state1)
    rest = ssv_cuda.ssv_sweep(torch.from_numpy(symbols),
                              torch.from_numpy(scores[P1:].copy()), state,
                              torch.from_numpy(icarry[P1:].copy()),
                              row_offset=P1)
    rows, pos, whole_state, _ = ssv_pallas(symbols, scores, istate, icarry,
                                           config=CFG)
    got = np.sort(np.concatenate([keys_of(rows1, pos1),
                                  rest.keys.numpy()]))
    np.testing.assert_array_equal(got, keys_of(rows, pos))
    np.testing.assert_array_equal(rest.final_state.numpy(), whole_state)


@pytest.fixture(scope="module")
def planted_db():
    models, records = generate_planted_fixture(
        seed=29, model_length=30, sequence_length=2500, num_models=3)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    return models, load_fasta_database(fasta, pad_multiple=BW, is_text=True)


@pytest.mark.parametrize("jax_chunks,port_chunks", [
    ((1 << 24, 8160), (1 << 24, 8160)), ((1024, 48), (1777, 37))])
def test_engine_matches_jax_packing1_pipeline(planted_db, jax_chunks,
                                              port_chunks):
    """The JAX engine's packing=1 pipelined path (the unpacked kernel in
    interpret mode, chunk state chained through it) against the port's
    engine: identical resolved and raw hits."""
    models, db = planted_db
    ref = JaxHavac(p_value=0.05, config=CFG, backend="pallas_interpret",
                   chunk_symbols=jax_chunks[0], chunk_rows=jax_chunks[1])
    ref.load_phmm(models).load_sequence(db).run()
    assert ref.config.packing == 1
    ours = Havac(p_value=0.05, device="cpu", pad_multiple=BW,
                 chunk_symbols=port_chunks[0], chunk_rows=port_chunks[1])
    ours.load_phmm(profile_hmms_from_reference(models))
    ours.load_sequence(database_from_reference(db)).run()
    a, b = ours.hits(), ref.hits()
    assert len(a) == len(b) > 0
    assert a.as_tuples() == b.as_tuples()
    for x, y in zip(ours.raw_hits(), ref.raw_hits()):
        np.testing.assert_array_equal(x, y)
