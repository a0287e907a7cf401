"""`havac_tpu_torch.convert`: the JAX engine's state in the port's tensors."""

import os

import numpy as np
import torch

from havac_tpu.engine import Havac as JaxHavac
from havac_tpu.engine import HavacRunState
from havac_tpu.io.fasta import load_fasta_database
from havac_tpu.ops.common import SsvKernelConfig
from havac_tpu.ops.ssv_swar import pack_state, unpack_state
from havac_tpu.testing.generator import generate_planted_fixture
from havac_tpu_torch.convert import (checkpoint_from_reference,
                                     database_from_reference,
                                     from_reference_engine,
                                     profile_hmms_from_reference,
                                     state_from_swar)
from havac_tpu_torch.engine import Havac

P_VALUE = 0.05
CFG = SsvKernelConfig(block_width=1024, rows_per_strip=8, interpret=True)


def fasta_text(records):
    return "".join(f">{name}\n{seq}\n" for name, seq in records)


def test_from_reference_engine_carries_unbiased_state():
    models, records = generate_planted_fixture(seed=91, model_length=36,
                                               sequence_length=2000,
                                               num_models=3)
    ref = JaxHavac(p_value=P_VALUE, config=CFG, backend="xla",
                   isolate_models=True, strand="both")
    ref.load_phmm(models).load_sequence(fasta_text(records), is_text=True)
    got = from_reference_engine(ref, "cpu")
    assert got.scores.dtype == torch.int8
    np.testing.assert_array_equal(got.scores.numpy(), ref.scores)
    assert int(got.scores.min()) >= -128 and got.scores.shape[1] == 4
    np.testing.assert_array_equal(got.phmm_prefix.numpy(), ref.phmm_prefix)
    np.testing.assert_array_equal(got.reset_rows.numpy(),
                                  ref.reset_rows.astype(np.int32))
    np.testing.assert_array_equal(got.codes.numpy(), ref.database.codes)
    np.testing.assert_array_equal(got.starts.numpy(), ref.database.starts)
    np.testing.assert_array_equal(got.lengths.numpy(), ref.database.lengths)
    assert (got.alphabet, got.strand) == ("dna", "both")
    plain = JaxHavac(p_value=P_VALUE, config=CFG, backend="xla")
    plain.load_phmm(models).load_sequence(fasta_text(records), is_text=True)
    assert from_reference_engine(plain, "cpu").reset_rows is None


def test_state_from_swar_matches_unpack_state():
    rng = np.random.default_rng(0)
    block_words = 3072 // 3
    vals = rng.integers(0, 256, 3 * 3072).astype(np.int32)
    packed = pack_state(vals, block_words)
    got = state_from_swar(packed, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), vals)
    np.testing.assert_array_equal(got.numpy(), unpack_state(packed))


class _JaxAbortAfterCheckpoint(JaxHavac):
    """The JAX engine, stopped right after its first pipelined checkpoint."""

    def _build_pipelined_sweep(self):
        sweep = super()._build_pipelined_sweep()
        run = sweep.run

        def run_then_abort(abort_event, progress, lookahead=None,
                           checkpoint_cb=None, resume=None):
            def cb(*payload):
                checkpoint_cb(*payload)
                abort_event.set()

            return run(abort_event, progress, lookahead=lookahead,
                       checkpoint_cb=cb, resume=resume)

        sweep.run = run_then_abort
        return sweep


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the JAX pipelined engine wrote mid-run reads back
    through checkpoint_from_reference, and the port's engine continues the
    same run from it (same fingerprint, same chunk geometry) to the JAX
    engine's hits."""
    ckpt = str(tmp_path / "pipe.ckpt.npz")
    models, records = generate_planted_fixture(
        seed=37, model_length=24, sequence_length=3000, num_models=2)
    db = load_fasta_database(fasta_text(records), pad_multiple=1024,
                             is_text=True)
    first = _JaxAbortAfterCheckpoint(p_value=P_VALUE, config=CFG,
                                     backend="pallas_interpret",
                                     chunk_symbols=1024, checkpoint_path=ckpt)
    first.load_phmm(models).load_sequence(db).run_async()
    assert first.wait(timeout=300) == HavacRunState.ABORTED
    next_ci, carries, rows, pos, fingerprint = checkpoint_from_reference(ckpt)
    assert next_ci == 1 and carries.shape == (1, 49)
    assert carries.dtype == np.int32 and rows.shape == pos.shape

    ours = Havac(p_value=P_VALUE, device="cpu", pad_multiple=1024,
                 chunk_symbols=1024, chunk_rows=48, checkpoint_path=ckpt)
    ours.load_phmm(profile_hmms_from_reference(models))
    ours.load_sequence(database_from_reference(db))
    assert ours._fingerprint(3072, 48, 1024, 48) == fingerprint
    ours.run()
    assert ours.resumed_chunks == 1
    assert not os.path.exists(ckpt)
    whole = JaxHavac(p_value=P_VALUE, config=CFG, backend="xla")
    whole.load_phmm(models).load_sequence(db).run()
    assert ours.hits().as_tuples() == whole.hits().as_tuples()
    for x, y in zip(ours.raw_hits(), whole.raw_hits()):
        np.testing.assert_array_equal(x, y)
