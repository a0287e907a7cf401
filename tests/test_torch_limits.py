"""Searches past the hit-key bounds: the port returns the JAX engine's hits.

The u64 key (row << 38) | pos holds global coordinates only for fewer than
2^25 model rows, 2^38 database positions and sequences shorter than 2^31.
Past them the port launches chunks with chunk-local keys and resolves int64
(row, position) pairs on the host. ``monkeypatch`` lowers those bounds so
that a small collection and a small database cross them; every resolved
field, in order, and the raw hits must equal the JAX engine's.
"""

import os

import numpy as np
import pytest

from havac_tpu.engine import Havac as JaxHavac
from havac_tpu.io.fasta import load_fasta_database
from havac_tpu.ops.common import SsvKernelConfig
from havac_tpu.testing.generator import generate_planted_fixture
from havac_tpu_torch.convert import database_from_reference as port_db
from havac_tpu_torch.convert import profile_hmms_from_reference as port_models
from havac_tpu_torch.engine import Havac, HavacRunState, pipeline

P_VALUE = 0.05
CFG = SsvKernelConfig(block_width=1024, rows_per_strip=8, max_hit_tiles=512,
                      interpret=True)
FIELDS = ("sequence_index", "sequence_position", "phmm_index",
          "phmm_position", "strand")
# The bound each case lowers, and to what: the collection has 125 rows, the
# padded database 6,144 positions, its one sequence 6,000 symbols.
LIMITS = {"rows": ("KEY_ROWS", 100), "positions": ("KEY_POSITIONS", 5_000),
          "sequence": ("KEY_SEQUENCE", 4_000), "inside": (None, None)}


@pytest.fixture(scope="module")
def fixture():
    models, records = generate_planted_fixture(
        seed=19, model_length=25, sequence_length=6000, num_models=5)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    db = load_fasta_database(fasta, pad_multiple=1024, is_text=True)
    ref = JaxHavac(p_value=P_VALUE, config=CFG, backend="xla",
                   chunk_symbols=2048, chunk_rows=48)
    ref.load_phmm(models).load_sequence(db).run()
    assert len(ref.hits()) > 0
    return port_models(models), port_db(db), ref


def assert_same_run(ours, ref):
    a, b = ours.hits(), ref.hits()
    assert len(a) == len(b) > 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for x, y in zip(ours.raw_hits(), ref.raw_hits()):
        np.testing.assert_array_equal(x, y)


def lower(monkeypatch, case):
    name, value = LIMITS[case]
    if name is not None:
        monkeypatch.setattr(pipeline, name, value)


@pytest.mark.parametrize("case", sorted(LIMITS))
def test_past_the_key_bounds_matches_jax(fixture, monkeypatch, case):
    """Each bound crossed alone (and none) gives the JAX engine's hits, with
    uneven chunk cuts on both axes; inside the bounds the key path runs."""
    models, db, ref = fixture
    lower(monkeypatch, case)
    ours = Havac(p_value=P_VALUE, device="cpu", pad_multiple=1024,
                 chunk_symbols=1777, chunk_rows=37)
    ours.load_phmm(models).load_sequence(db)
    sweep = ours._build_sweep()
    assert sweep.keyform == (case == "inside")
    ours.run()
    assert ours.state == HavacRunState.COMPLETED
    assert ours.stats.num_chunks == 4 * 4
    assert ours.stats.num_raw_hits == ref.raw_hits()[0].shape[0]
    assert_same_run(ours, ref)


class _AbortAfterCheckpoint(Havac):
    """Sets the abort flag right after the first checkpoint is written."""

    def _build_sweep(self, run=None):
        sweep = super()._build_sweep(run)
        sweep.key_cap = 2  # every chunk with hits regrows
        run = sweep.run
        self.sweep = sweep

        def run_then_abort(abort_event, progress, checkpoint_cb=None,
                           resume=None, **kw):
            def cb(*payload):
                checkpoint_cb(*payload)
                self.saved = payload
                abort_event.set()

            return run(abort_event, progress, checkpoint_cb=cb,
                       resume=resume, **kw)

        sweep.run = run_then_abort
        return sweep


def test_pairs_survive_a_regrow_and_a_resume(fixture, monkeypatch, tmp_path):
    """Past the row bound: a key buffer too small for a chunk regrows with
    chunk-local keys, and a run resumed from a column-chunk checkpoint (hits
    saved as global pairs) ends with the JAX engine's hits."""
    models, db, ref = fixture
    lower(monkeypatch, "rows")
    ckpt = str(tmp_path / "run.ckpt.npz")
    kw = dict(p_value=P_VALUE, device="cpu", pad_multiple=1024,
              chunk_symbols=2048, chunk_rows=50, checkpoint_path=ckpt)
    first = _AbortAfterCheckpoint(**kw)
    first.load_phmm(models).load_sequence(db).run_async()
    assert first.wait(timeout=120) == HavacRunState.ABORTED
    assert first.sweep.regrows >= 1 and not first.sweep.keyform
    next_ci, _, rows_s, _ = first.saved
    assert next_ci == 1 and int(rows_s.max()) >= 100  # global rows
    assert os.path.exists(ckpt)
    second = Havac(**kw)
    second.load_phmm(models).load_sequence(db).run()
    assert second.resumed_chunks == 3  # one column of three row chunks
    assert_same_run(second, ref)
