"""The port's engine (`havac_tpu_torch.engine.Havac`, device="cpu") against
the JAX engine (`havac_tpu.engine.Havac`) on the test_engine.py fixtures.

Each comparison requires identical resolved hits (every column, in order)
and identical raw hits. The JAX side runs as its own tests run it: the
serial XLA backend, or the pipelined Pallas path in interpret mode. The port
pads its database to the JAX kernel's block width so that raw hits in the
padding agree too; its own chunk cuts are chosen unlike the JAX engine's.
"""

import os

import numpy as np
import pytest
import torch

from havac_tpu.engine import Havac as JaxHavac
from havac_tpu.io.fasta import load_fasta_database, reverse_complement
from havac_tpu.ops.common import SsvKernelConfig
from havac_tpu.testing.generator import generate_planted_fixture
from havac_tpu_torch.convert import database_from_reference as port_db
from havac_tpu_torch.convert import profile_hmms_from_reference as port_models
from havac_tpu_torch.engine import Havac, HavacRunState, HavacUsageError

P_VALUE = 0.05
CFG = SsvKernelConfig(block_width=1024, rows_per_strip=8, max_hit_tiles=512,
                      interpret=True)
FIELDS = ("sequence_index", "sequence_position", "phmm_index",
          "phmm_position", "strand")


def fasta_text(records):
    return "".join(f">{name}\n{seq}\n" for name, seq in records)


def port(**kw):
    kw.setdefault("pad_multiple", CFG.block_width)
    return Havac(p_value=kw.pop("p_value", P_VALUE), device="cpu", **kw)


def assert_same_run(ours, ref):
    a, b = ours.hits(), ref.hits()
    assert len(a) == len(b)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for x, y in zip(ours.raw_hits(), ref.raw_hits()):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def planted():
    models, records = generate_planted_fixture(
        seed=7, model_length=48, sequence_length=3000, num_models=3)
    db = load_fasta_database(fasta_text(records), pad_multiple=1024,
                             is_text=True)
    ref = JaxHavac(p_value=P_VALUE, config=CFG, backend="xla")
    ref.load_phmm(models).load_sequence(db).run()
    assert len(ref.hits()) > 0
    return port_models(models), port_db(db), ref  # the port's objects


@pytest.mark.parametrize("chunks", [(1 << 24, 8160), (700, 40), (999, 1),
                                    (97, 144)])
def test_planted_multi_model_matches_jax(planted, chunks):
    """Whole-matrix, uneven, one-row and one-column chunk cuts all give the
    JAX engine's hits."""
    models, db, ref = planted
    ours = port(chunk_symbols=chunks[0], chunk_rows=chunks[1])
    ours.load_phmm(models).load_sequence(db).run()
    assert ours.state == HavacRunState.COMPLETED
    assert ours.stats.num_chunks == (-(-db.padded_length // chunks[0])
                                     * -(-144 // chunks[1]))
    assert_same_run(ours, ref)
    assert ours.stats.cells == ref.stats.cells
    assert ours.stats.native_active is not None


def test_chunked_jax_run_matches_uneven_port_cuts():
    """Both engines chunked on both axes, with cuts that never line up."""
    models, records = generate_planted_fixture(
        seed=19, model_length=25, sequence_length=6000, num_models=5)
    db = load_fasta_database(fasta_text(records), pad_multiple=1024,
                             is_text=True)
    ref = JaxHavac(p_value=P_VALUE, config=CFG, backend="xla",
                   chunk_symbols=2048, chunk_rows=48)
    ref.load_phmm(models).load_sequence(db).run()
    ours = port(chunk_symbols=1777, chunk_rows=37)
    ours.load_phmm(port_models(models)).load_sequence(port_db(db)).run()
    assert ours.stats.num_chunks == 4 * 4
    assert_same_run(ours, ref)


def test_multi_sequence_resolution_matches_jax():
    models, records = generate_planted_fixture(
        seed=3, model_length=32, sequence_length=1500, num_models=1)
    seq = records[0][1]
    recs = [("s0", seq[:500]), ("s1", seq[500:1000]), ("s2", seq[1000:])]
    ref = JaxHavac(p_value=P_VALUE, config=CFG, backend="xla")
    ref.load_phmm(models).load_sequence(fasta_text(recs), is_text=True).run()
    ours = port(chunk_symbols=600)
    ours.load_phmm(port_models(models)).load_sequence(fasta_text(recs), is_text=True).run()
    assert_same_run(ours, ref)
    assert set(ours.hits().sequence_index.tolist()) <= {0, 1, 2}


def test_both_strands_match_jax():
    models, records = generate_planted_fixture(
        seed=71, model_length=40, sequence_length=1200, num_models=1)
    name, seq = records[0]
    fasta = f">{name}\n{reverse_complement(seq.encode()).decode()}\n"
    ref = JaxHavac(p_value=P_VALUE, config=CFG, backend="xla", strand="both")
    ref.load_phmm(models).load_sequence(fasta, is_text=True).run()
    ours = port(strand="both", chunk_symbols=900)
    ours.load_phmm(port_models(models)).load_sequence(fasta, is_text=True).run()
    assert (ours.hits().strand == "-").sum() > 0
    assert_same_run(ours, ref)


def test_isolate_models_matches_jax():
    models, records = generate_planted_fixture(
        seed=91, model_length=36, sequence_length=4000, num_models=3)
    fasta = fasta_text(records)
    ref = JaxHavac(p_value=P_VALUE, config=CFG, backend="xla",
                   isolate_models=True)
    ref.load_phmm(models).load_sequence(fasta, is_text=True).run()
    ours = port(isolate_models=True, chunk_symbols=1500, chunk_rows=50)
    ours.load_phmm(port_models(models)).load_sequence(fasta, is_text=True).run()
    assert ours.reset_rows.sum() == 3
    assert_same_run(ours, ref)
    joined = port(chunk_symbols=1500, chunk_rows=50)
    joined.load_phmm(port_models(models)).load_sequence(fasta, is_text=True).run()
    assert len(joined.hits()) >= len(ours.hits())


def test_amino_matches_jax():
    """Cardinality-20 models against the JAX main path: the pipelined SWAR
    kernel with its native key-form hits (amino needs it), at uneven port
    cuts. The JAX engine sweeps the port's projected scores: the port
    scores amino residues against HMMER's background
    (`tests/test_torch_amino_null.py` holds that projection to the plain
    reference), the JAX package against 2 bits a residue."""
    models, records = generate_planted_fixture(
        seed=5, model_length=30, sequence_length=2500, num_models=2,
        alphabet="amino")
    fasta = fasta_text(records)
    ours = port(p_value=0.02, pad_multiple=3072, chunk_symbols=1000,
                chunk_rows=25)
    ours.load_phmm(port_models(models)).load_sequence(fasta, is_text=True)
    cfg = SsvKernelConfig(block_width=3072, rows_per_strip=30, packing=3,
                          interpret=True)
    ref = JaxHavac(p_value=0.02, config=cfg, backend="pallas_interpret",
                   chunk_symbols=3072, chunk_rows=60)
    ref.load_phmm(models)
    ref.scores = ours.scores
    ref.load_sequence(fasta, is_text=True).run()
    ours.run()
    assert ours.alphabet == "amino" and ours.database.alphabet == "amino"
    assert len(ours.hits()) > 0
    assert_same_run(ours, ref)


class _AbortAt(Havac):
    """Sets the abort flag after ``at`` chunks, or (``at=None``) right after
    the first checkpoint is written: a deterministic mid-run abort."""

    def __init__(self, at=None, **kw):
        super().__init__(p_value=P_VALUE, device="cpu", pad_multiple=1024,
                         **kw)
        self.at = at

    def _build_sweep(self, run=None):
        sweep = super()._build_sweep(run)
        run = sweep.run

        def run_then_abort(abort_event, progress, checkpoint_cb=None,
                           resume=None, **kw):
            def prog(done):
                progress(done)
                if self.at is not None and done >= self.at:
                    abort_event.set()

            def cb(*payload):
                checkpoint_cb(*payload)
                if self.at is None:
                    abort_event.set()

            return run(abort_event, prog,
                       checkpoint_cb=cb if checkpoint_cb else None,
                       resume=resume, **kw)

        sweep.run = run_then_abort
        return sweep


def test_abort_then_fresh_run(planted):
    models, db, ref = planted
    eng = _AbortAt(at=2, chunk_symbols=512)
    eng.load_phmm(models).load_sequence(db)
    eng.run_async()
    assert eng.wait(timeout=120) == HavacRunState.ABORTED
    assert 0 < eng.progress < 1
    with pytest.raises(HavacUsageError):
        eng.hits()
    eng.at = None
    eng.run()
    assert eng.state == HavacRunState.COMPLETED
    assert_same_run(eng, ref)


def test_async_run_completes(planted):
    models, db, ref = planted
    eng = port(chunk_symbols=512)
    eng.load_phmm(models).load_sequence(db)
    eng.run_async()
    assert eng.wait(timeout=120) == HavacRunState.COMPLETED
    assert eng.progress == 1.0
    assert_same_run(eng, ref)


def test_checkpoint_resume_matches_jax(planted, tmp_path):
    """A run aborted after its first column-chunk checkpoint resumes from
    the file, and the resumed run equals the JAX engine's whole run."""
    models, db, ref = planted
    ckpt = str(tmp_path / "run.ckpt.npz")
    first = _AbortAt(chunk_symbols=1024, chunk_rows=100,
                     checkpoint_path=ckpt)
    first.load_phmm(models).load_sequence(db).run_async()
    assert first.wait(timeout=120) == HavacRunState.ABORTED
    assert os.path.exists(ckpt)
    second = port(chunk_symbols=1024, chunk_rows=100, checkpoint_path=ckpt)
    second.load_phmm(models).load_sequence(db).run()
    assert second.resumed_chunks == 2  # one column of two row chunks
    assert not os.path.exists(ckpt)
    assert_same_run(second, ref)


def test_stale_checkpoint_is_ignored(planted, tmp_path):
    models, db, ref = planted
    ckpt = str(tmp_path / "run.ckpt.npz")
    np.savez(ckpt[:-4], fingerprint=np.int64(12345), next_ci=np.int64(1),
             carries=np.zeros((1, 145), np.int32),
             hit_rows=np.zeros(5, np.int64),
             hit_positions=np.zeros(5, np.int64))
    eng = port(chunk_symbols=1024, checkpoint_path=ckpt)
    eng.load_phmm(models).load_sequence(db).run()
    assert eng.resumed_chunks == 0
    assert_same_run(eng, ref)


def test_warmup_verify_and_verify_hits(planted):
    models, db, ref = planted
    eng = port(chunk_symbols=2000, verify_hits=True)
    eng.load_phmm(models).load_sequence(db).warmup().run()
    assert eng.verification.all_verified
    assert eng.verification.num_hits == eng.stats.num_raw_hits > 0
    assert eng.stats.num_unverified == 0
    assert_same_run(eng, ref)
    sample = eng.verify(sample=5)
    assert sample.num_hits == 5 and sample.all_verified


def test_usage_errors():
    models, records = generate_planted_fixture(seed=1, model_length=16,
                                               sequence_length=512)
    am_models, _ = generate_planted_fixture(seed=2, model_length=16,
                                            sequence_length=512,
                                            alphabet="amino")
    models, am_models = port_models(models), port_models(am_models)
    eng = Havac(device="cpu")
    assert eng.state == HavacRunState.IDLE and eng.backend == "torch"
    with pytest.raises(HavacUsageError):
        eng.run()
    with pytest.raises(HavacUsageError):
        eng.warmup()
    with pytest.raises(HavacUsageError):
        eng.hits()
    with pytest.raises(HavacUsageError, match="ShardMesh"):
        Havac(device="cpu", mesh=object())  # not a mesh of the port's
    with pytest.raises(HavacUsageError, match="unsupported device"):
        Havac(device="meta")
    with pytest.raises(HavacUsageError, match="strand"):
        Havac(device="cpu", strand="reverse")
    with pytest.raises(TypeError):
        Havac()  # the device is never picked implicitly
    if not torch.cuda.is_available():
        with pytest.raises(HavacUsageError, match="not available"):
            Havac(device="cuda")
    with pytest.raises(HavacUsageError, match="no models"):
        Havac(device="cpu").load_phmm([])
    with pytest.raises(HavacUsageError, match="mixed alphabets"):
        Havac(device="cpu").load_phmm(models + am_models)
    with pytest.raises(HavacUsageError, match="meaningless"):
        Havac(device="cpu", strand="both").load_phmm(am_models)

    class Stub:
        name = "odd"
        alphabet_cardinality = 7

    with pytest.raises(HavacUsageError, match="cardinality 7"):
        Havac(device="cpu").load_phmm([Stub()])
    amino = Havac(device="cpu").load_phmm(am_models)
    dna_db = port_db(load_fasta_database(fasta_text(records), is_text=True))
    with pytest.raises(HavacUsageError, match="alphabet"):
        amino.load_sequence(dna_db)


def test_cli_search_writes_the_engines_hits(planted, tmp_path):
    from havac_tpu.io.hmm import write_hmm
    from havac_tpu_torch.engine.cli import main

    models, _, _ = planted
    _, records = generate_planted_fixture(
        seed=7, model_length=48, sequence_length=3000, num_models=3)
    hmm, fasta, out = (str(tmp_path / n) for n in
                       ("m.hmm", "db.fasta", "hits.tsv"))
    write_hmm(models, hmm)
    with open(fasta, "w") as f:
        f.write(fasta_text(records))
    assert main(["search", "--hmm", hmm, "--fasta", fasta, "--device", "cpu",
                 "--pvalue", str(P_VALUE), "--chunk-symbols", "1000",
                 "--out", out]) == 0
    ref = JaxHavac(p_value=P_VALUE, config=CFG, backend="xla")
    ref.load_phmm(hmm).load_sequence(fasta).run()
    with open(out) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("#sequence")
    want = [f"{ref.database.names[si]}\t{sp}\t{ref.models[mi].name}\t{mp}\t+"
            for si, sp, mi, mp in ref.hits().as_tuples()]
    assert lines[1:] == want and want


def test_provenance_stamp():
    from havac_tpu_torch.utils.provenance import provenance

    stamp = provenance("cpu", native_active=True)
    assert stamp["torch"] == torch.__version__
    assert stamp["device"] == "cpu" and stamp["native_active"] is True
    assert "device_name" not in stamp  # only a CUDA device has a card name


def test_key_buffer_overflow_relaunches_once_per_chunk(planted):
    """A chunk with more hits than its key buffer runs once more with an
    exact buffer, and chunks launched after that get a larger buffer; the
    hits are the JAX engine's."""
    from havac_tpu_torch.engine.pipeline import PipelinedSweep

    models, db, ref = planted
    eng = port().load_phmm(models).load_sequence(db)
    sweep = PipelinedSweep(eng._codes(), eng.scores, 1024, 8160, "cpu", db,
                           eng.phmm_prefix, key_cap=4)
    resolved, parts, _ = sweep.run()
    assert 1 <= sweep.regrows <= sweep.n_col * sweep.n_row
    assert sweep.key_cap >= 1 << 16
    keys = np.sort(np.concatenate(parts))
    rows, pos = ref.raw_hits()
    np.testing.assert_array_equal(keys >> np.uint64(38), rows)
    np.testing.assert_array_equal(keys & np.uint64((1 << 38) - 1), pos)
    assert resolved.as_tuples() == ref.hits().as_tuples()
