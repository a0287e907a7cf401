"""Amino residues scored against HMMER3's background: the port's projection
(`havac_tpu_torch/scoring/reprojection.py`) against the benchmark's plain
reference (`ssvbench/reference/ssv.py`), bit for bit, and the port's
searches of amino models against the reference's sweep. The DNA projection
stays the JAX package's."""

import numpy as np
import pytest

from havac_tpu.scoring.reprojection import project_models as jax_project
from havac_tpu.testing.generator import generate_planted_fixture as jax_fixture
from havac_tpu_torch.convert import profile_hmms_from_reference
from havac_tpu_torch.engine import Havac
from havac_tpu_torch.io.hmm import ProfileHmm
from havac_tpu_torch.scoring import reprojection
from havac_tpu_torch.scoring.reprojection import (
    AMINO_NULL_BITS, c_round, legacy_project_single_score, null_bits,
    project_models, project_scores_for_threshold256,
    threshold256_scale_factor)
from havac_tpu_torch.validation import (diagonal_scores_float,
                                        float_projected_scores,
                                        quantization_report)
from havac_tpu_torch.validation.quantization import diagonal_scores_int8
from ssvbench import workload
from ssvbench.reference import ssv

COLUMNS = ("sequence_index", "sequence_position", "phmm_index",
           "phmm_position")


def random_amino_models(seed, n=6):
    """Seeded amino models: log-normal-ish lengths, emissions from near 0
    (the scores saturate at +127) to 12 nats (at -128), and a few "*"
    (+inf) emissions; per-model mu, lambda and maximum lengths. The first
    is short, with a low mu: its threshold is low and its scale high."""
    rng = np.random.default_rng(seed)
    models = []
    for i in range(n):
        length = 6 if i == 0 else int(rng.integers(5, 90))
        em = rng.uniform(0.0, 5.0, size=(length, 20)).astype(np.float32)
        em[rng.random(em.shape) < 0.03] = np.inf
        em[rng.random(em.shape) < 0.03] = rng.uniform(0, 1e-3)
        em[rng.random(em.shape) < 0.03] = rng.uniform(9.0, 12.0)
        models.append(ProfileHmm(
            name=f"m{i}", model_length=length,
            max_length=int(length * rng.uniform(1.5, 6.0)), alphabet="amino",
            msv_mu=-12.0 if i == 0 else float(rng.uniform(-12.0, -8.0)),
            msv_lambda=float(rng.uniform(0.6, 0.8)), match_scores=em))
    return models


def reference_collection(models):
    return ssv.Collection(
        np.array([m.model_length for m in models], np.int64),
        np.array([m.max_length for m in models], np.int64),
        np.array([m.msv_mu for m in models]),
        np.array([m.msv_lambda for m in models]),
        np.concatenate([m.match_scores for m in models]))


def test_amino_null_is_hmmers_background():
    assert np.array_equal(reprojection.AMINO_FREQUENCIES,
                          ssv.AMINO_BACKGROUND)
    assert AMINO_NULL_BITS.dtype == np.float32
    assert np.array_equal(AMINO_NULL_BITS, ssv.AMINO_NULL_BITS)
    assert np.array_equal(null_bits("DNA"), np.full(4, 2, np.float32))
    assert np.array_equal(null_bits("rna"), null_bits("dna"))
    with pytest.raises(ValueError):
        null_bits("binary")


@pytest.mark.parametrize("p_value", [0.02, 0.001])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_amino_projection_equals_reference(seed, p_value):
    models = random_amino_models(seed)
    ours = project_models(models, p_value)
    theirs = ssv.project(reference_collection(models), p_value)
    assert ours.dtype == np.int8 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours.astype(np.int16), theirs)
    # the draws reach both saturations and the -inf of "*"
    assert (ours == 127).any() and (ours == -128).any()


@pytest.mark.parametrize("p_value", [0.02, 0.001])
def test_dna_projection_unchanged(p_value):
    models, _ = jax_fixture(seed=31, model_length=40, sequence_length=10,
                            num_models=3)
    ours = project_models(profile_hmms_from_reference(models), p_value)
    theirs = jax_project(models, p_value)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    # and the projection's default null is the nucleotide one
    m = profile_hmms_from_reference(models)[0]
    scale = threshold256_scale_factor(m.msv_mu, m.msv_lambda, m.max_length,
                                      m.model_length, p_value)
    np.testing.assert_array_equal(
        project_scores_for_threshold256(m.match_scores, scale),
        ours[:m.model_length])


def test_legacy_formula_takes_the_null():
    """The per-score cross-check follows the vectorized projection within
    one of its last step's roundings, for each amino residue's null."""
    (m,) = random_amino_models(4, n=1)
    scale = threshold256_scale_factor(m.msv_mu, m.msv_lambda, m.max_length,
                                      m.model_length, 0.02)
    vec = project_scores_for_threshold256(m.match_scores, scale,
                                          AMINO_NULL_BITS)
    legacy = np.array([[legacy_project_single_score(
        float(m.match_scores[r, x]), scale, float(AMINO_NULL_BITS[x]))
        for x in range(20)] for r in range(m.model_length)])
    assert np.abs(legacy - vec.astype(np.int64)).max() <= 1
    assert (legacy == vec).mean() > 0.97


def _write_inputs(tmp_path, seed):
    """Eight small amino models and two proteomes with planted domains,
    written as the benchmark writes its cells' files."""
    rng = workload.rng_for(seed)
    coll = {"model_positions": 320, "match_probability": 0.6,
            "msv_mu": -9.8664, "msv_lambda": 0.71313,
            "model_length": {"median": 40, "sigma": 0.4, "clip": [12, 80]}}
    models = workload.amino_models(rng, coll)
    hmm = str(tmp_path / "models.hmm")
    workload.write_hmm(models, hmm)
    rec = {"protein_length": {"median": 200, "sigma": 0.6,
                              "clip": [30, 1_000]},
           "domain_share": 0.5, "domains": [1, 2]}
    paths = []
    for k, proteins in enumerate((24, 31)):
        path = str(tmp_path / f"proteome{k}.fa")
        workload.write_fasta(path, [
            (f"p{k}_{j}", codes) for j, codes in enumerate(
                workload.proteome(rng, proteins, rec, models))],
            workload.AMINO_LETTERS)
        paths.append(path)
    return hmm, paths, len(models)


def _reference_hits(hmm, path, p_value, isolate):
    coll = ssv.read_hmm(hmm)
    db = ssv.read_fasta(path, coll.card)
    win, row, pos = ssv.window_hits(
        [(db.symbols, 0)], db.symbols.shape[0], ssv.project(coll, p_value),
        model_lengths=coll.lengths if isolate else None)
    out = ssv.resolve(row, pos, db, coll)
    return out[np.lexsort(out.T[::-1])]


@pytest.mark.parametrize("isolate", [True, False])
def test_scan_files_amino_equals_reference(tmp_path, isolate):
    """The port's amino scan over two proteomes: every file's hits are the
    reference's over the whole database, models isolated or chained."""
    hmm, paths, n_models = _write_inputs(tmp_path, 2**31 + 19)
    assert n_models >= 6
    eng = Havac(p_value=0.02, device="cpu", isolate_models=isolate,
                chunk_symbols=3_000, chunk_rows=70)
    eng.load_phmm(hmm)
    assert eng.alphabet == "amino"
    got = list(eng.scan_files(paths))
    assert [p for p, _ in got] == paths
    total = 0
    for path, hits in got:
        ours = np.stack([np.asarray(getattr(hits, c), np.int64)
                         for c in COLUMNS], axis=1)
        ours = ours[np.lexsort(ours.T[::-1])]
        ref = _reference_hits(hmm, path, 0.02, isolate)
        np.testing.assert_array_equal(ours, ref)
        total += ref.shape[0]
    assert total > 0


def test_validation_projects_against_the_amino_null():
    """``float_projected_scores`` and the quantization report's float
    sweep take the model's null: within half a unit of the int8
    projection wherever it does not saturate, and a planted domain reaches
    the threshold in both."""
    models, records = jax_fixture(seed=12, model_length=60,
                                  sequence_length=2_000, num_models=1,
                                  alphabet="amino")
    (m,) = profile_hmms_from_reference(models)
    proj, scale = float_projected_scores(m, 0.02)
    int8 = project_models([m], 0.02).astype(np.float64)
    inside = (int8 > -128) & (int8 < 127)
    assert inside.mean() > 0.9
    assert np.abs(proj - int8)[inside].max() <= 0.5 + 1e-4
    np.testing.assert_array_equal(np.clip(c_round(proj), -128, 127)[inside],
                                  int8[inside])
    letters = {c: i for i, c in enumerate("ACDEFGHIKLMNPQRSTVWY")}
    codes = np.array([letters[c] for c in records[0][1] if c in letters])
    floats = diagonal_scores_float(codes, m.match_scores, scale,
                                   null_bits("amino"))
    ints = diagonal_scores_int8(codes, project_models([m], 0.02))
    assert floats.max() >= 256 and ints.max() >= 256
    rep = quantization_report([codes], m, 0.02)
    assert rep.int8_pass_256 == rep.float_pass_256 == 1


def test_validation_dna_unchanged():
    models, records = jax_fixture(seed=12, model_length=60,
                                  sequence_length=2_000, num_models=1)
    (m,) = profile_hmms_from_reference(models)
    proj, scale = float_projected_scores(m, 0.02)
    expect = ((np.float32(2.0) - m.match_scores * np.float32(1.44269504089))
              * np.float32(scale))
    np.testing.assert_array_equal(proj, np.where(np.isfinite(expect),
                                                 expect, np.float32(-1e9)))
    codes = np.array(["ACGT".index(c) for c in records[0][1] if c in "ACGT"])
    np.testing.assert_array_equal(
        diagonal_scores_float(codes, m.match_scores, scale),
        diagonal_scores_float(codes, m.match_scores, scale, null_bits("dna")))


def test_port_imports_no_reference():
    """The projection's constants are the port's own: the port's
    projection imports nothing of the benchmark's reference."""
    with open(reprojection.__file__) as f:
        assert "ssvbench" not in f.read()
