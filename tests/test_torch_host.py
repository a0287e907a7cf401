"""The port's own host modules (copies of the JAX package's, under the same
relative paths in `havac_tpu_torch`) against the originals, exactly, on the
same seeded inputs: HMM and FASTA parsing and encoding, score reprojection,
the native core's key resolution and run merge (and the port's numpy path
beside them), hit verification, the planted-fixture generator, the numpy
oracle's DP matrix, and the `convert.py` carriers that turn the JAX
package's objects into the port's.
"""

import dataclasses

import numpy as np
import pytest

from havac_tpu import native as jax_native
from havac_tpu.hits.verify import verify_hits as jax_verify_hits
from havac_tpu.io.fasta import load_fasta_database as jax_load_fasta
from havac_tpu.io.hmm import read_hmm as jax_read_hmm
from havac_tpu.io.hmm import read_hmm_text as jax_read_hmm_text
from havac_tpu.io.hmm import write_hmm as jax_write_hmm
from havac_tpu.ops.reference import ssv_reference as jax_ssv_reference
from havac_tpu.scoring.reprojection import project_models as jax_project
from havac_tpu.testing.generator import generate_planted_fixture as jax_fixture
from havac_tpu.testing.percell import dp_matrix_oracle as jax_dp_oracle
from havac_tpu_torch import native
from havac_tpu_torch.convert import (database_from_reference,
                                     profile_hmms_from_reference)
from havac_tpu_torch.engine.pipeline import keys_from_pairs, pairs_from_keys
from havac_tpu_torch.hits.decode import resolve_block_with_keys
from havac_tpu_torch.hits.verify import verify_hits
from havac_tpu_torch.io.fasta import SequenceDatabase, load_fasta_database
from havac_tpu_torch.io.hmm import (ProfileHmm, model_length_prefix_sums,
                                    read_hmm, read_hmm_text, write_hmm)
from havac_tpu_torch.ops.reference import ssv_reference
from havac_tpu_torch.scoring.reprojection import project_models
from havac_tpu_torch.testing.generator import generate_planted_fixture
from havac_tpu_torch.testing.percell import dp_matrix_oracle

MODEL_FIELDS = ("name", "model_length", "max_length", "alphabet", "msv_mu",
                "msv_lambda", "accession", "description", "extra_header_lines")
DB_ARRAYS = ("codes", "starts", "lengths")


def fasta_text(records):
    return "".join(f">{name}\n{seq}\n" for name, seq in records)


def assert_same_models(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert isinstance(a, ProfileHmm)
        for f in MODEL_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert a.match_scores.dtype == b.match_scores.dtype
        np.testing.assert_array_equal(a.match_scores, b.match_scores)


def assert_same_db(ours, theirs):
    assert isinstance(ours, SequenceDatabase)
    for f in DB_ARRAYS:
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.names == theirs.names
    assert (ours.seed, ours.alphabet) == (theirs.seed, theirs.alphabet)


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("alphabet", ["dna", "amino"])
def test_generator_matches(seed, alphabet):
    kw = dict(seed=seed, model_length=40, sequence_length=1500, num_models=2,
              alphabet=alphabet)
    models, records = generate_planted_fixture(**kw)
    jmodels, jrecords = jax_fixture(**kw)
    assert_same_models(models, jmodels)
    assert records == jrecords


@pytest.fixture(scope="module")
def hmm_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("hmm")
    models, _ = jax_fixture(seed=5, model_length=50, sequence_length=10,
                            num_models=3)
    path = str(d / "m.hmm")
    jax_write_hmm(models, path)
    return path


@pytest.mark.parametrize("native_mode", ["never", "auto"])
def test_read_hmm_matches(hmm_file, native_mode):
    assert_same_models(read_hmm(hmm_file, native=native_mode),
                       jax_read_hmm(hmm_file, native=native_mode))
    with open(hmm_file) as f:
        text = f.read()
    assert_same_models(read_hmm_text(text), jax_read_hmm_text(text))


def test_write_hmm_writes_the_same_file(hmm_file, tmp_path):
    ours = str(tmp_path / "ours.hmm")
    write_hmm(read_hmm(hmm_file), ours)
    with open(ours) as a, open(hmm_file) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("alphabet,pad,seed", [("dna", 1, 0x5A5A),
                                               ("dna", 1024, 77),
                                               ("amino", 1, 0x5A5A),
                                               ("amino", 512, 3)])
@pytest.mark.parametrize("from_file", [False, True])
def test_load_fasta_database_matches(tmp_path, alphabet, pad, seed,
                                     from_file):
    _, records = jax_fixture(seed=9, model_length=30, sequence_length=2000,
                             num_models=2, alphabet=alphabet)
    text = fasta_text(records + [("odd", "ACGTNNRY" if alphabet == "dna"
                                  else "ACDXBZ*")])
    src, is_text = text, True
    if from_file:
        src = str(tmp_path / "db.fasta")
        with open(src, "w") as f:
            f.write(text)
        is_text = False
    kw = dict(pad_multiple=pad, seed=seed, is_text=is_text, alphabet=alphabet)
    assert_same_db(load_fasta_database(src, **kw),
                   jax_load_fasta(src, **kw))


@pytest.mark.parametrize("p_value", [0.02, 0.001])
def test_project_models_matches(hmm_file, p_value):
    ours = project_models(read_hmm(hmm_file), p_value)
    theirs = jax_project(jax_read_hmm(hmm_file), p_value)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


@pytest.fixture(scope="module")
def hits():
    """A planted search's raw hits, global keys, and tables."""
    models, records = jax_fixture(seed=13, model_length=40,
                                  sequence_length=4000, num_models=3)
    db = jax_load_fasta(fasta_text(records), pad_multiple=1024, is_text=True)
    scores = jax_project(models, 0.05)
    res, _ = jax_ssv_reference(db.codes, scores)
    rows = np.asarray(res.hit_rows, dtype=np.int64)
    pos = np.asarray(res.hit_positions, dtype=np.int64)
    assert rows.size > 0
    prefix = model_length_prefix_sums(profile_hmms_from_reference(models))
    return db, scores, rows, pos, prefix


def test_resolve_keys_native_matches(hits):
    db, _, rows, pos, prefix = hits
    assert native.available() and jax_native.available()
    keys = np.sort(keys_from_pairs(rows, pos))
    tables = (np.asarray(db.starts, np.int64),
              np.asarray(db.lengths, np.int64), prefix)
    ours = native.resolve_keys_native(keys, *tables)
    theirs = jax_native.resolve_keys_native(keys, *tables)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # The port's numpy path (no native core) gives the same table.
    r, p = pairs_from_keys(keys)
    res, kr, kp = resolve_block_with_keys(r, p, database_from_reference(db),
                                          prefix)
    for a, f in zip(ours[:4], ("sequence_index", "sequence_position",
                               "phmm_index", "phmm_position")):
        np.testing.assert_array_equal(a, getattr(res, f), err_msg=f)
    np.testing.assert_array_equal(ours[4], keys_from_pairs(kr, kp))


def test_merge_runs_u64_native_matches(hits):
    _, _, rows, pos, _ = hits
    keys = keys_from_pairs(rows, pos)
    rng = np.random.default_rng(1)
    cuts = np.sort(rng.choice(np.arange(1, keys.size), 3, replace=False))
    runs = [np.sort(k) for k in np.split(rng.permutation(keys), cuts)]
    cat = np.concatenate(runs)
    offs = np.cumsum([0] + [r.size for r in runs])
    ours = native.merge_runs_u64_native(cat, offs)
    np.testing.assert_array_equal(ours,
                                  jax_native.merge_runs_u64_native(cat, offs))
    np.testing.assert_array_equal(cat[ours], np.sort(keys))
    np.testing.assert_array_equal(cat[ours],
                                  cat[np.argsort(cat, kind="stable")])


def test_verify_hits_matches(hits):
    db, scores, rows, pos, _ = hits
    bad_rows = np.concatenate([rows, rows[:5]])
    bad_pos = np.concatenate([pos, (pos[:5] + 1) % db.codes.size])
    for r, p in ((rows, pos), (bad_rows, bad_pos)):
        ours = verify_hits(r, p, db.codes, scores)
        theirs = jax_verify_hits(r, p, db.codes, scores)
        a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        assert a.keys() == b.keys()
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert verify_hits(rows, pos, db.codes, scores).all_verified
    assert not verify_hits(bad_rows, bad_pos, db.codes, scores).all_verified


def test_dp_matrix_oracle_matches():
    rng = np.random.default_rng(4)
    sym = rng.integers(0, 4, 700).astype(np.uint8)
    sc = rng.integers(-40, 110, (23, 4)).astype(np.int8)
    ours = dp_matrix_oracle(sym, sc)
    theirs = jax_dp_oracle(sym, sc)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    res, _ = ssv_reference(sym, sc)
    jres, _ = jax_ssv_reference(sym, sc)
    np.testing.assert_array_equal(res.hit_rows, jres.hit_rows)
    np.testing.assert_array_equal(res.hit_positions, jres.hit_positions)


def test_convert_carries_jax_package_objects():
    models, records = jax_fixture(seed=21, model_length=30,
                                  sequence_length=1200, num_models=2)
    ours = profile_hmms_from_reference(models)
    assert_same_models(ours, models)
    ours[0].match_scores[0, 0] += 1  # a copy, not a view
    assert ours[0].match_scores[0, 0] != models[0].match_scores[0, 0]
    db = jax_load_fasta(fasta_text(records), pad_multiple=1024, is_text=True,
                        seed=99)
    assert_same_db(database_from_reference(db), db)
    np.testing.assert_array_equal(
        project_models(profile_hmms_from_reference(models), 0.02),
        jax_project(models, 0.02))


def test_engine_refuses_jax_package_objects():
    """A JAX-package ProfileHmm or SequenceDatabase handed to the port's
    engine is refused with the carrier to use, not taken for a path."""
    from havac_tpu_torch.engine import Havac
    from havac_tpu_torch.engine.api import HavacUsageError

    models, records = jax_fixture(seed=21, model_length=30,
                                  sequence_length=1200, num_models=2)
    for src in (models, models[0]):
        with pytest.raises(HavacUsageError,
                           match="profile_hmms_from_reference"):
            Havac(device="cpu").load_phmm(src)
    db = jax_load_fasta(fasta_text(records), is_text=True)
    engine = Havac(device="cpu").load_phmm(profile_hmms_from_reference(models))
    with pytest.raises(HavacUsageError, match="database_from_reference"):
        engine.load_sequence(db)
    assert engine.load_sequence(database_from_reference(db)).database \
        .num_sequences == db.num_sequences
