"""The plain reference: its windowed sweep equals a scalar SSV, and its
projection and encoding equal the port's, computed independently."""

import os

import numpy as np
import pytest

from ssvbench import workload
from ssvbench.reference import ssv
from ssvbench.tests.tiny import tiny_amino_cell, tiny_cell


def scalar_ssv(symbols, scores, reset=()):
    """Every (row, position) hit of the full matrix, one cell at a time;
    the rows in ``reset`` take no incoming diagonal (a model's first row
    under isolation)."""
    P, L = scores.shape[0], symbols.shape[0]
    prev = [0] * L
    hits = set()
    for j in range(P):
        row = [0] * L
        for i in range(L):
            s = ((prev[i - 1] if i and j not in reset else 0)
                 + int(scores[j][symbols[i]]))
            if s >= 256:
                hits.add((j, i))
                s = 0
            row[i] = max(s, 0)
        prev = row
    return hits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_hits_equal_scalar_ssv(seed):
    rng = np.random.default_rng(seed)
    P, L, w = 37, 300, 41
    scores = rng.integers(-60, 128, size=(P, 4))
    symbols = rng.integers(0, 4, size=L).astype(np.uint8)
    want = scalar_ssv(symbols, scores)
    assert want
    starts = [0, 20, 130, L - w]
    win, row, pos = ssv.window_hits([(symbols, a) for a in starts], w,
                                    scores)
    for k, a in enumerate(starts):
        got = set(zip(row[win == k].tolist(), pos[win == k].tolist()))
        assert got == {(j, i) for j, i in want if a <= i < a + w}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("isolate", [False, True])
@pytest.mark.parametrize("card", [4, 20])
def test_window_hits_with_resets_equal_scalar_ssv(card, isolate, seed):
    """Any alphabet, chained or isolated models: the windows (one starting
    left of the longest model's span, at the sentinel) hold exactly the
    scalar SSV's hits, the models' first rows reset where isolated."""
    rng = np.random.default_rng(100 + seed)
    lengths = np.array([5, 12, 3, 17])
    P, L, w = int(lengths.sum()), 300, 41
    scores = rng.integers(-60, 128, size=(P, card))
    symbols = rng.integers(0, card, size=L).astype(np.uint8)
    first = set(np.concatenate([[0], np.cumsum(lengths)[:-1]]).tolist())
    want = scalar_ssv(symbols, scores, first if isolate else ())
    assert want
    starts = [0, 5, 20, 130, L - w]
    win, row, pos = ssv.window_hits([(symbols, a) for a in starts], w,
                                    scores,
                                    model_lengths=lengths if isolate else None)
    for k, a in enumerate(starts):
        got = set(zip(row[win == k].tolist(), pos[win == k].tolist()))
        assert got == {(j, i) for j, i in want if a <= i < a + w}


@pytest.mark.parametrize("isolate", [False, True])
def test_small_blocks_give_the_same_hits(isolate, monkeypatch):
    """Blocks of a few models, each pulling its hits row by row, find what
    one block of every model does."""
    rng = np.random.default_rng(5)
    lengths = rng.integers(3, 40, size=30)
    scores = rng.integers(-60, 128, size=(int(lengths.sum()), 20))
    symbols = rng.integers(0, 20, size=2_000).astype(np.uint8)
    windows = [(symbols, a) for a in (0, 10, 700, 1_800)]
    iso = lengths if isolate else None
    want = ssv.window_hits(windows, 200, scores, model_lengths=iso)
    monkeypatch.setattr(ssv, "_BLOCK_CELLS", 4 * 300)
    got = ssv.window_hits(windows, 200, scores, model_lengths=iso)
    assert want[0].shape[0] > 0

    def key(h):
        return sorted(zip(*(a.tolist() for a in h)))
    assert key(got) == key(want)


def test_amino_background_is_hmmers():
    f = ssv.AMINO_BACKGROUND
    assert f.shape == (20,) and abs(f.sum() - 1) < 1e-6
    assert np.array_equal(ssv.AMINO_NULL_BITS,
                          (-np.log2(f)).astype(np.float32))


def test_amino_projection_is_log_odds_against_the_background(tmp_path):
    """Each amino score is round(scale · log2(e / f)) for its model's
    scale: the float32 arithmetic lands on the rounding of the exact value
    wherever that is not within 1e-3 of a half."""
    c = tiny_amino_cell(positions=2_000)
    inputs = workload.make_inputs(c.config, c.traffic, 7, str(tmp_path))
    coll = ssv.read_hmm(inputs.hmm_path)
    assert coll.card == 20
    got = ssv.project(coll, 0.02).astype(np.int64)
    prefix = coll.prefix
    ties = 0
    for k in range(coll.lengths.shape[0]):
        scale = float(ssv.scale_factor(coll.mu[k], coll.lam[k],
                                       coll.max_lengths[k], coll.lengths[k],
                                       0.02))
        e = np.exp(-coll.emissions[prefix[k]:prefix[k + 1]].astype(np.float64))
        x = scale * np.log2(e / ssv.AMINO_BACKGROUND)
        want = np.clip(np.where(x >= 0, np.floor(x + 0.5),
                                np.ceil(x - 0.5)), -128, 127)
        near = np.abs(np.abs(x - np.trunc(x)) - 0.5) < 1e-3
        mine = got[prefix[k]:prefix[k + 1]]
        assert np.array_equal(mine[~near], want[~near])
        assert np.all(np.abs(mine[near] - want[near]) <= 1)
        ties += int(near.sum())
    assert ties < 0.01 * got.size


def test_port_reads_the_amino_hmm(tmp_path):
    """The port's parser reads the harness's amino ``.hmm`` as the
    reference does, and both hold the generator's emissions to the file's
    five decimals (and float32's rounding)."""
    from havac_tpu_torch.io.hmm import read_hmm

    c = tiny_amino_cell()
    inputs = workload.make_inputs(c.config, c.traffic, 8, str(tmp_path))
    theirs = read_hmm(inputs.hmm_path, native="never")
    coll = ssv.read_hmm(inputs.hmm_path)
    models = workload.amino_models(
        workload.rng_for(c.config["collection"]["seed"]),
        c.config["collection"])
    assert [m.alphabet for m in theirs] == ["amino"] * len(models)
    assert np.array_equal(np.concatenate([m.match_scores for m in theirs]),
                          coll.emissions)
    assert np.abs(coll.emissions - np.concatenate(
        [m.match_scores for m in models])).max() <= 5e-6 + 1e-6
    assert [m.max_length for m in theirs] == coll.max_lengths.tolist()
    assert [m.msv_mu for m in theirs] == pytest.approx(coll.mu.tolist())


def test_projection_equals_port(tmp_path):
    from havac_tpu_torch.io.hmm import read_hmm
    from havac_tpu_torch.scoring.reprojection import project_models

    c = tiny_cell(positions=3_000)
    inputs = workload.make_inputs(c.config, c.traffic, 99, str(tmp_path))
    coll = ssv.read_hmm(inputs.hmm_path)
    for p in (0.02, 0.001):
        assert np.array_equal(ssv.project(coll, p),
                              project_models(read_hmm(inputs.hmm_path,
                                                      native="never"), p))
    assert np.array_equal(coll.lengths, inputs.model_lengths)


def test_bfloat16_control_changes_the_scores(tmp_path):
    c = tiny_cell()
    inputs = workload.make_inputs(c.config, c.traffic, 3, str(tmp_path))
    coll = ssv.read_hmm(inputs.hmm_path)
    low = ssv.project(coll, 0.02, "bfloat16")
    assert (low != ssv.project(coll, 0.02)).any(axis=1).mean() > 0.5


def test_encoding_equals_port(tmp_path):
    from havac_tpu_torch.io.fasta import load_fasta_database

    c = tiny_cell()
    inputs = workload.make_inputs(c.config, c.traffic, 4, str(tmp_path))
    for f in inputs.files:
        db = ssv.read_fasta(f.path)
        theirs = load_fasta_database(f.path, native="never")
        assert np.array_equal(db.symbols, theirs.codes)
        assert np.array_equal(db.starts, theirs.starts)
        assert db.names == theirs.names == f.names


def test_amino_encoding_equals_port(tmp_path):
    """Residues 0..19 in HMMER's order and the separators SplitMix64 mod
    20, as the port's amino encoder lays them out."""
    from havac_tpu_torch.io.fasta import load_fasta_database

    c = tiny_amino_cell()
    inputs = workload.make_inputs(c.config, c.traffic, 4, str(tmp_path))
    for f in inputs.files:
        db = ssv.read_fasta(f.path, 20)
        theirs = load_fasta_database(f.path, native="never",
                                     alphabet="amino")
        assert np.array_equal(db.symbols, theirs.codes)
        assert np.array_equal(db.starts, theirs.starts)
        assert db.names == theirs.names == f.names


@pytest.mark.parametrize("card, text", [(20, b">a\nACDX\n"),
                                        (20, b">a\nACDB\n"),
                                        (4, b">a\nACGE\n")])
def test_read_fasta_refuses_other_letters(card, text, tmp_path):
    (tmp_path / "x.fa").write_bytes(text)
    with pytest.raises(ValueError):
        ssv.read_fasta(str(tmp_path / "x.fa"), card)


def test_resolve_drops_separators():
    db = ssv.Database(["a", "b"], np.array([3, 2]),
                      np.zeros(7, dtype=np.uint8))
    coll = ssv.Collection(np.array([2, 3]), np.array([8, 12]),
                          np.zeros(2), np.ones(2),
                          np.zeros((5, 4), np.float32))
    got = ssv.resolve(np.array([0, 1, 4, 2]), np.array([2, 3, 4, 6]), db,
                      coll)
    assert got.tolist() == [[0, 2, 0, 0], [1, 0, 1, 2]]


def test_reference_imports_nothing_of_the_program():
    import ast

    here = os.path.join(os.path.dirname(ssv.__file__))
    for name in os.listdir(here):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(here, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split(".")[0] not in ("havac_tpu_torch", "havac_tpu",
                                               "jax", "jaxlib", "flax"), \
                    (name, m)
