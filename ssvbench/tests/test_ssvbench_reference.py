"""The plain reference: its windowed sweep equals a scalar SSV, and its
projection and encoding equal the port's, computed independently."""

import os

import numpy as np
import pytest

from ssvbench import workload
from ssvbench.reference import ssv
from ssvbench.tests.tiny import tiny_cell


def scalar_ssv(symbols, scores):
    """Every (row, position) hit of the full matrix, one cell at a time."""
    P, L = scores.shape[0], symbols.shape[0]
    prev = [0] * L
    hits = set()
    for j in range(P):
        row = [0] * L
        for i in range(L):
            s = (prev[i - 1] if i else 0) + int(scores[j][symbols[i]])
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
