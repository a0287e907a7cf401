"""``correct``: true on a sound run, false for the control (the reference
in the program's place, in bfloat16) and for each fault a cell can have,
planted under the timed path of a whole run (the harness's look for a
card skipped: the plain sweep on the CPU)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from havac_tpu_torch.engine import api
from havac_tpu_torch.engine.api import Havac
from havac_tpu_torch.hits.decode import ResolvedHits
from havac_tpu_torch.scoring import reprojection
from ssvbench import control, run
from ssvbench.reference import ssv
from ssvbench.tests.tiny import tiny_amino_cell, tiny_cell

SEED = 2**31 + 77


def _run(tmp_path, cell=None, seconds=2.0):
    return run.measure(cell or tiny_cell(), SEED, seconds, False, "cpu",
                       str(tmp_path), out=open(os.devnull, "w"))


def _amino_null(models, p_value):
    """The port's projection with the amino background in place of its
    2 bits an amino residue, the null HMMER scores a protein against."""
    blocks = []
    for m in models:
        scale = reprojection.threshold256_scale_factor(
            m.msv_mu, m.msv_lambda, m.max_length, m.model_length, p_value)
        bits = ssv.AMINO_NULL_BITS if m.alphabet == "amino" else np.float32(2)
        null = (bits * scale).astype(np.float32)
        v = null - m.match_scores * (reprojection.LOG2_E * scale)
        blocks.append(np.clip(reprojection.c_round(v), -128, 127
                              ).astype(np.int8))
    return np.concatenate(blocks, axis=0)


@pytest.fixture
def amino_null(monkeypatch):
    """Searches of amino models scored against the amino background
    (nucleotide models as the port scores them)."""
    monkeypatch.setattr(api, "project_models", _amino_null)


def _cell(name):
    return tiny_amino_cell() if name == "amino" else tiny_cell(name)


@pytest.mark.parametrize("cell", ["rfam150k.contigs-stream",
                                  "rfam150k.chr22-genomic"])
def test_sound_run_is_correct(cell, tmp_path):
    res = _run(tmp_path, tiny_cell(cell))
    assert res["correct"], res["checks"]
    assert res["sample"]["reference_hits"] > 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("isolate", [True, False])
def test_sound_amino_run_is_correct(isolate, tmp_path, amino_null):
    """Amino models against proteomes, isolated or chained: every number
    at 0 once the search scores residues against the amino background."""
    res = _run(tmp_path, tiny_amino_cell(1_500 if isolate else 500,
                                         isolate))
    assert res["correct"], res["checks"]
    assert res["sample"]["reference_hits"] > 0
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["rfam150k.contigs-stream", "amino"])
def test_control_is_not_correct(cell, tmp_path):
    row = control.control_readings(_cell(cell), SEED, "cpu", str(tmp_path))
    assert row["score_rows_differing"] > 0
    assert row["hits_missing"] + row["hits_extra"] > 0


# the control's readings of the tiny nucleotide cells at seed 2**31 + 11, as
# the reference read them before it took amino models and isolation
PINNED_CONTROL = {
    "rfam150k.contigs-stream": (1200, 525, 0, 670),
    "rfam150k.chr22-genomic": (1200, 227, 1, 285),
    "rfam150k.chr22-uniform": (1200, 28, 0, 68),
}


@pytest.mark.parametrize("cell", sorted(PINNED_CONTROL))
def test_nucleotide_reference_is_pinned(cell, tmp_path):
    row = control.control_readings(tiny_cell(cell), 2**31 + 11, "cpu",
                                   str(tmp_path))
    assert (row["score_rows_differing"], row["hits_missing"],
            row["hits_extra"], row["reference_hits"]) == PINNED_CONTROL[cell]


def _take(h, keep):
    return ResolvedHits(*(np.asarray(getattr(h, f))[keep] for f in (
        "sequence_index", "sequence_position", "phmm_index",
        "phmm_position")))


def _stale(hits):
    """A step that returns its state unchanged: each request answered with
    the previous request's hits."""
    last = []

    def wrapped(self):
        h = hits(self)
        out = last[0] if last else h
        last[:] = [h]
        return out
    return wrapped


def _half(hits):
    """Half of the batch left out."""
    return lambda self: _take(hits(self), slice(None, None, 2))


def _altered(hits):
    """An answer altered where it is produced: every third hit one position
    further on."""
    def wrapped(self):
        h = hits(self)
        pos = np.array(h.sequence_position)
        pos[::3] += 1
        return ResolvedHits(h.sequence_index, pos, h.phmm_index,
                            h.phmm_position)
    return wrapped


@pytest.mark.parametrize("cell", ["rfam150k.contigs-stream", "amino"])
@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_faults_are_not_correct(fault, cell, tmp_path, monkeypatch,
                                amino_null):
    monkeypatch.setattr(Havac, "hits", fault(Havac.hits))
    res = _run(tmp_path, _cell(cell))
    assert not res["correct"]
    assert res["checks"]["hits_missing"]["value"] + \
        res["checks"]["hits_extra"]["value"] > 0


def test_late_fault_is_not_correct(tmp_path, monkeypatch):
    """Answers altered only once every file has answered once (a fault
    after a regrow, or in a buffer reused late in the window): the first
    answers match the reference, the later ones differ from the first."""
    hits = Havac.hits
    calls = []

    def late(self):
        calls.append(None)
        h = hits(self)
        if len(calls) <= 3:  # the warm search, then each file's first
            return h
        return _take(h, slice(1, None))
    monkeypatch.setattr(Havac, "hits", late)
    res = _run(tmp_path, tiny_cell("rfam150k.chr22-genomic"))
    assert res["sample"]["later_answers"] > 0
    assert not res["correct"]
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert checks["answers_differing"] == res["sample"]["later_answers"]
    assert checks["hits_missing"] == checks["hits_extra"] == 0


def test_wrong_scores_are_not_correct(tmp_path, monkeypatch):
    load = Havac.load_phmm

    def off_by_one(self, *a, **k):
        out = load(self, *a, **k)
        self.scores = self.scores.copy()
        self.scores[5] += 1
        return out
    monkeypatch.setattr(Havac, "load_phmm", off_by_one)
    res = _run(tmp_path)
    assert not res["correct"]
    assert res["checks"]["score_rows_differing"]["value"] == 1


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of each cell on the card: correct, and its line has
    the cell's metrics (``python -m pytest ssvbench/tests -m cuda``)."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for cell in cells:
        out = subprocess.run(
            [sys.executable, "-m", "ssvbench.run", "--workload", cell,
             "--seed", "424242", "--seconds", "3", "--trace", "0"],
            cwd=run.ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.splitlines()[-1])
        assert res["correct"], res["checks"]
        assert set(res["metrics"]) == {
            m["name"] for m in run.load_cell(cell).end_to_end}
