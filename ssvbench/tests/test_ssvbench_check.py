"""``correct``: true on a sound run, false for the control (the reference
in the program's place, in bfloat16) and for each fault a cell can have,
planted under the timed path of a whole run (the harness's look for a
card skipped: the plain sweep on the CPU)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from havac_tpu_torch.engine.api import Havac
from havac_tpu_torch.hits.decode import ResolvedHits
from ssvbench import control, run
from ssvbench.tests.tiny import tiny_cell

SEED = 2**31 + 77


def _run(tmp_path, cell=None, seconds=2.0):
    return run.measure(cell or tiny_cell(), SEED, seconds, False, "cpu",
                       str(tmp_path), out=open(os.devnull, "w"))


@pytest.mark.parametrize("cell", ["rfam150k.contigs-stream",
                                  "rfam150k.chr22-genomic"])
def test_sound_run_is_correct(cell, tmp_path):
    res = _run(tmp_path, tiny_cell(cell))
    assert res["correct"], res["checks"]
    assert res["sample"]["reference_hits"] > 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_control_is_not_correct(tmp_path):
    row = control.control_readings(tiny_cell(), SEED, "cpu", str(tmp_path))
    assert row["score_rows_differing"] > 0
    assert row["hits_missing"] + row["hits_extra"] > 0


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


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_faults_are_not_correct(fault, tmp_path, monkeypatch):
    monkeypatch.setattr(Havac, "hits", fault(Havac.hits))
    res = _run(tmp_path)
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
        assert "setup_s" in res["metrics"] and "search_gcups" in res["metrics"]
