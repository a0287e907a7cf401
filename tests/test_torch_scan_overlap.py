"""``Havac.scan_files`` with file i+1's sweep started before file i is
yielded (`havac_tpu_torch/engine/api.py`): the answers, the per-file state
seen at each yield, the ``launched_ahead`` counter, closing early and a
file that fails in its sweep, on the CPU.

A tail made slow on purpose (``slow_tail``) holds each file's finish long
enough that the next file's launches run beside it on every machine;
launches made slow as well (``slow_runs``) keep the next file's run in
flight while the test reads a yield."""

import sys
import threading
import time

import numpy as np
import pytest

from havac_tpu_torch.engine import Havac, HavacRunState
from havac_tpu_torch.engine import pipeline
from havac_tpu_torch.engine.api import SCAN_PRODUCER_THREAD, SWEEP_THREAD
from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.testing.generator import generate_planted_fixture

P_VALUE = 0.05
FIELDS = ("sequence_index", "sequence_position", "phmm_index",
          "phmm_position", "strand")
LENGTHS = (1500, 2700, 900, 3400)  # residues a file, unequal
CHUNKS = {"dna": dict(chunk_symbols=700, chunk_rows=40),
          "amino": dict(chunk_symbols=500, chunk_rows=40)}
# (alphabet, engine options) of the scans held to per-file runs.
CASES = {"dna-forward": ("dna", dict(strand="forward")),
         "dna-both": ("dna", dict(strand="both")),
         "amino-isolated": ("amino", dict(isolate_models=True))}


def _files(d, alphabet, seed):
    models, _ = generate_planted_fixture(seed=seed, model_length=36,
                                         sequence_length=10, num_models=3,
                                         alphabet=alphabet)
    paths = []
    for i, n in enumerate(LENGTHS):
        _, recs = generate_planted_fixture(seed=seed + i, model_length=36,
                                           sequence_length=n, num_models=3,
                                           alphabet=alphabet)
        path = d / f"{alphabet}{i}.fasta"
        path.write_text("".join(f">{name}-f{i}-{k}\n{s}\n"
                                for k, (name, s) in enumerate(recs)))
        paths.append(str(path))
    return models, paths


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("overlap")
    return {"dna": _files(d, "dna", 91), "amino": _files(d, "amino", 95)}


@pytest.fixture
def slow_tail(monkeypatch):
    """Every sweep's tail takes 0.3 s longer."""
    merge = pipeline._merge_resolved

    def slow(*args, **kw):
        time.sleep(0.3)
        return merge(*args, **kw)

    monkeypatch.setattr(pipeline, "_merge_resolved", slow)


@pytest.fixture
def slow_runs(slow_tail, monkeypatch):
    """And every launch 0.05 s longer."""
    launch = ssv_cuda.launch

    def slow(*args, **kw):
        time.sleep(0.05)
        return launch(*args, **kw)

    monkeypatch.setattr(ssv_cuda, "launch", slow)


def engine(alphabet, **kw):
    return Havac(p_value=P_VALUE, device="cpu", **CHUNKS[alphabet], **kw)


def per_file(models, paths, alphabet, **kw):
    """(hits, stats, names) of a ``load_sequence`` + ``run()`` a file."""
    eng = engine(alphabet, **kw).load_phmm(models)
    out = []
    for path in paths:
        eng.load_sequence(path).run()
        out.append((eng.hits(), eng.stats, list(eng.database.names)))
    return out


def assert_same_hits(a, b):
    assert len(a) == len(b)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def sweeps_alive():
    return [t for t in threading.enumerate()
            if t.name == SWEEP_THREAD and t.is_alive()]


def producer_gone(timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(t.name == SCAN_PRODUCER_THREAD and t.is_alive()
                   for t in threading.enumerate()):
            return True
        time.sleep(0.02)
    return False


@pytest.mark.parametrize("prefetch", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_overlapped_scan_equals_per_file_runs(inputs, slow_tail, case,
                                              prefetch):
    """(a) Column for column, each file's hits are a run of its own; every
    later file launched before the previous one was yielded."""
    alphabet, kw = CASES[case]
    models, paths = inputs[alphabet]
    want = per_file(models, paths, alphabet, **kw)
    eng = engine(alphabet, **kw).load_phmm(models)
    got, ahead = [], []
    for path, hits in eng.scan_files(paths, prefetch=prefetch):
        got.append((path, hits))
        ahead.append(eng.stats.pipeline_prof["launched_ahead"])
    assert [p for p, _ in got] == paths
    assert sum(len(h) for _, h in got) > 0
    for (_, h), (w, _, _) in zip(got, want):
        assert_same_hits(h, w)
    assert all(n > 0 for n in ahead[1:])
    if case == "dna-both":
        assert any((h.strand == "-").any() for _, h in got)


def test_each_yield_sees_its_own_file(inputs, slow_runs):
    """(b) At each yield the engine's stats, database and request are the
    yielded file's, though the next file's run is in flight."""
    models, paths = inputs["dna"]
    want = per_file(models, paths, "dna")
    eng = engine("dna").load_phmm(models)
    first = eng._request + 1
    for i, (path, hits) in enumerate(eng.scan_files(paths)):
        if i + 1 < len(paths):
            assert sweeps_alive()
        w_hits, w_stats, w_names = want[i]
        st = eng.stats
        assert st.chunk_geometry == w_stats.chunk_geometry
        assert st.num_raw_hits == w_stats.num_raw_hits
        assert st.num_chunks == w_stats.num_chunks
        assert st.pipeline_prof["launches"] == w_stats.pipeline_prof[
            "launches"] == (st.chunk_geometry["n_col"]
                            * st.chunk_geometry["n_row"]) > 1
        assert list(eng.database.names) == w_names
        assert eng._run.request == first + i
        assert eng.state == HavacRunState.COMPLETED
        assert_same_hits(eng.hits(), w_hits)


def test_launched_ahead_counts_the_overlap(inputs, slow_tail, tmp_path):
    """(c) With the producer ahead, a later file's launches start before
    the previous file is yielded; never the first file's, and never on a
    checkpointed scan, which sweeps one file at a time."""
    models, paths = inputs["dna"]
    eng = engine("dna").load_phmm(models)
    ahead = [(eng.stats.pipeline_prof["launched_ahead"],
              eng.stats.pipeline_prof["launches"])
             for _ in eng.scan_files(paths, prefetch=2)]
    assert ahead[0][0] == 0
    assert all(0 < n <= launches for n, launches in ahead[1:])
    ck = engine("dna", checkpoint_path=str(tmp_path / "run.ckpt")
                ).load_phmm(models)
    assert [ck.stats.pipeline_prof["launched_ahead"]
            for _ in ck.scan_files(paths, prefetch=2)] == [0] * len(paths)


@pytest.mark.parametrize("closed_after", [1, 2])
def test_closing_stops_the_run_in_flight(inputs, slow_runs, closed_after):
    """(d) Closing after the first or a middle yield aborts the next
    file's sweep and joins its thread; nothing is left running and the
    engine runs again."""
    models, paths = inputs["dna"]
    want = per_file(models, paths[:1], "dna")
    eng = engine("dna").load_phmm(models)
    gen = eng.scan_files(paths * 2, prefetch=1)
    for _ in range(closed_after):
        next(gen)
    assert sweeps_alive()  # the next file's run is in flight
    gen.close()
    assert sweeps_alive() == []
    assert eng.state == HavacRunState.COMPLETED
    assert producer_gone()
    eng.load_sequence(paths[0]).run()
    assert eng.state == HavacRunState.COMPLETED
    assert_same_hits(eng.hits(), want[0][0])


class _FailsOn(Havac):
    """A sweep that fails to build for the database whose first record's
    name starts with ``bad``."""

    def _build_sweep(self, run=None):
        db = self.database if run is None else run.database
        if db.names[0].startswith("bad"):
            raise RuntimeError("sweep failed: " + db.names[0])
        return super()._build_sweep(run)


def test_a_failing_file_raises_at_its_own_next(inputs, slow_tail, tmp_path):
    """(e) File 2's sweep fails while file 1 is finishing: file 1 is
    yielded intact, the error is raised at the ``next()`` for file 2, and
    no sweep thread is left."""
    models, paths = inputs["dna"]
    bad = tmp_path / "bad.fasta"
    bad.write_text(">bad-0\nACGTACGTTTGACCA\n")
    want = per_file(models, paths[:2], "dna")
    eng = _FailsOn(p_value=P_VALUE, device="cpu", **CHUNKS["dna"])
    gen = eng.load_phmm(models).scan_files(
        [paths[0], paths[1], str(bad), paths[2]], prefetch=2)
    for w_hits, _, _ in want:
        _, hits = next(gen)
        assert_same_hits(hits, w_hits)
    with pytest.raises(RuntimeError, match="sweep failed: bad-0"):
        next(gen)
    assert eng.state == HavacRunState.ERROR
    with pytest.raises(StopIteration):
        next(gen)
    assert sweeps_alive() == []
    assert producer_gone()


def test_scan_under_a_short_switch_interval(inputs):
    """Threads switched every microsecond: twelve files, each staged while
    the last one launches, equal their own runs and are seen at their own
    yields."""
    models, paths = inputs["dna"]
    want = per_file(models, paths, "dna")
    eng = engine("dna").load_phmm(models)
    first = eng._request + 1
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i, (_, hits) in enumerate(eng.scan_files(paths * 3, prefetch=3)):
            assert eng._run.request == first + i
            assert list(eng.database.names) == want[i % len(paths)][2]
            got.append(hits)
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 3 * len(paths)
    for i, hits in enumerate(got):
        assert_same_hits(hits, want[i % len(paths)][0])
    assert sweeps_alive() == []
