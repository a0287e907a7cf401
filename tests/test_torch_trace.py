"""The engine's spans (`havac_tpu_torch/engine/trace.py`): what a profiler
sees of a ``scan_files`` run on the CPU, what the counters hold without a
profiler, and the per-layer metrics of the benchmark that read them."""

import json
import threading
import time
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from havac_tpu_torch.engine import Havac, trace
from havac_tpu_torch.engine.api import SCAN_PRODUCER_THREAD
from havac_tpu_torch.engine.pipeline import PipelinedSweep
from havac_tpu_torch.io.hmm import write_hmm
from havac_tpu_torch.testing.generator import generate_planted_fixture
from ssvbench.run import Search, Window, metric_reader

CHUNKS = dict(chunk_symbols=700, chunk_rows=40)
API_KEYS = {"encode", "encode_wait", "hits"}
NEW_KEYS = ({"stage", "resolve_wait", "tail_merge", "tail_gather",
             "tail_segments"} | API_KEYS)
# The spans the single-device path runs without a regrow, by thread.
PRODUCER = {"havac.encode"}
CONSUMER = {"havac.encode_wait", "havac.hits"}
WORKER = {"havac.stage", "havac.launch", "havac.pull", "havac.resolve_wait",
          "havac.tail.merge", "havac.tail.gather"}
POOL = {"havac.sort", "havac.resolve"}
# The caller's load_phmm, before any request.
LOAD = {"havac.load.parse", "havac.load.project"}
NEW_METRICS = ("api.encode_wait_share", "api.stage_share",
               "pipeline.resolve_wait_share")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    models, _ = generate_planted_fixture(seed=81, model_length=36,
                                         sequence_length=10, num_models=2)
    write_hmm(models, str(d / "m.hmm"))
    paths = []
    for i, seed in enumerate((81, 82)):
        _, recs = generate_planted_fixture(
            seed=seed, model_length=36, sequence_length=1500 + 400 * i,
            num_models=2)
        path = d / f"db{i}.fasta"
        path.write_text("".join(f">{n}-{k}\n{s}\n"
                                for k, (n, s) in enumerate(recs)))
        paths.append(str(path))
    return str(d / "m.hmm"), paths


def scan(hmm, paths):
    """Every file of one ``scan_files`` run: (path, hits, stats), and the
    native id of the producer thread, the one that encodes the files."""
    eng = Havac(p_value=0.05, device="cpu", **CHUNKS).load_phmm(hmm)
    encode, producer = eng._encode, set()

    def encoding(*args, **kw):
        t = threading.current_thread()
        if t.name == SCAN_PRODUCER_THREAD:
            producer.add(t.native_id)
        return encode(*args, **kw)

    eng._encode = encoding
    out = [(path, hits, eng.stats) for path, hits in eng.scan_files(paths)]
    return out, producer


def spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("havac.")]


def test_scan_spans_in_an_all_threads_trace(files, tmp_path, monkeypatch):
    """Under the benchmark's profiler setting every span of the table runs
    on its thread, each launch names its chunk, every span its request,
    and no span holds another on its thread."""
    hmm, paths = files
    monkeypatch.setattr(trace, "_ARGS", [])
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        runs, producer = scan(hmm, paths)
    out = str(tmp_path / "trace.json")
    trace.export_chrome_trace(prof, out)
    ev = spans(out)
    consumer = threading.get_native_id()
    load = [e for e in ev if e["name"] in LOAD]
    assert sorted(e["name"] for e in load) == sorted(LOAD)
    assert {e["tid"] for e in load} == {consumer}
    ev = [e for e in ev if e["name"] not in LOAD]
    by_thread = defaultdict(set)
    for e in ev:
        by_thread[e["tid"]].add(e["name"])
    assert by_thread[consumer] == CONSUMER
    (p,) = producer
    assert by_thread[p] == PRODUCER
    workers = [t for t, names in by_thread.items() if "havac.launch" in names]
    assert len(workers) == len(paths)  # a worker thread a run
    for t in workers:
        assert by_thread[t] == WORKER
    pools = set(by_thread) - set(workers) - {consumer, p}
    assert pools and set().union(*(by_thread[t] for t in pools)) == POOL

    requests = Counter(e["args"]["request"] for e in ev)
    assert set(requests) == {0, 1, 2}  # the last wait finds the end
    for i, (_, _, st) in enumerate(runs):
        geo = st.chunk_geometry
        launches = [e["args"] for e in ev if e["name"] == "havac.launch"
                    and e["args"]["request"] == i]
        assert sorted((a["column_chunk"], a["row_chunk"]) for a in launches
                      ) == [(c, r) for c in range(geo["n_col"])
                            for r in range(geo["n_row"])]
        assert all(a["symbols"] <= geo["chunk_symbols"]
                   and a["rows"] <= geo["chunk_rows"] for a in launches)
        pulls = [e for e in ev if e["name"] == "havac.pull"
                 and e["args"]["request"] == i]
        assert len(pulls) == len(launches) == st.num_chunks
        (gather,) = [e["args"] for e in ev if e["name"] == "havac.tail.gather"
                     and e["args"]["request"] == i]
        assert gather["segments"] == st.pipeline_prof["tail_segments"] > 0
        assert {e["name"] for e in ev if e["args"]["request"] == i} == (
            PRODUCER | CONSUMER | WORKER | POOL)

    for t in by_thread:
        mine = sorted((e for e in ev if e["tid"] == t), key=lambda e: e["ts"])
        for a, b in zip(mine, mine[1:]):
            assert a["ts"] + a["dur"] <= b["ts"] + 1e-3, (a["name"],
                                                          b["name"])


def test_regrow_span(files):
    """A chunk that overflows its key buffer runs once more under
    ``havac.regrow``, after the ``havac.pull`` that found the count."""
    hmm, paths = files
    eng = Havac(p_value=0.05, device="cpu").load_phmm(hmm).load_sequence(
        paths[0])
    sweep = PipelinedSweep(eng._codes(), eng.scores, 700, 40, "cpu",
                           eng.database, eng.phmm_prefix, key_cap=1,
                           request=7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sweep.run()
    names = [e.name for e in prof.events() if e.name.startswith("havac.")]
    assert names.count("havac.regrow") == sweep.regrows >= 1
    assert names.count("havac.pull") == sweep.n_col * sweep.n_row
    assert sweep.prof["regrow"] > 0


def test_spans_without_a_profiler(files, monkeypatch):
    """No profiler: ``record_function`` is never entered, nothing is kept
    for the trace, and every counter is there; the tail's halves make its
    whole."""
    hmm, paths = files
    entered = []
    real = torch.autograd.profiler.record_function

    class counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    monkeypatch.setattr(trace, "_ARGS", [])
    runs, _ = scan(hmm, paths)
    assert entered == [] and trace._ARGS == []
    for _, _, st in runs:
        prof = st.pipeline_prof
        assert NEW_KEYS <= set(prof)
        assert prof["tail_merge"] + prof["tail_gather"] == pytest.approx(
            prof["tail"], abs=1e-3)
        assert prof["resolve_wait"] <= prof["drain"]
        assert min(prof[k] for k in ("stage", "encode", "dispatch")) > 0
    with profile(activities=[ProfilerActivity.CPU]):
        scan(hmm, paths[:1])
    assert "havac.launch" in entered


def test_tail_segments_follow_the_column_chunks(files):
    """One column chunk with hits in every row chunk places one segment a
    row chunk; column chunks that interleave in each row place more."""
    hmm, paths = files
    eng = Havac(p_value=0.05, device="cpu").load_phmm(hmm).load_sequence(
        paths[1])
    counts = {}
    for symbols in (1 << 20, 700):
        sweep = PipelinedSweep(eng._codes(), eng.scores, symbols, 40, "cpu",
                               eng.database, eng.phmm_prefix)
        resolved, parts, _ = sweep.run()
        counts[symbols] = sweep.prof["tail_segments"]
        if symbols == 1 << 20:
            assert sweep.n_col == 1 and sweep.n_row >= 2
            rows = [sweep.row_range(ri) for ri in range(sweep.n_row)]
            kept = eng.phmm_prefix[resolved.phmm_index] + resolved.phmm_position
            assert all(((kept >= r0) & (kept < r1)).any() for r0, r1 in rows)
            assert counts[symbols] == sweep.n_row
        else:
            assert sweep.n_col >= 3
    assert counts[700] > counts[1 << 20]


def test_span_charges_its_counters():
    """``split`` moves the seconds so far to another counter; a lock
    guards a shared dict; a span without a name only counts."""
    prof = {"a": 0.0, "b": 0.0}
    with trace.span("havac.test", prof, "a", threading.Lock()) as s:
        time.sleep(0.01)
        s.split("b")
    assert prof["b"] >= 0.01 and 0 <= prof["a"] < prof["b"]
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with trace.span(None, prof, "a"):
            pass
    assert not any(e.name.startswith("havac.") for e in p.events())


def _search(prof, sweep=0.5, ask=0.0, got=1.0):
    return Search(0, 1000, 10, ask, got, sweep_seconds=sweep, prof=prof)


@pytest.mark.parametrize("name,key", [
    ("api.encode_wait_share", "encode_wait"),
    ("api.stage_share", "stage"),
    ("pipeline.resolve_wait_share", "resolve_wait")])
def test_new_metric_readers(name, key):
    read = metric_reader(name)
    w = Window([_search({key: 0.25}), _search({key: 0.5}, ask=1, got=2)],
               4.0, 100, "cpu")
    assert read(w) == pytest.approx(0.75 / 4.0)
    older = {"fetch": 0.1, "regrow": 0.0, "drain": 0.0, "tail": 0.1}
    assert read(Window([_search({key: 0.25}), _search(older)], 4.0, 100,
                       "cpu")) is None
    assert read(Window([_search(None)], 4.0, 100, "cpu")) is None
    assert read(Window([], 4.0, 100, "cpu")) is None


def test_api_shares_within_the_time_outside_the_sweep(files, tmp_path):
    """Over a real CPU scan of one file at a time, read as the harness
    reads it: the encode wait, the staging and ``hits()`` lie outside the
    sweep and apart in time. (A checkpointed scan sweeps one file at a
    time; an overlapped one stages and sweeps file i+1 while file i's tail
    and ``hits()`` run, so the sum of the runs' sweep seconds counts that
    time twice and ``api.outside_sweep_share`` may read below 0.)"""
    hmm, paths = files
    eng = Havac(p_value=0.05, device="cpu", **CHUNKS,
                checkpoint_path=str(tmp_path / "run.ckpt")).load_phmm(hmm)
    gen = eng.scan_files(paths * 3)
    searches = []
    t0 = time.perf_counter()
    for _ in range(len(paths) * 3):
        ask = time.perf_counter()
        _, hits = next(gen)
        st = eng.stats
        searches.append(Search(0, 1000, len(hits), ask, time.perf_counter(),
                               st.sweep_seconds, dict(st.pipeline_prof)))
    gen.close()
    w = Window(searches, searches[-1].got - t0, 100, "cpu")
    shares = {m: metric_reader(m)(w) for m in NEW_METRICS}
    assert all(v > 0 for v in shares.values())
    hits_share = sum(s.prof["hits"] for s in searches) / w.seconds
    outside = metric_reader("api.outside_sweep_share")(w)
    assert (shares["api.encode_wait_share"] + shares["api.stage_share"]
            + hits_share) <= outside


def test_launches_count_the_launch_spans(files):
    """``launches`` counts the ``havac.launch`` spans of a chunked run, one
    a (column, row) chunk: a regrow's relaunch, under ``havac.regrow``, is
    not counted again."""
    hmm, paths = files
    eng = Havac(p_value=0.05, device="cpu").load_phmm(hmm).load_sequence(
        paths[0])
    sweep = PipelinedSweep(eng._codes(), eng.scores, 700, 40, "cpu",
                           eng.database, eng.phmm_prefix, key_cap=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sweep.run()
    names = [e.name for e in prof.events() if e.name.startswith("havac.")]
    assert sweep.regrows >= 1 and names.count("havac.regrow") == sweep.regrows
    assert sweep.prof["launches"] == names.count("havac.launch") == (
        sweep.n_col * sweep.n_row) > 1
    runs, _ = scan(hmm, paths)
    for _, _, st in runs:
        geo = st.chunk_geometry
        assert st.pipeline_prof["launches"] == st.num_chunks == (
            geo["n_col"] * geo["n_row"])


@pytest.mark.parametrize("alphabet,isolate", [("amino", True),
                                              ("dna", False)])
def test_launch_args_card_and_resets(tmp_path, monkeypatch, alphabet,
                                     isolate):
    """Each ``havac.launch`` names its alphabet's size and the model starts
    among its rows that reset the chain: on an isolated run the resets of
    a column chunk's row chunks add up to the number of models."""
    models, records = generate_planted_fixture(
        seed=83, model_length=30, sequence_length=2_400, num_models=5,
        alphabet=alphabet)
    eng = Havac(p_value=0.05, device="cpu", isolate_models=isolate)
    eng.load_phmm(models).load_sequence(
        "".join(f">{n}\n{s}\n" for n, s in records), is_text=True)
    sweep = PipelinedSweep(eng._codes(), eng.scores, 900, 37, "cpu",
                           eng.database, eng.phmm_prefix,
                           reset_rows=eng.reset_rows)
    assert sweep.n_col >= 2 and sweep.n_row >= 3
    monkeypatch.setattr(trace, "_ARGS", [])
    with trace.profiler([ProfilerActivity.CPU]) as prof:
        sweep.run()
    out = str(tmp_path / "trace.json")
    trace.export_chrome_trace(prof, out)
    launches = [e["args"] for e in spans(out) if e["name"] == "havac.launch"]
    assert len(launches) == sweep.prof["launches"] == sweep.n_col * sweep.n_row
    card = 20 if alphabet == "amino" else 4
    assert {a["card"] for a in launches} == {card}
    per_column = Counter()
    for a in launches:
        per_column[a["column_chunk"]] += a["resets"]
        assert a["reset_windows"] <= a["resets"]
        assert (a["reset_windows"] > 0) == (a["resets"] > 0)
    assert per_column == Counter({c: len(models) if isolate else 0
                                  for c in range(sweep.n_col)})
    assert sweep.prof["reset_windows"] == sum(a["reset_windows"]
                                              for a in launches)


@pytest.mark.parametrize("rows,want", [
    ([], (0, 0)), ([0], (1, 1)), ([15, 16], (2, 2)), ([3, 9, 15], (3, 1)),
    ([36], (1, 1)), ([0, 16, 32, 36], (4, 3))])
def test_reset_counts_align_windows_with_the_launch(rows, want):
    """A launch's reset rows and its 16-row hit windows (from its first
    row, the last one short) that hold one; none without reset rows."""
    from havac_tpu_torch.engine.pipeline import reset_counts

    reset = np.zeros(37, np.int32)
    reset[rows] = 1
    assert reset_counts(reset) == want
    assert reset_counts(None) == (0, 0)


def test_load_prof_times_parse_and_project(files, tmp_path):
    """``load_phmm`` times the ``.hmm`` parse and the projection apart, in
    ``load_prof``, and marks both in a profiler's trace; models handed in
    whole are not parsed."""
    hmm, _ = files
    eng = Havac(p_value=0.05, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.load_phmm(hmm)
    assert set(eng.load_prof) == {"parse", "project"}
    assert eng.load_prof["parse"] > 0 and eng.load_prof["project"] > 0
    names = {e.name for e in prof.events()}
    assert {"havac.load.parse", "havac.load.project"} <= names
    eng.load_phmm(list(eng.models))
    assert eng.load_prof["parse"] == 0 and eng.load_prof["project"] > 0
