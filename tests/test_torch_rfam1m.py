"""The ``rfam1m.chr22-genomic`` cell: HAVAC's whole pHMM capacity of DNA
models, each searched alone. Its tiny form scanned by the port on the CPU
against the benchmark's plain reference, its configuration as stated, the
cumulative-slice property of its collection, its kernel reader on
synthetic traces, and the reset counts of an isolated DNA search."""

import json
from collections import Counter

import numpy as np
import pytest
from torch.profiler import ProfilerActivity

from havac_tpu_torch.engine import Havac, trace
from ssvbench import trace as bench_trace
from ssvbench import workload
from ssvbench.kernel_cost import peaks, ssv_sweep
from ssvbench.reference import ssv
from ssvbench.run import Search, Window, load_cell, metric_reader
from ssvbench.tests.tiny import tiny_cell

CELL = "rfam1m.chr22-genomic"
READER = "ssv_word_kernel_roofline.card4_resets"
H100 = "NVIDIA H100 80GB HBM3"
SEED = 2**31 + 2023
COLUMNS = ("sequence_index", "sequence_position", "phmm_index",
           "phmm_position")
# The demangled names of the sweep's instances, as a device trace shows
# them: <kCard4, kReset, threads, words, dump>.
K4_RESET = ("void (anonymous namespace)::ssv_word_kernel<true, true, 256, "
            "2, false>((anonymous namespace)::Sweep)")
K4 = K4_RESET.replace("<true, true,", "<true, false,")
K20_RESET = K4_RESET.replace("<true, true,", "<false, true,")
K20 = K4_RESET.replace("<true, true,", "<false, false,")
K4_RESET_MANGLED = ("_ZN12_GLOBAL__N_115ssv_word_kernelILb1ELb1ELi64ELi2ELb0EE"
                    "EvNS_5SweepE")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The cell's own files, cut in scale only: 1,500 model positions of
    the same collection and 30-kb chromosomes of the same traffic."""
    d = tmp_path_factory.mktemp("rfam1m")
    cell = tiny_cell(CELL, positions=1_500)
    inputs = workload.make_inputs(cell.config, cell.traffic, SEED, str(d))
    return cell, inputs


def _columns(hits):
    got = np.stack([np.asarray(getattr(hits, c), np.int64) for c in COLUMNS],
                   axis=1)
    return got[np.lexsort(got.T[::-1])]


def _reference(inputs, path, isolate):
    """The reference's resolved hits over every position of ``path``."""
    coll = ssv.read_hmm(inputs.hmm_path)
    db = ssv.read_fasta(path, coll.card)
    _, row, pos = ssv.window_hits(
        [(db.symbols, 0)], db.symbols.shape[0], ssv.project(coll, 0.02),
        model_lengths=coll.lengths if isolate else None)
    out = ssv.resolve(row, pos, db, coll)
    return out[np.lexsort(out.T[::-1])]


def _scan(inputs, isolate, **chunks):
    eng = Havac(p_value=0.02, device="cpu", strand="forward",
                isolate_models=isolate, **chunks)
    eng.load_phmm(inputs.hmm_path)
    paths = [f.path for f in inputs.files]
    got = list(eng.scan_files(paths))
    assert [p for p, _ in got] == paths
    return [_columns(h) for _, h in got]


# ----------------------------------------------------------- the search


@pytest.mark.parametrize("chunks", [{}, {"chunk_symbols": 9_000,
                                         "chunk_rows": 410}])
def test_tiny_cell_isolated_equals_reference(tiny, chunks):
    """Every file's hits, isolated, are the reference's over the whole
    file, column for column, in one launch a file or across row and
    column chunks whose edges cut models."""
    cell, inputs = tiny
    assert cell.config["search"]["isolate_models"] is True
    assert len(inputs.files) == 2 and inputs.model_positions >= 1_500
    total = 0
    for f, got in zip(inputs.files, _scan(inputs, True, **chunks)):
        ref = _reference(inputs, f.path, isolate=True)
        np.testing.assert_array_equal(got, ref)
        total += ref.shape[0]
    assert total > 0


def test_tiny_cell_chained_differs(tiny):
    """The same search with the models chained is the chained reference's,
    and another answer than the isolated one: isolation took effect."""
    _, inputs = tiny
    isolated = _scan(inputs, True)
    chained = _scan(inputs, False)
    for f, iso, ch in zip(inputs.files, isolated, chained):
        np.testing.assert_array_equal(ch, _reference(inputs, f.path, False))
    assert any(iso.shape != ch.shape or not np.array_equal(iso, ch)
               for iso, ch in zip(isolated, chained))


def test_isolated_dna_counts_its_reset_windows(tiny, tmp_path, monkeypatch):
    """An isolated DNA scan counts ``reset_windows`` above 0, and its
    ``havac.launch`` spans carry card 4 and the model starts among their
    rows: a column chunk's resets add up to the number of models."""
    _, inputs = tiny
    n_models = inputs.model_lengths.shape[0]
    eng = Havac(p_value=0.02, device="cpu", isolate_models=True,
                chunk_symbols=16_000, chunk_rows=410)
    eng.load_phmm(inputs.hmm_path)
    monkeypatch.setattr(trace, "_ARGS", [])
    with trace.profiler([ProfilerActivity.CPU]) as prof:
        _, hits = next(eng.scan_files([inputs.files[0].path]))
        st = eng.stats
    out = str(tmp_path / "trace.json")
    trace.export_chrome_trace(prof, out)
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    launches = [e["args"] for e in events
                if e.get("cat") == "user_annotation"
                and e.get("name") == "havac.launch"]
    assert len(launches) == st.pipeline_prof["launches"] > 2
    assert {a["card"] for a in launches} == {4}
    assert any(a["resets"] > 0 for a in launches)
    per_column = Counter()
    for a in launches:
        per_column[a["column_chunk"]] += a["resets"]
    assert set(per_column.values()) == {n_models}
    assert st.pipeline_prof["reset_windows"] == sum(
        a["reset_windows"] for a in launches) > 0
    assert len(hits) > 0


# ----------------------------------------------------------- the cell


def test_cell_as_stated():
    cell = load_cell(CELL)
    coll, search = cell.config["collection"], cell.config["search"]
    assert cell.config["name"] == "rfam1m" and cell.chips == 1
    assert coll["model_positions"] == 1_000_000
    assert coll.get("alphabet", "dna") == "dna"
    assert search["isolate_models"] is True
    assert search["strand"] == "forward" and search["p_value"] == 0.02
    assert cell.config["reduced"] == [] and len(cell.config["source"]) <= 200
    assert cell.config["reference"] == "ssvbench/reference/ssv.py"
    # the collection is rfam150k's but for its size; the traffic is its
    # genomic cell's own file
    ref = load_cell("rfam150k.chr22-genomic")
    other = dict(ref.config["collection"], model_positions=1_000_000)
    assert coll == other and cell.traffic == ref.traffic
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "search_gcups"}
    assert {m["name"] for m in cell.per_layer} == {READER,
                                                   "device.idle_share"}


class _Drawn(Exception):
    def __init__(self, models):
        super().__init__()
        self.models = models


def _drawn_models(name, monkeypatch, tmp_path):
    """The collection ``make_inputs`` draws for cell ``name``, caught at
    the ``.hmm`` writer before anything is written or any chromosome is
    drawn."""
    def catch(models, path):
        raise _Drawn(models)

    monkeypatch.setattr(workload, "write_hmm", catch)
    cell = load_cell(name)
    with pytest.raises(_Drawn) as got:
        workload.make_inputs(cell.config, cell.traffic, SEED, str(tmp_path))
    return got.value.models


def test_rfam150k_is_a_cumulative_slice_of_rfam1m(monkeypatch, tmp_path):
    """rfam150k's models but its cut last one are rfam1m's first, score
    for score, as hmmDbByLength.py cuts one collection at cumulative
    sizes; the models' lengths stay in the configuration's range."""
    small = _drawn_models("rfam150k.chr22-genomic", monkeypatch, tmp_path)
    large = _drawn_models(CELL, monkeypatch, tmp_path)
    assert sum(m.model_length for m in small) == 150_043
    assert sum(m.model_length for m in large) == 1_000_000
    k = len(small) - 1
    assert len(large) > 6 * len(small)
    for a, b in zip(small[:k], large[:k]):
        assert a.name == b.name and a.max_length == b.max_length
        np.testing.assert_array_equal(a.match_scores, b.match_scores)
    assert small[k].model_length < large[k].model_length
    lengths = np.array([m.model_length for m in large[:-1]])
    assert lengths.min() >= 60 and lengths.max() < 200


# ----------------------------------------------------------- the reader


def _events(kernels):
    ev = [{"ph": "X", "cat": "user_annotation", "name": bench_trace.WINDOW_SPAN,
           "ts": 0.0, "dur": 30_000_000.0}]
    t = 1_000.0
    for name, dur in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": t,
                   "dur": dur})
        t += dur + 10.0
    return ev


SEARCHES = [(50_818_468, 1_000_000, 250_000_000)] * 3


def _window(kernels, kind=H100):
    w = Window([Search(i % 2, p, h, 10.0 * i, 10.0 * i + 10.0,
                       sweep_seconds=9.5) for i, (p, _, h) in
                enumerate(SEARCHES)], 30.0, 1_000_000, kind, card=4)
    if kernels is not None:
        w.trace = bench_trace.reduce_events(_events(kernels))
    return w


def test_reader_reads_only_the_card4_reset_kernel():
    """Over the card-4 reset-row instances alone, demangled or mangled,
    the floor ``least_seconds(..., 4)`` of the window's searches over the
    kernel's summed seconds."""
    least = ssv_sweep.least_seconds(SEARCHES, peaks(H100), 4)
    assert least["bound"] == "operations"
    w = _window([(K4_RESET, 20_000_000.0), (K4, 3_000_000.0),
                 (K20_RESET, 2_000_000.0), (K20, 1_000_000.0)])
    assert metric_reader(READER)(w) == pytest.approx(
        100 * least["seconds"] / 20.0)
    assert w.notes[READER]["kernel_s"] == pytest.approx(20.0)
    assert w.notes[READER]["seconds"] == pytest.approx(least["seconds"])
    # the bytes at 2-bit codes and 4 score bytes a row
    assert w.notes[READER]["bytes_s"] == pytest.approx(least["bytes_s"])
    assert least["bytes_s"] < ssv_sweep.least_seconds(
        SEARCHES, peaks(H100), 20)["bytes_s"]
    w = _window([(K4_RESET_MANGLED, 12_000_000.0), (K4_RESET, 8_000_000.0),
                 (K4.replace("256", "64"), 5_000_000.0)])
    assert metric_reader(READER)(w) == pytest.approx(
        100 * least["seconds"] / 20.0)


def test_reader_fails_without_the_card4_reset_kernel():
    """A trace of the chained card-4 kernel, of card 20 or of neither
    fails the run; an untraced window, or a card without published peaks,
    gives nothing to read."""
    for kernels in ([(K4, 1_000.0)], [(K20_RESET, 1_000.0), (K20, 5.0)],
                    [("_ZN12_GLOBAL__N_115ssv_word_kernelILb1ELb0ELi256ELi2"
                      "ELb0EEEvNS_5SweepE", 1_000.0)], [("other", 5.0)], []):
        with pytest.raises(RuntimeError):
            metric_reader(READER)(_window(kernels))
    assert metric_reader(READER)(_window(None)) is None
    assert metric_reader(READER)(_window([(K4_RESET, 1_000.0)],
                                         kind="cpu")) is None

