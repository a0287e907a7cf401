"""The ``pfam35.proteomes`` cell: its files at a tiny scale, its two
per-layer readers on synthetic windows, and amino runs judged on the
program's own projection (HMMER's amino background, no stand-in)."""

import copy
import hashlib
import os

import numpy as np
import pytest

from havac_tpu_torch.engine import Havac
from havac_tpu_torch.hits.decode import ResolvedHits
from havac_tpu_torch.scoring import reprojection
from ssvbench import trace, workload
from ssvbench.kernel_cost import peaks, ssv_sweep
from ssvbench.run import Search, Window, load_cell, measure, metric_reader
from ssvbench.tests.tiny import tiny_amino_cell

H100 = "NVIDIA H100 80GB HBM3"
SEED = 2**31 + 1935
CARD20 = "ssv_word_kernel_roofline.card20"
DISPATCH = "pipeline.dispatch_ms_per_launch"
# The demangled names of the sweep's instances, as a device trace shows
# them: <kCard4, kReset, threads, words, dump>.
K20_RESET = ("void (anonymous namespace)::ssv_word_kernel<false, true, 256, "
             "2, false>((anonymous namespace)::Sweep)")
K20 = K20_RESET.replace("<false, true,", "<false, false,")
K4_RESET = K20_RESET.replace("<false, true,", "<true, true,")
K4 = K20_RESET.replace("<false, true,", "<true, false,")


def tiny_pfam35(files=3, positions=2_400):
    """The cell's own files, shrunk in scale only: fewer and shorter
    models (the same median, sigma and clip's floor), fewer and smaller
    proteomes, a smaller sample."""
    cell = copy.deepcopy(load_cell("pfam35.proteomes"))
    coll = cell.config["collection"]
    coll["model_positions"] = positions
    coll["model_length"]["clip"] = [10, 400]
    rec = cell.traffic["records"]
    rec["proteins"] = [30, 50]
    rec["protein_length"]["clip"] = [30, 1_500]
    cell.traffic["files"] = files
    cell.traffic["sample"].update(files=files, windows_per_file=2,
                                  window=2_048)
    return cell


def _digest(inputs):
    h = hashlib.sha256()
    for path in [inputs.hmm_path] + [f.path for f in inputs.files]:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_cell_files_as_stated():
    cell = load_cell("pfam35.proteomes")
    coll, search = cell.config["collection"], cell.config["search"]
    assert coll["alphabet"] == "amino" and coll["repeat_model_share"] == 0
    assert coll["model_positions"] == 3_300_000
    assert coll["model_length"] == {"median": 122, "sigma": 0.8,
                                    "clip": [10, 2500]}
    assert (coll["match_probability"], coll["msv_mu"],
            coll["msv_lambda"]) == (0.37, -9.8664, 0.71313)
    assert search["p_value"] == 0.02 and search["strand"] == "forward"
    assert search["isolate_models"] is True and search["guarantee"]
    assert cell.config["reduced"] == [] and len(cell.config["assumed"]) >= 4
    assert len(cell.config["source"]) <= 200
    rec = cell.traffic["records"]
    assert cell.traffic["files"] == 16 and rec["kind"] == "proteome"
    assert rec["proteins"] == [3000, 5000]
    assert rec["protein_length"] == {"median": 267, "sigma": 0.7,
                                     "clip": [30, 5000]}
    assert rec["domain_share"] == 0.75 and rec["domains"] == [1, 3]
    assert cell.traffic["sample"] == {"files": 4, "windows_per_file": 4,
                                      "window": 8192}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "search_gcups"}
    assert {m["name"] for m in cell.per_layer} == {CARD20, DISPATCH}


# the tiny cell's files at SEED: models.hmm, then each proteome
PINNED_DIGEST = (
    "f1619c46b768bcf41b58f5983eecc429470afc5c386cefaebe2b369240c753e3")


def test_tiny_files_are_pinned(tmp_path):
    """The tiny cell's sizes: the protein counts are the stratified set for
    every seed, the files deterministic in the seed and pinned."""
    cell = tiny_pfam35()
    counts, digests = [], []
    for seed, sub in ((SEED, "a"), (SEED, "b"), (SEED + 1, "c")):
        os.makedirs(tmp_path / sub)
        inputs = workload.make_inputs(cell.config, cell.traffic, seed,
                                      str(tmp_path / sub))
        counts.append(sorted(len(f.names) for f in inputs.files))
        digests.append(_digest(inputs))
        assert inputs.card == 20
        assert inputs.model_positions == 2_400
        lengths = np.concatenate([f.lengths for f in inputs.files])
        assert lengths.min() >= 30 and lengths.max() <= 1_500
    assert counts[0] == counts[1] == counts[2] == sorted(
        workload.bin_lengths(3, 30, 50).tolist()) == [33, 39, 46]
    assert digests[0] == digests[1] != digests[2]
    assert digests[0] == PINNED_DIGEST


def test_collection_is_pfam_sized():
    """The full collection's lengths, drawn from the fixed seed: ~19,700
    models (Pfam 35.0 has 19,632 families), median 122, Lmax 2,500. The
    consensus draws are left out: the lengths are drawn as the generator
    draws them, one model at a time."""
    coll = load_cell("pfam35.proteomes").config["collection"]
    rng = workload.rng_for(coll["seed"])
    lengths, total = [], 0
    while total < coll["model_positions"]:
        n = int(workload.lognormal_lengths(rng, 1, coll["model_length"])[0])
        n = min(n, coll["model_positions"] - total)
        rng.choice(20, size=n, p=workload.BACKGROUND)
        lengths.append(n)
        total += n
    assert len(lengths) == 19_693 and max(lengths) == 2_500
    assert np.median(lengths) == 122


# ------------------------------------------------------------- readers


def _events(kernels):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN,
           "ts": 0.0, "dur": 3_000_000.0}]
    t = 1_000.0
    for name, dur in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": t,
                   "dur": dur})
        t += dur + 10.0
    return ev


def _window(kernels, prof=None, searches=2):
    w = Window([Search(0, 1_400_000, 5_000_000, 2.0 * i, 2.0 * i + 2.0,
                       sweep_seconds=1.9, prof=prof)
                for i in range(searches)], 2.0 * searches, 3_300_000, H100,
               card=20)
    if kernels is not None:
        w.trace = trace.reduce_events(_events(kernels))
    return w


def test_card20_roofline_reads_only_the_card20_reset_kernel():
    w = _window([(K20_RESET, 1_500_000.0), (K20, 300_000.0),
                 (K4_RESET, 200_000.0), (K4, 100_000.0)])
    least = ssv_sweep.least_seconds(
        [(1_400_000, 3_300_000, 5_000_000)] * 2, peaks(H100), 20)
    assert metric_reader(CARD20)(w) == pytest.approx(
        100 * least["seconds"] / 1.5)
    assert w.notes[CARD20]["kernel_s"] == pytest.approx(1.5)
    # the mangled name counts too
    w = _window([("_ZN12_GLOBAL__N_115ssv_word_kernelILb0ELb1ELi64ELi2ELb0EEE"
                  "vNS_5SweepE", 750_000.0), (K20_RESET, 750_000.0)])
    assert metric_reader(CARD20)(w) == pytest.approx(
        100 * least["seconds"] / 1.5)


def test_card20_roofline_fails_without_the_card20_reset_kernel():
    for kernels in ([(K4_RESET, 1_000.0), (K4, 1_000.0)],
                    [(K20, 1_000.0)], [("other", 5.0)]):
        with pytest.raises(RuntimeError):
            metric_reader(CARD20)(_window(kernels))
    assert metric_reader(CARD20)(_window(None)) is None


def test_dispatch_ms_per_launch():
    w = _window(None, prof={"dispatch": 0.0405, "launches": 405})
    w.searches[1].prof = {"dispatch": 0.0810, "launches": 405}
    assert metric_reader(DISPATCH)(w) == pytest.approx(
        1e3 * 0.1215 / 810)
    # a parent without the counter, or a search without it: nothing
    assert metric_reader(DISPATCH)(_window(None, prof={"dispatch": 1.0})
                                   ) is None
    w.searches[0].prof = {"dispatch": 0.0405}
    assert metric_reader(DISPATCH)(w) is None
    assert metric_reader(DISPATCH)(_window(None, prof=None)) is None
    assert metric_reader(DISPATCH)(_window(None, searches=0)) is None


def test_dispatch_reads_a_real_scan(tmp_path):
    """Over a CPU scan of the tiny cell the reader finds its counters: the
    launches of every search, one a (column, row) chunk."""
    cell = tiny_pfam35(files=2)
    inputs = workload.make_inputs(cell.config, cell.traffic, SEED,
                                  str(tmp_path))
    eng = Havac(p_value=0.02, device="cpu", isolate_models=True,
                chunk_rows=500)
    eng.load_phmm(inputs.hmm_path)
    searches = []
    for k, (_, hits) in enumerate(eng.scan_files([f.path for f in
                                                  inputs.files])):
        st = eng.stats
        assert st.pipeline_prof["launches"] == st.num_chunks >= 5
        searches.append(Search(k, inputs.files[k].residues, len(hits),
                               0.0, 1.0, st.sweep_seconds,
                               dict(st.pipeline_prof)))
    w = Window(searches, 2.0, inputs.model_positions, "cpu", card=20)
    got = metric_reader(DISPATCH)(w)
    assert got == pytest.approx(1e3 * sum(s.prof["dispatch"]
                                          for s in searches)
                                / sum(s.prof["launches"] for s in searches))
    assert got > 0


# ------------------------------------------- runs on the program's scores


def _run(cell, tmp_path, seconds=2.0):
    return measure(cell, SEED, seconds, False, "cpu", str(tmp_path),
                   out=open(os.devnull, "w"))


@pytest.mark.parametrize("isolate", [True, False])
def test_amino_run_is_correct_on_the_programs_projection(isolate, tmp_path):
    res = _run(tiny_amino_cell(1_500 if isolate else 500, isolate), tmp_path)
    assert res["correct"], res["checks"]
    assert res["sample"]["reference_hits"] > 0
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_tiny_pfam35_run_is_correct(tmp_path):
    res = _run(tiny_pfam35(), tmp_path)
    assert res["correct"], res["checks"]
    assert res["sample"]["reference_hits"] > 0
    assert set(res["metrics"]) == {"setup_s", "search_gcups"}


def test_nucleotide_null_for_amino_is_not_correct(tmp_path, monkeypatch):
    """The projection as it was, 2 bits a residue whatever the alphabet:
    every score row and the reference's hits differ."""
    monkeypatch.setattr(reprojection, "null_bits",
                        lambda alphabet: reprojection.NUCLEOTIDE_NULL_BITS
                        if alphabet != "amino" else
                        np.full(20, 2.0, dtype=np.float32))
    res = _run(tiny_pfam35(), tmp_path)
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert not res["correct"]
    assert checks["score_rows_differing"] == 2_400
    assert checks["hits_missing"] > 0


def _drop_half(hits):
    return lambda self: ResolvedHits(*(np.asarray(getattr(hits(self), f))
                                       [::2] for f in (
        "sequence_index", "sequence_position", "phmm_index",
        "phmm_position")))


def test_amino_fault_is_not_correct(tmp_path, monkeypatch):
    monkeypatch.setattr(Havac, "hits", _drop_half(Havac.hits))
    res = _run(tiny_amino_cell(), tmp_path)
    assert not res["correct"]
    assert res["checks"]["hits_missing"]["value"] > 0
    assert res["checks"]["score_rows_differing"]["value"] == 0
