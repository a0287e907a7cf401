"""The port's measurement tools (`havac_tpu_torch/tools/runtime_table.py`,
`hmm_db_by_length.py`, `hostbench.py`, `scaling_mesh.py`) against the JAX
package's tools and engine on the CPU.

Every comparison is exact: the generated workloads array for array, every
hit (resolved columns in order), the cut files byte for byte, the resolved
keys column for column, and the mesh's steps against S + D - 1. The JAX
tools under `tools/` are loaded by path. The tools' card cases are in
`tests/test_torch_cuda.py`, which imports no JAX.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from havac_tpu.engine import Havac as JaxHavac
from havac_tpu.hits.decode import resolve_block_with_keys
from havac_tpu.io.fasta import SequenceDatabase as JaxDatabase
from havac_tpu.parallel.engine_dist import ssv_distributed as jax_distributed
from havac_tpu_torch.engine import Havac
from havac_tpu_torch.engine.pipeline import collector, pairs_from_keys
from havac_tpu_torch.io.hmm import write_hmm
from havac_tpu_torch.testing.workload import write_fasta
from havac_tpu_torch.tools import (hmm_db_by_length, hostbench,
                                   runtime_table, scaling_mesh)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESOLVED = ("sequence_index", "sequence_position", "phmm_index",
            "phmm_position")
SEQ_LEN = 200_000


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_runtime_table():
    return jax_tool("runtime_table")


def assert_same_hits(got, want):
    assert len(got) == len(want)
    for f in RESOLVED:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def recording(monkeypatch):
    """Engines that the tool creates, kept for their hits."""
    made = []

    class Recording(Havac):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(runtime_table, "Havac", Recording)
    return made


def jax_search(models, db):
    engine = JaxHavac(p_value=0.02, backend="xla")
    engine.load_phmm(models).load_sequence(db).run()
    return engine.hits()


# ------------------------------------------------------------ generators


@pytest.mark.parametrize("total,seq_len,composition", [
    (1007, runtime_table.CHR22_LENGTH, "uniform"),
    (1007, 1_000_000, "genomic"),
    (3000, 1_000_000, "genomic"),
])
def test_synthetic_workload_is_the_jax_tools(jax_runtime_table, total,
                                             seq_len, composition):
    """Draw for draw: every model's fields and the chromosome."""
    models, seq = runtime_table.synthetic_workload(total, seq_len,
                                                   composition)
    want_models, want_seq = jax_runtime_table.synthetic_workload(
        total, seq_len, composition)
    np.testing.assert_array_equal(seq, want_seq)
    assert len(models) == len(want_models)
    assert sum(m.model_length for m in models) == total
    for got, want in zip(models, want_models):
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name),
                                          err_msg=f.name)
    assert runtime_table.REFERENCE_SECONDS == \
        jax_runtime_table.REFERENCE_SECONDS


# ---------------------------------------------------------- runtime_table


@pytest.mark.parametrize("composition", ["uniform", "genomic"])
def test_runtime_table_hits_equal_the_jax_engine(
        monkeypatch, tmp_path, jax_runtime_table, composition):
    made = recording(monkeypatch)
    out = tmp_path / "rows.json"
    rc = runtime_table.main([
        "--synthetic", "--lengths", "300", "600", "--seq-len", str(SEQ_LEN),
        "--composition", composition, "--device", "cpu", "--verify-sample",
        "50", "--json", str(out)])
    assert rc == 0
    record = json.loads(out.read_text())
    assert record["provenance"]["device"] == "cpu"
    assert [r["model_positions"] for r in record["rows"]] == [300, 600]
    assert [s["kind"] for s in record["summary"]] == ["cold", "cold"]
    for total, row, engine in zip((300, 600), record["rows"], made):
        models, seq = jax_runtime_table.synthetic_workload(total, SEQ_LEN,
                                                           composition)
        want = jax_search(models, JaxDatabase(
            codes=seq, starts=np.array([0, len(seq) + 1]),
            lengths=np.array([len(seq)]), names=["synth-chr"], seed=0))
        assert row["num_hits"] == len(want) == len(engine.hits())
        assert_same_hits(engine.hits(), want)
        assert row["composition"] == composition
        assert row["native_active"] is True
        assert row["verify"]["verified"] == row["verify"]["sampled"] == min(
            50, row["num_raw_hits"])
        assert set(row["phases"]) >= {"sort", "resolve", "regrow"}
        assert row["chunk_geometry"]["n_col"] >= 1
    assert record["rows"][1]["num_hits"] > 0


def test_runtime_table_file_form_equals_the_jax_engine(monkeypatch, tmp_path):
    made = recording(monkeypatch)
    models, seq = runtime_table.synthetic_workload(600, SEQ_LEN, "genomic")
    hmm, fasta = str(tmp_path / "m.hmm"), str(tmp_path / "chr.fa")
    write_hmm(models, hmm)
    write_fasta(fasta, "synth-chr", seq)
    out = tmp_path / "rows.json"
    assert runtime_table.main(["--hmm", hmm, "--fasta", fasta, "--device",
                               "cpu", "--verify-sample", "20", "--json",
                               str(out)]) == 0
    (row,) = json.loads(out.read_text())["rows"]
    ref = JaxHavac(p_value=0.02, backend="xla")
    want = ref.load_phmm(hmm).load_sequence(fasta).run().hits()
    assert row["num_hits"] == len(want) > 0
    assert row["model_positions"] == 600 and row["composition"] == "file"
    assert_same_hits(made[0].hits(), want)


@pytest.mark.parametrize("tool,argv", [
    (runtime_table, ["--synthetic", "--lengths", "8", "--seq-len", "100"]),
    (scaling_mesh, ["--seq-len", "100", "--positions", "8", "--devices",
                    "1"]),
])
def test_tools_default_to_the_card_and_refuse_without_it(monkeypatch, tool,
                                                         argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)


# ------------------------------------------------------- hmm_db_by_length


def test_hmm_db_by_length_files_equal_the_jax_tools(monkeypatch, tmp_path,
                                                     capsys):
    models, _ = runtime_table.synthetic_workload(3000, 100, "genomic")
    src = str(tmp_path / "all.hmm")
    write_hmm(models, src)
    lengths = ["500", "1000", "2000", "5000"]  # 5000: past the collection
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    assert hmm_db_by_length.main([src, str(ours), "--lengths", *lengths]) == 0
    printed = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["hmm_db_by_length.py", src,
                                      str(theirs), "--lengths", *lengths])
    assert jax_tool("hmm_db_by_length").main() == 0
    want = capsys.readouterr().out
    assert printed.replace(str(ours), "") == want.replace(str(theirs), "")
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) == [
        "db_1000.hmm", "db_2000.hmm", "db_500.hmm"]
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()


# -------------------------------------------------------------- hostbench


@pytest.mark.parametrize("nthreads,presorted", [(1, False), (4, False),
                                                (1, True)])
def test_hostbench_work_item_resolves_as_the_jax_package(nthreads, presorted):
    rng = np.random.default_rng(0)
    db, total = hostbench.fake_db(rng, nseq=2_000)
    prefix = hostbench.model_prefix(rng, 5_000)
    keys = hostbench.make_keys(3, 20_000, 5_000, total)
    ordered = np.sort(keys)
    got = collector(db, prefix)._resolve_chunk(
        (ordered if presorted else keys).copy(), nthreads=nthreads,
        presorted=presorted)
    rows, pos = pairs_from_keys(ordered)
    jdb = JaxDatabase(codes=np.empty(0, np.uint8), starts=db.starts,
                      lengths=db.lengths, names=db.names, seed=0)
    want, kr, kp = resolve_block_with_keys(rows, pos, jdb, prefix)
    np.testing.assert_array_equal(got.keys, ordered)
    for f in RESOLVED:
        np.testing.assert_array_equal(
            getattr(got.resolved, f).astype(np.int64),
            getattr(want, f).astype(np.int64), err_msg=f)
    np.testing.assert_array_equal(pairs_from_keys(got.kept_keys)[0], kr)
    np.testing.assert_array_equal(pairs_from_keys(got.kept_keys)[1], kp)
    assert 0 < kr.size < keys.size  # separators among the keys


def test_hostbench_main_runs(tmp_path, capsys):
    out = tmp_path / "host.json"
    assert hostbench.main(["--hits-per-chunk", "2000", "--chunks", "8",
                           "--json", str(out)]) == 0
    record = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip()) == record
    assert list(record["variants"]) == [v[0] for v in hostbench.VARIANTS]
    for v in record["variants"].values():
        assert v["ms_per_chunk"] > 0 and 0 < v["kept_per_chunk"] <= 2000


# ----------------------------------------------------------- scaling_mesh

MESH_ARGS = ["--seq-len", "131072", "--positions", "512", "--rows-per-step",
             "128"]


@pytest.fixture(scope="module")
def jax_mesh_hits():
    symbols, scores = scaling_mesh.workload(131072, 512)
    mesh = Mesh(np.array(jax.devices()[:8]), ("seq",))
    return jax_distributed(symbols, scores, mesh, rows_per_step=128,
                           rows_per_call=512)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_scaling_mesh_hits_and_steps(jax_mesh_hits, D):
    symbols, scores = scaling_mesh.workload(131072, 512)
    rows, pos, steps, launches, regrows, kernel = scaling_mesh.sweep(
        symbols, scores, torch.device("cpu"), D, 128)
    assert rows.size > 0
    np.testing.assert_array_equal(rows, jax_mesh_hits[0])
    np.testing.assert_array_equal(pos, jax_mesh_hits[1])
    assert (steps, launches, regrows, kernel) == (4 + D - 1, 4 * D, 0, 0)


def test_scaling_mesh_main_reports_each_d(tmp_path):
    out = tmp_path / "mesh.json"
    assert scaling_mesh.main([*MESH_ARGS, "--device", "cpu", "--devices",
                              "1", "2", "4", "--iters", "1", "--json",
                              str(out)]) == 0
    record = json.loads(out.read_text())
    assert record["num_strips"] == 4
    assert "not a scaling figure" in record["note"]
    assert [(r["devices"], r["steps"], r["launches"])
            for r in record["rows"]] == [(1, 4, 4), (2, 5, 8), (4, 7, 16)]
    assert len({r["num_hits"] for r in record["rows"]}) == 1
