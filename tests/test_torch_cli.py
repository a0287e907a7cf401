"""`Havac.scan_files` and the CLI subcommands of the port against the JAX
package's, on the same files.

The JAX side runs its serial XLA backend, as tests/test_cli.py runs it.
Hits are compared exactly, TSV outputs byte for byte, JSON reports key for
key. Amino scans are held to per-file JAX runs, not to the JAX
``scan_files``: that one encodes every file as DNA whatever the models'
alphabet (`havac_tpu/engine/api.py` ``scan_files``), which the port repairs.
"""

import io
import json
import os
import threading
import time

import numpy as np
import pytest

from havac_tpu.engine import Havac as JaxHavac
from havac_tpu.engine import cli as jax_cli
from havac_tpu.io.hmm import write_hmm
from havac_tpu.ops.common import SsvKernelConfig
from havac_tpu.testing.generator import generate_planted_fixture
from havac_tpu_torch.convert import profile_hmms_from_reference
from havac_tpu_torch.engine import Havac, HavacUsageError
from havac_tpu_torch.engine import cli
from havac_tpu_torch.engine.api import SCAN_PRODUCER_THREAD

P_VALUE = 0.05
CFG = SsvKernelConfig(block_width=1024, rows_per_strip=8, interpret=True)
FIELDS = ("sequence_index", "sequence_position", "phmm_index",
          "phmm_position", "strand")
DATA = os.path.join(os.path.dirname(__file__), "data")
NHMMER = [os.path.join(DATA, f"nhmmer_fixture.{x}")
          for x in ("hmm", "fasta", "tblout")]


def write_fasta(path, records):
    with open(path, "w") as f:
        f.write("".join(f">{n}\n{s}\n" for n, s in records))
    return str(path)


@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    d = tmp_path_factory.mktemp("dna")
    models, _ = generate_planted_fixture(seed=81, model_length=36,
                                         sequence_length=10, num_models=2)
    write_hmm(models, str(d / "m.hmm"))
    paths = []
    for i, seed in enumerate((81, 82, 83)):
        _, recs = generate_planted_fixture(
            seed=seed, model_length=36, sequence_length=1500 + 400 * i,
            num_models=2)
        recs = [(f"{n}-f{i}-{k}", s) for k, (n, s) in enumerate(recs)]
        paths.append(write_fasta(d / f"db{i}.fasta", recs))
    return str(d / "m.hmm"), paths


def assert_same_hits(a, b):
    assert len(a) == len(b)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


# ---------------------------------------------------------------- scan_files

@pytest.mark.parametrize("strand", ["forward", "both"])
def test_scan_files_matches_jax_scan_files(dna, strand):
    hmm, paths = dna
    ref = JaxHavac(p_value=P_VALUE, config=CFG, backend="xla", strand=strand)
    want = list(ref.load_phmm(hmm).scan_files(paths))
    ours = Havac(p_value=P_VALUE, device="cpu", strand=strand)
    got = list(ours.load_phmm(hmm).scan_files(paths, prefetch=2))
    assert [p for p, _ in got] == paths == [p for p, _ in want]
    assert sum(len(h) for _, h in got) > 0
    for (_, a), (_, b) in zip(got, want):
        assert_same_hits(a, b)
    if strand == "both":
        assert any((h.strand == "-").any() for _, h in got)


def test_scan_files_amino_matches_per_file_runs(tmp_path):
    """Each file is encoded in the models' alphabet: the port's amino scan
    equals a JAX run per file (whose load_sequence does take the alphabet;
    amino runs need the JAX SWAR kernel, here in interpret mode) over the
    port's projected scores, which take HMMER's amino background where the
    JAX package takes 2 bits a residue."""
    models, _ = generate_planted_fixture(seed=5, model_length=30,
                                         sequence_length=10, num_models=2,
                                         alphabet="amino")
    paths = []
    for i in range(2):
        _, recs = generate_planted_fixture(
            seed=5 + i, model_length=30, sequence_length=1200,
            num_models=2, alphabet="amino")
        paths.append(write_fasta(tmp_path / f"a{i}.fasta", recs))
    ours = Havac(p_value=0.02, device="cpu")
    got = list(ours.load_phmm(profile_hmms_from_reference(models))
               .scan_files(paths))
    assert ours.alphabet == "amino" and ours.database.alphabet == "amino"
    assert sum(len(h) for _, h in got) > 0
    swar = SsvKernelConfig(block_width=3072, rows_per_strip=30, packing=3,
                           interpret=True)
    for path, hits in got:
        ref = JaxHavac(p_value=0.02, config=swar, backend="pallas_interpret",
                       chunk_symbols=3072, chunk_rows=60)
        ref.load_phmm(models)
        ref.scores = ours.scores
        ref.load_sequence(path).run()
        assert_same_hits(hits, ref.hits())


def producer_alive():
    return any(t.name == SCAN_PRODUCER_THREAD and t.is_alive()
               for t in threading.enumerate())


def wait_for_producer_exit(timeout=10.0):
    deadline = time.monotonic() + timeout
    while producer_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    return not producer_alive()


def test_scan_files_closed_early_stops_the_producer(dna):
    """Closing the generator after the first file: the producer, blocked on
    a full queue with later files parsed, gives up and ends."""
    hmm, paths = dna
    engine = Havac(p_value=P_VALUE, device="cpu").load_phmm(hmm)
    gen = engine.scan_files(paths * 3, prefetch=1)
    path, hits = next(gen)
    assert path == paths[0] and len(hits) > 0
    time.sleep(0.3)  # let the producer fill the queue and block on put()
    assert producer_alive()
    gen.close()
    assert wait_for_producer_exit()


def test_scan_files_raises_a_producer_error_on_the_consumer(dna, tmp_path):
    hmm, paths = dna
    engine = Havac(p_value=P_VALUE, device="cpu").load_phmm(hmm)
    gen = engine.scan_files([paths[0], str(tmp_path / "missing.fasta"),
                             paths[1]])
    assert next(gen)[0] == paths[0]
    with pytest.raises((OSError, ValueError), match="missing.fasta"):
        next(gen)
    assert wait_for_producer_exit()


def test_scan_files_needs_models():
    with pytest.raises(HavacUsageError, match="load_phmm"):
        next(Havac(device="cpu").scan_files(["x.fasta"]))


# ----------------------------------------------------------------------- CLI

def run_both(capsys, jax_args, port_args):
    """(rc, stdout) of the JAX CLI and of the port's on the same call."""
    out = []
    for main, args in ((jax_cli.main, jax_args), (cli.main, port_args)):
        rc = main(args)
        out.append((rc, capsys.readouterr().out))
    return out


JAX = ["--backend", "xla"]
PORT = ["--device", "cpu"]


@pytest.mark.parametrize("mode", ["tblout", "float-ssv", "both-strands"])
def test_cli_validate_matches_jax(capsys, mode):
    hmm, fasta, tbl = NHMMER
    args = ["validate", "--hmm", hmm, "--fasta", fasta, "--pvalue", "0.02",
            "--slack", "2", "--min-recall", "0.95", "--show-disagreements"]
    if mode != "float-ssv":
        args += ["--tblout", tbl]
    if mode == "both-strands":
        args += ["--strand", "both"]
    (rc_j, out_j), (rc_p, out_p) = run_both(capsys, args + JAX, args + PORT)
    assert rc_p == rc_j
    assert json.loads(out_p) == json.loads(out_j)
    assert json.loads(out_p)["num_engine_hits"] > 0


def test_cli_quantize_matches_jax(capsys):
    hmm, fasta, tbl = NHMMER
    args = ["quantize", "--hmm", hmm, "--fasta", fasta, "--tblout", tbl,
            "--pvalue", "0.02"]
    (rc_j, out_j), (rc_p, out_p) = run_both(capsys, args + JAX, args + PORT)
    assert rc_p == rc_j == 0
    assert json.loads(out_p) == json.loads(out_j) != {}


def test_cli_benchmark_matches_jax(capsys, dna, tmp_path):
    hmm, paths = dna
    args = ["benchmark", "--hmm", hmm, "--fasta", paths[1], "--pvalue",
            str(P_VALUE)]
    trace = tmp_path / "trace"
    (rc_j, out_j), (rc_p, out_p) = run_both(
        capsys, args + JAX, args + PORT + ["--verify", "--trace", str(trace)])
    j, p = json.loads(out_j), json.loads(out_p)
    assert rc_p == rc_j == 0
    assert p["num_hits"] == j["num_hits"] > 0
    assert p["backend"] == "torch" and p["num_chunks"] == 1
    assert set(p) == set(j) | {"verified_hits", "unverified_hits"}
    assert set(p["phase_seconds"]) == set(j["phase_seconds"])
    assert p["unverified_hits"] == 0
    with open(trace / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    launches = [e for e in events if e.get("name") == "havac.launch"]
    assert [e["args"]["column_chunk"] for e in launches] == [0]


@pytest.mark.parametrize("strand", ["forward", "both"])
def test_cli_scan_matches_jax(capsys, dna, tmp_path, strand):
    hmm, paths = dna
    outs = [tmp_path / "jax.tsv", tmp_path / "port.tsv"]
    args = ["scan", "--hmm", hmm, *paths, "--pvalue", str(P_VALUE),
            "--strand", strand, "--prefetch", "2"]
    (rc_j, _), (rc_p, _) = run_both(capsys, args + JAX + ["--out", str(outs[0])],
                                    args + PORT + ["--out", str(outs[1])])
    assert rc_p == rc_j == 0
    text = outs[1].read_text()
    assert text == outs[0].read_text()
    assert {ln.split("\t")[0] for ln in text.splitlines()[1:]} == set(paths)


def test_cli_serve_matches_jax(capsys, dna, tmp_path, monkeypatch):
    """One JSON status line per request, blank lines skipped, a missing file
    answered with an error while the server lives on, ``quit`` ends it; the
    hits files equal the JAX server's."""
    hmm, paths = dna
    missing = str(tmp_path / "missing.fasta")
    statuses, files = [], []
    for main, tag, extra in ((jax_cli.main, "jax", JAX),
                             (cli.main, "port", PORT)):
        out0 = str(tmp_path / f"{tag}0.tsv")
        req = f"{paths[0]}\t{out0}\n\n{missing}\n{paths[1]}\nquit\n{paths[2]}\n"
        monkeypatch.setattr("sys.stdin", io.StringIO(req))
        assert main(["serve", "--hmm", hmm, "--pvalue", str(P_VALUE),
                     *extra]) == 0
        lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
        statuses.append(lines)
        with open(out0) as f0, open(paths[1] + ".hits.tsv") as f1:
            files.append((f0.read(), f1.read()))
    jax_lines, port_lines = statuses
    assert len(port_lines) == len(jax_lines) == 4  # ready + 3 requests
    assert port_lines[0] == jax_lines[0] == {"ready": True, "models": 2}
    assert port_lines[1]["out"].endswith("port0.tsv")
    assert port_lines[2]["file"] == missing and "error" in port_lines[2]
    assert "error" in jax_lines[2]
    assert port_lines[3]["out"] == paths[1] + ".hits.tsv"
    for p, j in zip(port_lines[1::2], jax_lines[1::2]):
        assert p["hits"] == j["hits"] > 0
    assert files[0] == files[1]
