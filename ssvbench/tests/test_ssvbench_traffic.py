"""The traffic generators: deterministic in the seed, and the frozen copies
agree with the port's draw for draw."""

import hashlib
import os

import numpy as np
import pytest

from ssvbench import workload
from ssvbench.tests.tiny import tiny_cell


def _digest(inputs):
    h = hashlib.sha256()
    for path in [inputs.hmm_path] + [f.path for f in inputs.files]:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


@pytest.mark.parametrize("cell", ["rfam150k.contigs-stream",
                                  "rfam150k.chr22-genomic",
                                  "rfam150k.chr22-uniform"])
def test_inputs_deterministic_in_seed(cell, tmp_path):
    c = tiny_cell(cell)
    digests = []
    for seed, sub in ((2**31 + 11, "a"), (2**31 + 11, "b"), (5, "c")):
        os.makedirs(tmp_path / sub)
        digests.append(_digest(workload.make_inputs(
            c.config, c.traffic, seed, str(tmp_path / sub))))
    assert digests[0] == digests[1]
    assert digests[0] != digests[2]


@pytest.mark.parametrize("composition", ["uniform", "genomic"])
def test_synthetic_workload_draw_for_draw(composition):
    from havac_tpu_torch.tools.runtime_table import synthetic_workload

    theirs, seq = synthetic_workload(3_000, 40_000, composition)
    mine, seq2 = workload.synthetic_workload(3_000, 40_000, composition,
                                             seed=7)
    assert np.array_equal(seq, seq2)
    assert len(theirs) == len(mine)
    for a, b in zip(theirs, mine):
        assert a.name == b.name and a.max_length == b.max_length
        assert np.array_equal(a.match_scores, b.match_scores)


@pytest.mark.parametrize("cell", ["rfam150k.contigs-stream",
                                  "rfam150k.chr22-genomic",
                                  "rfam150k.chr22-uniform"])
def test_collection_is_the_configurations_alone(cell, tmp_path):
    """Every traffic mix of a configuration searches one collection: the
    port's genomic models at seed 7, whatever the traffic or the seed."""
    from havac_tpu_torch.io.hmm import write_hmm
    from havac_tpu_torch.tools.runtime_table import synthetic_workload

    c = tiny_cell(cell)
    inputs = workload.make_inputs(c.config, c.traffic, 2**31 + 5,
                                  str(tmp_path))
    theirs, _ = synthetic_workload(
        c.config["collection"]["model_positions"], 1_000, "genomic")
    write_hmm(theirs, str(tmp_path / "theirs.hmm"))
    with open(inputs.hmm_path) as f:
        assert f.read() == (tmp_path / "theirs.hmm").read_text()


def test_write_hmm_matches_port(tmp_path):
    from havac_tpu_torch.io.hmm import write_hmm
    from havac_tpu_torch.tools.runtime_table import synthetic_workload

    theirs, _ = synthetic_workload(900, 1_000, "genomic")
    mine, _ = workload.synthetic_workload(900, 1_000, "genomic", seed=7)
    write_hmm(theirs, str(tmp_path / "theirs.hmm"))
    workload.write_hmm(mine, str(tmp_path / "mine.hmm"))
    assert (tmp_path / "theirs.hmm").read_text() == \
        (tmp_path / "mine.hmm").read_text()


def test_write_fasta_matches_port(tmp_path):
    from havac_tpu_torch.testing.workload import write_fasta

    codes = np.random.default_rng(3).integers(0, 4, 1_003).astype(np.uint8)
    write_fasta(str(tmp_path / "theirs.fa"), "chr", codes)
    workload.write_fasta(str(tmp_path / "mine.fa"), [("chr", codes)])
    assert (tmp_path / "theirs.fa").read_bytes() == \
        (tmp_path / "mine.fa").read_bytes()


def test_bin_lengths_same_set_for_every_seed(tmp_path):
    c = tiny_cell()
    sets = []
    for seed in (1, 2):
        os.makedirs(tmp_path / str(seed))
        inputs = workload.make_inputs(c.config, c.traffic, seed,
                                      str(tmp_path / str(seed)))
        totals = [f.residues for f in inputs.files]
        lo, hi = c.traffic["records"]["contig_length"]["clip"]
        for f in inputs.files:
            assert f.lengths.min() >= lo and f.lengths.max() <= hi
        sets.append(sorted(totals))
    target = workload.bin_lengths(4, *c.traffic["records"]["bin_length"])
    for totals in sets:  # each file within one contig floor of its target
        assert np.all(np.abs(np.array(totals) - np.sort(target)) < 2_500)
