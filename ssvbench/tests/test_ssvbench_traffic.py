"""The traffic generators: deterministic in the seed, and the frozen copies
agree with the port's draw for draw."""

import hashlib
import os

import numpy as np
import pytest

from ssvbench import workload
from ssvbench.reference import ssv
from ssvbench.tests.tiny import tiny_amino_cell, tiny_cell

# the tiny nucleotide cells' files (models.hmm, then each request) at seed
# 2**31 + 11, as the generator wrote them before it took amino models
PINNED = {
    "rfam150k.contigs-stream":
        "9b2686e87ac62081af7f0eb7386d91ebb2f617afa2f36b1612c5bcc80bb571dd",
    "rfam150k.chr22-genomic":
        "b58f57475081c5eb6c5c2d2eda8ad0035200c8c8b864a8dd875e0ac55e0bc071",
    "rfam150k.chr22-uniform":
        "6dc6b373dd8438287571a01cfe2a5dc8cead259e04dc7523d21cd0b5f1d2a5ab",
    "rfam10k.chr22-genomic":
        "b58f57475081c5eb6c5c2d2eda8ad0035200c8c8b864a8dd875e0ac55e0bc071",
}


def _cell(name):
    return tiny_amino_cell() if name == "amino" else tiny_cell(name)


def _digest(inputs):
    h = hashlib.sha256()
    for path in [inputs.hmm_path] + [f.path for f in inputs.files]:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


@pytest.mark.parametrize("cell", ["rfam150k.contigs-stream",
                                  "rfam150k.chr22-genomic",
                                  "rfam150k.chr22-uniform", "amino"])
def test_inputs_deterministic_in_seed(cell, tmp_path):
    c = _cell(cell)
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


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_nucleotide_inputs_are_pinned(cell, tmp_path):
    c = tiny_cell(cell)
    assert _digest(workload.make_inputs(c.config, c.traffic, 2**31 + 11,
                                        str(tmp_path))) == PINNED[cell]


def test_amino_models(tmp_path):
    """Log-normal lengths inside the clip, the collection's positions
    exactly, each row the consensus at ``match_probability`` and the rest
    in the background's proportions; a length range works too, and repeat
    families are refused."""
    coll = tiny_amino_cell(positions=5_000).config["collection"]
    models = workload.amino_models(workload.rng_for(coll["seed"]), coll)
    lengths = np.array([m.model_length for m in models])
    assert lengths.sum() == 5_000
    lo, hi = coll["model_length"]["clip"]
    assert lengths[:-1].min() >= lo and lengths.max() <= hi
    for m in models[:5]:
        p = np.exp(-m.match_scores.astype(np.float64))
        assert np.allclose(p.sum(axis=1), 1, atol=1e-6)
        top = p.argmax(axis=1)
        assert np.allclose(p.max(axis=1), coll["match_probability"])
        rest = p.copy()
        rest[np.arange(p.shape[0]), top] = 0
        ratio = rest / workload.BACKGROUND
        ratio[np.arange(p.shape[0]), top] = np.nan
        assert np.allclose(np.nanmin(ratio, axis=1),
                           np.nanmax(ratio, axis=1), rtol=1e-5)
    ranged = dict(coll, model_length_range=[20, 40])
    del ranged["model_length"]
    got = workload.amino_models(workload.rng_for(1), ranged)
    assert all(20 <= m.model_length < 40 for m in got[:-1])
    with pytest.raises(ValueError):
        workload.amino_models(workload.rng_for(1),
                              dict(coll, repeat_model_share=0.2))


def test_amino_match_lines_as_the_port_writes_them(tmp_path):
    """The bulk writer's match lines are the port writer's ("%.5f")."""
    from havac_tpu_torch.io.hmm import ProfileHmm, write_hmm

    coll = tiny_amino_cell(positions=800).config["collection"]
    models = workload.amino_models(workload.rng_for(coll["seed"]), coll)
    workload.write_hmm(models, str(tmp_path / "mine.hmm"))
    write_hmm([ProfileHmm(m.name, m.model_length, m.max_length, "amino",
                          m.msv_mu, m.msv_lambda, m.match_scores)
               for m in models], str(tmp_path / "theirs.hmm"))

    def match_lines(name):
        return [line for line in (tmp_path / name).read_text().splitlines()
                if line.endswith(" x - - -")]
    mine = match_lines("mine.hmm")
    assert len(mine) == 800 and mine == match_lines("theirs.hmm")


def test_proteome_composition_and_sizes(tmp_path):
    """Without domains the residues follow the background; each file holds
    one of the stratified protein counts, the same set for every seed."""
    c = tiny_amino_cell(files=6)
    c.traffic["records"].update(domain_share=0.0, proteins=[100, 200])
    counts = []
    for seed in (1, 2):
        os.makedirs(tmp_path / str(seed))
        inputs = workload.make_inputs(c.config, c.traffic, seed,
                                      str(tmp_path / str(seed)))
        counts.append(sorted(len(f.names) for f in inputs.files))
        lo, hi = c.traffic["records"]["protein_length"]["clip"]
        residues = []
        for f in inputs.files:
            assert f.lengths.min() >= lo and f.lengths.max() <= hi
            db = ssv.read_fasta(f.path, 20)
            residues.append(np.delete(db.symbols, db.starts[1:] - 1))
        res = np.concatenate(residues)
        freq = np.bincount(res, minlength=20) / res.shape[0]
        assert np.abs(freq - ssv.AMINO_BACKGROUND).max() < 0.005
    assert counts[0] == counts[1] == sorted(
        workload.bin_lengths(6, 100, 200).tolist())


def test_planted_domains_give_reference_hits(tmp_path):
    """The planted domains are what the isolated reference finds: the same
    proteomes with every protein carrying one read over twice the hits of
    proteomes with none."""
    hits = {}
    for share in (0.0, 1.0):
        c = tiny_amino_cell(files=1)
        c.traffic["records"].update(domain_share=share, domains=[1, 1])
        os.makedirs(tmp_path / str(share))
        inputs = workload.make_inputs(c.config, c.traffic, 3,
                                      str(tmp_path / str(share)))
        coll = ssv.read_hmm(inputs.hmm_path)
        db = ssv.read_fasta(inputs.files[0].path, 20)
        w = db.symbols.shape[0]
        win, _, _ = ssv.window_hits([(db.symbols, 0)], w,
                                    ssv.project(coll, 0.02),
                                    model_lengths=coll.lengths)
        hits[share] = win.shape[0] / w
    assert hits[1.0] > 2 * hits[0.0] > 0
