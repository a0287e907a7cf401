"""A cell's inputs: the model collection of its configuration (a ``.hmm``
file) and the FASTA files of its traffic mix, drawn from ``--seed``.

The generators are frozen copies of the port's, with the seed as a
parameter: ``synthetic_workload`` and ``genomic_sequence`` of
`havac_tpu_torch/tools/runtime_table.py` (draw for draw: seed 7 gives that
tool's models and chromosome), ``model_from_consensus`` of
`havac_tpu_torch/testing/generator.py`, ``write_hmm`` of
`havac_tpu_torch/io/hmm.py` and ``write_fasta`` of
`havac_tpu_torch/testing/workload.py`. Later changes to the program do not
move them.

One generator, :func:`make_inputs`, reads every traffic mix: a mix is a
JSON file of parameters (``traffic/<name>.json``), never code. The model
collection and the genome's two repeat families are the configuration's
alone, drawn from its fixed ``collection.seed`` with its
``repeat_model_share`` (a deployment searches one collection, whatever the
traffic); the files' sequences, sizes and order are drawn from
``--seed``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

FASTA_LINE = 80
NUCLEOTIDES = b"ACGT"


@dataclass
class Model:
    """One profile HMM as the SSV filter reads it: match emissions as
    negative natural-log probabilities, ``(length, 4)`` float32."""

    name: str
    match_scores: np.ndarray
    max_length: int
    msv_mu: float
    msv_lambda: float

    @property
    def model_length(self) -> int:
        return int(self.match_scores.shape[0])


@dataclass
class FastaFile:
    """One written request: its path and its records' names and lengths."""

    path: str
    names: List[str]
    lengths: np.ndarray  # int64 (records,)

    @property
    def residues(self) -> int:
        return int(self.lengths.sum())


@dataclass
class Inputs:
    hmm_path: str
    model_lengths: np.ndarray  # int64 (models,)
    files: List[FastaFile] = field(default_factory=list)

    @property
    def model_positions(self) -> int:
        return int(self.model_lengths.sum())


def rng_for(seed: int) -> np.random.Generator:
    """The cell's generator: any whole number is a seed (negative ones and
    those past 64 bits wrap); 7 is the port's tools' fixed seed."""
    return np.random.default_rng(int(seed) % (1 << 64))


# ------------------------------------------------------------------ models

def model_from_consensus(consensus_codes: np.ndarray, name: str,
                         match_probability: float = 0.91,
                         msv_mu: float = -9.8664,
                         msv_lambda: float = 0.71313) -> Model:
    """A model whose match states emit ``consensus_codes`` with
    ``match_probability`` (the rest spread evenly), maximum instance length
    four times its length."""
    codes = np.asarray(consensus_codes, dtype=np.int64)
    length = codes.shape[0]
    probs = np.full((length, 4), (1.0 - match_probability) / 3,
                    dtype=np.float64)
    probs[np.arange(length), codes] = match_probability
    return Model(name=name, match_scores=(-np.log(probs)).astype(np.float32),
                 max_length=4 * length, msv_mu=msv_mu, msv_lambda=msv_lambda)


def repeat_families(rng: np.random.Generator):
    """Two repeat families (300 and 1,500 positions) and the share of a
    genomic chromosome each covers."""
    return [(rng.integers(0, 4, size=300).astype(np.uint8), 0.20),
            (rng.integers(0, 4, size=1500).astype(np.uint8), 0.10)]


def synthetic_models(rng: np.random.Generator, total_positions: int,
                     families, repeat_every: int,
                     length_range: Sequence[int] = (60, 200),
                     match_probability: float = 0.91,
                     msv_mu: float = -9.8664,
                     msv_lambda: float = 0.71313) -> List[Model]:
    """Consensus models of ``length_range`` positions until
    ``total_positions`` exist; with ``repeat_every`` n > 0 every n-th is
    cut from a repeat family (the port's tools: every fifth for genomic
    composition, none for uniform)."""
    lo, hi = (int(v) for v in length_range)
    models: List[Model] = []
    cum = 0
    i = 0
    while cum < total_positions:
        length = int(rng.integers(lo, hi))
        length = min(length, total_positions - cum) or 1
        if repeat_every and i % repeat_every == repeat_every - 1:
            fam = families[i % len(families)][0]
            off = int(rng.integers(0, max(1, fam.shape[0] - length)))
            consensus = fam[off:off + max(length, 8)]
            if consensus.shape[0] < max(length, 8):
                consensus = np.tile(fam, 2)[:max(length, 8)]
        else:
            consensus = rng.integers(0, 4, size=max(length, 8)).astype(np.uint8)
        models.append(model_from_consensus(
            consensus, f"synth-{i}", match_probability, msv_mu, msv_lambda))
        cum += models[-1].model_length
        i += 1
    return models


# --------------------------------------------------------------- sequences

def genomic_sequence(rng: np.random.Generator, seq_len: int,
                     families) -> np.ndarray:
    """A chromosome with genomic composition: GC-varying isochores,
    interspersed repeat copies with ~15 % divergence, tandem
    microsatellites (~3 %)."""
    seq = np.empty(seq_len, dtype=np.uint8)
    pos = 0
    while pos < seq_len:  # isochores: 50-300 kb blocks, GC 32-58 %
        blk = int(rng.integers(50_000, 300_000))
        gc = rng.uniform(0.32, 0.58)
        p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
        n = min(blk, seq_len - pos)
        seq[pos:pos + n] = rng.choice(4, size=n, p=p).astype(np.uint8)
        pos += n
    for fam, frac in families:  # interspersed repeats, diverged
        fam_len = fam.shape[0]
        ncopy = int(seq_len * frac) // fam_len
        starts = rng.integers(0, seq_len - fam_len, size=ncopy)
        for s in starts:
            copy = fam.copy()
            nmut = rng.binomial(fam_len, 0.15)
            idx = rng.integers(0, fam_len, size=nmut)
            copy[idx] = rng.integers(0, 4, size=nmut)
            seq[s:s + fam_len] = copy
    placed = 0
    while placed < int(seq_len * 0.03):  # tandem microsatellites
        unit = rng.integers(0, 4, size=int(rng.integers(2, 7))).astype(np.uint8)
        arr = np.tile(unit, int(rng.integers(10, 60)))
        s = int(rng.integers(0, seq_len - arr.shape[0]))
        seq[s:s + arr.shape[0]] = arr
        placed += arr.shape[0]
    return seq


def chromosome(rng: np.random.Generator, length: int, composition: str,
               families) -> np.ndarray:
    if composition == "genomic":
        return genomic_sequence(rng, length, families)
    return rng.integers(0, 4, size=length).astype(np.uint8)


def synthetic_workload(total_positions: int, seq_len: int,
                       composition: str = "uniform", seed: int = 7
                       ) -> Tuple[List[Model], np.ndarray]:
    """Families, models, then one chromosome, from one generator: at seed 7
    the port's ``runtime_table.synthetic_workload``, draw for draw."""
    rng = rng_for(seed)
    families = repeat_families(rng)
    models = synthetic_models(rng, total_positions, families,
                              5 if composition == "genomic" else 0)
    return models, chromosome(rng, seq_len, composition, families)


def bin_order(rng: np.random.Generator, n: int) -> np.ndarray:
    """Request k takes the size of rank ``order[k]``: the ranks of ``u + k
    φ`` (mod 1), ``u`` drawn from the seed, so that every run of
    consecutive requests spreads over the sizes."""
    x = (rng.random() + np.arange(n) * 0.6180339887498949) % 1.0
    return np.argsort(np.argsort(x))


def bin_lengths(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` request lengths stratified over log-uniform [lo, hi]: the same
    set for every seed, so a seed changes the order, not the work."""
    q = (np.arange(n) + 0.5) / n
    return np.round(np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
                    ).astype(np.int64)


def contig_lengths(rng: np.random.Generator, total: int, spec: dict
                   ) -> List[int]:
    """Log-normal contig lengths (median and sigma of ``spec``), clipped,
    until they fill ``total``; the last is cut to fit (dropped below the
    clip's floor)."""
    lo, hi = (int(v) for v in spec["clip"])
    out: List[int] = []
    filled = 0
    while filled < total:
        n = int(round(spec["median"] * math.exp(spec["sigma"]
                                                * rng.standard_normal())))
        n = min(max(n, lo), hi, total - filled)
        if n < lo:
            break
        out.append(n)
        filled += n
    return out


# ------------------------------------------------------------------ writers

def _fmt_score(score: float) -> str:
    return "      *" if math.isinf(score) else f"{score:.5f}"


def write_hmm(models: Sequence[Model], path: str) -> None:
    """HMMER3/f text with the fields SSV reads (flat inserts and
    transitions), as the port's ``write_hmm`` writes it."""
    flat = "  ".join(["1.38629"] * 4)
    trans = "  ".join(["0.01000"] * 7)
    with open(path, "w") as out:
        for m in models:
            out.write("HMMER3/f [3.4 | havac_tpu]\n")
            out.write(f"NAME  {m.name}\n")
            out.write(f"LENG  {m.model_length}\n")
            out.write(f"MAXL  {m.max_length}\n")
            out.write("ALPH  DNA\n")
            out.write("RF    no\nMM    no\nCONS  yes\nCS    no\nMAP   yes\n")
            out.write("NSEQ  1\nEFFN  1.000000\nCKSUM 0\n")
            for kind in ("MSV     ", "VITERBI ", "FORWARD "):
                out.write(f"STATS LOCAL {kind} {m.msv_mu:9.4f} "
                          f"{m.msv_lambda:8.5f}\n")
            out.write("HMM     " + "     ".join(f"{c}    " for c in "ACGT")
                      + "\n")
            out.write("        " + "  ".join(
                ["m->m", "m->i", "m->d", "i->m", "i->i", "d->m", "d->d"])
                + "\n")
            out.write(f"  COMPO   {flat}\n          {flat}\n"
                      f"          {trans}\n")
            for pos in range(m.model_length):
                scores = "  ".join(_fmt_score(s) for s in m.match_scores[pos])
                out.write(f"{pos + 1:7d}   {scores} {pos + 1:7d} x - - -\n"
                          f"          {flat}\n          {trans}\n")
            out.write("//\n")


def write_fasta(path: str, records: Sequence[Tuple[str, np.ndarray]]) -> None:
    """FASTA records of nucleotide codes (0..3), 80 columns a line."""
    table = np.frombuffer(NUCLEOTIDES, dtype=np.uint8)
    with open(path, "wb") as f:
        for name, codes in records:
            letters = table[codes]
            n = letters.shape[0]
            full = n - n % FASTA_LINE
            body = np.empty((full // FASTA_LINE, FASTA_LINE + 1),
                            dtype=np.uint8)
            body[:, :FASTA_LINE] = letters[:full].reshape(-1, FASTA_LINE)
            body[:, FASTA_LINE] = ord("\n")
            f.write(f">{name}\n".encode())
            f.write(body.tobytes())
            if n > full:
                f.write(letters[full:].tobytes() + b"\n")


# ---------------------------------------------------------------- the cell

def make_inputs(config: dict, traffic: dict, seed: int,
                directory: str) -> Inputs:
    """Write the configuration's ``models.hmm`` and the traffic's FASTA
    files for ``seed`` into ``directory``.

    ``traffic["records"]["kind"]``: ``"chromosome"`` (each file one record
    of ``length`` positions, drawn afresh) or ``"bins"`` (each file a genome
    bin: stratified log-uniform ``bin_length``, filled with log-normal
    ``contig_length`` contigs cut at seed-drawn offsets from one
    ``source_length`` sequence)."""
    composition = traffic["composition"]
    coll = config["collection"]
    crng = rng_for(coll["seed"])
    families = repeat_families(crng)
    share = float(coll["repeat_model_share"])
    models = synthetic_models(
        crng, int(coll["model_positions"]), families,
        int(round(1 / share)) if share else 0,
        coll["model_length_range"], coll["match_probability"],
        coll["msv_mu"], coll["msv_lambda"])
    hmm_path = os.path.join(directory, "models.hmm")
    write_hmm(models, hmm_path)
    inputs = Inputs(hmm_path, np.array([m.model_length for m in models],
                                       dtype=np.int64))
    del models
    rng = rng_for(seed)
    rec = traffic["records"]
    n_files = int(traffic["files"])
    if rec["kind"] == "chromosome":
        for k in range(n_files):
            seq = chromosome(rng, int(rec["length"]), composition, families)
            _write(inputs, directory, k, [(f"chr{k}", seq)])
    elif rec["kind"] == "bins":
        source = chromosome(rng, int(rec["source_length"]), composition,
                            families)
        sizes = bin_lengths(n_files, *rec["bin_length"])
        for k, i in enumerate(bin_order(rng, n_files)):
            lengths = contig_lengths(rng, int(sizes[i]), rec["contig_length"])
            offs = rng.integers(0, source.shape[0] - np.array(lengths))
            _write(inputs, directory, k,
                   [(f"bin{k}_contig{j}", source[o:o + n])
                    for j, (o, n) in enumerate(zip(offs, lengths))])
    else:
        raise ValueError(f"unknown records kind {rec['kind']!r}")
    return inputs


def _write(inputs: Inputs, directory: str, k: int, records) -> None:
    path = os.path.join(directory, f"request{k:04d}.fa")
    write_fasta(path, records)
    inputs.files.append(FastaFile(
        path, [name for name, _ in records],
        np.array([codes.shape[0] for _, codes in records], dtype=np.int64)))
