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
``--seed``. A collection of ``alphabet`` ``"amino"`` is drawn from the
amino background (HMMER3's, :data:`ssvbench.reference.ssv.AMINO_BACKGROUND`)
and searched by ``"proteome"`` traffic; the nucleotide path draws exactly
as before.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from ssvbench.reference.ssv import AMINO, AMINO_BACKGROUND

FASTA_LINE = 80
NUCLEOTIDES = b"ACGT"
AMINO_LETTERS = AMINO.encode()
# HMMER's frequencies sum to 0.9999999: the draws take them normalised
BACKGROUND = AMINO_BACKGROUND / AMINO_BACKGROUND.sum()
# the insert and composition lines of an amino model: the background's
# negative natural logs, as HMMER writes a null-like insert emission
_AMINO_FLAT = "  ".join(f"{v:.5f}" for v in -np.log(AMINO_BACKGROUND))


@dataclass
class Model:
    """One profile HMM as the SSV filter reads it: match emissions as
    negative natural-log probabilities, ``(length, card)`` float32 (card 4
    nucleotide, 20 amino)."""

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
    card: int = 4  # the alphabet's size: 4 nucleotide, 20 amino

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


def lognormal_lengths(rng: np.random.Generator, n: int, spec: dict
                      ) -> np.ndarray:
    """``n`` log-normal lengths (``median``, ``sigma``), rounded and
    clipped to ``clip``."""
    lo, hi = (int(v) for v in spec["clip"])
    x = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.round(x), lo, hi).astype(np.int64)


def amino_model(consensus_codes: np.ndarray, name: str,
                match_probability: float, msv_mu: float,
                msv_lambda: float) -> Model:
    """A protein model whose match states emit ``consensus_codes`` with
    ``match_probability`` and the rest over the other 19 residues in
    proportion to the background; maximum instance length four times its
    length, as :func:`model_from_consensus`."""
    codes = np.asarray(consensus_codes, dtype=np.int64)
    length = codes.shape[0]
    rest = BACKGROUND[codes]
    probs = ((1.0 - match_probability) * BACKGROUND[None, :]
             / (1.0 - rest)[:, None])
    probs[np.arange(length), codes] = match_probability
    return Model(name=name, match_scores=(-np.log(probs)).astype(np.float32),
                 max_length=4 * length, msv_mu=msv_mu, msv_lambda=msv_lambda)


def amino_models(rng: np.random.Generator, coll: dict) -> List[Model]:
    """Protein consensus models drawn from the amino background until
    ``model_positions`` exist, the last cut to fit. Lengths are log-normal
    (``model_length``: ``median``, ``sigma``, ``clip``) or uniform over
    ``model_length_range``."""
    if float(coll.get("repeat_model_share", 0)):
        raise ValueError("an amino collection draws no repeat families: "
                         "its repeat_model_share must be 0")
    total = int(coll["model_positions"])
    models: List[Model] = []
    cum = 0
    while cum < total:
        if "model_length" in coll:
            length = int(lognormal_lengths(rng, 1, coll["model_length"])[0])
        else:
            length = int(rng.integers(*coll["model_length_range"]))
        length = min(length, total - cum)
        consensus = rng.choice(20, size=length, p=BACKGROUND)
        models.append(amino_model(
            consensus, f"prot-{len(models)}", coll["match_probability"],
            coll["msv_mu"], coll["msv_lambda"]))
        cum += length
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


def proteome(rng: np.random.Generator, proteins: int, rec: dict,
             models: Sequence[Model]) -> List[np.ndarray]:
    """One proteome of ``proteins`` proteins' codes: log-normal
    ``protein_length``, residues i.i.d. from the amino background. A
    ``domain_share`` of the proteins carry ``domains`` [lo, hi] planted
    domains, each one sample of a seed-drawn model's match emissions over
    the whole model, written without overlap at seed-drawn offsets; a
    protein too short for its domains is lengthened to hold them."""
    lengths = lognormal_lengths(rng, proteins, rec["protein_length"])
    carriers = np.flatnonzero(rng.random(proteins) < rec["domain_share"])
    lo, hi = (int(v) for v in rec["domains"])
    per = rng.integers(lo, hi + 1, size=carriers.shape[0])
    picks = rng.integers(0, len(models), size=int(per.sum()))
    sizes = np.array([models[p].model_length for p in picks], np.int64)
    owner = np.repeat(np.arange(carriers.shape[0]), per)
    need = np.bincount(owner, weights=sizes, minlength=carriers.shape[0])
    lengths[carriers] = np.maximum(lengths[carriers], need.astype(np.int64))
    codes = rng.choice(20, size=int(lengths.sum()), p=BACKGROUND
                       ).astype(np.uint8)
    starts = np.concatenate([[0], np.cumsum(lengths)])
    a = 0
    for c, n in zip(carriers, per):
        mine, span = picks[a:a + n], sizes[a:a + n]
        a += n
        cuts = np.sort(rng.integers(0, lengths[c] - span.sum() + 1, size=n))
        offs = starts[c] + cuts + np.concatenate([[0], np.cumsum(span)[:-1]])
        for p, o, n_p in zip(mine, offs, span):
            codes[o:o + n_p] = emit(rng, models[p].match_scores)
    return [codes[s:s + n] for s, n in zip(starts[:-1], lengths)]


def emit(rng: np.random.Generator, scores: np.ndarray) -> np.ndarray:
    """One sample of each match row's emissions (``scores``: negative
    natural logs), in row order."""
    cdf = np.cumsum(np.exp(-scores.astype(np.float64)), axis=1)
    u = rng.random(scores.shape[0]) * cdf[:, -1]
    return np.minimum((cdf < u[:, None]).sum(axis=1),
                      scores.shape[1] - 1).astype(np.uint8)


# ------------------------------------------------------------------ writers

def _digits(values: np.ndarray, width: int, blank: bool = True
            ) -> np.ndarray:
    """(n, width) ASCII of whole numbers ``0 <= values < 10**width``,
    right-aligned: "%{width}d" with ``blank``, else zero-padded."""
    v = np.asarray(values, dtype=np.int64)
    out = np.empty((v.shape[0], width), dtype=np.uint8)
    for k in range(width - 1, -1, -1):
        out[:, k] = 48 + v % 10
        v = v // 10
    if blank:
        lead = (np.cumsum(out != ord("0"), axis=1) == 0)
        lead[:, -1] = False
        out[lead] = ord(" ")
    return out


def _scores_ascii(scores: np.ndarray) -> np.ndarray:
    """(rows, 9 x card - 2) ASCII of each row's "%.5f" fields joined by two
    blanks, for finite scores in [0, 10)."""
    q = np.round(scores.astype(np.float64) * 1e5)
    if not (np.isfinite(q).all() and q.min() >= 0 and q.max() < 10**6):
        raise ValueError("amino scores must be finite and in [0, 10)")
    rows, card = q.shape
    d = _digits(q.reshape(-1), 6, blank=False).reshape(rows, card, 6)
    out = np.full((rows, card, 9), ord(" "), dtype=np.uint8)
    out[:, :, 0] = d[:, :, 0]
    out[:, :, 1] = ord(".")
    out[:, :, 2:7] = d[:, :, 1:]
    return out.reshape(rows, card * 9)[:, :-2]


def write_hmm(models: Sequence[Model], path: str) -> None:
    """HMMER3/f text with the fields SSV reads, as the port's ``write_hmm``
    writes it: flat transitions, match lines of "%.5f" scores (finite, in
    [0, 10)). Nucleotide models are ``ALPH  DNA`` with flat inserts; amino
    models ``ALPH  amino``, the 20 columns ``ACDEFGHIKLMNPQRSTVWY``, with
    insert and COMPO lines of the background's negative natural logs. The
    match lines are formatted in bulk: a Pfam-sized collection has
    millions of rows."""
    trans = "  ".join(["0.01000"] * 7)
    with open(path, "wb") as out:
        for m in models:
            if m.match_scores.shape[1] == 20:
                letters, alph, flat = AMINO, "amino", _AMINO_FLAT
            else:
                letters, alph, flat = "ACGT", "DNA", "  ".join(
                    ["1.38629"] * 4)
            head = (
                "HMMER3/f [3.4 | havac_tpu]\n"
                f"NAME  {m.name}\nLENG  {m.model_length}\n"
                f"MAXL  {m.max_length}\nALPH  {alph}\n"
                "RF    no\nMM    no\nCONS  yes\nCS    no\nMAP   yes\n"
                "NSEQ  1\nEFFN  1.000000\nCKSUM 0\n"
                + "".join(f"STATS LOCAL {kind} {m.msv_mu:9.4f} "
                          f"{m.msv_lambda:8.5f}\n"
                          for kind in ("MSV     ", "VITERBI ", "FORWARD "))
                + "HMM     " + "     ".join(f"{c}    " for c in letters)
                + "\n        " + "  ".join(["m->m", "m->i", "m->d", "i->m",
                                           "i->i", "d->m", "d->d"]) + "\n"
                f"  COMPO   {flat}\n          {flat}\n          {trans}\n")
            out.write(head.encode())
            n = m.model_length
            node = _digits(np.arange(1, n + 1), 7)
            tail = f" x - - -\n          {flat}\n          {trans}\n"
            out.write(np.concatenate([
                node, np.full((n, 3), ord(" "), np.uint8),
                _scores_ascii(m.match_scores),
                np.full((n, 1), ord(" "), np.uint8), node,
                np.tile(np.frombuffer(tail.encode(), np.uint8), (n, 1))],
                axis=1).tobytes())
            out.write(b"//\n")


def write_fasta(path: str, records: Sequence[Tuple[str, np.ndarray]],
                letters: bytes = NUCLEOTIDES) -> None:
    """FASTA records of codes (0..3 of ``ACGT``, or 0..19 of
    :data:`AMINO_LETTERS`), 80 columns a line."""
    table = np.frombuffer(letters, dtype=np.uint8)
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
    of ``length`` positions, drawn afresh), ``"bins"`` (each file a genome
    bin: stratified log-uniform ``bin_length``, filled with log-normal
    ``contig_length`` contigs cut at seed-drawn offsets from one
    ``source_length`` sequence), both nucleotide, or ``"proteome"`` (each
    file one proteome of stratified log-uniform ``proteins``, see
    :func:`proteome`), for an amino collection."""
    coll = config["collection"]
    amino = coll.get("alphabet", "dna") == "amino"
    rec = traffic["records"]
    if amino != (rec["kind"] == "proteome"):
        raise ValueError(f"{rec['kind']!r} traffic does not search a "
                         f"{coll.get('alphabet', 'dna')!r} collection")
    crng = rng_for(coll["seed"])
    if amino:
        families = None
        models = amino_models(crng, coll)
    else:
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
                                       dtype=np.int64),
                    card=20 if amino else 4)
    rng = rng_for(seed)
    n_files = int(traffic["files"])
    if rec["kind"] == "chromosome":
        del models
        for k in range(n_files):
            seq = chromosome(rng, int(rec["length"]), traffic["composition"],
                             families)
            _write(inputs, directory, k, [(f"chr{k}", seq)])
    elif rec["kind"] == "bins":
        del models
        source = chromosome(rng, int(rec["source_length"]),
                            traffic["composition"], families)
        sizes = bin_lengths(n_files, *rec["bin_length"])
        for k, i in enumerate(bin_order(rng, n_files)):
            lengths = contig_lengths(rng, int(sizes[i]), rec["contig_length"])
            offs = rng.integers(0, source.shape[0] - np.array(lengths))
            _write(inputs, directory, k,
                   [(f"bin{k}_contig{j}", source[o:o + n])
                    for j, (o, n) in enumerate(zip(offs, lengths))])
    elif rec["kind"] == "proteome":
        sizes = bin_lengths(n_files, *rec["proteins"])
        for k, i in enumerate(bin_order(rng, n_files)):
            proteins = proteome(rng, int(sizes[i]), rec, models)
            _write(inputs, directory, k,
                   [(f"proteome{k}_protein{j}", codes)
                    for j, codes in enumerate(proteins)], AMINO_LETTERS)
    else:
        raise ValueError(f"unknown records kind {rec['kind']!r}")
    return inputs


def _write(inputs: Inputs, directory: str, k: int, records,
           letters: bytes = NUCLEOTIDES) -> None:
    path = os.path.join(directory, f"request{k:04d}.fa")
    write_fasta(path, records, letters)
    inputs.files.append(FastaFile(
        path, [name for name, _ in records],
        np.array([codes.shape[0] for _, codes in records], dtype=np.int64)))
