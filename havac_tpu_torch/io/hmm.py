"""HMMER3 ``.hmm`` text-format parser and writer.

Replaces the reference's vendored P7HmmReader C submodule. We capture exactly the
fields the SSV pipeline consumes (SURVEY.md §2.4): per model, ``NAME``, ``ACC``,
``LENG`` (model length), ``MAXL`` (max instance length), ``ALPH``, the
``STATS LOCAL MSV`` Gumbel mu/lambda, and the flat match-emission score table
(negative natural-log probabilities, ``*`` = impossible = +inf).

Files may hold many concatenated models (``//`` terminated), exactly as the
reference streams them (`host/phmm/PhmmPreprocessor.cpp:9-31`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, List, Sequence, TextIO, Union

import numpy as np

DNA_ALPHABET = "ACGT"
RNA_ALPHABET = "ACGU"
AMINO_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"  # HMMER column order

_ALPHABET_CARDINALITY = {"dna": 4, "rna": 4, "amino": 20}


class HmmFormatError(ValueError):
    """Raised when an .hmm file does not follow the HMMER3 text format."""


@dataclass
class ProfileHmm:
    """One profile HMM, restricted to the fields SSV needs.

    ``match_scores`` is ``(model_length, alphabet_cardinality)`` float32 holding
    negative natural-log match-emission probabilities (the HMMER3 on-disk
    representation); ``np.inf`` encodes the format's ``*``.
    """

    name: str
    model_length: int
    max_length: int
    alphabet: str
    msv_mu: float
    msv_lambda: float
    match_scores: np.ndarray
    accession: str = ""
    description: str = ""
    extra_header_lines: List[str] = field(default_factory=list)

    @property
    def alphabet_cardinality(self) -> int:
        return _ALPHABET_CARDINALITY[self.alphabet.lower()]

    def __post_init__(self) -> None:
        self.match_scores = np.asarray(self.match_scores, dtype=np.float32)
        expected = (self.model_length, self.alphabet_cardinality)
        if self.match_scores.shape != expected:
            raise ValueError(
                f"match_scores shape {self.match_scores.shape} != {expected}"
            )


def _parse_score_token(token: str) -> float:
    if token == "*":
        return math.inf
    return float(token)


def _read_model(lines: List[str], start: int, path: str) -> tuple[ProfileHmm, int]:
    """Parse one model beginning at ``lines[start]`` (the HMMER3/x line).

    Returns the model and the index one past its ``//`` terminator.
    """
    i = start
    header = lines[i].strip()
    if not header.startswith("HMMER3"):
        raise HmmFormatError(
            f"{path}: model at line {i + 1} does not start with 'HMMER3' "
            f"(got {header[:40]!r})"
        )
    i += 1

    name = ""
    accession = ""
    description = ""
    model_length = -1
    max_length = -1
    alphabet = ""
    msv_mu = None
    msv_lambda = None
    extra_header_lines: List[str] = []

    while i < len(lines):
        line = lines[i].rstrip("\n")
        stripped = line.strip()
        if stripped.startswith("HMM") and not stripped.startswith("HMMER"):
            break
        parts = stripped.split(None, 1)
        key = parts[0] if parts else ""
        value = parts[1] if len(parts) > 1 else ""
        if key == "NAME":
            name = value
        elif key == "ACC":
            accession = value
        elif key == "DESC":
            description = value
        elif key == "LENG":
            model_length = int(value)
        elif key == "MAXL":
            max_length = int(value)
        elif key == "ALPH":
            alphabet = value.lower()
        elif key == "STATS":
            fields = value.split()
            if len(fields) >= 4 and fields[0] == "LOCAL" and fields[1] == "MSV":
                msv_mu = float(fields[2])
                msv_lambda = float(fields[3])
            else:
                extra_header_lines.append(line)
        elif stripped:
            extra_header_lines.append(line)
        i += 1

    if i >= len(lines):
        raise HmmFormatError(f"{path}: model {name!r} has no HMM section")
    if model_length <= 0:
        raise HmmFormatError(f"{path}: model {name!r} missing/invalid LENG")
    if not alphabet:
        raise HmmFormatError(f"{path}: model {name!r} missing ALPH")
    if alphabet not in _ALPHABET_CARDINALITY:
        raise HmmFormatError(f"{path}: model {name!r} has unknown ALPH {alphabet!r}")
    if msv_mu is None or msv_lambda is None:
        raise HmmFormatError(
            f"{path}: model {name!r} missing 'STATS LOCAL MSV' line (required "
            "for p-value score reprojection, PhmmReprojection.cpp:36-39)"
        )
    if max_length <= 0:
        # nhmmer always writes MAXL for nucleotide models; if absent, use the
        # same window-length default HMMER applies (~4 * model length).
        max_length = 4 * model_length

    cardinality = _ALPHABET_CARDINALITY[alphabet]

    # lines[i] is the "HMM  A  C  G  T" header; next line is the transition
    # header ("m->m m->i ...").
    i += 2
    # Optional COMPO block: COMPO line + insert-emission line + transition line.
    if i < len(lines) and lines[i].strip().startswith("COMPO"):
        i += 3
    else:
        # Node-0 insert emissions + transitions.
        i += 2

    match_scores = np.empty((model_length, cardinality), dtype=np.float32)
    for position in range(model_length):
        if i >= len(lines):
            raise HmmFormatError(
                f"{path}: model {name!r} truncated at position {position + 1}"
            )
        tokens = lines[i].split()
        if len(tokens) < 1 + cardinality:
            raise HmmFormatError(
                f"{path}: model {name!r} line {i + 1}: expected node index + "
                f"{cardinality} match scores, got {lines[i]!r}"
            )
        try:
            node = int(tokens[0])
        except ValueError as exc:
            raise HmmFormatError(
                f"{path}: model {name!r} line {i + 1}: bad node index "
                f"{tokens[0]!r}"
            ) from exc
        if node != position + 1:
            raise HmmFormatError(
                f"{path}: model {name!r}: node {node} where {position + 1} expected"
            )
        match_scores[position] = [
            _parse_score_token(t) for t in tokens[1 : 1 + cardinality]
        ]
        i += 3  # skip the insert-emission and transition lines

    while i < len(lines) and lines[i].strip() != "//":
        i += 1
    if i >= len(lines):
        raise HmmFormatError(f"{path}: model {name!r} missing '//' terminator")
    i += 1

    return (
        ProfileHmm(
            name=name,
            accession=accession,
            description=description,
            model_length=model_length,
            max_length=max_length,
            alphabet=alphabet,
            msv_mu=msv_mu,
            msv_lambda=msv_lambda,
            match_scores=match_scores,
            extra_header_lines=extra_header_lines,
        ),
        i,
    )


def read_hmm_text(text: str, path: str = "<string>") -> List[ProfileHmm]:
    lines = text.splitlines()
    models: List[ProfileHmm] = []
    i = 0
    while i < len(lines):
        if lines[i].strip().startswith("HMMER3"):
            model, i = _read_model(lines, i, path)
            models.append(model)
        else:
            if lines[i].strip():
                raise HmmFormatError(
                    f"{path}: unexpected content outside a model at line "
                    f"{i + 1}: {lines[i]!r}"
                )
            i += 1
    if not models:
        raise HmmFormatError(f"{path}: no models found")
    return models


def read_hmm(path: str, native: str = "auto") -> List[ProfileHmm]:
    """Parse every model in a HMMER3 text ``.hmm`` file.

    ``native``: "auto" uses the C++ parser (havac_tpu_torch/native) when built,
    "never"/"always" force a path; both produce identical models."""
    if native != "never":
        from havac_tpu_torch import native as native_mod

        if native_mod.available():
            return native_mod.read_hmm_native(path)
        if native == "always":
            raise RuntimeError(
                "native parser requested but libhavac_native.so is not "
                "built; see havac_tpu_torch.native.build")
    with open(path, "r") as f:
        return read_hmm_text(f.read(), path)


def _fmt_score(score: float) -> str:
    if math.isinf(score):
        return "      *"
    return f"{score:.5f}"


def write_hmm(models: Union[ProfileHmm, Sequence[ProfileHmm]], out: Union[str, TextIO]) -> None:
    """Write models back out in HMMER3/f text format (for test fixtures).

    Emits only the fields this pipeline consumes, with flat insert/transition
    placeholders; the output round-trips through :func:`read_hmm` and is
    accepted by nhmmer-adjacent tooling that only reads SSV-relevant fields.
    """
    if isinstance(models, ProfileHmm):
        models = [models]
    if isinstance(out, str):
        with open(out, "w") as f:
            write_hmm(models, f)
        return

    for m in models:
        k = m.alphabet_cardinality
        if m.alphabet == "amino":
            symbols = AMINO_ALPHABET
        else:
            symbols = DNA_ALPHABET if m.alphabet != "rna" else RNA_ALPHABET
        out.write("HMMER3/f [3.4 | havac_tpu]\n")
        out.write(f"NAME  {m.name}\n")
        if m.accession:
            out.write(f"ACC   {m.accession}\n")
        if m.description:
            out.write(f"DESC  {m.description}\n")
        out.write(f"LENG  {m.model_length}\n")
        out.write(f"MAXL  {m.max_length}\n")
        out.write(f"ALPH  {m.alphabet.upper()}\n")
        out.write("RF    no\nMM    no\nCONS  yes\nCS    no\nMAP   yes\n")
        out.write(f"NSEQ  1\nEFFN  1.000000\nCKSUM 0\n")
        out.write(f"STATS LOCAL MSV      {m.msv_mu:9.4f} {m.msv_lambda:8.5f}\n")
        out.write(f"STATS LOCAL VITERBI  {m.msv_mu:9.4f} {m.msv_lambda:8.5f}\n")
        out.write(f"STATS LOCAL FORWARD  {m.msv_mu:9.4f} {m.msv_lambda:8.5f}\n")
        out.write("HMM     " + "     ".join(f"{c}    " for c in symbols) + "\n")
        out.write(
            "        "
            + "  ".join(["m->m", "m->i", "m->d", "i->m", "i->i", "d->m", "d->d"])
            + "\n"
        )
        flat = "  ".join(["1.38629"] * k)
        trans = "  ".join(["0.01000"] * 7)
        out.write(f"  COMPO   {flat}\n")
        out.write(f"          {flat}\n")
        out.write(f"          {trans}\n")
        for pos in range(m.model_length):
            scores = "  ".join(_fmt_score(s) for s in m.match_scores[pos])
            out.write(f"{pos + 1:7d}   {scores} {pos + 1:7d} x - - -\n")
            out.write(f"          {flat}\n")
            out.write(f"          {trans}\n")
        out.write("//\n")


def total_model_length(models: Iterable[ProfileHmm]) -> int:
    return sum(m.model_length for m in models)


def model_length_prefix_sums(models: Sequence[ProfileHmm]) -> np.ndarray:
    """``prefix[i]`` = global row index at which model ``i`` starts; last entry
    is the total row count (mirrors `host/Havac.cpp:104-116`)."""
    lengths = np.fromiter(
        (m.model_length for m in models), dtype=np.int64, count=len(models)
    )
    return np.concatenate([[0], np.cumsum(lengths)])
