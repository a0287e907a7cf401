"""Multi-FASTA ingestion: parse, 2-bit encode, concatenate, coordinate maps.

Replaces the reference's vendored FastaVector C submodule plus
SequencePreprocessor (`host/sequence/SequencePreprocessor.cpp`). The sequence
database becomes one flat array of 2-bit nucleotide codes (a/A→0, c/C→1,
g/G→2, t/T/u/U→3) with a single separator position after every sequence
(FastaVector's null terminators), padded up to a block multiple. Separator and
pad positions receive deterministic pseudo-random symbols — the reference uses
`rand()` there; we key a stateless hash on the absolute position so runs and
shards agree (SURVEY.md §7(f)). Hits landing on separator/pad positions are
dropped at resolution time, mirroring `host/Havac.cpp:166-172`.

Two-way IUPAC ambiguity codes resolve to one of their two nucleotides; all
other non-ACGT symbols resolve uniformly over the four nucleotides
(`SequencePreprocessor.cpp:62-85`; we fix the reference's operator-precedence
bug that made 'Y' always resolve to 'A').
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import numpy as np

from havac_tpu_torch.utils.prng import hash_u64

# Symbol classes for the encode table.
_DIRECT = {
    "a": 0, "c": 1, "g": 2, "t": 3, "u": 3,
}
# 2-way ambiguity codes -> (option0, option1)
_TWO_WAY = {
    "r": (0, 2),  # A/G
    "y": (1, 3),  # C/T
    "s": (1, 2),  # C/G
    "w": (0, 3),  # A/T
    "k": (2, 3),  # G/T
    "m": (0, 1),  # A/C
}

# Encode table: value 0-3 direct; 4-9 two-way (index into _TWO_WAY order); 10 = uniform.
_TWO_WAY_ORDER = "ryswkm"
_ENCODE_TABLE = np.full(256, 10, dtype=np.uint8)
for _ch, _code in _DIRECT.items():
    _ENCODE_TABLE[ord(_ch)] = _code
    _ENCODE_TABLE[ord(_ch.upper())] = _code
for _i, _ch in enumerate(_TWO_WAY_ORDER):
    _ENCODE_TABLE[ord(_ch)] = 4 + _i
    _ENCODE_TABLE[ord(_ch.upper())] = 4 + _i
_TWO_WAY_OPTIONS = np.array([_TWO_WAY[c] for c in _TWO_WAY_ORDER], dtype=np.uint8)

# Amino-acid alphabet (capability beyond the nucleotide-only reference,
# `README.md:2`): canonical residues in HMMER column order (alphabetical),
# selenocysteine U→C and pyrrolysine O→K direct, two-way ambiguities
# B→{D,N}, Z→{E,Q}, J→{I,L}, everything else (X, *, gaps) uniform over 20 —
# the same position-keyed-hash resolution scheme as the nucleotide table.
AMINO_ORDER = "ACDEFGHIKLMNPQRSTVWY"
_AMINO_TWO_WAY_ORDER = "bzj"
_AMINO_TWO_WAY = {
    "b": (AMINO_ORDER.index("D"), AMINO_ORDER.index("N")),
    "z": (AMINO_ORDER.index("E"), AMINO_ORDER.index("Q")),
    "j": (AMINO_ORDER.index("I"), AMINO_ORDER.index("L")),
}
_AMINO_TABLE = np.full(256, 23, dtype=np.uint8)  # 20-22 two-way, 23 uniform
for _i, _ch in enumerate(AMINO_ORDER):
    _AMINO_TABLE[ord(_ch)] = _i
    _AMINO_TABLE[ord(_ch.lower())] = _i
for _ch, _code in (("u", AMINO_ORDER.index("C")),
                   ("o", AMINO_ORDER.index("K"))):
    _AMINO_TABLE[ord(_ch)] = _code
    _AMINO_TABLE[ord(_ch.upper())] = _code
for _i, _ch in enumerate(_AMINO_TWO_WAY_ORDER):
    _AMINO_TABLE[ord(_ch)] = 20 + _i
    _AMINO_TABLE[ord(_ch.upper())] = 20 + _i
_AMINO_TWO_WAY_OPTIONS = np.array(
    [_AMINO_TWO_WAY[c] for c in _AMINO_TWO_WAY_ORDER], dtype=np.uint8)


@dataclass
class SequenceDatabase:
    """A concatenated, encoded multi-FASTA database.

    ``codes``: uint8 (padded_length,) of 2-bit symbol codes (values 0..3).
    ``starts``: int64 (n+1,) — sequence i occupies global positions
    [starts[i], starts[i] + lengths[i]); starts[n] is the first pad position
    minus nothing meaningful (= total concatenated length incl. separators).
    ``lengths``: int64 (n,) original sequence lengths.
    ``names``: FASTA record names (first token of the header line).
    """

    codes: np.ndarray
    starts: np.ndarray
    lengths: np.ndarray
    names: List[str]
    seed: int
    alphabet: str = "dna"  # "dna" (codes 0..3) or "amino" (codes 0..19)

    @property
    def num_sequences(self) -> int:
        return len(self.names)

    @property
    def concatenated_length(self) -> int:
        """Total length including one separator after each sequence."""
        return int(self.starts[-1])

    @property
    def padded_length(self) -> int:
        return int(self.codes.shape[0])

    def global_to_local(self, global_positions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Map global positions to (sequence_index, position_in_sequence, valid).

        ``valid`` is False for separator positions, pad positions, and anything
        out of range — those hits must be discarded
        (`fastaVectorGetLocalSequencePositionFromGlobal` semantics,
        `host/Havac.cpp:166-172`).
        """
        gp = np.asarray(global_positions, dtype=np.int64)
        idx = np.searchsorted(self.starts, gp, side="right") - 1
        idx_clamped = np.clip(idx, 0, self.num_sequences - 1)
        local = gp - self.starts[idx_clamped]
        valid = (
            (gp >= 0)
            & (idx >= 0)
            & (idx < self.num_sequences)
            & (local < self.lengths[idx_clamped])
        )
        return idx_clamped.astype(np.int64), local, valid


def parse_fasta_text(text: str) -> Tuple[List[str], List[bytes]]:
    names: List[str] = []
    seqs: List[bytes] = []
    current: List[str] = []
    for raw_line in io.StringIO(text):
        line = raw_line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if current or names:
                if not names:
                    raise ValueError("FASTA data before first '>' header")
            if names:
                seqs.append("".join(current).encode())
                current = []
            names.append(line[1:].split()[0] if len(line) > 1 else "")
        else:
            if not names:
                raise ValueError("FASTA data before first '>' header")
            current.append(line)
    if names:
        seqs.append("".join(current).encode())
    if not names:
        raise ValueError("no FASTA records found")
    return names, seqs


def read_fasta(path: str) -> Tuple[List[str], List[bytes]]:
    with open(path, "r") as f:
        return parse_fasta_text(f.read())


def encode_database(
    names: Sequence[str],
    sequences: Sequence[bytes],
    pad_multiple: int = 1,
    seed: int = 0x5A5A,
    alphabet: str = "dna",
) -> SequenceDatabase:
    """Encode and concatenate sequences into a :class:`SequenceDatabase`.

    Layout: seq0, SEP, seq1, SEP, ..., seqN-1, SEP, PAD... — padded so the total
    is a multiple of ``pad_multiple`` (the reference pads to its 12,288-wide
    segment, `SequencePreprocessor.cpp:13-17`; our pad width is a kernel block
    parameter). SEP/PAD symbols come from the position-keyed hash.

    ``alphabet="amino"`` encodes 20-symbol protein residues (codes 0..19,
    HMMER column order) with the same deterministic ambiguity scheme; the
    nucleotide path is byte-for-byte unchanged (its hashes must agree with
    the native C++ encoder).
    """
    lengths = np.fromiter((len(s) for s in sequences), dtype=np.int64, count=len(sequences))
    starts = np.concatenate([[0], np.cumsum(lengths + 1)])
    concat_len = int(starts[-1])
    padded_len = -(-max(concat_len, 1) // pad_multiple) * pad_multiple

    raw = np.full(padded_len, ord("\0"), dtype=np.uint8)
    for i, seq in enumerate(sequences):
        arr = np.frombuffer(seq, dtype=np.uint8)
        raw[starts[i] : starts[i] + lengths[i]] = arr

    if alphabet == "amino":
        table, card, uni_cls, tw_base = _AMINO_TABLE, 20, 23, 20
        tw_options = _AMINO_TWO_WAY_OPTIONS
    elif alphabet == "dna":
        table, card, uni_cls, tw_base = _ENCODE_TABLE, 4, 10, 4
        tw_options = _TWO_WAY_OPTIONS
    else:
        raise ValueError(f"unknown alphabet {alphabet!r}")
    classes = table[raw]
    codes = np.where(classes < card, classes, 0).astype(np.uint8)

    needs_random = classes >= card
    if np.any(needs_random):
        positions = np.nonzero(needs_random)[0]
        cls = classes[positions]
        two_way = cls < uni_cls
        if np.any(two_way):
            bits = hash_u64(positions[two_way].astype(np.uint64), seed) & np.uint64(1)
            pair_idx = (cls[two_way] - tw_base).astype(np.int64)
            codes[positions[two_way]] = tw_options[pair_idx, bits.astype(np.int64)]
        uniform = ~two_way
        if np.any(uniform):
            h = hash_u64(positions[uniform].astype(np.uint64), seed)
            if card == 4:  # keep the exact legacy bit extraction (native parity)
                codes[positions[uniform]] = (h & np.uint64(3)).astype(np.uint8)
            else:
                codes[positions[uniform]] = (h % np.uint64(card)).astype(np.uint8)

    return SequenceDatabase(
        codes=codes,
        starts=starts,
        lengths=lengths,
        names=list(names),
        seed=seed,
        alphabet=alphabet,
    )


def load_fasta_database(
    path_or_text: Union[str, Tuple[List[str], List[bytes]]],
    pad_multiple: int = 1,
    seed: int = 0x5A5A,
    is_text: bool = False,
    native: str = "auto",
    alphabet: str = "dna",
) -> SequenceDatabase:
    """Load + encode a database. ``native``: "auto" uses the C++ parser
    (havac_tpu_torch/native) when built, "never"/"always" force a path; both
    produce byte-identical databases. Amino databases (``alphabet="amino"``)
    encode on the Python path (the native encoder is nucleotide-only)."""
    if (isinstance(path_or_text, str) and not is_text and native != "never"
            and alphabet == "dna"):
        from havac_tpu_torch import native as native_mod

        if native_mod.available():
            names, lengths, starts, codes = native_mod.read_fasta_encoded(
                path_or_text, pad_multiple=pad_multiple, seed=seed)
            return SequenceDatabase(codes=codes, starts=starts,
                                    lengths=lengths, names=names, seed=seed)
        if native == "always":
            raise RuntimeError(
                "native parser requested but libhavac_native.so is not "
                "built; see havac_tpu_torch.native.build")
    if isinstance(path_or_text, tuple):
        names, seqs = path_or_text
    elif is_text:
        names, seqs = parse_fasta_text(path_or_text)
    else:
        names, seqs = read_fasta(path_or_text)
    return encode_database(names, seqs, pad_multiple=pad_multiple, seed=seed,
                           alphabet=alphabet)


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit symbol codes 4-per-byte, little-endian within the byte
    (symbol i occupies bits [2i, 2i+2) of byte i//4), matching the reference's
    packing (`SequencePreprocessor.cpp:43-58`)."""
    if codes.shape[0] % 4:
        codes = np.pad(codes, (0, 4 - codes.shape[0] % 4))
    quads = codes.reshape(-1, 4).astype(np.uint8)
    return (
        quads[:, 0]
        | (quads[:, 1] << 2)
        | (quads[:, 2] << 4)
        | (quads[:, 3] << 6)
    ).astype(np.uint8)


def unpack_2bit(packed: np.ndarray, length: int) -> np.ndarray:
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty(packed.shape[0] * 4, dtype=np.uint8)
    out[0::4] = packed & 3
    out[1::4] = (packed >> 2) & 3
    out[2::4] = (packed >> 4) & 3
    out[3::4] = (packed >> 6) & 3
    return out[:length]


# IUPAC complement for raw FASTA bytes (case-preserving).
_COMPLEMENT = np.arange(256, dtype=np.uint8)


def _set_complements() -> None:
    symmetric = [("a", "t"), ("c", "g"), ("r", "y"), ("k", "m"),
                 ("b", "v"), ("d", "h")]
    one_way = [("u", "a")]  # U complements to A; A still maps to T
    for a, b in symmetric:
        for fa, fb in ((a, b), (a.upper(), b.upper())):
            _COMPLEMENT[ord(fa)] = ord(fb)
            _COMPLEMENT[ord(fb)] = ord(fa)
    for a, b in one_way:
        _COMPLEMENT[ord(a)] = ord(b)
        _COMPLEMENT[ord(a.upper())] = ord(b.upper())
    # s, w, n are their own complements (identity already).


_set_complements()


def reverse_complement(seq: bytes) -> bytes:
    """Reverse-complement raw FASTA bytes (IUPAC-aware, case-preserving)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _COMPLEMENT[arr[::-1]].tobytes()


def augment_with_reverse_complement(
    db: SequenceDatabase, pad_multiple: int = 1
) -> SequenceDatabase:
    """Append each sequence's reverse complement as an extra record.

    The engine scans minus-strand hits by sweeping this augmented database
    once: record i+n is the reverse complement of record i (2-bit code
    complement is ``3 - code``), so a hit on record i+n at local position p
    maps to forward coordinates (record i, lengths[i]-1-p, strand '-').
    Separator/pad symbols are re-randomized with the same position-keyed
    hash as :func:`encode_database`.
    """
    from havac_tpu_torch.utils.prng import random_bits_at_positions

    n = db.num_sequences
    lengths = np.concatenate([db.lengths, db.lengths])
    names = list(db.names) + list(db.names)
    starts = np.concatenate([[0], np.cumsum(lengths + 1)])
    concat_len = int(starts[-1])
    padded_len = -(-max(concat_len, 1) // pad_multiple) * pad_multiple

    codes = np.zeros(padded_len, dtype=np.uint8)
    codes[: db.concatenated_length] = db.codes[: db.concatenated_length]
    for i in range(n):
        s = int(db.starts[i])
        length = int(db.lengths[i])
        seg = db.codes[s: s + length]
        d = int(starts[n + i])
        codes[d: d + length] = 3 - seg[::-1]
    # Deterministic separator/pad symbols at their (new) absolute positions.
    fill = np.concatenate([
        starts[1:] - 1,  # separator after every record
        np.arange(concat_len, padded_len, dtype=np.int64),  # padding
    ])
    codes[fill] = random_bits_at_positions(fill, db.seed, 2)
    return SequenceDatabase(codes=codes, starts=starts, lengths=lengths,
                            names=names, seed=db.seed)
