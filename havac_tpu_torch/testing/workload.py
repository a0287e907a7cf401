"""Synthetic search workloads written to real .hmm / .fasta files.

The reference's published scaling point pairs a chromosome-sized sequence
(chr22, 50,818,468 positions) with model collections of growing total
length; `tools/runtime_table.py` `synthetic_workload` builds it from random
DNA and synthetic models (60-200 positions each). This module builds the
same uniform workload from an explicit seed and writes it as files, so the
engine runs it through its file loaders.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from havac_tpu_torch.io.hmm import ProfileHmm, write_hmm
from havac_tpu_torch.testing.generator import model_from_consensus

CHR22_LENGTH = 50_818_468
FASTA_LINE = 80


def synthetic_models(total_positions: int, seed: int) -> List[ProfileHmm]:
    """Models of 60-200 positions from random consensus sequences, until
    ``total_positions`` model positions exist."""
    rng = np.random.default_rng(seed)
    models = []
    cum = 0
    while cum < total_positions:
        length = min(int(rng.integers(60, 200)), total_positions - cum)
        consensus = rng.integers(0, 4, size=max(length, 8)).astype(np.uint8)
        models.append(model_from_consensus(consensus,
                                           name=f"synth-{len(models)}"))
        cum += models[-1].model_length
    return models


def write_fasta(path: str, name: str, codes: np.ndarray) -> None:
    """One FASTA record of nucleotide ``codes`` (0..3), 80 columns a line."""
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    n = letters.shape[0]
    full = n - n % FASTA_LINE
    body = np.empty((full // FASTA_LINE, FASTA_LINE + 1), dtype=np.uint8)
    body[:, :FASTA_LINE] = letters[:full].reshape(-1, FASTA_LINE)
    body[:, FASTA_LINE] = ord("\n")
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        f.write(body.tobytes())
        if n > full:
            f.write(letters[full:].tobytes() + b"\n")


def write_workload(directory: str, total_positions: int, seq_len: int,
                   seed: int):
    """Write ``models.hmm`` and ``db.fasta`` into ``directory``; returns
    their paths."""
    rng = np.random.default_rng(seed)
    hmm = os.path.join(directory, "models.hmm")
    fasta = os.path.join(directory, "db.fasta")
    write_hmm(synthetic_models(total_positions, seed), hmm)
    write_fasta(fasta, "synth-chr",
                rng.integers(0, 4, size=seq_len).astype(np.uint8))
    return hmm, fasta
