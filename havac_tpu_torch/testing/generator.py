"""Synthetic model/sequence fixture factory for tests and benchmarks.

The reference generates test inputs by shelling out to HMMER's ``hmmbuild``
(`test/generator/hmmSeqGenerator.cpp:128-132`) then mutating the sequence so
hits land near but not exactly on the consensus diagonal. We synthesize
equivalent fixtures directly — random DNA, a profile HMM whose match emissions
put high probability on a sampled subsequence (so planted hits exist), then
substitutions/indels/flanks — so the test suite needs no HMMER install.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from havac_tpu_torch.io.hmm import ProfileHmm

NUCS = "ACGT"

# Typical nhmmer-built DNA model calibration constants; exact values do not
# matter for kernel parity tests (any mu/lambda produces a valid projection),
# only for cross-validation against real nhmmer output.
DEFAULT_MSV_MU = -9.8664
DEFAULT_MSV_LAMBDA = 0.71313


def random_dna(rng: np.random.Generator, length: int) -> str:
    return "".join(NUCS[i] for i in rng.integers(0, 4, size=length))


def model_from_consensus(
    consensus_codes: np.ndarray,
    name: str = "synth-model",
    match_probability: float = 0.91,
    msv_mu: float = DEFAULT_MSV_MU,
    msv_lambda: float = DEFAULT_MSV_LAMBDA,
    max_length: int = 0,
    alphabet: str = "dna",
) -> ProfileHmm:
    """Build a ProfileHmm whose match states emit ``consensus_codes`` with
    probability ``match_probability`` (rest spread evenly). Scores are stored
    as negative natural logs, the HMMER3 on-disk convention."""
    card = 20 if alphabet == "amino" else 4
    consensus_codes = np.asarray(consensus_codes, dtype=np.int64)
    length = consensus_codes.shape[0]
    off_probability = (1.0 - match_probability) / (card - 1)
    probs = np.full((length, card), off_probability, dtype=np.float64)
    probs[np.arange(length), consensus_codes] = match_probability
    return ProfileHmm(
        name=name,
        model_length=length,
        max_length=max_length if max_length > 0 else 4 * length,
        alphabet=alphabet,
        msv_mu=msv_mu,
        msv_lambda=msv_lambda,
        match_scores=(-np.log(probs)).astype(np.float32),
    )


def mutate_codes(
    rng: np.random.Generator,
    codes: np.ndarray,
    substitution_rate: float = 0.05,
    indel_rate: float = 0.01,
    card: int = 4,
) -> np.ndarray:
    """Substitutions + indels so hits are near- but not exact-diagonal
    (hmmSeqGenerator.cpp:156-234 analog)."""
    out: List[int] = []
    for code in codes:
        r = rng.random()
        if r < indel_rate / 2:
            continue  # deletion
        if r < indel_rate:
            out.append(int(rng.integers(0, card)))  # insertion
        if rng.random() < substitution_rate:
            out.append(int((code + rng.integers(1, card)) % card))
        else:
            out.append(int(code))
    return np.asarray(out, dtype=np.uint8)


def generate_planted_fixture(
    seed: int = 0,
    model_length: int = 120,
    sequence_length: int = 8000,
    num_models: int = 1,
    num_plants_per_model: int = 2,
    alphabet: str = "dna",
) -> Tuple[List[ProfileHmm], List[Tuple[str, str]]]:
    """Random sequence(s) with mutated copies of each model's consensus planted
    at random offsets. Returns (models, [(name, sequence_string)])."""
    from havac_tpu_torch.io.hmm import AMINO_ALPHABET

    rng = np.random.default_rng(seed)
    card = 20 if alphabet == "amino" else 4
    letters = AMINO_ALPHABET if alphabet == "amino" else NUCS
    models = []
    background = rng.integers(0, card, size=sequence_length).astype(np.uint8)
    for mi in range(num_models):
        consensus = rng.integers(0, card, size=model_length).astype(np.uint8)
        models.append(model_from_consensus(consensus, name=f"synth-{mi}",
                                           alphabet=alphabet))
        for _ in range(num_plants_per_model):
            planted = mutate_codes(rng, consensus, card=card)
            offset = int(rng.integers(0, max(1, sequence_length - planted.size)))
            background[offset : offset + planted.size] = planted[
                : max(0, sequence_length - offset)
            ]
    seq_str = "".join(letters[c] for c in background)
    return models, [("synth-seq-0", seq_str)]
