"""p-value → int8 score reprojection: the numerics core of the SSV engine.

Per model, scores are rescaled so that the bits-score hit threshold for the
requested p-value lands exactly at 256; a DP cell reaching 256 is a hit. This
reproduces the math of the reference's PhmmReprojection
(`PhmmReprojection/PhmmReprojection.cpp:15-145`), which itself adapts
nhmmer/Easel's single-hit model calibration:

  1. invert the MSV Gumbel survival function at the p-value (mu/lambda from the
     model's ``STATS LOCAL MSV`` line) → full-model bits score;
  2. adjust by nhmmer's single-hit model penalties (N/C loop + escape, B→Mk,
     E→C) and the background null score → single-hit bits threshold;
  3. scale = 256 / threshold_bits; project each negative-nat-log match emission
     ``s`` of residue ``x`` to round(B_x·scale − s·log2(e)·scale), saturated to
     int8, where ``B_x = −log2 f_x`` is the null's bits for ``x``.

The null is the alphabet's background, as HMMER3 scores a residue ``x`` by
log2(e_x / f_x): the uniform 0.25 for DNA and RNA (``B_x`` = 2, the
reference's constant) and HMMER3's ``p7_AminoFrequencies`` for proteins.

All "round" operations use C ``round()`` semantics (half away from zero), not
banker's rounding — this matters for bit-exact int8 parity.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

GUMBEL_EPSILON = 5e-9
NAT_LOG_2 = 0.69314718055994529
LOG2_E = np.float32(1.44269504089)

# HMMER3's p7_AminoFrequencies (src/hmmer.c), the protein null of
# p7_bg_Create, in HMMER's column order A..Y.
AMINO_FREQUENCIES = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062, 0.0695071,
    0.0229198, 0.0590092, 0.0594422, 0.0963728, 0.0237718, 0.0414386,
    0.0482904, 0.0395639, 0.0540978, 0.0683364, 0.0540687, 0.0673417,
    0.0114135, 0.0304133])
# The null's bits a residue, −log2 f_x: worked out in double, kept float32.
NUCLEOTIDE_NULL_BITS = np.full(4, 2.0, dtype=np.float32)
AMINO_NULL_BITS = (-np.log2(AMINO_FREQUENCIES)).astype(np.float32)


def null_bits(alphabet: str) -> np.ndarray:
    """(card,) float32 bits of the background null a residue of
    ``alphabet`` ("dna", "rna" or "amino")."""
    if alphabet.lower() == "amino":
        return AMINO_NULL_BITS
    if alphabet.lower() in ("dna", "rna"):
        return NUCLEOTIDE_NULL_BITS
    raise ValueError(f"no background null for alphabet {alphabet!r}")


def gumbel_inverse_survival(p_value: float, mu: float, lam: float) -> float:
    """Score whose Gumbel survival probability equals ``p_value``.

    Double precision, with the small-p series guard of Easel's
    esl_gumbel_invsurv (`PhmmReprojection.cpp:15-31`).
    """
    if p_value < GUMBEL_EPSILON:
        log_part = (math.pow(p_value, p_value) - 1.0) / p_value
    else:
        log_part = math.log(-1.0 * math.log(1.0 - p_value))
    return mu - (log_part / lam)


def threshold256_scale_factor(
    msv_mu: float,
    msv_lambda: float,
    max_length: float,
    model_length: float,
    p_value: float,
) -> np.float32:
    """Per-model scale factor that puts the p-value hit threshold at 256.

    Mirrors findThreshold256ScalingFactor (`PhmmReprojection.cpp:36-66`)
    including its mixed float/double evaluation order.
    """
    f32 = np.float32
    mu = f32(msv_mu)
    lam = f32(msv_lambda)
    max_len = f32(max_length)
    model_len = f32(model_length)

    score_full_model = gumbel_inverse_survival(p_value, float(mu), float(lam))

    with np.errstate(divide="ignore"):
        n_loop_penalty = f32(np.log(f32(max_len / (max_len + f32(3)))))
        n_loop_penalty_total = f32(n_loop_penalty * max_len)
        n_escape_penalty = f32(np.log(f32(f32(3) / (max_len + f32(3)))))
        b_to_mk_penalty = f32(np.log(f32(f32(2) / (model_len * (model_len + f32(1))))))
        e_to_c_penalty = f32(np.log(f32(0.5)))
        core_adjustment = f32(
            n_escape_penalty
            + n_loop_penalty_total
            + n_escape_penalty
            + b_to_mk_penalty
            + e_to_c_penalty
        )

        bg_loop_prob = f32(max_len / (max_len + f32(1)))
        # The reference uses double log() here (not logf), then narrows.
        bg_loop_penalty_total = f32(float(max_len) * math.log(float(bg_loop_prob)))
        bg_move_penalty = f32(math.log(1.0 - float(bg_loop_prob)))
        bg_score = f32(bg_loop_penalty_total + bg_move_penalty)

    threshold_nats = f32(
        f32(score_full_model * NAT_LOG_2) + bg_score - core_adjustment
    )
    threshold_bits = f32(threshold_nats / f32(NAT_LOG_2))
    return f32(f32(256.0) / threshold_bits)


def c_round(x: np.ndarray) -> np.ndarray:
    """C round(): round half away from zero (numpy rounds half to even)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def project_scores_for_threshold256(
    match_scores: np.ndarray, scale_factor: float,
    null: np.ndarray = NUCLEOTIDE_NULL_BITS
) -> np.ndarray:
    """Project negative-nat-log emissions to threshold-256 int8 scores.

    Vectorized p7HmmProjectForThreshold256 (`PhmmReprojection.cpp:109-145`)
    with the null's bits ``null`` ((card,) float32, :func:`null_bits`):
    score = round(f32(B·m) − f32(s·f32(log2(e)·m))) clamped to [−128, 127],
    each step rounded to float32. For DNA, ``B`` = 2 and this is the
    reference's round(2·m − s·log2(e)·m). +inf emissions ("*" tokens,
    probability zero) saturate to −128.
    """
    scores = np.asarray(match_scores, dtype=np.float32)
    scale = np.float32(scale_factor)
    alpha = np.asarray(null, dtype=np.float32) * scale
    beta = LOG2_E * scale
    projected = alpha - scores * beta
    projected = np.where(np.isnan(projected), np.float32(-np.inf), projected)
    projected = c_round(projected)
    projected = np.clip(projected, -128, 127)
    return projected.astype(np.int8)


def legacy_project_single_score(emission_score: float, scale_factor: float,
                                null: float = 2.0) -> int:
    """The reference's per-score legacy formula (`PhmmReprojection.cpp:88-107`),
    kept (like the reference keeps it) as an independent cross-check of the
    vectorized projection: round(−log2(e)·(s − B / log2(e))·m), with ``null``
    the residue's null bits ``B`` (2 for DNA, as the reference has it)."""
    f32 = np.float32
    log2_e = f32(1.44269504089)
    projected = f32(-log2_e * (f32(emission_score) - f32(null) / log2_e) * f32(scale_factor))
    projected = float(c_round(np.asarray(projected)))
    return int(min(127, max(-128, projected)))


def project_models(models: Sequence, p_value: float) -> np.ndarray:
    """Concatenate every model's projected int8 scores into one flat
    ``(total_rows, cardinality)`` array — the device-side model stream
    (`host/phmm/PhmmPreprocessor.cpp:9-31`). Each model is projected with its
    own scale factor and its alphabet's null (:func:`null_bits`)."""
    blocks = []
    for m in models:
        scale = threshold256_scale_factor(
            m.msv_mu, m.msv_lambda, m.max_length, m.model_length, p_value
        )
        blocks.append(project_scores_for_threshold256(
            m.match_scores, scale, null_bits(m.alphabet)))
    return np.concatenate(blocks, axis=0)
