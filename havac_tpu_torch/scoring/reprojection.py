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
     to round(2·scale − emission·log2(e)·scale), saturated to int8.

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
    match_scores: np.ndarray, scale_factor: float
) -> np.ndarray:
    """Project negative-nat-log emissions to threshold-256 int8 scores.

    Vectorized p7HmmProjectForThreshold256 (`PhmmReprojection.cpp:109-145`):
    score = round(2·m − s·log2(e)·m) clamped to [−128, 127]. +inf emissions
    ("*" tokens, probability zero) saturate to −128.
    """
    scores = np.asarray(match_scores, dtype=np.float32)
    scale = np.float32(scale_factor)
    alpha = np.float32(2) * scale
    beta = LOG2_E * scale
    projected = alpha - scores * beta
    projected = np.where(np.isnan(projected), np.float32(-np.inf), projected)
    projected = c_round(projected)
    projected = np.clip(projected, -128, 127)
    return projected.astype(np.int8)


def legacy_project_single_score(emission_score: float, scale_factor: float) -> int:
    """The reference's per-score legacy formula (`PhmmReprojection.cpp:88-107`),
    kept (like the reference keeps it) as an independent cross-check of the
    vectorized projection."""
    f32 = np.float32
    log2_e = f32(1.44269504089)
    projected = f32(-log2_e * (f32(emission_score) - f32(2) / log2_e) * f32(scale_factor))
    projected = float(c_round(np.asarray(projected)))
    return int(min(127, max(-128, projected)))


def project_models(models: Sequence, p_value: float) -> np.ndarray:
    """Concatenate every model's projected int8 scores into one flat
    ``(total_rows, cardinality)`` array — the device-side model stream
    (`host/phmm/PhmmPreprocessor.cpp:9-31`). Each model is projected with its
    own scale factor."""
    blocks = []
    for m in models:
        scale = threshold256_scale_factor(
            m.msv_mu, m.msv_lambda, m.max_length, m.model_length, p_value
        )
        blocks.append(project_scores_for_threshold256(m.match_scores, scale))
    return np.concatenate(blocks, axis=0)
