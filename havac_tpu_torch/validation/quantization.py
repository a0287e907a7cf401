"""Quantization forensics: int8-projected vs float SSV scoring of windows.

The analog of the reference's hmmerSsvRef tool
(`test/hmmerSsvRef/hmmerSsvRef.cpp:166-325`), which re-scores nhmmer windows
with int8-projected, float-projected, and unprojected emission scores and
counts pass@256 / pass@250 to quantify how much int8 rounding moves hits
across the threshold. Used to explain residual disagreements in
nhmmer-containment comparisons.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from havac_tpu_torch.scoring.reprojection import (
    NUCLEOTIDE_NULL_BITS,
    null_bits,
    project_scores_for_threshold256,
    threshold256_scale_factor,
)

LOG2_E = 1.4426950408889634


def diagonal_scores_int8(codes: np.ndarray, scores_int8: np.ndarray) -> np.ndarray:
    """Max running SSV score (int semantics: floor at 0, NO 256 reset) for
    every diagonal of the (P × L) window; returns the per-diagonal maxima.

    Mirrors the reference's walkback re-scoring
    (`hmmerSsvRef.cpp:234-325`): a window "passes" at T if any diagonal's
    running score reaches T.
    """
    codes = np.asarray(codes, dtype=np.int64)
    s = np.asarray(scores_int8, dtype=np.int64)
    P = s.shape[0]
    L = codes.shape[0]
    match = s[np.arange(P)[:, None], codes[None, :]]  # (P, L)
    best = np.zeros(L, dtype=np.int64)
    run = np.zeros(L, dtype=np.int64)
    for j in range(P):
        shifted = np.concatenate([[0], run[:-1]])
        run = np.maximum(shifted + match[j], 0)
        best = np.maximum(best, run)
    return best


def diagonal_scores_float(
    codes: np.ndarray, match_scores: np.ndarray, scale: float,
    null: np.ndarray = NUCLEOTIDE_NULL_BITS
) -> np.ndarray:
    """Same sweep with unquantized projected scores (float32), the
    reference's float variant (`hmmerSsvRef.cpp:189-205`), against the
    null's bits ``null`` ((card,), ``reprojection.null_bits``)."""
    codes = np.asarray(codes, dtype=np.int64)
    m = np.asarray(match_scores, dtype=np.float32)
    proj = ((np.asarray(null, dtype=np.float32) - m * np.float32(LOG2_E))
            * np.float32(scale))
    proj = np.where(np.isfinite(proj), proj, np.float32(-1e9))
    P = proj.shape[0]
    L = codes.shape[0]
    match = proj[np.arange(P)[:, None], codes[None, :]]
    best = np.zeros(L, dtype=np.float32)
    run = np.zeros(L, dtype=np.float32)
    for j in range(P):
        shifted = np.concatenate([[np.float32(0)], run[:-1]])
        run = np.maximum(shifted + match[j], np.float32(0))
        best = np.maximum(best, run)
    return best


@dataclass
class QuantizationReport:
    """pass@T counts for a set of windows (hmmerSsvRef stdout analog)."""

    num_windows: int
    int8_pass_256: int
    int8_pass_250: int
    float_pass_256: int
    agreements: int  # windows where int8@256 == float@256

    @property
    def disagreement_rate(self) -> float:
        return (1.0 - self.agreements / self.num_windows
                if self.num_windows else 0.0)


def quantization_report(
    windows: Sequence[np.ndarray],
    model,
    p_value: float,
) -> QuantizationReport:
    """Score each window (code array) against ``model`` with int8 and
    float projections against its alphabet's null; count threshold
    passes."""
    scale = threshold256_scale_factor(
        model.msv_mu, model.msv_lambda, model.max_length, model.model_length,
        p_value)
    null = null_bits(model.alphabet)
    int8_scores = project_scores_for_threshold256(model.match_scores, scale,
                                                  null)

    i256 = i250 = f256 = agree = 0
    for codes in windows:
        bi = diagonal_scores_int8(codes, int8_scores).max(initial=0)
        bf = diagonal_scores_float(codes, model.match_scores, float(scale),
                                   null).max(initial=0.0)
        pi = bi >= 256
        i256 += int(pi)
        i250 += int(bi >= 250)
        pf = bf >= 256.0
        f256 += int(pf)
        agree += int(pi == pf)
    return QuantizationReport(
        num_windows=len(windows),
        int8_pass_256=i256,
        int8_pass_250=i250,
        float_pass_256=f256,
        agreements=agree,
    )
