"""Independent float-space nhmmer-SSV oracle (non-circular validation).

HMMER itself cannot be installed in this environment, so the containment
rung (`validate`) previously compared the engine against tblout fixtures
authored by the repo's own generator — circular. This module re-implements
the scoring semantics nhmmer's SSV filter applies — the published
ungapped-diagonal recurrence over FLOAT-projected emission scores with the
Gumbel/penalty threshold math — as an independent code path (no int8
quantization, no Pallas/engine code, a different sweep formulation), and
emits nhmmer-style hit windows from it. Engine runs are then validated
against an oracle that shares only the *specification*, not the
implementation: the float variant the reference's forensics tool uses to
second-source its hardware (`test/hmmerSsvRef/hmmerSsvRef.cpp:166-325`,
float re-scoring at `:189-205` via ``refSsvFloat``/``refSsvDiagonalFloat``;
threshold math `PhmmReprojection/PhmmReprojection.cpp:36-66`).

Residual disagreement between the engine (int8-projected, c-rounded) and
this float oracle is exactly the quantization boundary effect that
`havac_tpu.validation.quantization` measures; tests bound it with
pass@256/250 agreement.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from havac_tpu_torch.validation.nhmmer import NhmmerWindow

LOG2_E = np.float32(1.44269504089)
THRESHOLD = np.float32(256.0)


def float_projected_scores(model, p_value: float) -> Tuple[np.ndarray, float]:
    """(P, card) float32 projected emission scores (NO int8 rounding) +
    scale.

    Uses the same published projection formula as the engine's int8 path
    (`PhmmReprojection.cpp:118-144`: ``(B − s·log2 e) · scale``, ``B`` the
    alphabet's null bits a residue, 2 for DNA) but stops
    before quantization — the quantization-free scoring space the
    reference's float re-scorer works in (`hmmerSsvRef.cpp:189-205`).
    A scaled running sum reaching 256.0 is equivalent to the bits-space
    score reaching the p-value threshold (scale = 256 / threshold_bits).
    """
    from havac_tpu_torch.scoring.reprojection import (
        null_bits, threshold256_scale_factor)

    scale = threshold256_scale_factor(
        model.msv_mu, model.msv_lambda, model.max_length,
        model.model_length, p_value)
    m = np.asarray(model.match_scores, dtype=np.float32)
    proj = (null_bits(model.alphabet) - m * LOG2_E) * np.float32(scale)
    proj = np.where(np.isfinite(proj), proj, np.float32(-1e9))
    return proj.astype(np.float32), float(scale)


def float_ssv_crossings(
    codes: np.ndarray, proj: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (model row, sequence position, score) where the float SSV
    running score crosses the threshold.

    Recurrence (the SSV spec, `test/softSsv/SoftSsv.cpp:31-63`, float form
    `hmmerSsvRef.cpp` ``refSsvFloat``): running diagonal sum, floored at 0,
    reset after a crossing is recorded. Implemented as a row-vectorized
    numpy sweep — deliberately a different formulation from both the
    engine's SWAR kernel and the scalar int oracle in ops/reference.py.
    """
    codes = np.asarray(codes, dtype=np.int64)
    proj = np.asarray(proj, dtype=np.float32)
    P, L = proj.shape[0], codes.shape[0]
    run = np.zeros(L, dtype=np.float32)
    rows: List[np.ndarray] = []
    pos: List[np.ndarray] = []
    scs: List[np.ndarray] = []
    for j in range(P):
        match = proj[j][codes]
        shifted = np.empty_like(run)
        shifted[0] = np.float32(0)
        shifted[1:] = run[:-1]
        run = np.maximum(shifted + match, np.float32(0))
        cross = run >= THRESHOLD
        if cross.any():
            i = np.nonzero(cross)[0]
            rows.append(np.full(i.shape[0], j, dtype=np.int64))
            pos.append(i)
            scs.append(run[i].copy())
            run[i] = np.float32(0)  # reset on hit, like the int path
    if not rows:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), np.empty(0, dtype=np.float32)
    return np.concatenate(rows), np.concatenate(pos), np.concatenate(scs)


def float_ssv_windows(
    database, models: Sequence, p_value: float, pad: int = 25
) -> List[NhmmerWindow]:
    """nhmmer-style hit windows from the independent float oracle.

    ``database`` is an ``io.fasta.SequenceDatabase`` (the engine's own
    ingested input, so coordinates agree); each model is swept separately
    (nhmmer scores models independently — the concatenated-stream chain
    artifact is the engine's, not nhmmer's). Crossings landing on
    inter-sequence separators/padding are dropped, the rest are merged
    into per-sequence windows when within ``2·pad`` of each other (the
    envelope-merging shape of real nhmmer output), reported 1-based like
    tblout. Scores are bits (scaled score / scale); E-values from the
    Gumbel survival of the window's best score.
    """
    windows: List[NhmmerWindow] = []
    for model in models:
        proj, scale = float_projected_scores(model, p_value)
        rows, gpos, scores = float_ssv_crossings(database.codes, proj)
        if rows.size == 0:
            continue
        seq_idx, local_pos, valid = database.global_to_local(gpos)
        rows, scores = rows[valid], scores[valid]
        seq_idx, local_pos = seq_idx[valid], local_pos[valid]
        label = model.accession or model.name
        for si in np.unique(seq_idx):
            m = seq_idx == si
            order = np.argsort(local_pos[m], kind="stable")
            lp = local_pos[m][order]
            rj = rows[m][order]
            sc = scores[m][order]
            gaps = np.nonzero(np.diff(lp) > 2 * pad)[0]
            for sl in np.split(np.arange(lp.shape[0]), gaps + 1):
                seq_len = int(database.lengths[si])
                lo = max(1, int(lp[sl].min()) + 1 - pad)
                hi = min(seq_len, int(lp[sl].max()) + 1 + pad)
                best_bits = float(sc[sl].max()) / scale
                # Gumbel survival P(S >= x) = 1 - exp(-exp(-lambda(x-mu)))
                lam, mu = model.msv_lambda, model.msv_mu
                ev = float(1.0 - np.exp(-np.exp(
                    -lam * (best_bits - mu))))
                windows.append(NhmmerWindow(
                    target_name=database.names[si],
                    query_name=model.name,
                    query_accession=model.accession or "",
                    hmm_from=int(rj[sl].min()) + 1,
                    hmm_to=int(rj[sl].max()) + 1,
                    ali_from=lo,
                    ali_to=hi,
                    strand="+",
                    score=round(best_bits, 2),
                    evalue=ev,
                ))
    return windows
