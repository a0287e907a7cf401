"""Plain reference of one SSV search: ``.hmm`` and FASTA text in, resolved
hits out, for sampled windows of the database.

Semantics (HAVAC's, the configuration's ``search`` block):

- Each model is projected to int8 scores so that its p-value threshold
  lands at 256 (nhmmer's MSV calibration: the Gumbel inverse survival at
  ``p``, the single-hit penalties, the background null, then
  ``round(2·m − e·log2(e)·m)`` half away from zero, saturated to int8).
  The arithmetic is float32 with a double Gumbel step, as HAVAC's
  ``PhmmReprojection.cpp`` writes it; ``precision="bfloat16"`` rounds
  every float32 step to bfloat16 instead (the control).
- The models' rows are concatenated and the database's records laid out
  as ``rec0, SEP, rec1, SEP, ...``; a separator's symbol is the low two
  bits of SplitMix64 of its position keyed by ``SEPARATOR_SEED``.
- ``S[j][i] = S[j-1][i-1] + M[j][sym[i]]`` with ``S[-1][*] = S[*][-1] =
  0``; below 0 it is 0; at 256 or more it is a hit and is 0.
- A hit on a separator is dropped; the rest resolve to (sequence index,
  position in it, model index, position in it).

A window of ``w`` positions at ``a`` is exact when swept from ``a − (P−1)``:
no diagonal is longer than the ``P`` rows, so every chain that reaches the
window starts inside that span, at row 0 or at the database's left edge.
The sweep runs row by row in the diagonal frame (index ``d = i − j``),
where row ``j`` needs ``d < C − j`` only, batched over windows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

SEPARATOR_SEED = 0x5A5A
SENTINEL = 4  # a position left of the database: its score forces 0
_NAT_LOG_2 = 0.69314718055994529
_LOG2_E = 1.44269504089
_GUMBEL_EPSILON = 5e-9
_HIT_BLOCK_ROWS = 256


# ---------------------------------------------------------------- models

@dataclass
class Collection:
    lengths: np.ndarray  # int64 (models,)
    max_lengths: np.ndarray  # int64 (models,)
    mu: np.ndarray  # float64 (models,), as written
    lam: np.ndarray  # float64 (models,)
    emissions: np.ndarray  # float32 (rows, 4), negative natural logs

    @property
    def prefix(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.lengths)])


def read_hmm(path: str) -> Collection:
    """The SSV fields of every model in a HMMER3 text file."""
    with open(path) as f:
        lines = f.read().splitlines()
    lengths, maxl, mu, lam, rows = [], [], [], [], []
    i = 0
    while i < len(lines):
        if not lines[i].startswith("HMMER3"):
            i += 1
            continue
        leng = maxlen = None
        stats = None
        i += 1
        while not lines[i].startswith("HMM "):
            tok = lines[i].split()
            if tok and tok[0] == "LENG":
                leng = int(tok[1])
            elif tok and tok[0] == "MAXL":
                maxlen = int(tok[1])
            elif tok[:3] == ["STATS", "LOCAL", "MSV"]:
                stats = (float(tok[3]), float(tok[4]))
            i += 1
        if leng is None or stats is None:
            raise ValueError(f"{path}: a model lacks LENG or STATS LOCAL MSV")
        i += 2  # the alphabet header and the transition header
        i += 3 if lines[i].strip().startswith("COMPO") else 2
        for pos in range(leng):
            tok = lines[i].split()
            if int(tok[0]) != pos + 1:
                raise ValueError(f"{path}: node {tok[0]} where {pos + 1}")
            rows.append([math.inf if t == "*" else float(t) for t in tok[1:5]])
            i += 3
        if lines[i].strip() != "//":
            raise ValueError(f"{path}: a model is not closed by //")
        i += 1
        lengths.append(leng)
        maxl.append(maxlen if maxlen else 4 * leng)
        mu.append(stats[0])
        lam.append(stats[1])
    return Collection(np.array(lengths, np.int64), np.array(maxl, np.int64),
                      np.array(mu), np.array(lam),
                      np.array(rows, dtype=np.float32).reshape(-1, 4))


def _rounding(precision: str):
    """Rounding to the working precision, for scalars and arrays alike."""
    if precision == "float32":
        return np.float32
    if precision == "bfloat16":
        def bf16(x):
            a = np.asarray(x, dtype=np.float32)
            r = torch.from_numpy(np.ascontiguousarray(a.reshape(-1))).to(
                torch.bfloat16).to(torch.float32).numpy().reshape(a.shape)
            return r if a.ndim else np.float32(r)
        return bf16
    raise ValueError(f"unknown precision {precision!r}")


def _log(x: float) -> float:
    # bfloat16 can round max_len / (max_len + 1) to 1: its log is -inf
    return math.log(x) if x > 0 else -math.inf


def _c_round(x: np.ndarray) -> np.ndarray:
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def scale_factor(mu: float, lam: float, max_length: float,
                 model_length: float, p_value: float,
                 precision: str = "float32") -> np.float32:
    """The factor that puts a model's p-value threshold at 256."""
    f = _rounding(precision)
    mu, lam, max_len, model_len = f(mu), f(lam), f(max_length), f(model_length)
    if p_value < _GUMBEL_EPSILON:
        log_part = (math.pow(p_value, p_value) - 1.0) / p_value
    else:
        log_part = math.log(-1.0 * math.log(1.0 - p_value))
    score_full = float(mu) - log_part / float(lam)  # double, as in HAVAC
    with np.errstate(divide="ignore"):
        n_loop = f(np.log(f(max_len / f(max_len + f(3)))))
        n_loop_total = f(n_loop * max_len)
        n_escape = f(np.log(f(f(3) / f(max_len + f(3)))))
        b_to_mk = f(np.log(f(f(2) / f(model_len * f(model_len + f(1))))))
        e_to_c = f(np.log(f(0.5)))
        core = f(f(f(f(n_escape + n_loop_total) + n_escape) + b_to_mk)
                 + e_to_c)
        bg_loop = f(max_len / f(max_len + f(1)))
        bg_loop_total = f(float(max_len) * _log(float(bg_loop)))
        bg_move = f(_log(1.0 - float(bg_loop)))
        bg = f(bg_loop_total + bg_move)
    thr_nats = f(f(f(score_full * _NAT_LOG_2) + bg) - core)
    thr_bits = f(thr_nats / f(_NAT_LOG_2))
    return f(f(256.0) / thr_bits)


def project(coll: Collection, p_value: float,
            precision: str = "float32") -> np.ndarray:
    """(rows, 4) int16 projected scores of the whole collection."""
    f = _rounding(precision)
    out = []
    prefix = coll.prefix
    for k in range(coll.lengths.shape[0]):
        scale = scale_factor(coll.mu[k], coll.lam[k], coll.max_lengths[k],
                             coll.lengths[k], p_value, precision)
        alpha = f(f(2) * scale)
        beta = f(f(_LOG2_E) * scale)
        em = coll.emissions[prefix[k]:prefix[k + 1]]
        val = f(alpha - f(f(em) * beta))
        val = np.where(np.isnan(val), np.float32(-np.inf), val)
        out.append(np.clip(_c_round(val), -128, 127).astype(np.int16))
    return np.concatenate(out, axis=0)


# -------------------------------------------------------------- database

@dataclass
class Database:
    names: List[str]
    lengths: np.ndarray  # int64 (records,)
    symbols: np.ndarray  # uint8 (records + residues,), separators included

    @property
    def starts(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.lengths + 1)])


_ENCODE = np.full(256, 255, dtype=np.uint8)
for _code, _letters in enumerate(("Aa", "Cc", "Gg", "TtUu")):
    for _ch in _letters:
        _ENCODE[ord(_ch)] = _code


def splitmix64(values: np.ndarray, seed: int) -> np.ndarray:
    phi = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        z = values.astype(np.uint64) + np.uint64(seed) * phi
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def read_fasta(path: str) -> Database:
    """Records of A/C/G/T(/U) text, encoded 0..3, each followed by its
    separator."""
    with open(path, "rb") as f:
        text = f.read()
    names, seqs = [], []
    for rec in text.split(b">")[1:]:
        header, _, body = rec.partition(b"\n")
        names.append(header.split()[0].decode() if header.split() else "")
        seqs.append(_ENCODE[np.frombuffer(
            body.replace(b"\n", b"").replace(b"\r", b""), dtype=np.uint8)])
    if any((s == 255).any() for s in seqs):
        raise ValueError(f"{path}: the reference reads A, C, G, T, U only")
    lengths = np.array([s.shape[0] for s in seqs], dtype=np.int64)
    sep = np.cumsum(lengths + 1) - 1
    symbols = np.empty(int(sep[-1]) + 1 if len(sep) else 0, dtype=np.uint8)
    keep = np.ones(symbols.shape[0], dtype=bool)
    keep[sep] = False
    symbols[keep] = np.concatenate(seqs) if seqs else []
    symbols[sep] = (splitmix64(sep, SEPARATOR_SEED)
                    & np.uint64(3)).astype(np.uint8)
    return Database(names, lengths, symbols)


# ----------------------------------------------------------------- sweep

def window_hits(windows: Sequence[Tuple[np.ndarray, int]], width: int,
                scores: np.ndarray, device="cpu"
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every raw hit (window, row, global position) in each window
    ``(symbols, a)``, the positions ``[a, a + width)`` of ``symbols``: the
    exact SSV, each window swept from ``a − (P − 1)`` (positions left of
    the database read as a sentinel whose score forces 0)."""
    P = scores.shape[0]
    n, C = len(windows), P - 1 + width
    span = np.full((n, C), SENTINEL, dtype=np.int32)
    for k, (symbols, a) in enumerate(windows):
        src = symbols[max(a - (P - 1), 0):a + width]
        span[k, C - src.shape[0]:] = src
    dev = torch.device(device)
    table = torch.full((P, 5), -1024, dtype=torch.int16)
    table[:, :4] = torch.from_numpy(np.asarray(scores, dtype=np.int16))
    table = table.to(dev)
    sym = torch.from_numpy(span).to(dev)
    state = torch.zeros((n, C), dtype=torch.int16, device=dev)
    block = torch.zeros((min(_HIT_BLOCK_ROWS, P), n, width), dtype=torch.bool,
                        device=dev)
    found = []
    for j in range(P):
        view = state[:, :C - j]
        view.add_(table[j][sym[:, j:]])
        hit = view >= 256
        view.clamp_(min=0).masked_fill_(hit, 0)
        r = j % block.shape[0]
        block[r] = hit[:, P - 1 - j:]
        if r == block.shape[0] - 1 or j == P - 1:
            nz = block[:r + 1].nonzero()
            nz[:, 0] += j - r
            found.append(nz.cpu())
    hits = torch.cat(found).numpy() if found else np.empty((0, 3), np.int64)
    win, row, col = hits[:, 1], hits[:, 0], hits[:, 2]
    starts = np.array([a for _, a in windows], dtype=np.int64)
    return win, row, starts[win] + col if n else col


def resolve(rows: np.ndarray, positions: np.ndarray, db: Database,
            coll: Collection) -> np.ndarray:
    """(n, 4) int64 (sequence, position, model, model position) of raw
    hits, separator hits dropped."""
    starts = db.starts
    seq = np.searchsorted(starts, positions, side="right") - 1
    local = positions - starts[seq]
    ok = local < db.lengths[seq]
    prefix = coll.prefix
    model = np.searchsorted(prefix, rows, side="right") - 1
    return np.stack([seq, local, model, rows - prefix[model]],
                    axis=1)[ok].astype(np.int64)
