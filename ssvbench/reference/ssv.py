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
- The null is the alphabet's background: a residue ``x`` scores
  ``log2(e_x / f_x)`` bits, so the projection adds ``−log2 f_x`` bits a
  row, which is 2 for DNA's uniform 0.25 and HMMER3's amino composition
  (:data:`AMINO_BACKGROUND`) for proteins.
- The models' rows are concatenated and the database's records laid out
  as ``rec0, SEP, rec1, SEP, ...``; a separator's symbol is SplitMix64 of
  its position keyed by ``SEPARATOR_SEED``: its low two bits for DNA, the
  value mod 20 for amino.
- ``S[j][i] = S[j-1][i-1] + M[j][sym[i]]`` with ``S[-1][*] = S[*][-1] =
  0``; below 0 it is 0; at 256 or more it is a hit and is 0. With isolated
  models (``search.isolate_models``) a model's first row takes no incoming
  diagonal: ``S[j][i] = M[j][sym[i]]`` there, so no chain runs from one
  model into the next.
- A hit on a separator is dropped; the rest resolve to (sequence index,
  position in it, model index, position in it).

A window of ``w`` positions at ``a`` is exact when swept from ``a − (P−1)``:
no diagonal is longer than the ``P`` rows, so every chain that reaches the
window starts inside that span, at row 0 or at the database's left edge.
With isolated models no chain is longer than the longest model, ``Lmax``,
and the window is exact from ``a − (Lmax − 1)``. The sweep runs row by row
in the diagonal frame (index ``d = i − j``), where row ``j`` needs
``d < C − j`` only, batched over windows (and, isolated, over the models'
``j``-th rows).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

SEPARATOR_SEED = 0x5A5A
AMINO = "ACDEFGHIKLMNPQRSTVWY"  # HMMER's column order, codes 0..19
# HMMER3's p7_AminoFrequencies (src/hmmer.c), the Swiss-Prot 50.8
# composition that p7_bg_Create uses as the protein null, A..Y.
AMINO_BACKGROUND = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062, 0.0695071,
    0.0229198, 0.0590092, 0.0594422, 0.0963728, 0.0237718, 0.0414386,
    0.0482904, 0.0395639, 0.0540978, 0.0683364, 0.0540687, 0.0673417,
    0.0114135, 0.0304133])
# −log2 f_x a residue, worked out in double and stored as float32
AMINO_NULL_BITS = (-np.log2(AMINO_BACKGROUND)).astype(np.float32)
CARDINALITY = {"dna": 4, "rna": 4, "amino": 20}
_SENTINEL_SCORE = -1024  # a position left of the database: forces 0
_BLOCK_CELLS = 1 << 29  # the most state cells a block of models holds
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
    emissions: np.ndarray  # float32 (rows, card), negative natural logs

    @property
    def prefix(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.lengths)])

    @property
    def card(self) -> int:
        """The alphabet's size: 4 (DNA, RNA) or 20 (amino)."""
        return int(self.emissions.shape[1])


def read_hmm(path: str) -> Collection:
    """The SSV fields of every model in a HMMER3 text file, as many match
    columns as its ``ALPH`` says (one alphabet a file)."""
    with open(path) as f:
        lines = f.read().splitlines()
    lengths, maxl, mu, lam, rows = [], [], [], [], []
    cards = set()
    i = 0
    while i < len(lines):
        if not lines[i].startswith("HMMER3"):
            i += 1
            continue
        leng = maxlen = card = None
        stats = None
        i += 1
        while not lines[i].startswith("HMM "):
            tok = lines[i].split()
            if tok and tok[0] == "LENG":
                leng = int(tok[1])
            elif tok and tok[0] == "MAXL":
                maxlen = int(tok[1])
            elif tok and tok[0] == "ALPH":
                card = CARDINALITY.get(tok[1].lower())
                if card is None:
                    raise ValueError(f"{path}: unknown ALPH {tok[1]!r}")
            elif tok[:3] == ["STATS", "LOCAL", "MSV"]:
                stats = (float(tok[3]), float(tok[4]))
            i += 1
        if leng is None or stats is None or card is None:
            raise ValueError(
                f"{path}: a model lacks LENG, ALPH or STATS LOCAL MSV")
        cards.add(card)
        i += 2  # the alphabet header and the transition header
        i += 3 if lines[i].strip().startswith("COMPO") else 2
        for pos in range(leng):  # a Pfam-sized file has millions of nodes
            tok = lines[i].replace("*", "inf").split(None, card + 1)
            if int(tok[0]) != pos + 1:
                raise ValueError(f"{path}: node {tok[0]} where {pos + 1}")
            rows.extend(map(float, tok[1:1 + card]))
            i += 3
        if lines[i].strip() != "//":
            raise ValueError(f"{path}: a model is not closed by //")
        i += 1
        lengths.append(leng)
        maxl.append(maxlen if maxlen else 4 * leng)
        mu.append(stats[0])
        lam.append(stats[1])
    if len(cards) > 1:
        raise ValueError(f"{path}: models of more than one alphabet")
    return Collection(np.array(lengths, np.int64), np.array(maxl, np.int64),
                      np.array(mu), np.array(lam),
                      np.array(rows, dtype=np.float32).reshape(
                          -1, cards.pop() if cards else 4))


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
    """(rows, card) int16 projected scores of the whole collection: a
    residue ``x`` adds ``f(B_x · scale)``, with ``B_x`` its null's bits
    (2 for DNA, :data:`AMINO_NULL_BITS` for amino)."""
    f = _rounding(precision)
    null_bits = f(2) if coll.card == 4 else f(AMINO_NULL_BITS)
    out = []
    prefix = coll.prefix
    for k in range(coll.lengths.shape[0]):
        scale = scale_factor(coll.mu[k], coll.lam[k], coll.max_lengths[k],
                             coll.lengths[k], p_value, precision)
        alpha = f(null_bits * scale)
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


def _encoder(groups) -> np.ndarray:
    table = np.full(256, 255, dtype=np.uint8)
    for code, letters in enumerate(groups):
        for ch in letters:
            table[ord(ch)] = code
    return table


_ENCODE = {4: _encoder(("Aa", "Cc", "Gg", "TtUu")),
           20: _encoder(c + c.lower() for c in AMINO)}
_LETTERS = {4: "A, C, G, T, U", 20: AMINO}


def splitmix64(values: np.ndarray, seed: int) -> np.ndarray:
    phi = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        z = values.astype(np.uint64) + np.uint64(seed) * phi
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def read_fasta(path: str, card: int = 4) -> Database:
    """Records of A/C/G/T(/U) text encoded 0..3 (``card`` 4), or of the 20
    amino letters encoded 0..19 in HMMER's order (``card`` 20), each
    followed by its separator. Any other letter is refused."""
    with open(path, "rb") as f:
        text = f.read()
    encode = _ENCODE[card]
    names, seqs = [], []
    for rec in text.split(b">")[1:]:
        header, _, body = rec.partition(b"\n")
        names.append(header.split()[0].decode() if header.split() else "")
        seqs.append(encode[np.frombuffer(
            body.replace(b"\n", b"").replace(b"\r", b""), dtype=np.uint8)])
    if any((s == 255).any() for s in seqs):
        raise ValueError(f"{path}: the reference reads {_LETTERS[card]} only")
    lengths = np.array([s.shape[0] for s in seqs], dtype=np.int64)
    sep = np.cumsum(lengths + 1) - 1
    symbols = np.empty(int(sep[-1]) + 1 if len(sep) else 0, dtype=np.uint8)
    keep = np.ones(symbols.shape[0], dtype=bool)
    keep[sep] = False
    symbols[keep] = np.concatenate(seqs) if seqs else []
    mixed = splitmix64(sep, SEPARATOR_SEED)
    symbols[sep] = (mixed & np.uint64(3) if card == 4
                    else mixed % np.uint64(card)).astype(np.uint8)
    return Database(names, lengths, symbols)


# ----------------------------------------------------------------- sweep

def window_hits(windows: Sequence[Tuple[np.ndarray, int]], width: int,
                scores: np.ndarray, device="cpu",
                model_lengths: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every raw hit (window, row, global position) in each window
    ``(symbols, a)``, the positions ``[a, a + width)`` of ``symbols``: the
    exact SSV over ``scores`` ((rows, card)), each window swept from
    ``a − (P − 1)`` (positions left of the database read as the sentinel
    symbol ``card``, whose score forces 0). With ``model_lengths`` (the
    models' lengths in row order) the models are isolated: each starts
    from zero and each window is swept from ``a − (Lmax − 1)``; without,
    the rows are one chain, as one model of ``P`` rows."""
    P, card = scores.shape
    lengths = (np.array([P]) if model_lengths is None
               else np.asarray(model_lengths, dtype=np.int64))
    table = torch.full((P, card + 1), _SENTINEL_SCORE, dtype=torch.int16)
    table[:, :card] = torch.from_numpy(np.asarray(scores, dtype=np.int16))
    dev = torch.device(device)
    table = table.to(dev)
    lead = int(lengths.max()) - 1
    n, C = len(windows), lead + width
    span = np.full((n, C), card, dtype=np.int32)
    for k, (symbols, a) in enumerate(windows):
        src = symbols[max(a - lead, 0):a + width]
        span[k, C - src.shape[0]:] = src
    hits = _sweep(torch.from_numpy(span).to(dev), width, table, lengths)
    win, row, col = hits[:, 1], hits[:, 0], hits[:, 2]
    starts = np.array([a for _, a in windows], dtype=np.int64)
    return win, row, starts[win] + col if n else col


def _sweep(sym: torch.Tensor, width: int, table: torch.Tensor,
           lengths: np.ndarray) -> np.ndarray:
    """(row, window, column) of every hit, each model its own chain from
    zero. Models go longest first, in blocks of at most ``_BLOCK_CELLS``
    state cells; a block sweeps the ``r``-th row of each of its models
    longer than ``r`` together, over the last ``len_max − 1 + width``
    positions of the span (``len_max`` its longest model), and keeps the
    windows' hits of up to ``_HIT_BLOCK_ROWS`` rows before it pulls them."""
    n, C = sym.shape
    dev = sym.device
    order = np.argsort(-lengths, kind="stable")
    first = np.concatenate([[0], np.cumsum(lengths)])[:-1]
    found = []
    i = 0
    while i < order.shape[0]:
        longest = int(lengths[order[i]])
        Cb = longest - 1 + width
        m = max(1, min(order.shape[0] - i, _BLOCK_CELLS // (n * Cb)))
        block = order[i:i + m]
        i += m
        lens = lengths[block]  # descending
        alive = np.searchsorted(-lens, -np.arange(longest), side="left")
        # the block's rows, row r of every model together (a short model's
        # later rows repeat its last, and are never read)
        rows = first[block][None, :] + np.minimum(
            np.arange(longest)[:, None], lens[None, :] - 1)
        sub = table[torch.from_numpy(rows).to(dev)]  # (longest, m, card + 1)
        base = torch.from_numpy(first[block]).to(dev)
        s = sym[:, C - Cb:]
        state = torch.zeros((m, n, Cb), dtype=torch.int16, device=dev)
        kept = torch.zeros((max(1, min(_HIT_BLOCK_ROWS, longest,
                                       _BLOCK_CELLS // (m * n * width))),
                            m, n, width), dtype=torch.bool, device=dev)
        for r in range(longest):
            mr = int(alive[r])  # the models longer than r
            view = state[:mr, :, :Cb - r]
            view.add_(sub[r, :mr][:, s[:, r:]])
            hit = view >= 256
            view.clamp_(min=0).masked_fill_(hit, 0)
            q = r % kept.shape[0]
            kept[q, :mr] = hit[:, :, Cb - width - r:]
            if mr < m:
                kept[q, mr:] = False
            if q == kept.shape[0] - 1 or r == longest - 1:
                nz = kept[:q + 1].nonzero()  # (row - r + q, model, win, col)
                rows = base[nz[:, 1]] + nz[:, 0] + (r - q)
                found.append(torch.cat([rows[:, None], nz[:, 2:]], 1).cpu())
    return torch.cat(found).numpy() if found else np.empty((0, 3), np.int64)


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
