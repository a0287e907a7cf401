"""The comparison that decides ``correct``.

Once the window has closed, the first answer the window gave for each
sampled file (the traffic's ``sample.files`` drawn from the seed, and the
pool's longest file) is held to the plain reference
(``ssvbench/reference``) in windows of positions drawn from the seed, and
every later answer the window gave for that file is held to the first:

- ``score_rows_differing``: rows of the program's projected scores
  (``Havac.scores``, the projection made at ``load_phmm``) that differ from
  the reference's projection of the same ``.hmm`` file;
- ``hits_missing``: resolved hits the reference finds in the windows and
  the answer lacks;
- ``hits_extra``: resolved hits of the answer in the windows that the
  reference lacks, each duplicate, and every hit of the answer (window or
  not) whose coordinates lie outside its file or its model;
- ``answers_differing``: later answers of a sampled file that differ from
  its first in any hit or in their number (the search is exact and its
  hits come ordered by (row, position), so a file answers the same every
  time);
- ``requests_failed``: requests of the window that raised or answered for
  another file.

Each is exact: its limit is 0. A check whose windows hold no reference hit
proves nothing and is not correct.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ssvbench.reference import ssv

LIMITS = {"score_rows_differing": 0, "hits_missing": 0, "hits_extra": 0,
          "answers_differing": 0, "requests_failed": 0}
COLUMNS = ("sequence_index", "sequence_position", "phmm_index",
           "phmm_position")


@dataclass
class Plan:
    files: List[int]  # sampled pool indices, ascending
    windows: Dict[int, List[int]]  # pool index -> window starts
    width: int


def plan(seed: int, sizes: Sequence[int], sample: dict) -> Plan:
    """The sample of a run, from its seed: ``sizes`` are the files' swept
    lengths (residues and one separator a record)."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 0x5C4E])
    n = len(sizes)
    chosen = set(rng.choice(n, size=min(n, int(sample["files"])),
                            replace=False).tolist())
    chosen.add(int(np.argmax(sizes)))
    width = int(sample["window"])
    windows = {}
    for f in sorted(chosen):
        m = min(int(sample["windows_per_file"]), sizes[f] // width)
        if m < 1:
            raise ValueError(f"file {f} ({sizes[f]} positions) is shorter "
                             f"than a window ({width})")
        seg = sizes[f] // m
        windows[f] = [i * seg + int(rng.integers(0, seg - width + 1))
                      for i in range(m)]
    return Plan(sorted(chosen), windows, width)


def answer_columns(hits) -> Tuple[np.ndarray, ...]:
    """(sequence, position, model, model position) int64 columns of a
    ``ResolvedHits``-like answer."""
    return tuple(np.asarray(getattr(hits, f), dtype=np.int64)
                 for f in COLUMNS)


def differing(first: Tuple[np.ndarray, ...],
              later: Sequence[Tuple[np.ndarray, ...]]) -> int:
    """How many of the answers ``later`` (columns) differ from ``first``."""
    return sum(not all(np.array_equal(a, b) for a, b in zip(first, cols))
               for cols in later)


def reference_answers(pl: Plan, paths: Dict[int, str], coll: ssv.Collection,
                      scores: np.ndarray, device, isolate: bool = False):
    """The reference's resolved hits in each sampled file's windows (the
    models isolated where ``isolate``), and the files' reference
    databases."""
    dbs = {f: ssv.read_fasta(paths[f], coll.card) for f in pl.files}
    windows = [(dbs[f].symbols, a) for f in pl.files for a in pl.windows[f]]
    owner = np.array([f for f in pl.files for _ in pl.windows[f]])
    win, row, pos = ssv.window_hits(windows, pl.width, scores, device,
                                    coll.lengths if isolate else None)
    out = {}
    for f in pl.files:
        sel = owner[win] == f if win.size else np.zeros(0, dtype=bool)
        out[f] = ssv.resolve(row[sel], pos[sel], dbs[f], coll)
    return out, dbs


def compare(ref: np.ndarray, got: Tuple[np.ndarray, ...],
            db: ssv.Database, coll: ssv.Collection, starts: Sequence[int],
            width: int):
    """(missing, extra, compared) of one file's answer ``got`` (columns)
    against the reference's hits ``ref`` ((n, 4) rows) in the windows at
    ``starts``."""
    seq, pos, model, mpos = got
    nrec, nmod = db.lengths.shape[0], coll.lengths.shape[0]
    bad = (seq < 0) | (seq >= nrec) | (model < 0) | (model >= nmod)
    seq, model = np.clip(seq, 0, nrec - 1), np.clip(model, 0, nmod - 1)
    bad |= (pos < 0) | (pos >= db.lengths[seq])
    bad |= (mpos < 0) | (mpos >= coll.lengths[model])
    N = db.symbols.shape[0]
    g = db.starts[seq] + pos
    ws = np.sort(np.asarray(starts, dtype=np.int64))
    k = np.searchsorted(ws, g, side="right") - 1
    inside = ~bad & (k >= 0) & (g < ws[np.maximum(k, 0)] + width)
    keys = (coll.prefix[model[inside]] + mpos[inside]) * N + g[inside]
    ukeys = np.unique(keys)
    rkeys = np.unique((coll.prefix[ref[:, 2]] + ref[:, 3]) * N
                      + db.starts[ref[:, 0]] + ref[:, 1])
    missing = np.setdiff1d(rkeys, ukeys, assume_unique=True).shape[0]
    extra = (np.setdiff1d(ukeys, rkeys, assume_unique=True).shape[0]
             + (keys.shape[0] - ukeys.shape[0]) + int(bad.sum()))
    return int(missing), int(extra), int(rkeys.shape[0])


def judge(answers: Dict[int, Tuple[np.ndarray, ...]], program_scores: np.ndarray,
          hmm_path: str, paths: Dict[int, str], pl: Plan, p_value: float,
          requests_failed: int, device, later=None,
          isolate: bool = False) -> dict:
    """Readings of every compared number, the sample's size, and ``ok``.
    ``answers`` maps sampled pool indices to their first answers' columns
    (:func:`answer_columns`), ``later`` to the lists of their later
    answers' columns, which are emptied as they are compared; files the
    window never answered are left out of the sample. ``isolate``: the
    search isolates its models (``search.isolate_models``)."""
    later = later or {}
    n_later = sum(len(v) for v in later.values())
    changed = 0
    for f, answers_f in later.items():
        changed += differing(answers[f], answers_f)
        answers_f.clear()
    coll = ssv.read_hmm(hmm_path)
    scores = ssv.project(coll, p_value)
    program_scores = np.asarray(program_scores)
    if program_scores.shape == scores.shape:
        rows_differing = int((program_scores != scores).any(axis=1).sum())
    else:
        rows_differing = scores.shape[0]
    served = Plan([f for f in pl.files if f in answers],
                  {f: pl.windows[f] for f in pl.files if f in answers},
                  pl.width)
    ref, dbs = reference_answers(served, paths, coll, scores, device,
                                 isolate)
    missing = extra = compared = 0
    for f in served.files:
        m, e, c = compare(ref[f], answers[f], dbs[f], coll,
                          served.windows[f], served.width)
        missing, extra, compared = missing + m, extra + e, compared + c
    readings = {"score_rows_differing": rows_differing,
                "hits_missing": missing, "hits_extra": extra,
                "answers_differing": changed,
                "requests_failed": int(requests_failed)}
    ok = compared > 0 and all(readings[k] <= LIMITS[k] for k in LIMITS)
    return {"readings": readings, "ok": ok,
            "sample": {"files": len(served.files),
                       "windows": sum(len(w) for w in served.windows.values()),
                       "window": served.width, "reference_hits": compared,
                       "later_answers": n_later}}
