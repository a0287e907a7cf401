"""Kernel micro-benchmark: the sweep kernel's device-only GCUPS.

The counterpart of `tools/kbench.py`, and the chained point that
:mod:`havac_tpu_torch.bench` shares. Each point launches
``havac_tpu_torch/csrc/ssv_sweep.cu`` (through ``ops/ssv_cuda.py``
``launch``) on inputs already on the card and times it DIFFERENTIALLY:
chains of N dispatches, each taking the previous one's final row state as
its initial state with the carry zero every time (the engine's row-chunk
chaining), the seconds a dispatch ``(t(9) - t(1)) / 8`` from the min of
``--iters`` timings of each chain, so that a chain's fixed cost cancels
(``tools/roofline.py`` ``time_differential``, the port's one timing
loop: the chains of 1 first, then those of 9). Each chain is timed by
CUDA events on the current stream with one synchronise at its end;
nothing is allocated inside it (two row-state buffers used in turn, the
key and count buffers made before timing).

Points (the JAX tool's draws, ``np.random.default_rng(0)``, L = B x W):

- ``--kernel swar`` (default): codes in [0, ``--card``), scores in [-40,
  12) (sparse: no or few hits, the word update alone) or, with
  ``--dense``, in [-40, 110) (a hit every 7-8 cells).
- ``--resets M`` (SWAR kernel only): reset rows at the starts of models
  whose lengths are log-normal with median ``M`` rows (sigma 0.8, clipped
  to 10-2,500, as ``ssvbench/configs/pfam35.json`` draws Pfam's families),
  the first model entered at a uniform row of its length
  (:func:`model_starts`): the isolated models' launch, whose kernel
  instantiation takes reset rows.
- ``--kernel unpacked``: the unpacked Pallas kernel's draw, symbols (B,
  W/128, 128) and scores (S, K, 4) with S = P // K
  (``--rows-per-strip`` sets K, so only S x K rows). The port serves that
  kernel through the same ``ssv_sweep.cu``, so this times the same kernel
  on that draw; no second kernel exists.

Two restrictions of the TPU kernels are not ported: W a multiple of 3,072
and amino's 196,608 width (VMEM); any W >= 1 runs.

The key buffer starts at 2^20 keys. The warm-up is one counting chain of 9
dispatches that reads every dispatch's exact count (the kernel keeps
counting past the buffer); if the largest exceeds the buffer, it is
regrown once to that count, outside every timed window, and a point whose
keys would not fit the device's free memory is refused. A regrow
launches nothing: every timed chain's per-dispatch counts must equal the
counting chain's, or the run fails. So a point launches 9 + 10 x iters
times, which the run checks on the card.

Each point prints one line: GCUPS (min and median), the kernel's time for
one launch alone (the fastest chain of one), its bound (the larger of the
bytes over the memory rate, the hits in the fewer bytes of 8-byte keys and
a one-bit-a-cell bitmap, and ``sweep_min_ops`` at the card's issue peak),
the share of it, the bound with the port's 8-byte keys charged, the hits,
the block geometry the kernel chose and the route.

``--device`` defaults to ``cuda`` and raises where CUDA is missing; there
is no fallback (``--device cpu`` runs the plain version on a host clock,
which the tests use).

    python -m havac_tpu_torch.tools.kbench [--kernel swar|unpacked]
        [--blocks 22] [--rows 4080] [--width 387072] [--sweep-blocks 2 4 8 22]
        [--dense] [--card 4] [--resets 122] [--iters 5] [--json out.json]
    python -m havac_tpu_torch.tools.kbench --device cpu --width 3072 \\
        --rows 60 --sweep-blocks 1 2 --iters 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from havac_tpu_torch import native
from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.tools import roofline
from havac_tpu_torch.tools.roofline import time_differential
from havac_tpu_torch.utils.provenance import provenance

N_LO, N_HI = 1, 9  # dispatches of the short and the long chain
FIRST_CAP = 1 << 20  # keys the buffer holds before the counting chain
ROUTE = "ssv_sweep.cu"
KEY_BYTES = 8


def sweep_min_ops(card: int) -> tuple:
    """Lower bounds on the instructions a word (3 cells) and row of the
    sweep issues: (all, logic). The codes' extraction and the reads'
    addressing are left out, as a design may stage them.

    Card 4 takes ``current``'s count (``tools/roofline.py`` ``MIN_OPS``,
    the rule of the smoke's bound): the row update's add, shift, hit bits,
    keep mask and state (8, 3 of them logic) and the bit-plane match's
    three multiply-adds, 11. Any other card matches by table: a field's
    score is its code's among ``card`` arbitrary values of the row, which
    no multiply-add of two bit planes computes and no byte permute (8
    bytes) selects past card 8. The fewest reads any table layout needs is
    one: a row's table of the ``card``^3 packed, biased words of three
    fields gives a word's match, already in place, in one read, and the
    row's own add takes it. So 8 + 1 = 9, logic 3. It counts the work,
    not the design's 21.63 SASS. The same one-read table would put card 4
    at 9 too; card 4 keeps ``current``'s 11, so that its bound is the one
    the smoke and the earlier records use."""
    if card == 4:
        return roofline.MIN_OPS["current"]
    total, logic = roofline.MIN_OPS["nomatch"]  # the row update alone
    return total + 1, logic


def sweep_bytes(L: int, P: int, card: int, hits: int, *,
                keys: bool = False) -> int:
    """Bytes one dispatch must move: symbols, scores, the initial row state
    and carry read once; the final state and carry and the count written
    once, and the hits in the fewer bytes of two formats, the port's
    8-byte keys or a bitmap of one bit a cell (the TPU kernel's dirty
    tiles at their densest). ``keys`` charges the port's keys alone (the
    bound of the port's format, not of the function)."""
    hit_bytes = KEY_BYTES * hits
    if not keys:
        hit_bytes = min(hit_bytes, -(-L * P // 8))
    return L + P * card + 2 * 4 * L + 2 * 4 * (P + 1) + 8 + hit_bytes


def sweep_bound(gpu: roofline.Card, L: int, P: int, card: int,
                hits: int) -> dict:
    """The least time of one dispatch on ``gpu``: its bytes over the
    memory rate or its ``sweep_min_ops`` at the issue peak, the larger;
    ``key_bound_ms`` the same with the port's 8-byte keys charged."""
    op_s = max(gpu.count_seconds(*sweep_min_ops(card), L * P / 3))
    keyed = roofline.bound(sweep_bytes(L, P, card, hits, keys=True), op_s)
    return {**roofline.bound(sweep_bytes(L, P, card, hits), op_s),
            "key_bound_ms": keyed["bound_ms"]}


def free_bytes(device: torch.device) -> int:
    """Bytes the device has free: ``cudaMemGetInfo``'s figure on a GPU,
    the host's available memory on the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class Chain:
    """One sweep's inputs on a device and the buffers of chains of up to
    ``n_hi`` dispatches. Dispatch k reads ``state0`` (k = 0) or the state
    dispatch k - 1 wrote, and writes the other of two state buffers, so a
    launch never reads the state it writes; every dispatch's carry in is
    zero. All dispatches share one key buffer; dispatch k writes its exact
    count into ``counts[k]``. ``reset_rows`` (P,) int32, when given, go to
    every dispatch."""

    def __init__(self, symbols: torch.Tensor, scores: torch.Tensor,
                 n_hi: int = N_HI, reset_rows: Optional[torch.Tensor] = None):
        dev = symbols.device
        L, P = symbols.shape[0], scores.shape[0]
        self.symbols, self.scores, self.n_hi = symbols, scores, n_hi
        self.reset_rows = reset_rows
        self.state0 = torch.zeros(L, dtype=torch.int32, device=dev)
        self.carry0 = torch.zeros(P + 1, dtype=torch.int32, device=dev)
        self._states = [torch.empty(L, dtype=torch.int32, device=dev)
                        for _ in range(2)]
        self._carries = [torch.empty(P + 1, dtype=torch.int32, device=dev)
                         for _ in range(2)]
        self.counts = torch.zeros(n_hi, dtype=torch.int64, device=dev)
        self.expected: Optional[List[int]] = None
        self.regrows = 0
        self._use_keys(torch.empty(FIRST_CAP, dtype=torch.int64, device=dev))

    def _use_keys(self, keys: torch.Tensor) -> None:
        self.keys = keys
        self.outs = [ssv_cuda.SweepBuffers(keys, self.counts[k:k + 1],
                                           self._states[k % 2],
                                           self._carries[k % 2])
                     for k in range(self.n_hi)]

    @property
    def cap(self) -> int:
        return self.keys.shape[0]

    def step(self, state: torch.Tensor, k: int) -> torch.Tensor:
        """Launch dispatch ``k`` from ``state``; returns the state it
        writes."""
        out = self.outs[k]
        ssv_cuda.launch(self.symbols, self.scores, state, self.carry0,
                        self.reset_rows, 0, 0, out)
        return out.final_state

    def run(self, n: int) -> ssv_cuda.SweepBuffers:
        """A chain of ``n`` dispatches from ``state0``; returns the last
        one's buffers (its keys are ``keys[:counts[n - 1]]``)."""
        st = self.state0
        for k in range(n):
            st = self.step(st, k)
        return self.outs[n - 1]

    def fit(self) -> None:
        """The warm-up: one counting chain of ``n_hi`` dispatches. Keeps
        every dispatch's exact count and, where the largest exceeds the
        key buffer, regrows it once to that count (launching nothing);
        refuses counts whose keys would not fit the free memory."""
        self.run(self.n_hi)
        self.expected = self.counts.tolist()
        need = max(self.expected)
        if need <= self.cap:
            return
        dev = self.keys.device
        nbytes, free = KEY_BYTES * need, free_bytes(dev)
        if nbytes > free:
            raise MemoryError(
                f"{need} hit keys need {nbytes} bytes; the device has {free} "
                f"bytes free (fewer blocks, or sparse scores)")
        self._use_keys(torch.empty(need, dtype=torch.int64, device=dev))
        self.regrows += 1

    def check(self, n: int) -> None:
        """A chain of ``n`` dispatches hit what the counting chain hit,
        dispatch for dispatch (so every key fitted the buffer)."""
        got = self.counts[:n].tolist()
        if got != self.expected[:n]:
            raise RuntimeError(f"hit counts changed between chains: {got} "
                               f"against {self.expected[:n]}")


def swar_inputs(B: int, P: int, W: int, dense: bool = False,
                card: int = 4) -> tuple:
    """The JAX tool's ``bench_swar`` draw: codes (B * W,) uint8 and scores
    (P, card) int8. The TPU kernel takes ``scores + 256`` as biased int32
    strips; the port's kernel takes the int8 scores themselves, which is
    the same recurrence."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, card, size=B * W).astype(np.uint8)
    scores = rng.integers(-40, 110 if dense else 12,
                          size=(P, card)).astype(np.int8)
    return codes, scores


def model_starts(P: int, median: int, seed: int = 1) -> np.ndarray:
    """(P,) int32 reset rows: 1 at each model's first row, for models whose
    lengths are log-normal with median ``median`` rows (sigma 0.8, clipped
    to 10-2,500), the first entered at a uniform row of its length; drawn
    from ``np.random.default_rng(seed)``, apart from the codes and scores."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(np.rint(rng.lognormal(np.log(median), 0.8,
                                            P // 10 + 2)), 10, 2500)
    starts = np.cumsum(lengths.astype(np.int64)) - rng.integers(0, lengths[0])
    reset = np.zeros(P, np.int32)
    reset[starts[starts < P]] = 1
    return reset


def unpacked_inputs(B: int, P: int, W: int, K: int) -> tuple:
    """The JAX tool's ``bench_unpacked`` draw: symbols (B, W/128, 128) and
    scores (S, K, 4) in [-40, 12) with S = P // K, flattened in that
    order to (B * W,) uint8 and (S * K, 4) int8 (the unpacked kernel takes
    raw scores too)."""
    rng = np.random.default_rng(0)
    sym = rng.integers(0, 4, size=B * W).astype(np.uint8)
    S = P // K
    scores = rng.integers(-40, 12, size=S * K * 4).astype(np.int8)
    return sym, scores.reshape(S * K, 4)


def bench_point(symbols: np.ndarray, scores: np.ndarray, *, iters: int,
                device, inspect: Optional[Callable[[Chain], None]] = None,
                reset_rows: Optional[np.ndarray] = None) -> dict:
    """Time one point (module docstring); its record. ``reset_rows`` (P,)
    int32, when given, go to every dispatch. ``inspect(chain)``,
    if given, sees the chain after its timing: its last timed chain is of
    ``N_HI`` dispatches, whose last one's buffers are ``chain.outs[-1]``.
    Any failure raises."""
    dev = torch.device(device)
    sym = torch.from_numpy(symbols).to(dev)
    sc = torch.from_numpy(scores).to(dev)
    (L,), (P, card) = sym.shape, sc.shape
    rr = (None if reset_rows is None else
          torch.from_numpy(np.asarray(reset_rows, np.int32)).to(dev))
    chain = Chain(sym, sc, reset_rows=rr)
    before = ssv_cuda.LAUNCHES
    chain.fit()
    timing = time_differential(chain.run, N_LO, N_HI, dev, iters,
                               warm=False, check=chain.check)
    launches = ssv_cuda.LAUNCHES - before
    if dev.type == "cuda" and launches != N_HI + iters * (N_LO + N_HI):
        raise RuntimeError(f"{launches} kernel launches, not the counting "
                           f"chain's {N_HI} and {iters} x {N_LO + N_HI}")
    if timing.sec <= 0:
        raise RuntimeError(f"t({N_HI}) {min(timing.t_hi)} s <= t({N_LO}) "
                           f"{min(timing.t_lo)} s")
    if inspect is not None:
        inspect(chain)
    hits = chain.expected[0]
    point = {
        "L": L, "P": P, "card": card, "cells": L * P,
        "gcups": L * P / timing.sec / 1e9,
        "gcups_median": L * P / timing.sec_median / 1e9,
        "sec_per_dispatch": timing.sec, "t_lo": timing.t_lo,
        "t_hi": timing.t_hi,
        "kernel_ms": min(timing.t_lo) / N_LO * 1e3,
        "hits": hits, "counts": chain.expected, "regrows": chain.regrows,
        "key_cap": chain.cap, "launches": launches,
        "route": ROUTE if dev.type == "cuda" else "plain",
        "threads": (ssv_cuda.block_threads(L, P, dev)
                    if dev.type == "cuda" else None),
        "bound_ms": None, "bound_by": None, "bound_share": None,
        "key_bound_ms": None, "min_ops": list(sweep_min_ops(card)),
        "reset_rows": 0 if rr is None else int(rr.count_nonzero()),
    }
    if dev.type == "cuda":
        point.update(sweep_bound(roofline.Card.query(dev), L, P, card, hits))
        point["bound_share"] = point["bound_ms"] / point["kernel_ms"]
    return point


def bench_swar(B: int, P: int, W: int, iters: int = 5, dense: bool = False,
               card: int = 4, device="cuda", inspect=None,
               resets: Optional[int] = None) -> dict:
    """The SWAR kernel's point: ``swar_inputs``' draw through
    :func:`bench_point`, with :func:`model_starts` at a median of
    ``resets`` rows when given."""
    return bench_point(*swar_inputs(B, P, W, dense, card), iters=iters,
                       device=device, inspect=inspect,
                       reset_rows=(None if resets is None
                                   else model_starts(P, resets)))


def bench_unpacked(B: int, P: int, W: int, K: int = 32, iters: int = 5,
                   device="cuda", inspect=None) -> dict:
    """The unpacked kernel's point: ``unpacked_inputs``' draw (S x K rows)
    through :func:`bench_point`."""
    return bench_point(*unpacked_inputs(B, P, W, K), iters=iters,
                       device=device, inspect=inspect)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=["swar", "unpacked"], default="swar")
    ap.add_argument("--blocks", type=int, default=22)
    ap.add_argument("--rows", type=int, default=4080)
    ap.add_argument("--width", type=int, default=387072)
    ap.add_argument("--rows-per-strip", type=int, default=32,
                    help="unpacked kernel only: S = rows // K strips of K")
    ap.add_argument("--sweep-blocks", type=int, nargs="*", default=None,
                    help="bench each B in the list instead of one point")
    ap.add_argument("--dense", action="store_true",
                    help="hit-rich scores in [-40, 110) (SWAR kernel only)")
    ap.add_argument("--card", type=int, default=4,
                    help="alphabet cardinality (SWAR kernel only): 4 = "
                    "nucleotide, 20 = amino")
    ap.add_argument("--resets", type=int, default=None,
                    help="reset rows at model starts, model lengths "
                    "log-normal at this median (SWAR kernel only)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--json", default=None,
                    help="also write the provenance and the points here")
    args = ap.parse_args(argv)
    if args.kernel == "unpacked" and (args.dense or args.card != 4
                                      or args.resets is not None):
        ap.error("--dense, --card and --resets are for --kernel swar")
    if args.resets is not None and args.resets < 1:
        ap.error("--resets must be positive")
    if args.kernel == "unpacked" and not 1 <= args.rows_per_strip <= args.rows:
        ap.error("--rows-per-strip must lie in [1, --rows]")
    if args.width < 1 or args.rows < 1 or args.iters < 1:
        ap.error("--width, --rows and --iters must be positive")
    return args


def describe(p: dict) -> str:
    """A point's line: the JAX tool's, plus the kernel's time, its bound
    and share, the hits, the geometry and the route."""
    resets = f" reset rows {p['reset_rows']}" if p["reset_rows"] else ""
    line = (f"{p['kernel']} B={p['B']:3d} W={p['W']} P={p['P']} "
            f"card={p['card']}{' dense' if p['dense'] else ''}{resets}: "
            f"{p['gcups']:8.1f} GCUPS (median "
            f"{p['gcups_median']:.1f}), kernel {p['kernel_ms']:.4f} ms")
    if p["bound_ms"] is not None:
        line += (f", bound {p['bound_ms']:.4f} ms ({p['bound_by']}, "
                 f"MIN_OPS {p['min_ops']}), share {p['bound_share']:.4f} "
                 f"(with 8-byte keys {p['key_bound_ms']:.4f} ms)")
    geometry = (f"{p['threads']}-thread blocks" if p["threads"]
                else "plain version")
    return (f"{line}, hits {p['hits']}, regrows {p['regrows']}, {geometry}, "
            f"launches {p['launches']}, route={p['route']}")


def main(argv: Optional[List[str]] = None,
         inspect: Optional[Callable[[Chain], None]] = None) -> int:
    """The tool; ``inspect`` goes to every point's :func:`bench_point`."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available on this "
                           "machine (there is no CPU fallback)")
    points = []
    for B in args.sweep_blocks or [args.blocks]:
        if args.kernel == "swar":
            p = bench_swar(B, args.rows, args.width, args.iters, args.dense,
                           args.card, device, inspect, args.resets)
        else:
            p = bench_unpacked(B, args.rows, args.width, args.rows_per_strip,
                               args.iters, device, inspect)
        p.update(kernel=args.kernel, B=B, W=args.width, dense=args.dense,
                 rows_per_strip=(args.rows_per_strip
                                 if args.kernel == "unpacked" else None))
        print(describe(p), flush=True)
        points.append(p)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"provenance": provenance(device, native.available()),
                       "points": points}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
