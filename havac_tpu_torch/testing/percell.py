"""Per-cell DP equivalence on the port: the byCellComparator analog.

The counterpart of `havac_tpu/testing/percell.py`. Each function returns
the full (P, L) matrix of post-update DP states, row-major by model row as
the JAX functions lay it out, as a uint8 tensor on the inputs' device (a
post-update state lies in [0, 255], so uint8 is exact, and a card-sized
matrix never has to reach the host):

  * ``dp_matrix_oracle`` — the numpy golden model (int32 numpy array);
  * ``dp_matrix_torch``  — the plain PyTorch sweep, filling the matrix row by
                           row;
  * ``dp_matrix_rows``   — the sweep kernel driven one model row per launch,
                           chaining each launch's final row state into the
                           next (``dp_matrix_pallas``'s readout);
  * ``dp_matrix_kernel`` — one launch of the kernel's row dump: the
                           production word body, storing every cell as it
                           computes it (``dp_matrix_swar``'s ``debug_rows``
                           dump of the production SWAR kernel).

The device is the symbols' device: on CUDA tensors the last two launch the
kernel (`havac_tpu_torch/csrc/ssv_sweep.cu`), on CPU tensors the wrapper
runs its plain version. Inputs may be numpy arrays (taken as CPU tensors).
``compare_matrices`` reports the first mismatching cells, like the JAX one,
on tensors of either device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.ops.reference import ssv_reference
from havac_tpu_torch.ops.ssv_torch import ssv_sweep_plain

__all__ = ["CellMismatch", "compare_matrices", "dp_matrix_kernel",
           "dp_matrix_oracle", "dp_matrix_rows", "dp_matrix_torch"]


def dp_matrix_oracle(symbols: np.ndarray, scores: np.ndarray) -> np.ndarray:
    _, matrix = ssv_reference(symbols, scores, return_matrix=True)
    return matrix


@dataclass
class CellMismatch:
    row: int
    position: int
    expected: int
    actual: int


def _inputs(symbols, scores, init_carry=None, reset_rows=None):
    sym = torch.as_tensor(symbols).to(torch.uint8).contiguous()
    dev = sym.device
    sc = torch.as_tensor(scores, device=dev).to(torch.int8).contiguous()
    P = sc.shape[0]
    icr = (torch.zeros(P + 1, dtype=torch.int32, device=dev)
           if init_carry is None
           else torch.as_tensor(init_carry, device=dev).to(torch.int32)
           .contiguous())
    rr = (None if reset_rows is None
          else torch.as_tensor(reset_rows, device=dev).to(torch.int32)
          .contiguous())
    return sym, sc, icr, rr


def _matrix(sym, sc) -> torch.Tensor:
    return torch.empty((sc.shape[0], sym.shape[0]), dtype=torch.uint8,
                       device=sym.device)


def dp_matrix_torch(symbols, scores, init_carry=None,
                    reset_rows=None) -> torch.Tensor:
    """Full state matrix from the plain PyTorch sweep, on any device."""
    sym, sc, icr, rr = _inputs(symbols, scores, init_carry, reset_rows)
    out = _matrix(sym, sc)
    ssv_sweep_plain(sym, sc, torch.zeros(sym.shape[0], dtype=torch.int32,
                                         device=sym.device), icr, rr,
                    dump=out)
    return out


def dp_matrix_rows(symbols, scores) -> torch.Tensor:
    """Full state matrix from the sweep kernel, one model row per launch
    (debug-only: P launches). Each launch starts from the previous row's
    final state and a zero carry, as ``dp_matrix_pallas`` dispatches each
    row of the unpacked kernel."""
    sym, sc, icr, _ = _inputs(symbols, scores)
    L, (P, card) = sym.shape[0], sc.shape
    if int(sym.max()) >= card:
        raise ValueError("symbol code >= alphabet cardinality")
    out = _matrix(sym, sc)
    zero_carry = icr[:2]
    # Two buffers in turn: launch j reads the state launch j-1 wrote.
    bufs = [ssv_cuda.SweepBuffers.empty(L, 1, 1, sym.device)
            for _ in range(2)]
    state = torch.zeros(L, dtype=torch.int32, device=sym.device)
    for j in range(P):
        buf = bufs[j % 2]
        ssv_cuda.launch(sym, sc[j:j + 1], state, zero_carry, None, 0, 0, buf)
        out[j].copy_(buf.final_state)
        state = buf.final_state
    return out


def dp_matrix_kernel(symbols, scores, init_carry=None,
                     reset_rows=None) -> torch.Tensor:
    """Full state matrix from one launch of the kernel's row dump.
    ``init_carry`` (P+1,) enters at the left edge and ``reset_rows`` (P,)
    zeroes the incoming diagonal, as in ``dp_matrix_swar``."""
    sym, sc, icr, rr = _inputs(symbols, scores, init_carry, reset_rows)
    out = _matrix(sym, sc)
    ssv_cuda.ssv_sweep(sym, sc, None, icr, rr, dump=out)
    return out


def compare_matrices(expected, actual,
                     max_report: int = 16) -> List[CellMismatch]:
    """Exhaustive cell comparison; returns up to ``max_report`` mismatches
    in row-major order (empty = bit-exact equivalence). Works a band of
    rows at a time, so a card-sized comparison needs no matrix-sized
    temporaries."""
    e = torch.as_tensor(expected)
    a = torch.as_tensor(actual, device=e.device)
    if e.shape != a.shape:
        raise ValueError(f"shape mismatch {tuple(e.shape)} vs "
                         f"{tuple(a.shape)}")
    P, L = e.shape
    band = max(1, (1 << 24) // max(L, 1))
    found: List[CellMismatch] = []
    for r0 in range(0, P, band):
        ne = e[r0:r0 + band] != a[r0:r0 + band]
        if not bool(ne.any()):
            continue
        for r, c in torch.nonzero(ne)[:max_report - len(found)].tolist():
            found.append(CellMismatch(r0 + r, c, int(e[r0 + r, c]),
                                      int(a[r0 + r, c])))
        if len(found) >= max_report:
            break
    return found
