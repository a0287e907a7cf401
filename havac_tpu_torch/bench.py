"""Headline benchmark of the port: the SSV sweep kernel's GCUPS on one GPU.

    python -m havac_tpu_torch.bench [--device cuda|cpu]

The counterpart of the root `bench.py`. It times the sweep kernel
(``havac_tpu_torch/csrc/ssv_sweep.cu``) device-only at the JAX system's
headline shape, L = 387,072 x 22 = 8,515,584 DNA positions against P =
4,080 model rows (random codes and sparse scores from
``np.random.default_rng(0)``, drawn as the root bench draws them), with
its inputs on the card: 9 against 1 dispatches chained through the row
state, timed differentially by CUDA events (``tools/kbench.py``
``bench_point`` through ``tools/roofline.py`` ``time_differential``, the
port's one timing loop). ``value`` is L x P over the seconds a dispatch
from the fastest of 5 chains of each length; ``gcups_median`` the same
from the median chains. ``kernel_ms`` is one
launch alone, beside its bound (the larger of the bytes over the memory
rate and the work's instructions at the card's issue peak) and the share
of it. ``vs_baseline`` compares with the Alveo U50 FPGA's published 1,739
GCUPS (`BASELINE.md`): the reference system's rate, not a target.

Prints ONE JSON line. ``device`` names the card and its power limit
(``nvidia-smi``). The port has no A/B knobs, so the root bench's
``knobs`` field has no counterpart. ``--device`` defaults to ``cuda`` and
raises where CUDA is missing; there is no fallback. ``--device cpu`` runs
the plain PyTorch version at L = 2^18, P = 256 on a host clock (the tests
use it), whose numbers are the CPU's, not a device's.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from havac_tpu_torch import native
from havac_tpu_torch.tools import kbench
from havac_tpu_torch.utils.provenance import provenance

BASELINE_GCUPS = 1739.0  # the Alveo U50 FPGA's published rate (BASELINE.md)
BASELINE = "Alveo U50 FPGA (the reference), 1,739 GCUPS published"
WIDTH, BLOCKS = 387_072, 22  # the JAX SWAR kernel's block width and blocks
CARD_SHAPE = (WIDTH * BLOCKS, 4_080)  # (L, P) on the card
CPU_SHAPE = (1 << 18, 256)  # (L, P) with --device cpu
ITERS = 5


def inputs(L: int, P: int) -> tuple:
    """The root bench's draw: codes (L,) uint8 in [0, 4) and scores (P, 4)
    int8 in [-40, 12). The TPU kernel takes ``scores + 256`` as biased
    int32 strips; the port's kernel takes the int8 scores themselves, which
    is the same recurrence."""
    rng = np.random.default_rng(0)
    symbols = rng.integers(0, 4, size=L).astype(np.int8)
    scores = rng.integers(-40, 12, size=(P, 4)).astype(np.int8)
    return symbols.astype(np.uint8), scores


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available on this "
                           "machine (there is no CPU fallback)")
    L, P = CARD_SHAPE if device.type == "cuda" else CPU_SHAPE
    p = kbench.bench_point(*inputs(L, P), iters=ITERS, device=device)
    stamp = provenance(device, native.available())
    print(json.dumps({
        "metric": "ssv_sweep_throughput",
        "value": p["gcups"],
        "unit": "GCUPS",
        "vs_baseline": p["gcups"] / BASELINE_GCUPS,
        "baseline": BASELINE,
        "gcups_median": p["gcups_median"],
        "iters": ITERS,
        "native_active": stamp["native_active"],
        "device": {"type": stamp["device"],
                   "name": stamp.get("device_name", "cpu"),
                   "nvidia_smi": stamp.get("nvidia_smi")},
        "kernel_ms": p["kernel_ms"],
        "bound_ms": p["bound_ms"],
        "bound_by": p["bound_by"],
        "bound_share": p["bound_share"],
        "sec_per_dispatch": p["sec_per_dispatch"],
        "hits": p["hits"],
        "L": L,
        "P": P,
        "threads": p["threads"],
        "launches": p["launches"],
        "route": p["route"],
        "torch": stamp["torch"],
        "cuda": stamp["cuda"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
