"""The 1-D wavefront's step accounting across mesh sizes, checked by measurement.

The counterpart of `tools/scaling_mesh.py`. A D-shard wavefront over S row
chunks runs T = S + D - 1 steps and launches the sweep kernel once per
active (shard, step) pair, S * D times. For each ``--devices`` D this tool
sweeps one random workload (``--seq-len`` positions against
``--positions`` rows of hot random scores, whose diagonals do reach the
threshold) through `parallel/engine_dist.py`
(``DistributedSweep.sweep_all``, the body of ``ssv_distributed``) on
``ShardMesh([device] * D)`` in rows of ``--rows-per-step``, and checks:

- every D's hits equal D = 1's, exactly;
- the steps the sweep ran equal S + D - 1;
- its launches equal S * D: the sweep's count of launches and, on a CUDA
  device, the kernel wrapper's own (``ops/ssv_cuda.LAUNCHES``, less the
  key-buffer regrows, each one more launch); on the CPU, where no kernel
  runs, the sweep counts its calls of the plain version.

Each row reports the wall's min and median over ``--iters`` runs after a
warm one, the fill ratio T / S and its wall ratio to D = 1.
**This is not a scaling figure.** All D shards sit on one device (one
GPU, or the CPU), so they run one after another: the wall measures the
rate of a schedule (its launch count, launch shapes and host work), not
how a sweep scales over devices.

    python -m havac_tpu_torch.tools.scaling_mesh --seq-len 16777216 \\
        --positions 4096 --rows-per-step 1024 --devices 1 2 4 8
    python -m havac_tpu_torch.tools.scaling_mesh --device cpu \\
        --seq-len 65536 --positions 256 --rows-per-step 64 --devices 1 2 4
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from havac_tpu_torch import native
from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.parallel.engine_dist import DistributedSweep
from havac_tpu_torch.parallel.multihost import ShardMesh
from havac_tpu_torch.utils.provenance import provenance

NOT_SCALING = ("all shards on one device: the rate of a schedule, not a "
               "scaling figure")


def workload(seq_len: int, positions: int) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX tool's inputs: random codes and (P, 4) scores in [-11, 11),
    hot enough that diagonals cross the threshold, from seed 11."""
    rng = np.random.default_rng(11)
    symbols = rng.integers(0, 4, size=seq_len).astype(np.uint8)
    scores = rng.integers(-11, 11, size=(positions, 4)).astype(np.int8)
    return symbols, scores


def sweep(symbols, scores, device: torch.device, D: int, R: int):
    """One run: the hits, the sweep's steps, launches and regrows, and the
    wrapper's launches (0 on the CPU)."""
    before = ssv_cuda.LAUNCHES
    s = DistributedSweep(symbols, ShardMesh([device] * D), rows_per_step=R,
                         rows_per_call=scores.shape[0])
    rows, pos = s.sweep_all(scores)
    return (rows, pos, s.steps, s.launches, s.regrows,
            ssv_cuda.LAUNCHES - before)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq-len", type=int, default=1 << 18)
    ap.add_argument("--positions", type=int, default=1024)
    ap.add_argument("--rows-per-step", type=int, default=128)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda:0",
                    help="where every shard lives: cuda:N (default; raises "
                    "without CUDA) or cpu")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available on this "
                           "machine (there is no CPU fallback)")

    L, P, R = args.seq_len, args.positions, args.rows_per_step
    symbols, scores = workload(L, P)
    S = -(-P // R)  # one call covers the whole score stream
    out = {"provenance": provenance(device, native.available()),
           "seq_len": L, "positions": P, "rows_per_step": R,
           "num_strips": S, "note": NOT_SCALING, "rows": []}
    base = wall1 = None
    for D in args.devices:
        rows, pos, steps, launches, regrows, kernel = sweep(
            symbols, scores, device, D, R)  # the warm run is the checked one
        if base is None:
            base = (rows, pos)
        elif not (np.array_equal(rows, base[0])
                  and np.array_equal(pos, base[1])):
            raise AssertionError(f"D={D}: {rows.size} hits differ from "
                                 f"D=1's {base[0].size}")
        T = S + D - 1
        if steps != T or launches != S * D or (
                device.type == "cuda" and kernel != launches + regrows):
            raise AssertionError(
                f"D={D}: {steps} steps (T = S + D - 1 = {T}), {launches} "
                f"launches and {regrows} regrows, {kernel} by the kernel's "
                f"count (S * D = {S * D})")
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            sweep(symbols, scores, device, D, R)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        wall = min(times)
        if wall1 is None:
            wall1 = wall
        row = {
            "devices": D, "steps": steps, "predicted_steps": T,
            "launches": launches, "regrows": regrows,
            "kernel_launches": kernel,
            "predicted_launches": S * D,
            "wall_s": wall, "wall_median_s": sorted(times)[len(times) // 2],
            "iters": args.iters,
            "predicted_fill_ratio": T / S,
            "measured_wall_ratio": wall / wall1,
            "num_hits": int(rows.size), "note": NOT_SCALING,
        }
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
