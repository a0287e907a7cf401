"""Time the sweep kernel at one chunk shape, once for each of its
instantiations on the main path's geometry: card 4, card 4 with reset rows
and card 20 (the table match).

    python -m havac_tpu_torch.tools.chunk_time [--positions 16777216]
        [--rows 5010] [--reps 5] [--seed 7]

Random codes and scores (int8 in [-30, 20), few hits) made from ``--seed``,
reset rows at 1 % of the rows; each time is the mean of ``--reps`` launches
between two CUDA events after one warm launch. It imports whichever
``havac_tpu_torch`` is first on the path, so two trees are compared on one
card by running it with ``PYTHONPATH`` set to each in turn. Prints one JSON
object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from havac_tpu_torch.ops import ssv_cuda


def chunk_ms(L: int, P: int, card: int, reset: bool, reps: int, seed: int,
             dev) -> float:
    rng = np.random.default_rng(seed)
    sym = torch.from_numpy(rng.integers(0, card, L).astype(np.uint8)).to(dev)
    sc = torch.from_numpy(rng.integers(-30, 20, (P, card)).astype(np.int8)
                          ).to(dev)
    rr = (torch.from_numpy((rng.random(P) < 0.01).astype(np.int32)).to(dev)
          if reset else None)
    ist = torch.zeros(L, dtype=torch.int32, device=dev)
    icr = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    out = ssv_cuda.SweepBuffers.empty(L, P, 1 << 20, dev)

    def go():
        ssv_cuda.launch(sym, sc, ist, icr, rr, 0, 0, out)

    go()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    e0.record()
    for _ in range(reps):
        go()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--positions", type=int, default=16_777_216)
    ap.add_argument("--rows", type=int, default=5_010)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chunk_time needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    report = {"device": smi, "package": ssv_cuda.__file__,
              "positions": args.positions, "rows": args.rows}
    for tag, card, reset in (("card4", 4, False), ("card4_reset", 4, True),
                             ("card20", 20, False)):
        report[f"{tag}_ms"] = chunk_ms(args.positions, args.rows, card, reset,
                                       args.reps, args.seed, dev)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
