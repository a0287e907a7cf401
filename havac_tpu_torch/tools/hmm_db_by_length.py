"""Cut a .hmm collection into cumulative-length databases.

The counterpart of `tools/hmm_db_by_length.py` (the reference's benchmark
database generator, `benchmark/hmmDbByLength.py`): the collection's models
are taken in file order, and each requested size gets the shortest prefix
whose model positions reach it, written as ``db_<size>.hmm`` through the
port's own `io.hmm` reader and writer. These databases are
`runtime_table.py`'s ``--hmm`` inputs.

    python -m havac_tpu_torch.tools.hmm_db_by_length Rfam.hmm outdir \\
        --lengths 1000 5000 10000
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from havac_tpu_torch.io.hmm import read_hmm, write_hmm


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("hmm", help="input .hmm collection")
    ap.add_argument("outdir")
    ap.add_argument("--lengths", type=int, nargs="+",
                    default=[1000, 5000, 10000, 20000, 30000, 40000, 50000,
                             60000, 70000, 80000, 90000, 100000, 150000])
    args = ap.parse_args(argv)

    models = read_hmm(args.hmm)
    os.makedirs(args.outdir, exist_ok=True)
    cum = 0
    cut_points = sorted(args.lengths)
    selected = []
    ci = 0
    for m in models:
        cum += m.model_length
        selected.append(m)
        while ci < len(cut_points) and cum >= cut_points[ci]:
            out = os.path.join(args.outdir, f"db_{cut_points[ci]}.hmm")
            write_hmm(selected, out)
            print(f"{out}: {len(selected)} models, {cum} positions")
            ci += 1
    if ci < len(cut_points):
        print(f"collection exhausted at {cum} positions; "
              f"{len(cut_points) - ci} requested sizes unreachable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
