"""The control of ``correct``: the plain reference put in the program's
place, computed a precision lower than the configuration states (the
projection's float32 steps in bfloat16), and judged as a run judges the
program, at the cell's own size and sample. It must come out not correct.

    python -m ssvbench.control --workload rfam150k.chr22-genomic \\
        --seeds 11 22 33

One JSON line a seed: the control's readings of every compared number
(``score_rows_differing``, ``hits_missing``, ``hits_extra``) and the
reference's seconds. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from ssvbench import check, workload
from ssvbench.reference import ssv


PRECISION = "bfloat16"


def control_readings(cell, seed: int, device, tmp: str) -> dict:
    """The control's readings on the cell's inputs and sample for
    ``seed``: the reference in :data:`PRECISION` judged as the program
    is."""
    inputs = workload.make_inputs(cell.config, cell.traffic, seed, tmp)
    sizes = [f.residues + len(f.names) for f in inputs.files]
    pl = check.plan(seed, sizes, cell.traffic["sample"])
    paths = {f: inputs.files[f].path for f in pl.files}
    p = cell.config["search"]["p_value"]
    isolate = cell.config["search"].get("isolate_models", False)
    coll = ssv.read_hmm(inputs.hmm_path)
    low = ssv.project(coll, p, PRECISION)
    got, _ = check.reference_answers(pl, paths, coll, low, device, isolate)
    t = time.perf_counter()
    verdict = check.judge({f: tuple(a.T) for f, a in got.items()}, low,
                          inputs.hmm_path, paths, pl, p, 0, device,
                          isolate=isolate)
    return dict(verdict["readings"], seed=seed, precision=PRECISION,
                correct=verdict["ok"],
                reference_hits=verdict["sample"]["reference_hits"],
                reference_s=time.perf_counter() - t)


def main(argv=None) -> int:
    from ssvbench.run import load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in args.seeds:
        tmp = tempfile.mkdtemp(prefix="ssvbench-control-")
        try:
            row = control_readings(cell, seed, "cuda", tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        row["workload"] = args.workload
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
