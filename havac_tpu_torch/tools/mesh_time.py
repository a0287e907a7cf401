"""Time the mesh sweep of the main workload on one card: the 50.8 Mb
chromosome against 10,020 model positions (`testing/workload.py`), on a
1-D mesh of ``--shards`` shards of ``cuda:0`` at each ``--rows`` (rows a
step), each run ``--repeat`` times after one warm run.

    python -m havac_tpu_torch.tools.mesh_time [--shards 4]
        [--rows 128 1024] [--repeat 3] [--work build/mesh_time]

Each run's sweep seconds, GCUPS, launches and host phases
(``stats.pipeline_prof``) are printed as one JSON object with the card's
name and power limit. The workload is written into ``--work`` once and
reused. It imports whichever ``havac_tpu_torch`` is first on the path, so
two trees are compared on one card by running this file with
``PYTHONPATH`` set to each in turn (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from havac_tpu_torch.engine import Havac
from havac_tpu_torch.parallel.multihost import ShardMesh
from havac_tpu_torch.testing.workload import CHR22_LENGTH, write_workload

P_VALUE = 0.02
MODEL_POSITIONS = 10020
SEED = 7


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--rows", type=int, nargs="+", default=[128, 1024])
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--work", default=os.path.join("build", "mesh_time"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("mesh_time needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    os.makedirs(args.work, exist_ok=True)
    hmm = os.path.join(args.work, "models.hmm")
    fasta = os.path.join(args.work, "db.fasta")
    if not (os.path.exists(hmm) and os.path.exists(fasta)):
        write_workload(args.work, MODEL_POSITIONS, CHR22_LENGTH, SEED)
    base = Havac(p_value=P_VALUE, device=dev).load_phmm(hmm)
    base.load_sequence(fasta)
    report = {"device": smi, "package": os.path.dirname(
        sys.modules["havac_tpu_torch"].__file__), "shards": args.shards,
              "runs": []}
    for rows in args.rows:
        for i in range(args.repeat + 1):
            e = Havac(p_value=P_VALUE, device=dev,
                      mesh=ShardMesh([dev] * args.shards),
                      dist_rows_per_step=rows)
            e.load_phmm(base.models).load_sequence(base.database).run()
            if i == 0:
                continue  # warm
            st = e.stats
            report["runs"].append({
                "rows": rows, "sweep_seconds": st.sweep_seconds,
                "gcups": st.gcups, "launches": st.num_chunks,
                "prof": st.pipeline_prof})
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
