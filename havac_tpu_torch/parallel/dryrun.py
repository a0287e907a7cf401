"""A dry run of the mesh sweeps: tiny inputs, hits checked against the oracle.

The counterpart of `__graft_entry__.py` ``dryrun_multichip``: the 1-D
wavefront over ``n_shards`` shards, and, when ``n_shards`` is even and at
least 4, the 2-D sweep on an ``(n_shards / 2, 2)`` (sequence x model) mesh
under model isolation, each held exactly to `ops/reference.py`. Every shard
lies on ``device`` (the kernel on a CUDA device, its plain version on the
CPU). The JAX dry run also runs its XLA wavefront; the port keeps no XLA
path, so this one checks the kernel paths only.

    python -c "from havac_tpu_torch.parallel.dryrun import dryrun_multichip; \\
               print(dryrun_multichip(8, 'cpu'))"
"""

from __future__ import annotations

import numpy as np

from havac_tpu_torch.ops.reference import ssv_reference
from havac_tpu_torch.parallel.multihost import (global_sequence_mesh,
                                                sequence_model_mesh)
from havac_tpu_torch.parallel.swar_dist import SwarDistributedSweep
from havac_tpu_torch.parallel.swar_dist2d import Swar2DSweep

ROWS = 30  # one row chunk of 30 rows: two models of 15 on the 2-D mesh
PREFIX = (0, 15, 30)


def _check(tag: str, got, codes, scores, reset=None) -> int:
    want, _ = ssv_reference(codes, scores, reset_rows=reset)
    if want.hit_rows.size == 0:
        raise AssertionError(f"{tag}: the dry-run workload has no hits")
    if not (np.array_equal(got[0], want.hit_rows)
            and np.array_equal(got[1], want.hit_positions)):
        raise AssertionError(f"{tag} hits diverge from ssv_reference: "
                             f"{got[0].size} vs {want.hit_rows.size}")
    return int(want.hit_rows.size)


def dryrun_multichip(n_shards: int, device) -> dict:
    """Run both checks; raises AssertionError on any difference from the
    oracle. Returns the meshes' shapes and the hits each found."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=3072 * n_shards).astype(np.uint8)
    scores = rng.integers(-40, 40, size=(ROWS, 4)).astype(np.int8)
    devices = [device] * n_shards

    mesh = global_sequence_mesh(devices=devices)
    hits = SwarDistributedSweep(codes, mesh, rows_per_step=ROWS).run(scores)
    out = {"1d": {"shape": dict(mesh.shape),
                  "hits": _check("1-D wavefront", hits, codes, scores)}}

    if n_shards >= 4 and n_shards % 2 == 0:
        mesh2 = sequence_model_mesh(2, devices=devices)
        prefix = np.asarray(PREFIX, dtype=np.int64)
        reset = np.zeros(ROWS, dtype=bool)
        reset[prefix[:-1]] = True
        hits = Swar2DSweep(codes, mesh2, rows_per_step=ROWS).run(scores,
                                                                 prefix)
        out["2d"] = {"shape": dict(mesh2.shape),
                     "hits": _check("2-D sweep", hits, codes, scores, reset)}
    return out
