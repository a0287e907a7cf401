"""One process of a ``torch.distributed`` mesh sweep, for tests and the chip
smoke test.

The counterpart of `tests/multihost_worker.py`: it joins a group of
``--world`` processes over a TCP rendezvous, holds ``--shards`` shards on
``--device``, stages only its own shards and writes only its own shards'
hits, to ``<out>/rank<r>.npz``. The hits of all the processes together are
the whole result. Any failure exits non-zero.

    python -m havac_tpu_torch.testing.multihost_worker --case plain \\
        --init 127.0.0.1:29500 --world 2 --rank 0 --backend gloo \\
        --device cpu --shards 2 --out DIR

Cases:

- ``plain``: :class:`SwarDistributedSweep` on random codes and scores
  (:func:`make_inputs`), rows and positions.
- ``regrow``: hits only in the first half of the database, so only the
  processes holding it outgrow their small key buffers.
- ``ckpt_diverge``: an engine run with step checkpoints aborted after its
  first checkpoint; rank 1 then deletes its file, so a second run must
  restart every process from step 0 (``resumed`` 0) and still be exact.
- ``engine``: ``Havac(mesh=...)`` on ``--hmm`` and ``--fasta``; resolved
  hits, raw hits and the run's launches.
- ``2d``: :class:`Swar2DSweep` on a (sequence x model) mesh of
  ``MODEL_PARALLEL`` model groups (:func:`sequence_model_mesh`), on the
  JAX package's ``2d`` inputs (two models, cut at ``PREFIX_2D``).
- ``engine2d``: ``Havac(mesh=<2-D>, isolate_models=True)`` on ``--hmm`` and
  ``--fasta`` with a checkpoint path under ``--out``: the hits as for
  ``engine``, whether the single-process warning was logged (``warned``)
  and whether a checkpoint file appeared (``ckpt_files``).
"""

from __future__ import annotations

import argparse
import json
import logging
import logging.handlers
import os
import sys
import time

import numpy as np
import torch.distributed as dist

from havac_tpu_torch.engine import Havac, HavacRunState
from havac_tpu_torch.engine.pipeline import FIRST_KEY_CAP
from havac_tpu_torch.ops import ssv_cuda

P_VALUE = 0.05
MODEL_PARALLEL = 2  # model groups of the 2-D cases
PREFIX_2D = (0, 33, 64)  # the 2d case's two models


class AbortAfterCheckpoint(Havac):
    """A mesh engine (1-D or 2-D) that sets its abort flag right after its
    first step checkpoint is written: a run killed between steps,
    deterministically."""

    def _abort_after(self, hooks):
        cb, resume, path = hooks

        def cb_then_abort(*payload):
            cb(*payload)
            self._abort_event.set()

        return cb_then_abort, resume, path

    def _mesh_checkpoint_hooks(self, sweep, P):
        return self._abort_after(super()._mesh_checkpoint_hooks(sweep, P))

    def _mesh2d_checkpoint_hooks(self, sweep, P):
        return self._abort_after(super()._mesh2d_checkpoint_hooks(sweep, P))


def make_inputs(case: str):
    """(codes, scores, key_cap) of the sweep cases, from a fixed seed."""
    rng = np.random.default_rng(0)
    if case == "plain":
        codes = rng.integers(0, 4, size=6001)
        scores = rng.integers(-40, 110, size=(75, 4))
        return codes.astype(np.uint8), scores.astype(np.int8), FIRST_KEY_CAP
    if case == "regrow":
        L = 4000
        codes = rng.integers(1, 4, size=L)
        codes[:L // 2] = 0
        scores = np.full((30, 4), -40)
        scores[:, 0] = 110
        return codes.astype(np.uint8), scores.astype(np.int8), 16
    if case == "2d":  # tests/multihost_worker.py make_inputs("2d", 8)
        codes = rng.integers(0, 4, size=2 * 3072 * 4)
        scores = rng.integers(-40, 110, size=(64, 4))
        return codes.astype(np.uint8), scores.astype(np.int8), FIRST_KEY_CAP
    raise ValueError(case)


def planted_fasta() -> tuple:
    """The ``ckpt_diverge`` case's models and FASTA text."""
    from havac_tpu_torch.testing.generator import generate_planted_fixture

    models, records = generate_planted_fixture(
        seed=61, model_length=40, sequence_length=30000, num_models=2)
    return models, "".join(f">{n}\n{s}\n" for n, s in records)


def _sweep(case: str, mesh, rows_per_step: int) -> dict:
    from havac_tpu_torch.parallel.swar_dist import SwarDistributedSweep
    from havac_tpu_torch.parallel.swar_dist2d import Swar2DSweep

    codes, scores, cap = make_inputs(case)
    if case == "2d":
        sweep = Swar2DSweep(codes, mesh, rows_per_step=rows_per_step,
                            key_cap=cap)
        rows, pos = sweep.run(scores, np.asarray(PREFIX_2D))
    else:
        sweep = SwarDistributedSweep(codes, mesh,
                                     rows_per_step=rows_per_step, key_cap=cap)
        rows, pos = sweep.run(scores)
    return dict(rows=rows, pos=pos, launches=sweep.launches,
                regrows=sweep.regrows, key_cap=sweep.key_cap)


def _engine2d(mesh, args) -> dict:
    """A 2-D engine run with a checkpoint path: it must warn and write no
    checkpoint in a multi-process mesh."""
    ckpt = os.path.join(args.out, "mesh2d.ckpt.npz")
    records = logging.handlers.BufferingHandler(1 << 20)
    logger = logging.getLogger("havac_tpu_torch.engine")
    logger.addHandler(records)
    try:
        engine = Havac(p_value=args.pvalue, device=args.device, mesh=mesh,
                       dist_rows_per_step=args.rows_per_step,
                       isolate_models=True, checkpoint_path=ckpt)
        engine.load_phmm(args.hmm).load_sequence(args.fasta).run()
    finally:
        logger.removeHandler(records)
    result = _hits(engine)
    result["warned"] = any("single-process only" in r.getMessage()
                           for r in records.buffer)
    result["ckpt_files"] = sorted(f for f in os.listdir(args.out)
                                  if f.startswith("mesh2d.ckpt"))
    result["steps"] = engine.stats.chunk_geometry["steps"]
    return result


def _hits(engine) -> dict:
    res = engine.hits()
    rows, pos = engine.raw_hits()
    return dict(si=res.sequence_index, sp=res.sequence_position,
                pi=res.phmm_index, pp=res.phmm_position, rows=rows, pos=pos,
                launches=engine.stats.num_chunks,
                regrows=engine.stats.overflow_retries,
                resumed=engine.resumed_chunks,
                sweep_seconds=engine.stats.sweep_seconds,
                prof=json.dumps(engine.stats.pipeline_prof))


def _ckpt_diverge(mesh, device, rank: int, out: str, rows_per_step: int
                  ) -> dict:
    models, fasta = planted_fasta()
    ckpt = os.path.join(out, "mesh.ckpt.npz")

    def make(cls):
        e = cls(p_value=P_VALUE, device=device, mesh=mesh,
                dist_rows_per_step=rows_per_step, checkpoint_path=ckpt)
        return e.load_phmm(models).load_sequence(fasta, is_text=True)

    first = make(AbortAfterCheckpoint).run_async()
    if first.wait(timeout=300) != HavacRunState.ABORTED:
        raise RuntimeError(f"first run ended {first.state}")
    mine = f"{ckpt}.p{rank}"
    if not os.path.exists(mine):
        raise RuntimeError(f"no checkpoint {mine}")
    if rank == 1:
        os.remove(mine)  # this process's checkpoint lost with it
    dist.barrier(group=mesh.group)  # every file as the second run finds it
    return _hits(make(Havac).run())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", required=True,
                    choices=("plain", "regrow", "ckpt_diverge", "engine",
                             "2d", "engine2d"))
    ap.add_argument("--init", required=True, help="host:port of the group")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", required=True)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--rows-per-step", type=int, default=30)
    ap.add_argument("--out", required=True)
    ap.add_argument("--hmm")
    ap.add_argument("--fasta")
    ap.add_argument("--pvalue", type=float, default=P_VALUE)
    args = ap.parse_args(argv)

    from havac_tpu_torch.parallel.multihost import (global_sequence_mesh,
                                                    initialize,
                                                    sequence_model_mesh)

    initialize(args.init, args.world, args.rank, backend=args.backend)
    try:
        devices = [args.device] * args.shards
        mesh = (sequence_model_mesh(MODEL_PARALLEL, devices=devices)
                if args.case in ("2d", "engine2d")
                else global_sequence_mesh(devices=devices))
        before = ssv_cuda.LAUNCHES
        t0 = time.perf_counter()
        if args.case == "ckpt_diverge":
            result = _ckpt_diverge(mesh, args.device, args.rank, args.out,
                                   args.rows_per_step)
        elif args.case == "engine2d":
            result = _engine2d(mesh, args)
        elif args.case == "engine":
            engine = Havac(p_value=args.pvalue, device=args.device,
                           mesh=mesh, dist_rows_per_step=args.rows_per_step)
            engine.load_phmm(args.hmm).load_sequence(args.fasta).run()
            result = _hits(engine)
        else:
            result = _sweep(args.case, mesh, args.rows_per_step)
        result["seconds"] = time.perf_counter() - t0
        # The kernel wrapper's own count (CUDA launches only).
        result["kernel_launches"] = ssv_cuda.LAUNCHES - before
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **result)
        print(f"rank {args.rank}: {result['rows'].size} hits, "
              f"{result['launches']} launches, {result['regrows']} regrows, "
              f"{result['seconds']:.3f} s", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
