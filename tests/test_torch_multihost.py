"""The port's mesh sweeps across real processes: ``torch.distributed`` with
the gloo backend on the CPU, 2 processes x 2 shards and 4 x 1, through
`havac_tpu_torch/testing/multihost_worker.py`: the 1-D wavefront, and the
2-D (sequence x model) sweep with 2 model groups, whose seams cross
processes (at 4 x 1, from process 0 to 2 and from 1 to 3).

Each process stages and reports only its own shards; the processes' hits
together must equal the one-process port and `ops/reference.py` exactly.
Every process runs under a timeout, so a deadlock fails the test.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from havac_tpu.ops.reference import ssv_reference
from havac_tpu_torch import native
from havac_tpu_torch.engine import Havac
from havac_tpu_torch.parallel.multihost import ShardMesh
from havac_tpu_torch.parallel.swar_dist import SwarDistributedSweep
from havac_tpu_torch.testing.multihost_worker import (MODEL_PARALLEL,
                                                      P_VALUE, PREFIX_2D,
                                                      make_inputs,
                                                      planted_fasta)
from multihost_worker import make_inputs as jax_make_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cluster(tmp_path, case, world, shards, *extra):
    native.build()  # before the workers, which would each race to build it
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    # One intra-op thread a process: several processes' thread pools on the
    # same cores, each blocking in gloo every step, run the CPU sweep ~60x
    # slower than one process.
    env["OMP_NUM_THREADS"] = "1"
    init = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "havac_tpu_torch.testing.multihost_worker",
         "--case", case, "--init", init, "--world", str(world), "--rank",
         str(r), "--backend", "gloo", "--device", "cpu", "--shards",
         str(shards), "--out", str(tmp_path), *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def merged(ranks, *fields):
    cols = [np.concatenate([z[f] for z in ranks]) for f in fields]
    order = np.lexsort(cols[::-1])
    return [c[order] for c in cols]


@pytest.mark.parametrize("world,shards", [(2, 2), (4, 1)])
def test_plain_matches_one_process_and_reference(tmp_path, world, shards):
    ranks = run_cluster(tmp_path, "plain", world, shards)
    rows, pos = merged(ranks, "rows", "pos")
    codes, scores, _ = make_inputs("plain")
    want, _ = ssv_reference(codes, scores)
    assert want.hit_rows.size > 0
    np.testing.assert_array_equal(rows, want.hit_rows)
    np.testing.assert_array_equal(pos, want.hit_positions)
    one = SwarDistributedSweep(codes, ShardMesh(["cpu"] * (world * shards)),
                               rows_per_step=30).run(scores)
    np.testing.assert_array_equal(rows, one[0])
    np.testing.assert_array_equal(pos, one[1])
    assert [int(z["launches"]) for z in ranks] == [3 * shards] * world
    # Each process reports only its own shards' positions.
    W = -(-codes.shape[0] // (world * shards))
    for r, z in enumerate(ranks):
        lo = r * shards * W
        assert ((z["pos"] >= lo) & (z["pos"] < lo + shards * W)).all()


@pytest.mark.parametrize("world,shards", [(2, 2), (4, 1)])
def test_one_process_regrows_alone_without_a_hang(tmp_path, world, shards):
    ranks = run_cluster(tmp_path, "regrow", world, shards)
    rows, pos = merged(ranks, "rows", "pos")
    codes, scores, _ = make_inputs("regrow")
    want, _ = ssv_reference(codes, scores)
    assert want.hit_rows.size > 1000  # hit-dense
    np.testing.assert_array_equal(rows, want.hit_rows)
    np.testing.assert_array_equal(pos, want.hit_positions)
    regrows = [int(z["regrows"]) for z in ranks]
    assert regrows[0] > 0 and regrows[-1] == 0


def test_divergent_checkpoints_restart_every_process(tmp_path):
    """Rank 1's checkpoint is gone: the all-gather of next steps sees the
    disagreement and both processes restart from step 0, exactly."""
    ranks = run_cluster(tmp_path, "ckpt_diverge", 2, 2)
    assert [int(z["resumed"]) for z in ranks] == [0, 0]
    got = merged(ranks, "si", "sp", "pi", "pp")
    models, fasta = planted_fasta()
    single = Havac(p_value=P_VALUE, device="cpu")
    want = single.load_phmm(models).load_sequence(fasta, is_text=True).run()
    want = want.hits()
    assert len(want) > 0
    order = np.lexsort((want.phmm_position, want.phmm_index,
                        want.sequence_position, want.sequence_index))
    for g, f in zip(got, ("sequence_index", "sequence_position",
                          "phmm_index", "phmm_position")):
        np.testing.assert_array_equal(g, getattr(want, f)[order])


@pytest.mark.parametrize("world,shards", [(2, 2), (4, 1)])
def test_2d_matches_the_jax_inputs_oracle(tmp_path, world, shards):
    """The JAX package's two-process 2-D case (tests/test_multihost.py) on
    the port: the processes' hits together equal the isolated oracle of the
    same inputs."""
    ranks = run_cluster(tmp_path, "2d", world, shards)
    rows, pos = merged(ranks, "rows", "pos")
    codes, scores, _ = make_inputs("2d")
    jax_codes, jax_scores = jax_make_inputs("2d", 8)
    np.testing.assert_array_equal(codes, jax_codes)
    np.testing.assert_array_equal(scores, jax_scores)
    reset = np.zeros(64, dtype=bool)
    reset[list(PREFIX_2D[:-1])] = True
    want, _ = ssv_reference(codes, scores, reset_rows=reset)
    assert want.hit_rows.size > 0
    np.testing.assert_array_equal(rows, want.hit_rows)
    np.testing.assert_array_equal(pos, want.hit_positions)
    # Each group (33 and 31 rows) is 2 row chunks of 30 on each of its
    # D_seq seq shards.
    d_seq = world * shards // MODEL_PARALLEL
    assert sum(int(z["launches"]) for z in ranks) == 2 * 2 * d_seq


def test_2d_engine_across_processes_warns_and_writes_no_checkpoint(tmp_path):
    """Two processes, each one seq shard of both model groups: the engine's
    2-D run with a checkpoint path logs the single-process warning, writes
    no checkpoint, and the hits together equal a one-process isolated
    run."""
    models, fasta = planted_fasta()
    from havac_tpu_torch.io.hmm import write_hmm

    hmm, fa = tmp_path / "m.hmm", tmp_path / "db.fasta"
    write_hmm(models, str(hmm))
    fa.write_text(fasta)
    ranks = run_cluster(tmp_path, "engine2d", 2, 2, "--hmm", str(hmm),
                        "--fasta", str(fa))
    assert [bool(z["warned"]) for z in ranks] == [True, True]
    assert [z["ckpt_files"].size for z in ranks] == [0, 0]
    assert not [f for f in os.listdir(tmp_path) if "ckpt" in f]
    single = Havac(p_value=P_VALUE, device="cpu", isolate_models=True)
    want = single.load_phmm(str(hmm)).load_sequence(str(fa)).run()
    rows, pos = merged(ranks, "rows", "pos")
    want_rows, want_pos = want.raw_hits()
    assert want_rows.size > 0
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(pos, want_pos)
