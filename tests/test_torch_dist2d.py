"""The port's 2-D (sequence x model) mesh (`havac_tpu_torch/parallel/
swar_dist2d.py`, `sequence_model_mesh`, the engine's 2-D branch and its
checkpoints, the dry run) on the CPU, in one process, against the JAX
package's 2-D sweep and engine on the 8 virtual CPU devices of
`conftest.py`, the port's single-device path and `ops/reference.py`.

The port's shards are CPU devices of one process
(``sequence_model_mesh(d_model, devices=["cpu"] * n)``). Hits must be
identical: every row and position, and every resolved column in order.
"""

import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from havac_tpu.engine import Havac as JaxHavac
from havac_tpu.io.fasta import load_fasta_database
from havac_tpu.io.hmm import model_length_prefix_sums
from havac_tpu.ops.common import SsvKernelConfig
from havac_tpu.ops.reference import ssv_reference
from havac_tpu.parallel.swar_dist2d import Swar2DSweep as JaxSwar2DSweep
from havac_tpu.parallel.swar_dist2d import \
    partition_models as jax_partition_models
from havac_tpu.scoring.reprojection import project_models
from havac_tpu.testing.generator import generate_planted_fixture
from havac_tpu_torch.convert import database_from_reference as port_db
from havac_tpu_torch.convert import profile_hmms_from_reference as port_models
from havac_tpu_torch.engine import (Havac, HavacRunState, HavacUsageError,
                                    pipeline)
from havac_tpu_torch.parallel import multihost
from havac_tpu_torch.parallel.dryrun import dryrun_multichip
from havac_tpu_torch.parallel.multihost import (ShardMesh,
                                                sequence_model_mesh)
from havac_tpu_torch.parallel.swar_dist import SwarDistributedSweep
from havac_tpu_torch.parallel.swar_dist2d import (Swar2DSweep,
                                                  partition_models)
from havac_tpu_torch.testing.multihost_worker import AbortAfterCheckpoint

P_VALUE = 0.05
FIELDS = ("sequence_index", "sequence_position", "phmm_index",
          "phmm_position", "strand")
GRIDS = [(4, 2), (2, 4)]


def jax_mesh2d(d_seq, d_model):
    devs = np.array(jax.devices()[:d_seq * d_model]).reshape(d_seq, d_model)
    return Mesh(devs, ("seq", "model"))


def cpu_mesh2d(d_seq, d_model):
    return sequence_model_mesh(d_model, devices=["cpu"] * (d_seq * d_model))


def isolation(prefix, P):
    reset = np.zeros(P, dtype=bool)
    reset[np.asarray(prefix)[:-1]] = True
    return reset


def oracle(codes, scores, reset):
    res, _ = ssv_reference(codes, scores, reset_rows=reset)
    return res.hit_rows, res.hit_positions


def assert_hits(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


class _AbortAfter:
    """threading.Event stand-in that trips after n is_set() polls."""

    def __init__(self, n):
        self.n = n
        self.calls = 0

    def is_set(self):
        self.calls += 1
        return self.calls > self.n


# --------------------------------------------------------------- the mesh


@pytest.mark.parametrize("case", ["random", "more_groups_than_models",
                                  "one_large_model"])
def test_partition_models_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "random":
        prefixes = [np.concatenate([[0], np.cumsum(rng.integers(1, 500, n))])
                    for n in (1, 2, 7, 20, 79)]
    elif case == "more_groups_than_models":
        prefixes = [np.array([0, 10, 20]), np.array([0, 32])]
    else:
        prefixes = [np.array([0, 5, 1000, 1010, 1020]),
                    np.array([0, 990, 1000, 1010])]
    for prefix in prefixes:
        for groups in range(1, 9):
            bounds = partition_models(prefix, groups)
            assert bounds == jax_partition_models(prefix, groups)
            assert len(bounds) == groups + 1 and bounds == sorted(bounds)
    if case == "more_groups_than_models":
        assert partition_models(np.array([0, 32]), 2) == [0, 1, 1]


def test_sequence_model_mesh_layout():
    mesh = cpu_mesh2d(4, 2)
    assert mesh.shape == {"seq": 4, "model": 2}
    assert mesh.axis_names == ("seq", "model")
    assert repr(mesh).startswith("ShardMesh(seq=4, model=2, rank 0/1")
    assert [mesh.coords(f) for f in (0, 1, 2, 7)] == [(0, 0), (0, 1), (1, 0),
                                                       (3, 1)]
    assert mesh.flat(3, 1) == 7 and mesh.owner(3, 1) == 0
    assert mesh.local_shards(1) == range(0, 4) == mesh.seq_shards()
    one_d = ShardMesh(["cpu"] * 3)
    assert repr(one_d).startswith("ShardMesh(seq=3, rank 0/1")
    assert one_d.local_shards() == range(0, 3) and one_d.coords(2) == (2, 0)
    with pytest.raises(ValueError, match="divisible"):
        sequence_model_mesh(3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="model_axis"):
        ShardMesh(["cpu"] * 4, model_parallel=2)
    codes = np.zeros(100, np.uint8)
    with pytest.raises(ValueError, match="Swar2DSweep"):
        SwarDistributedSweep(codes, mesh)
    with pytest.raises(ValueError, match="model axis"):
        Swar2DSweep(codes, one_d)


@pytest.mark.parametrize("world,per,d_model", [(4, 1, 2), (2, 2, 2),
                                               (2, 3, 2), (3, 2, 3),
                                               (2, 4, 4)])
def test_each_process_holds_a_contiguous_run_of_the_seq_major_grid(
        monkeypatch, world, per, d_model):
    """Every process's shards of a group are a contiguous run of seq
    shards, and ``owner`` names the process JAX's layout gives each shard
    (the flat grid reshaped to (-1, d_model), a contiguous run of it a
    process)."""
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda g: world)
    for rank in range(world):
        monkeypatch.setattr(multihost.dist, "get_rank", lambda g: rank)
        mesh = ShardMesh(["cpu"] * per, group=object(), model_axis="model",
                         model_parallel=d_model)
        grid = np.arange(world * per).reshape(-1, d_model)
        assert mesh.shape == {"seq": grid.shape[0], "model": d_model}
        mine = [divmod(f, d_model) for f in range(rank * per,
                                                  (rank + 1) * per)]
        for m in range(d_model):
            ks = [k for k, mm in mine if mm == m]
            assert list(mesh.local_shards(m)) == ks
        assert list(mesh.seq_shards()) == sorted({k for k, _ in mine})
        for k in range(grid.shape[0]):
            for m in range(d_model):
                assert mesh.owner(k, m) == grid[k, m] // per


# -------------------------------------------------------------- the sweep


@pytest.fixture(scope="module")
def planted2d():
    """tests/test_swar_dist2d.py's planted fixture and isolated oracle."""
    models, records = generate_planted_fixture(
        seed=101, model_length=32, sequence_length=9000, num_models=5)
    db = load_fasta_database(
        "".join(f">{n}\n{s}\n" for n, s in records), is_text=True)
    scores = project_models(models, P_VALUE)
    prefix = model_length_prefix_sums(models)
    want = oracle(db.codes, scores, isolation(prefix, scores.shape[0]))
    assert want[0].size > 0
    return db.codes, scores, prefix, want


@pytest.mark.parametrize("d_seq,d_model", GRIDS)
def test_sweep_matches_jax_and_the_oracle(planted2d, d_seq, d_model):
    codes, scores, prefix, want = planted2d
    ref = JaxSwar2DSweep(codes, jax_mesh2d(d_seq, d_model), block_width=3072,
                         rows_per_step=30, interpret=True).run(scores, prefix)
    assert_hits(ref, want)
    sweep = Swar2DSweep(codes, cpu_mesh2d(d_seq, d_model), rows_per_step=30)
    assert_hits(sweep.run(scores, prefix), ref)
    assert sweep.bounds == jax_partition_models(prefix, d_model)
    S = [g[2] for g in sweep.groups]
    assert sweep.T == max(S) + d_seq - 1 == sweep.steps
    assert sweep.launches == sum(S) * d_seq
    rows = [g[1] for g in sweep.groups]
    assert sum(rows) == scores.shape[0] and sweep.D_seq == d_seq


@pytest.mark.parametrize("d_seq,d_model,r", [(4, 2, 7), (2, 4, 47),
                                             (3, 2, 1), (1, 2, 1000)])
def test_rows_per_step_not_a_multiple_of_30(planted2d, d_seq, d_model, r):
    codes, scores, prefix, want = planted2d
    sweep = Swar2DSweep(codes, cpu_mesh2d(d_seq, d_model), rows_per_step=r)
    assert_hits(sweep.run(scores, prefix), want)


def test_an_empty_group_idles(planted2d):
    """One model on two model groups: the second group holds no rows and
    takes no launches, yet steps with the first."""
    codes, scores, prefix, _ = planted2d
    one = scores[:prefix[1]]
    pre = prefix[:2]
    want = oracle(codes, one, isolation(pre, one.shape[0]))
    assert want[0].size > 0
    ref = JaxSwar2DSweep(codes, jax_mesh2d(4, 2), block_width=3072,
                         rows_per_step=30, interpret=True).run(one, pre)
    assert_hits(ref, want)
    sweep = Swar2DSweep(codes, cpu_mesh2d(4, 2), rows_per_step=30)
    assert_hits(sweep.run(one, pre), ref)
    assert sweep.bounds == [0, 1, 1]
    assert sweep.groups == [(0, 32, 2), (32, 0, 0)]
    assert sweep.launches == 2 * 4 and sweep.steps == sweep.T == 2 + 4 - 1


@pytest.fixture(scope="module")
def random_case():
    """tests/test_swar_dist2d.py's step/abort case: two models of 33 and 31
    rows."""
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, size=2 * 3072 * 4).astype(np.uint8)
    scores = rng.integers(-40, 110, size=(64, 4)).astype(np.int8)
    prefix = np.array([0, 33, 64], dtype=np.int64)
    return codes, scores, prefix, oracle(codes, scores, isolation(prefix, 64))


def test_abort_between_steps_and_the_sweep_stays_usable(random_case):
    codes, scores, prefix, want = random_case
    sweep = Swar2DSweep(codes, cpu_mesh2d(4, 2), rows_per_step=30)
    ev = _AbortAfter(1)
    assert sweep.run(scores, prefix, abort_event=ev) is None
    assert ev.calls == 2 and sweep.steps == 1  # tripped before step 1
    assert sweep.launches == 2  # shard 0 of both groups
    assert_hits(sweep.run(scores, prefix), want)


@pytest.mark.parametrize("prefix,grid,groups,T", [
    ((0, 50, 64), (3, 2), [(0, 50, 5), (50, 14, 2)], 5 + 3 - 1),
    ((0, 10, 20, 64), (2, 4), [(0, 20, 2), (20, 44, 5), (64, 0, 0),
                               (64, 0, 0)], 5 + 2 - 1)])
def test_progress_steps_to_the_common_t(random_case, prefix, grid, groups, T):
    """Groups with unequal row chunks at R = 10 (the first group the
    longest, or a later one, with two empty groups): one T for all."""
    codes, scores, _, _ = random_case
    prefix = np.asarray(prefix, dtype=np.int64)
    sweep = Swar2DSweep(codes, cpu_mesh2d(*grid), rows_per_step=10)
    seen = []
    got = sweep.run(scores, prefix, progress=lambda *a: seen.append(a))
    assert_hits(got, oracle(codes, scores, isolation(prefix, 64)))
    assert sweep.groups == groups
    assert seen == [(t, T) for t in range(1, T + 1)]
    assert sweep.launches == sum(g[2] for g in groups) * grid[0]


def test_reset_rows_given_still_reset_each_group_start(random_case):
    """A caller's reset rows that do not isolate the models: the JAX sweep
    still resets each group's first row, and so does the port."""
    codes, scores, prefix, _ = random_case
    reset = np.zeros(64, dtype=bool)
    reset[10] = True
    want = JaxSwar2DSweep(codes, jax_mesh2d(4, 2), block_width=3072,
                          rows_per_step=30, interpret=True
                          ).run(scores, prefix, reset_rows=reset)
    both = reset.copy()
    both[33] = True
    assert_hits(want, oracle(codes, scores, both))
    got = Swar2DSweep(codes, cpu_mesh2d(4, 2), rows_per_step=30
                      ).run(scores, prefix, reset_rows=reset)
    assert_hits(got, want)
    assert not reset[33]  # the caller's array is left as it was


def test_checkpoint_then_resume_equals_a_run_without_a_break(random_case):
    codes, scores, prefix, want = random_case
    sweep = Swar2DSweep(codes, cpu_mesh2d(2, 2), rows_per_step=9)
    saved = []
    ev = _AbortAfter(10**9)

    def cb(*payload):
        saved.append(payload)
        ev.n = 0  # abort at the next step

    assert sweep.run(scores, prefix, abort_event=ev, checkpoint_cb=cb,
                     ckpt_every=3) is None
    t_next, istate, seams, rows, pos = saved[0]
    W = sweep.shard_width
    assert t_next == 3 and istate.shape == (2, 2, W)
    assert seams.shape == (2, 2, 10) and rows.size > 0
    fresh = Swar2DSweep(codes, cpu_mesh2d(2, 2), rows_per_step=9)
    assert_hits(fresh.run(scores, prefix,
                          resume=(t_next, istate, seams, rows, pos)), want)
    # Groups of 33 and 31 rows, S = 4 each, on 2 seq shards: 16 launches,
    # of which steps 0-2 made 2 + 2 + 2 a group.
    assert fresh.launches == 16 - 10


# ------------------------------------------------------------- the engine


@pytest.fixture(scope="module")
def engine_case():
    """tests/test_engine_dist.py's 2-D engine fixture."""
    models, records = generate_planted_fixture(
        seed=53, model_length=30, sequence_length=20000, num_models=4)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    db = load_fasta_database(fasta, pad_multiple=3072, is_text=True)
    return models, fasta, db


def port_engine(mesh=None, **kw):
    kw.setdefault("pad_multiple", 3072)
    return Havac(p_value=P_VALUE, device="cpu", mesh=mesh, **kw)


def assert_same_run(ours, ref, raw=True):
    a, b = ours.hits(), ref.hits()
    assert len(a) == len(b) > 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    if raw:
        for x, y in zip(ours.raw_hits(), ref.raw_hits()):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("strand", ["forward", "both"])
def test_engine_2d_matches_the_jax_engine(engine_case, strand):
    models, fasta, db = engine_case
    text = strand == "both"
    src = fasta if text else db
    cfg = SsvKernelConfig.swar(block_width=3072, interpret=True)
    ref = JaxHavac(p_value=P_VALUE, backend="pallas_interpret", config=cfg,
                   mesh=jax_mesh2d(4, 2), isolate_models=True, strand=strand)
    ref.load_phmm(models).load_sequence(src, is_text=text).run()
    pm = port_models(models)
    src = fasta if text else port_db(db)
    ours = port_engine(cpu_mesh2d(4, 2), dist_rows_per_step=50,
                       isolate_models=True, strand=strand, verify_hits=True)
    ours.load_phmm(pm).load_sequence(src, is_text=text).run()
    assert ours.state == HavacRunState.COMPLETED
    single = port_engine(isolate_models=True, strand=strand)
    single.load_phmm(pm).load_sequence(src, is_text=text).run()
    assert_same_run(ours, ref, raw=not text)
    assert_same_run(ours, single)
    assert ours.verification.all_verified
    geo = ours.stats.chunk_geometry
    assert (geo["shards"], geo["model_groups"]) == (4, 2)
    assert geo["group_bounds"] == [0, 2, 4]
    assert geo["group_row_chunks"] == [2, 2]  # 60 rows a group, R = 50
    assert geo["row_chunks"] == 2 and geo["steps"] == 2 + 4 - 1
    assert geo["launches"] == ours.stats.num_chunks == 2 * 2 * 4
    assert ours.stats.cells == ours.database.padded_length * 120
    assert ours.progress == 1.0
    assert set(ours.stats.pipeline_prof) == {
        "dispatch", "sync", "ready_wait", "fetch", "regrow", "sort", "resolve",
        "seam", "resolve_wait", "tail", "tail_merge", "tail_gather",
        "tail_segments", "launches", "reset_windows", "launched_ahead"}
    assert ours.stats.pipeline_prof["tail_segments"] > 0
    assert ours.stats.pipeline_prof["launches"] == geo["launches"]


def test_engine_2d_refuses_a_run_without_isolation(engine_case):
    models, _, db = engine_case
    bad = port_engine(cpu_mesh2d(4, 2))
    bad.load_phmm(port_models(models)).load_sequence(port_db(db))
    with pytest.raises(HavacUsageError, match="isolate_models"):
        bad.run()
    assert bad.state == HavacRunState.ERROR


@pytest.fixture(scope="module")
def planted():
    """tests/test_torch_dist.py's planted fixture: 3 models of 64 rows, cut
    into groups of 128 and 64 rows."""
    models, records = generate_planted_fixture(
        seed=43, model_length=64, sequence_length=6000, num_models=3)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    db = load_fasta_database(fasta, pad_multiple=3072, is_text=True)
    return port_models(models), port_db(db)


def _ckpt_run(cls, planted, ckpt, **kw):
    models, db = planted
    e = cls(p_value=P_VALUE, device="cpu", mesh=cpu_mesh2d(3, 2),
            pad_multiple=3072, dist_rows_per_step=16, isolate_models=True,
            checkpoint_path=ckpt, **kw)
    return e.load_phmm(models).load_sequence(db)


def test_engine_2d_checkpoint_then_resume(planted, tmp_path):
    ckpt = str(tmp_path / "mesh2d.ckpt.npz")
    first = _ckpt_run(AbortAfterCheckpoint, planted, ckpt).run_async()
    assert first.wait(timeout=120) == HavacRunState.ABORTED
    with np.load(ckpt) as ck:
        assert ck["istate"].shape[:2] == (2, 3)
        assert ck["seam"].shape == (2, 3, 17) and int(ck["next_t"]) == 4
    second = _ckpt_run(Havac, planted, ckpt).run()
    assert second.resumed_chunks == 4
    assert not os.path.exists(ckpt)  # removed once the run completes
    whole = _ckpt_run(Havac, planted, None).run()
    assert whole.resumed_chunks == 0
    assert_same_run(second, whole)
    geo = whole.stats.chunk_geometry
    assert geo["group_row_chunks"] == [8, 4] and geo["steps"] == 10
    assert second.stats.num_chunks == (8 + 4) * 3 - 4 * 3 - 3 * 2


@pytest.mark.parametrize("how", ["fingerprint", "shape", "garbage"])
def test_stale_or_reshaped_2d_checkpoint_is_rejected(planted, tmp_path,
                                                     caplog, how):
    ckpt = str(tmp_path / "mesh2d.ckpt.npz")
    first = _ckpt_run(AbortAfterCheckpoint, planted, ckpt).run_async()
    assert first.wait(timeout=120) == HavacRunState.ABORTED
    with np.load(ckpt) as ck:
        arrays = dict(ck)
    if how == "fingerprint":
        arrays["fingerprint"] = np.int64(int(arrays["fingerprint"]) ^ 1)
    elif how == "shape":
        arrays["seam"] = arrays["seam"][:1]
    if how == "garbage":
        with open(ckpt, "wb") as f:
            f.write(b"not a checkpoint")
    else:
        with open(ckpt, "wb") as f:
            np.savez(f, **arrays)
    with caplog.at_level("WARNING", logger="havac_tpu_torch.engine"):
        again = _ckpt_run(Havac, planted, ckpt).run()
    assert again.resumed_chunks == 0
    assert any("does not match" in r.getMessage() for r in caplog.records)
    assert_same_run(again, _ckpt_run(Havac, planted, None).run())


LIMITS = {"rows": ("KEY_ROWS", 100), "positions": ("KEY_POSITIONS", 5_000),
          "sequence": ("KEY_SEQUENCE", 4_000), "inside": (None, None)}


@pytest.fixture(scope="module")
def limits_ref():
    """tests/test_torch_dist.py's key-bound fixture, isolated."""
    models, records = generate_planted_fixture(
        seed=19, model_length=25, sequence_length=6000, num_models=5)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    db = load_fasta_database(fasta, pad_multiple=1024, is_text=True)
    cfg = SsvKernelConfig(block_width=1024, rows_per_strip=8,
                          max_hit_tiles=512, interpret=True)
    ref = JaxHavac(p_value=P_VALUE, config=cfg, backend="xla",
                   chunk_symbols=2048, chunk_rows=48, isolate_models=True)
    ref.load_phmm(models).load_sequence(db).run()
    assert len(ref.hits()) > 0
    return port_models(models), port_db(db), ref


@pytest.mark.parametrize("case", sorted(LIMITS))
def test_past_the_key_bounds_on_a_2d_mesh_matches_jax(limits_ref, monkeypatch,
                                                     case):
    """Each hit-key bound lowered (and none) on a (3, 2) mesh: chunk-local
    keys widened on the host, with regrows, give the JAX engine's isolated
    hits."""
    models, db, ref = limits_ref
    name, value = LIMITS[case]
    if name is not None:
        monkeypatch.setattr(pipeline, name, value)
    ours = Havac(p_value=P_VALUE, device="cpu", pad_multiple=1024,
                 mesh=cpu_mesh2d(3, 2), dist_rows_per_step=37,
                 dist_hit_capacity=2, isolate_models=True)
    ours.load_phmm(models).load_sequence(db).run()
    assert ours.state == HavacRunState.COMPLETED
    assert ours.stats.overflow_retries > 0
    assert_same_run(ours, ref)
    sweep = Swar2DSweep(ours._codes(), cpu_mesh2d(2, 2), database=db,
                        phmm_prefix=ours.phmm_prefix)
    resolved, _ = sweep.sweep(ours.scores, ours.phmm_prefix)
    assert sweep.keyform == (case == "inside")
    assert len(resolved) == len(ref.hits())


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip(n):
    out = dryrun_multichip(n, "cpu")
    assert out["1d"]["shape"] == {"seq": n} and out["1d"]["hits"] > 0
    if n == 8:
        assert out["2d"]["shape"] == {"seq": 4, "model": 2}
        assert out["2d"]["hits"] > 0
    else:
        assert "2d" not in out
