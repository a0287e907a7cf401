"""The port's 1-D mesh sweep (`havac_tpu_torch/parallel/`) on the CPU, in one
process, against the JAX package's mesh paths on the 8 virtual CPU devices
of `conftest.py`, the port's single-device path and `ops/reference.py`.

The port's shards are CPU devices of one process (`ShardMesh(["cpu"] * D)`,
as the JAX tests put 8 shards on one CPU). Hits must be identical: every
row and position, and every resolved column in order.
"""

import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from havac_tpu.engine import Havac as JaxHavac
from havac_tpu.io.fasta import load_fasta_database
from havac_tpu.ops.common import SsvKernelConfig
from havac_tpu.ops.reference import ssv_reference
from havac_tpu.parallel.engine_dist import ssv_distributed as jax_distributed
from havac_tpu.parallel.swar_dist import SwarDistributedSweep as JaxSwarSweep
from havac_tpu.parallel.wavefront import ssv_wavefront as jax_wavefront
from havac_tpu.testing.generator import generate_planted_fixture
from havac_tpu_torch.convert import database_from_reference as port_db
from havac_tpu_torch.convert import profile_hmms_from_reference as port_models
from havac_tpu_torch.engine import (Havac, HavacRunState, HavacUsageError,
                                    pipeline)
from havac_tpu_torch.parallel.engine_dist import (DistributedSweep,
                                                  ssv_distributed)
from havac_tpu_torch.parallel.multihost import (ShardMesh, host_local_codes,
                                                local_row_range, shard_width)
from havac_tpu_torch.parallel.swar_dist import SwarDistributedSweep
from havac_tpu_torch.parallel.wavefront import Schedule, ssv_wavefront
from havac_tpu_torch.testing.multihost_worker import AbortAfterCheckpoint

P_VALUE = 0.05
FIELDS = ("sequence_index", "sequence_position", "phmm_index",
          "phmm_position", "strand")
DS = (1, 2, 3, 4, 8)


def jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("seq",))


def cpu_mesh(d):
    return ShardMesh(["cpu"] * d)


def assert_hits(got, want):
    rows, pos = got
    np.testing.assert_array_equal(rows, want[0])
    np.testing.assert_array_equal(pos, want[1])


def oracle(codes, scores, reset=None):
    res, _ = ssv_reference(codes, scores, reset_rows=reset)
    return res.hit_rows, res.hit_positions


def sorted_pairs(rows, pos):
    order = np.lexsort((pos, rows))
    return rows[order], pos[order]


# ------------------------------------------------------ the three sweeps


@pytest.fixture(scope="module")
def random_case():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=4096).astype(np.uint8)
    scores = rng.integers(-40, 110, size=(300, 4)).astype(np.int8)
    want = oracle(codes, scores)
    assert want[0].size > 0
    jd = jax_distributed(codes, scores, jax_mesh(8), rows_per_step=32,
                         rows_per_call=96)
    jw = sorted_pairs(*jax_wavefront(codes, scores, jax_mesh(4),
                                     rows_per_step=64))
    assert_hits(jd, want)
    assert_hits(jw, want)
    return codes, scores, jd, jw


@pytest.mark.parametrize("d", DS)
def test_wavefront_matches_jax(random_case, d):
    codes, scores, jd, jw = random_case
    got = ssv_wavefront(codes, scores, cpu_mesh(d), rows_per_step=64)
    assert_hits(got, jw)
    assert_hits(got, jd)


@pytest.mark.parametrize("d", DS)
def test_swar_sweep_matches_jax(random_case, d):
    codes, scores, jd, jw = random_case
    sweep = SwarDistributedSweep(codes, cpu_mesh(d), rows_per_step=30)
    assert_hits(sweep.run(scores), jw)
    assert sweep.launches == 10 * d and sweep.steps == 10 + d - 1


@pytest.mark.parametrize("d", DS)
def test_ssv_distributed_matches_jax(random_case, d):
    """Row chunks of 96 rows chained call to call, 32 rows a step."""
    codes, scores, jd, _ = random_case
    got = ssv_distributed(codes, scores, cpu_mesh(d), rows_per_step=32,
                          rows_per_call=96)
    assert_hits(got, jd)


def test_distributed_sweep_chains_and_resets():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=1500).astype(np.uint8)
    scores = np.full((64, 4), 5, dtype=np.int8)  # chains across calls
    sweep = DistributedSweep(codes, cpu_mesh(3), rows_per_step=10,
                             rows_per_call=32)
    parts = [sweep.sweep_rows(scores[r0:r0 + 32], r0) for r0 in (0, 32)]
    got = (np.concatenate([p[0] for p in parts]),
           np.concatenate([p[1] for p in parts]))
    assert_hits(sorted_pairs(*got), oracle(codes, scores))
    assert sweep.rows_per_call == 40
    sweep.reset()  # a fresh chain: the second chunk alone
    assert_hits(sweep.sweep_rows(scores[32:], 32),
                (oracle(codes, scores[32:])[0] + 32,
                 oracle(codes, scores[32:])[1]))
    with pytest.raises(ValueError, match="rows_per_call"):
        sweep.sweep_rows(np.zeros((41, 4), np.int8), 0)


def test_isolation_matches_jax_swar_sweep():
    """Model isolation against the JAX SWAR mesh sweep (interpret mode), as
    in tests/test_swar_dist.py, and at shard and step counts it never
    runs."""
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=2 * 3072 * 2).astype(np.uint8)
    scores = rng.integers(-40, 110, size=(60, 4)).astype(np.int8)
    reset = np.zeros(60, dtype=bool)
    reset[0] = reset[23] = True
    want = JaxSwarSweep(codes, jax_mesh(2), block_width=3072,
                        rows_per_step=30, interpret=True).run(scores, reset)
    assert want[0].size > 0
    assert_hits(want, oracle(codes, scores, reset))
    for d, r in ((2, 30), (3, 7), (8, 1)):
        got = SwarDistributedSweep(codes, cpu_mesh(d), rows_per_step=r
                                   ).run(scores, reset)
        assert_hits(got, want)


# ------------------------------------------------------------------ edges


def _edge(name):
    rng = np.random.default_rng(11)
    if name == "l_below_d":  # 5 positions on 8 shards: 3 shards all padding
        return (rng.integers(0, 4, 5).astype(np.uint8),
                np.full((40, 4), 100, np.int8), 8, 3)
    if name == "p_not_a_multiple_of_r":
        return (rng.integers(0, 4, 2000).astype(np.uint8),
                rng.integers(-40, 110, (131, 4)).astype(np.int8), 3, 30)
    if name == "r_of_1":
        return (rng.integers(0, 4, 1200).astype(np.uint8),
                rng.integers(-40, 110, (40, 4)).astype(np.int8), 4, 1)
    if name == "dense_across_seams_and_chunks":
        return (rng.integers(0, 4, 1024).astype(np.uint8),
                np.full((128, 4), 5, np.int8), 8, 32)
    if name == "shard_narrower_than_a_chunk":
        return (rng.integers(0, 4, 37).astype(np.uint8),
                np.full((90, 4), 9, np.int8), 8, 20)
    raise ValueError(name)


EDGES = ("l_below_d", "p_not_a_multiple_of_r", "r_of_1",
         "dense_across_seams_and_chunks", "shard_narrower_than_a_chunk")


@pytest.mark.parametrize("name", EDGES)
def test_edges_match_the_oracle(name):
    codes, scores, d, r = _edge(name)
    want = oracle(codes, scores)
    assert want[0].size > 0
    sweep = SwarDistributedSweep(codes, cpu_mesh(d), rows_per_step=r)
    assert_hits(sweep.run(scores), want)
    assert sweep.launches == -(-scores.shape[0] // r) * d
    assert_hits(ssv_distributed(codes, scores, cpu_mesh(d), rows_per_step=r,
                                rows_per_call=2 * r + 1), want)


def test_dense_hits_match_jax_and_regrow():
    """Chains longer than a shard and a row chunk, as in
    tests/test_engine_dist.py, with a key buffer far too small."""
    codes, scores, d, r = _edge("dense_across_seams_and_chunks")
    want = jax_distributed(codes, scores, jax_mesh(8), rows_per_step=32,
                           rows_per_call=32)
    assert want[0].size > 100
    sweep = SwarDistributedSweep(codes, cpu_mesh(d), rows_per_step=r,
                                 key_cap=3)
    assert_hits(sweep.run(scores), want)
    assert sweep.regrows > 0 and sweep.key_cap >= 1 << 16


def test_one_shard_equals_the_single_device_sweep():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 3333).astype(np.uint8)
    scores = rng.integers(-40, 110, (77, 4)).astype(np.int8)
    single = pipeline.PipelinedSweep(codes, scores, 1000, 20, "cpu", None,
                                     None)
    _, parts, _ = single.run()
    sweep = SwarDistributedSweep(codes, cpu_mesh(1), rows_per_step=20)
    _, mesh_parts = sweep.sweep(scores)
    assert_hits(pipeline.raw_pairs(mesh_parts, ordered=True),
                pipeline.raw_pairs(parts, ordered=True))
    assert sweep.launches == sweep.steps == 4


def test_schedule_and_staging():
    sched = Schedule(D=3, P=131, R=30)
    assert (sched.S, sched.T) == (5, 7)
    assert [sched.chunk(1, t) for t in range(7)] == [None, 0, 1, 2, 3, 4,
                                                     None]
    assert sched.rows(4) == (120, 131)
    mesh = cpu_mesh(3)
    codes = np.arange(10, dtype=np.uint8)
    assert shard_width(10, mesh) == 4
    assert local_row_range(12, mesh) == (0, 12)
    local, lo = host_local_codes(codes, mesh)
    assert lo == 0 and np.array_equal(local, codes)
    assert (mesh.shape, mesh.axis_names, mesh.backend) == ({"seq": 3},
                                                           ("seq",), None)
    with pytest.raises(ValueError, match="axis"):
        SwarDistributedSweep(codes, mesh, axis="model")
    with pytest.raises(ValueError, match="at least 1"):
        SwarDistributedSweep(codes, mesh, rows_per_step=0)


# ------------------------------------------------------ abort and progress


class _AbortAfter:
    """threading.Event stand-in that trips after n is_set() polls."""

    def __init__(self, n):
        self.n = n
        self.calls = 0

    def is_set(self):
        self.calls += 1
        return self.calls > self.n


def test_abort_between_steps_and_progress():
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    scores = rng.integers(-40, 110, (90, 4)).astype(np.int8)  # S = 3
    sweep = SwarDistributedSweep(codes, cpu_mesh(4), rows_per_step=30)
    seen = []
    ev = _AbortAfter(2)
    assert sweep.run(scores, abort_event=ev,
                     progress=lambda *a: seen.append(a)) is None
    assert ev.calls == 3  # polled once a step; tripped before step 2
    assert seen == [(1, 6), (2, 6)] and sweep.launches == 3
    seen.clear()
    assert_hits(sweep.run(scores, progress=lambda *a: seen.append(a)),
                oracle(codes, scores))
    assert seen == [(t, 6) for t in range(1, 7)]  # T = S + D - 1 calls


def test_sweep_checkpoint_resume_equals_a_run_without_a_break():
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, 2500).astype(np.uint8)
    scores = np.full((100, 4), 6, np.int8)  # chains cross every seam
    scores[::7] = rng.integers(-40, 110, (15, 4))
    want = oracle(codes, scores)
    sweep = SwarDistributedSweep(codes, cpu_mesh(3), rows_per_step=9)
    saved = []
    ev = _AbortAfter(10**9)

    def cb(*payload):
        saved.append(payload)
        ev.n = 0  # abort at the next step

    assert sweep.run(scores, abort_event=ev, checkpoint_cb=cb,
                     ckpt_every=5) is None
    t_next, istate, ilo, seams, slo, rows, pos = saved[0]
    assert t_next == 5 and istate.shape == (3, 834) and seams.shape == (3, 10)
    assert ilo == slo == 0 and rows.size > 0
    fresh = SwarDistributedSweep(codes, cpu_mesh(3), rows_per_step=9)
    assert_hits(fresh.run(scores, resume=(t_next, istate, seams, rows, pos)),
                want)
    assert fresh.launches == 33 - 9  # the first five steps' launches done


# ----------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def planted():
    models, records = generate_planted_fixture(
        seed=43, model_length=64, sequence_length=6000, num_models=3)
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
def test_engine_on_a_mesh_matches_jax_mesh_and_single_device(planted, strand):
    models, fasta, db = planted
    ref = JaxHavac(p_value=P_VALUE, backend="xla", mesh=jax_mesh(8),
                   chunk_rows=64, dist_rows_per_step=32, strand=strand)
    ref.load_phmm(models).load_sequence(fasta if strand == "both" else db,
                                        is_text=strand == "both").run()
    pm = port_models(models)
    src = fasta if strand == "both" else port_db(db)
    ours = port_engine(cpu_mesh(4), dist_rows_per_step=32, strand=strand)
    ours.load_phmm(pm).load_sequence(src, is_text=strand == "both").run()
    assert ours.state == HavacRunState.COMPLETED
    single = port_engine(strand=strand)
    single.load_phmm(pm).load_sequence(src, is_text=strand == "both").run()
    assert_same_run(ours, ref, raw=strand == "forward")
    assert_same_run(ours, single)
    geo = ours.stats.chunk_geometry
    assert (geo["shards"], geo["rows_per_step"], geo["row_chunks"]) == (4, 32,
                                                                         6)
    assert geo["steps"] == 9 and geo["launches"] == 24
    assert ours.stats.num_chunks == 24 and ours.progress == 1.0
    assert ours.stats.cells == ours.database.padded_length * 192
    assert set(ours.stats.pipeline_prof) == {
        "dispatch", "sync", "ready_wait", "fetch", "regrow", "sort", "resolve",
        "seam", "resolve_wait", "tail", "tail_merge", "tail_gather",
        "tail_segments", "launches", "reset_windows", "launched_ahead"}
    assert ours.stats.pipeline_prof["tail_segments"] > 0
    assert ours.stats.pipeline_prof["launches"] == geo["launches"]


def test_engine_isolation_matches_jax_swar_mesh(planted):
    models, fasta, db = planted
    cfg = SsvKernelConfig.swar(block_width=3072, interpret=True)
    ref = JaxHavac(p_value=P_VALUE, backend="pallas_interpret", config=cfg,
                   mesh=jax_mesh(8), isolate_models=True)
    ref.load_phmm(models).load_sequence(db).run()
    ours = port_engine(cpu_mesh(3), dist_rows_per_step=50,
                       isolate_models=True, verify_hits=True)
    ours.load_phmm(port_models(models)).load_sequence(port_db(db)).run()
    single = port_engine(isolate_models=True)
    single.load_phmm(port_models(models)).load_sequence(port_db(db)).run()
    assert_same_run(ours, ref)
    assert_same_run(ours, single)
    assert ours.verification.all_verified


def _ckpt_run(cls, planted, ckpt, **kw):
    models, _, db = planted
    e = cls(p_value=P_VALUE, device="cpu", mesh=cpu_mesh(3),
            pad_multiple=3072, dist_rows_per_step=16, checkpoint_path=ckpt,
            **kw)
    return e.load_phmm(port_models(models)).load_sequence(port_db(db))


def test_engine_checkpoint_then_resume(planted, tmp_path):
    ckpt = str(tmp_path / "mesh.ckpt.npz")
    first = _ckpt_run(AbortAfterCheckpoint, planted, ckpt).run_async()
    assert first.wait(timeout=120) == HavacRunState.ABORTED
    assert os.path.exists(ckpt)
    second = _ckpt_run(Havac, planted, ckpt).run()
    assert second.resumed_chunks == 4
    assert not os.path.exists(ckpt)  # removed once the run completes
    whole = _ckpt_run(Havac, planted, None).run()
    assert whole.resumed_chunks == 0
    assert_same_run(second, whole)


@pytest.mark.parametrize("how", ["fingerprint", "shape", "garbage"])
def test_stale_or_reshaped_checkpoint_is_rejected(planted, tmp_path, caplog,
                                                  how):
    ckpt = str(tmp_path / "mesh.ckpt.npz")
    first = _ckpt_run(AbortAfterCheckpoint, planted, ckpt).run_async()
    assert first.wait(timeout=120) == HavacRunState.ABORTED
    with np.load(ckpt) as ck:
        arrays = dict(ck)
    if how == "fingerprint":
        arrays["fingerprint"] = np.int64(int(arrays["fingerprint"]) ^ 1)
    elif how == "shape":
        arrays["istate"] = arrays["istate"][:, :-1]
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
    models, records = generate_planted_fixture(
        seed=19, model_length=25, sequence_length=6000, num_models=5)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    db = load_fasta_database(fasta, pad_multiple=1024, is_text=True)
    cfg = SsvKernelConfig(block_width=1024, rows_per_strip=8,
                          max_hit_tiles=512, interpret=True)
    ref = JaxHavac(p_value=P_VALUE, config=cfg, backend="xla",
                   chunk_symbols=2048, chunk_rows=48)
    ref.load_phmm(models).load_sequence(db).run()
    assert len(ref.hits()) > 0
    return port_models(models), port_db(db), ref


@pytest.mark.parametrize("case", sorted(LIMITS))
def test_past_the_key_bounds_matches_jax(limits_ref, monkeypatch, case):
    """Each hit-key bound lowered (and none): chunk-local keys widened on
    the host, with regrows, give the JAX engine's hits."""
    models, db, ref = limits_ref
    name, value = LIMITS[case]
    if name is not None:
        monkeypatch.setattr(pipeline, name, value)
    ours = Havac(p_value=P_VALUE, device="cpu", pad_multiple=1024,
                 mesh=cpu_mesh(3), dist_rows_per_step=37,
                 dist_hit_capacity=2)
    ours.load_phmm(models).load_sequence(db).run()
    assert ours.state == HavacRunState.COMPLETED
    assert ours.stats.overflow_retries > 0
    assert_same_run(ours, ref)
    sweep = SwarDistributedSweep(ours._codes(), cpu_mesh(2), database=db,
                                 phmm_prefix=ours.phmm_prefix)
    resolved, parts = sweep.sweep(ours.scores)
    assert sweep.keyform == (case == "inside")
    assert len(resolved) == len(ref.hits())


def test_usage_errors_and_warmup(planted):
    models, _, db = planted
    with pytest.raises(HavacUsageError, match="dist_step_dispatch"):
        port_engine(cpu_mesh(2), dist_step_dispatch=False)
    with pytest.raises(HavacUsageError, match="does not agree"):
        port_engine(ShardMesh(["cuda:0"]))
    with pytest.raises(HavacUsageError, match="no axis"):
        port_engine(cpu_mesh(2), mesh_axis="model")
    with pytest.raises(HavacUsageError, match="at least 1"):
        port_engine(cpu_mesh(2), dist_rows_per_step=0)
    amino, _ = generate_planted_fixture(seed=2, model_length=16,
                                        sequence_length=512, alphabet="amino")
    with pytest.raises(HavacUsageError, match="amino"):
        port_engine(cpu_mesh(2)).load_phmm(port_models(amino))
    eng = port_engine(cpu_mesh(2)).load_phmm(port_models(models))
    eng.load_sequence(port_db(db)).warmup()
    assert eng._warm_sweep is None  # a no-op on a mesh
