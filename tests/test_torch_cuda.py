"""The CUDA sweep kernel (and its row-dump variant) and the roofline
kernels against their plain PyTorch versions, and the engine's CUDA paths
against the CPU engine, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips (the decision
is made inside the fixture, never at import). On the card:
``python -m pytest tests/test_torch_cuda.py -q``.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from havac_tpu_torch.engine import Havac
from havac_tpu_torch.engine.pipeline import reset_counts
from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.ops.ssv_torch import ssv_sweep_plain
from havac_tpu_torch.parallel.multihost import (ShardMesh,
                                                global_sequence_mesh,
                                                initialize,
                                                sequence_model_mesh)
from havac_tpu_torch.testing.generator import generate_planted_fixture
from havac_tpu_torch.testing.percell import (dp_matrix_kernel, dp_matrix_rows,
                                             dp_matrix_torch)
from havac_tpu_torch.tools import kbench, roofline, runtime_table, scaling_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("card,reset,cap", [(4, False, 1 << 20),
                                            (4, True, 1 << 20),
                                            (20, False, 1 << 20),
                                            (20, True, 1 << 20),
                                            (4, False, 3)])
def test_kernel_matches_plain(dev, card, reset, cap):
    rng = np.random.default_rng(card + 2 * reset + cap)
    L, P = 20_011, 77
    arrays = (rng.integers(0, card, L).astype(np.uint8),
              rng.integers(-40, 70, (P, card)).astype(np.int8),
              rng.integers(0, 256, L).astype(np.int32),
              rng.integers(0, 256, P + 1).astype(np.int32))
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    rr = (torch.from_numpy((rng.random(P) < 0.1).astype(np.int32)).to(dev)
          if reset else None)
    before = ssv_cuda.LAUNCHES
    res = ssv_cuda.ssv_sweep(*t, reset_rows=rr, row_offset=3, pos_offset=9,
                             cap=cap)
    assert ssv_cuda.LAUNCHES == before + (2 if res.regrown else 1)
    keys, state, carry = ssv_sweep_plain(*t, rr, 3, 9)
    assert res.count == keys.numel() > 0
    assert res.regrown == (cap < keys.numel())
    assert torch.equal(torch.sort(res.keys).values, keys)
    assert torch.equal(res.final_state, state)
    assert torch.equal(res.final_carry, carry)


# The word kernel's edges (a narrow block spans 3 * 128 = 384 diagonals, a
# wide one 1,536; sequences under ~811k positions run narrow blocks):
# (tag, L, P, card, reset, score high, row_offset, pos_offset)
EDGE_CASES = [
    ("ragged-l", 3 * 1536 * 7 + 1001, 70, 4, False, 70, 3, 9),
    ("p-above-l", 900, 2500, 4, True, 70, 3, 9),
    ("p-of-1", 50_000, 1, 4, False, 127, 3, 9),
    ("both-triangles", 1000, 1200, 20, False, 70, 3, 9),
    ("dense", 20_000, 40, 4, False, 127, 3, 9),
    ("key-limits", 9_000, 64, 4, True, 70, (1 << 25) - 64,
     (1 << 38) - 9_000),
    ("card20-reset", 30_011, 203, 20, True, 70, 3, 9),
    ("card5-tables", 12_345, 99, 5, True, 70, 3, 9),
    ("wide-blocks", 1_000_003, 37, 4, True, 70, 3, 9),
    ("wide-card20", 1_000_003, 29, 20, False, 70, 3, 9),
    # P above a block's span: triangle blocks whose middle tiles run the
    # unmasked row
    ("long-triangles", 50_000, 3_000, 4, True, 70, 3, 9),
    ("long-triangles-card20", 40_000, 2_500, 20, False, 70, 3, 9),
]


@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_kernel_edges_match_plain(dev, case):
    """Ragged L, P > L, P of 1, a block in both triangles, dense hits (many
    a warp and row), offsets at the key limits, card 20 and 5 with reset
    rows, wide blocks: sorted keys, count, state and carry exactly as the
    plain version."""
    tag, L, P, card, reset, hi, row_offset, pos_offset = case
    rng = np.random.default_rng(len(tag) * 1000 + L)
    sc = rng.integers(-40, hi, (P, card)).astype(np.int8)
    if tag == "dense":
        sc = np.maximum(sc, 100).astype(np.int8)
    arrays = (rng.integers(0, card, L).astype(np.uint8), sc,
              rng.integers(0, 256, L).astype(np.int32),
              rng.integers(0, 256, P + 1).astype(np.int32))
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    rr = (torch.from_numpy((rng.random(P) < 0.1).astype(np.int32)).to(dev)
          if reset else None)
    res = ssv_cuda.ssv_sweep(*t, reset_rows=rr, row_offset=row_offset,
                             pos_offset=pos_offset)
    keys, state, carry = ssv_sweep_plain(*t, rr, row_offset, pos_offset)
    assert res.count == keys.numel() > 0
    assert torch.equal(torch.sort(res.keys).values, keys)
    assert torch.equal(res.final_state, state)
    assert torch.equal(res.final_carry, carry)
    if tag == "dense":
        assert keys.numel() > L * P // 4


@pytest.mark.parametrize("L", [200_003, 1_000_003])
def test_card20_at_pfam_model_starts_matches_plain(dev, L):
    """Card 20 with reset rows at Pfam's density of model starts (model
    lengths log-normal, median 122 rows, over a few thousand rows: about
    one 16-row hit window in ten holds one), in narrow and wide blocks,
    with hits: sorted keys, count, state and carry as the plain version."""
    P = 3_000
    rng = np.random.default_rng(L)
    arrays = (rng.integers(0, 20, L).astype(np.uint8),
              rng.integers(-40, 75, (P, 20)).astype(np.int8),
              rng.integers(0, 256, L).astype(np.int32),
              rng.integers(0, 256, P + 1).astype(np.int32))
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    reset = kbench.model_starts(P, 122, seed=L)
    rr = torch.from_numpy(reset).to(dev)
    starts, windows = reset_counts(reset)
    assert 0.03 < windows / -(-P // 16) < 0.3 and windows <= starts
    res = ssv_cuda.ssv_sweep(*t, reset_rows=rr, row_offset=3, pos_offset=9)
    keys, state, carry = ssv_sweep_plain(*t, rr, 3, 9)
    assert res.count == keys.numel() > 0
    assert torch.equal(torch.sort(res.keys).values, keys)
    assert torch.equal(res.final_state, state)
    assert torch.equal(res.final_carry, carry)


def test_cuda_engine_matches_cpu_engine(dev):
    models, records = generate_planted_fixture(
        seed=19, model_length=25, sequence_length=6000, num_models=5)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    runs = []
    for device in (dev, "cpu"):
        e = Havac(p_value=0.05, device=device, chunk_symbols=1777,
                  chunk_rows=37)
        e.load_phmm(models).load_sequence(fasta, is_text=True).run()
        runs.append(e)
    assert runs[0].backend == "cuda" and runs[1].backend == "torch"
    assert runs[0].hits().as_tuples() == runs[1].hits().as_tuples()
    for x, y in zip(runs[0].raw_hits(), runs[1].raw_hits()):
        np.testing.assert_array_equal(x, y)


def _mesh_runs(dev, mesh, **kw):
    """The planted search on ``mesh`` (on the card) and on 3 CPU shards."""
    models, records = generate_planted_fixture(
        seed=23, model_length=30, sequence_length=9000, num_models=4)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    runs = []
    for device, m in ((dev, mesh), ("cpu", ShardMesh(["cpu"] * 3))):
        e = Havac(p_value=0.05, device=device, mesh=m, dist_rows_per_step=17,
                  **kw)
        e.load_phmm(models).load_sequence(fasta, is_text=True).run()
        runs.append(e)
    assert len(runs[0].hits()) > 0
    assert runs[0].hits().as_tuples() == runs[1].hits().as_tuples()
    for x, y in zip(runs[0].raw_hits(), runs[1].raw_hits()):
        np.testing.assert_array_equal(x, y)
    return runs


@pytest.mark.parametrize("isolate", [False, True])
def test_mesh_of_three_shards_on_the_card(dev, isolate):
    """D = 3 on cuda:0 (one stream, the seams passed as tensors) equals the
    plain CPU mesh run; every active (shard, step) pair is one launch."""
    before = ssv_cuda.LAUNCHES
    cuda, cpu = _mesh_runs(dev, ShardMesh([dev] * 3), isolate_models=isolate,
                           dist_hit_capacity=5)
    geo = cuda.stats.chunk_geometry
    assert geo["launches"] == 3 * geo["row_chunks"] == cpu.stats.num_chunks
    assert (ssv_cuda.LAUNCHES - before
            == geo["launches"] + cuda.stats.overflow_retries)
    assert cuda.stats.overflow_retries > 0


@pytest.mark.parametrize("d_model", [1, 2])
def test_mesh_sweep_orders_its_fills_before_its_launches(dev, monkeypatch,
                                                         d_model):
    """What the sweep fills on a device (the shards' zero row states among
    it) is ordered before its launches, and its streams start after the
    caller's queued work: with a long kernel queued right after the staging
    of the scores, on whatever stream staged them, and freed blocks of the
    state's size holding large values, the hits equal the CPU mesh's. (A
    state filled on another stream than the one that reads it would start
    from those values.) The sweep runs once on each of the pool's 32
    streams first, so that no allocation in the checked run reaches
    ``cudaMalloc``, which would synchronise the device and hide a race.
    ``d_model`` 2 holds the 2-D sweep (3 x 2 shards, two models) to the
    same."""
    from havac_tpu_torch.parallel.swar_dist import SwarDistributedSweep
    from havac_tpu_torch.parallel.swar_dist2d import Swar2DSweep

    rng = np.random.default_rng(31)
    codes = rng.integers(0, 4, 30_011).astype(np.uint8)
    scores = rng.integers(-40, 90, (70, 4)).astype(np.int8)
    prefix = np.array([0, 40, 70])

    def make(device):
        n = 3 * d_model
        if d_model == 1:
            return (SwarDistributedSweep(codes, ShardMesh([device] * n),
                                         rows_per_step=17), (scores,))
        mesh = sequence_model_mesh(d_model, devices=[device] * n)
        return Swar2DSweep(codes, mesh, rows_per_step=17), (scores, prefix)

    cpu_sweep, args = make("cpu")
    cpu = cpu_sweep.run(*args)
    sweep, _ = make(dev)
    for _ in range(32):
        sweep.run(*args)
    staged = SwarDistributedSweep._staged

    def staged_then_busy(self, *a):
        out = staged(self, *a)
        torch.cuda._sleep(500_000_000)  # ~0.25 s on the current stream
        return out

    monkeypatch.setattr(SwarDistributedSweep, "_staged", staged_then_busy)
    poison = [torch.full((sweep.shard_width,), 250, dtype=torch.int32,
                         device=dev) for _ in range(3 * d_model)]
    del poison
    torch.cuda._sleep(500_000_000)
    rows, pos = sweep.run(*args)
    assert cpu[0].size > 0
    np.testing.assert_array_equal(rows, cpu[0])
    np.testing.assert_array_equal(pos, cpu[1])


def test_mesh2d_of_three_by_two_shards_on_the_card(dev):
    """A (3, 2) sequence x model mesh on cuda:0 equals the single-device
    isolated run on the card and the same mesh on the CPU; every active
    (group, shard, step) is one launch."""
    models, records = generate_planted_fixture(
        seed=23, model_length=30, sequence_length=9000, num_models=4)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    runs = []
    for device, mesh in ((dev, sequence_model_mesh(2, devices=[dev] * 6)),
                         (dev, None),
                         ("cpu", sequence_model_mesh(2, devices=["cpu"] * 6))):
        before = ssv_cuda.LAUNCHES
        e = Havac(p_value=0.05, device=device, mesh=mesh,
                  dist_rows_per_step=17, dist_hit_capacity=5,
                  isolate_models=True)
        e.load_phmm(models).load_sequence(fasta, is_text=True).run()
        runs.append((e, ssv_cuda.LAUNCHES - before))
    (card, launched), (single, _), (cpu, _) = runs
    assert len(card.hits()) > 0
    for other in (single, cpu):
        assert card.hits().as_tuples() == other.hits().as_tuples()
        for x, y in zip(card.raw_hits(), other.raw_hits()):
            np.testing.assert_array_equal(x, y)
    geo = card.stats.chunk_geometry
    assert geo["model_groups"] == 2 and geo["shards"] == 3
    assert geo["launches"] == 3 * sum(geo["group_row_chunks"])
    assert launched == geo["launches"] + card.stats.overflow_retries
    assert card.stats.overflow_retries > 0


def test_mesh_nccl_at_world_size_1(dev):
    """NCCL on a one-process group (the card's only GPU): D = 1, its abort
    agreement an all-reduce on the card, equal to the CPU mesh."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        mesh = global_sequence_mesh(devices=[dev])
        assert mesh.backend == "nccl" and mesh.shape == {"seq": 1}
        _mesh_runs(dev, mesh)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("card,reset", [(4, False), (4, True), (20, False),
                                        (20, True)])
def test_dump_matches_plain(dev, card, reset):
    """The row-dump variant writes every cell (buffers prefilled with 0x00
    and with 0xFF give the plain matrix) and leaves keys, count, state and
    carry as an undumped launch has them; it counts in DUMP_LAUNCHES only."""
    rng = np.random.default_rng(100 + card + reset)
    L, P = 30_011, 203
    arrays = (rng.integers(0, card, L).astype(np.uint8),
              rng.integers(-40, 70, (P, card)).astype(np.int8),
              rng.integers(0, 256, L).astype(np.int32),
              rng.integers(0, 256, P + 1).astype(np.int32))
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    rr = (torch.from_numpy((rng.random(P) < 0.1).astype(np.int32)).to(dev)
          if reset else None)
    want = torch.empty((P, L), dtype=torch.uint8, device=dev)
    keys, state, carry = ssv_sweep_plain(*t, rr, 3, 9, dump=want)
    undumped = ssv_cuda.ssv_sweep(*t, reset_rows=rr, row_offset=3,
                                  pos_offset=9)
    for fill in (0x00, 0xFF):
        dump = torch.full((P, L), fill, dtype=torch.uint8, device=dev)
        launches, dumps = ssv_cuda.LAUNCHES, ssv_cuda.DUMP_LAUNCHES
        res = ssv_cuda.ssv_sweep(*t, reset_rows=rr, row_offset=3,
                                 pos_offset=9, dump=dump)
        torch.cuda.synchronize()
        assert ssv_cuda.LAUNCHES == launches
        assert ssv_cuda.DUMP_LAUNCHES == dumps + 1
        assert torch.equal(dump, want)
        assert res.count == undumped.count == keys.numel() > 0
        assert torch.equal(torch.sort(res.keys).values, keys)
        assert torch.equal(res.final_state, state)
        assert torch.equal(res.final_carry, carry)
        assert torch.equal(res.final_state, undumped.final_state)
        assert torch.equal(res.final_carry, undumped.final_carry)


@pytest.mark.parametrize("offset", [1, 7, 13])
def test_dump_into_an_unaligned_view(dev, offset):
    """The kernel aligns its staged rows and bulk copies by address: a
    (P, L) view starting at any byte of its buffer gets every cell and
    nothing around it."""
    rng = np.random.default_rng(offset)
    L, P = 5_003, 97
    sym = torch.from_numpy(rng.integers(0, 4, L).astype(np.uint8)).to(dev)
    sc = torch.from_numpy(rng.integers(-40, 70, (P, 4)).astype(np.int8)
                          ).to(dev)
    want = dp_matrix_torch(sym, sc)
    buf = torch.full((P * L + offset + 16,), 0xA5, dtype=torch.uint8,
                     device=dev)
    view = buf[offset:offset + P * L].view(P, L)
    ssv_cuda.ssv_sweep(sym, sc, dump=view)
    torch.cuda.synchronize()
    assert torch.equal(view, want)
    assert (buf[:offset] == 0xA5).all()
    assert (buf[offset + P * L:] == 0xA5).all()


# (tag, L, P, card, reset): the dump's 128-thread, one-word blocks span 384
# diagonals, so P = 1,000 puts whole blocks in both triangles and L = 150
# one block in both at once.
DUMP_EDGE_CASES = [
    ("p-above-span", 20_000, 1_000, 4, True),
    ("both-triangles", 150, 700, 20, True),
    ("ragged", 384 * 37 + 5, 300, 4, False),
]


@pytest.mark.parametrize("case", DUMP_EDGE_CASES,
                         ids=[c[0] for c in DUMP_EDGE_CASES])
def test_dump_edges_match_plain(dev, case):
    """The row dump's triangles and ragged end: every cell once (0xFF
    prefill), keys, count, state and carry as an undumped launch."""
    tag, L, P, card, reset = case
    rng = np.random.default_rng(len(tag) + L)
    arrays = (rng.integers(0, card, L).astype(np.uint8),
              rng.integers(-40, 70, (P, card)).astype(np.int8),
              rng.integers(0, 256, L).astype(np.int32),
              rng.integers(0, 256, P + 1).astype(np.int32))
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    rr = (torch.from_numpy((rng.random(P) < 0.1).astype(np.int32)).to(dev)
          if reset else None)
    want = torch.empty((P, L), dtype=torch.uint8, device=dev)
    keys, state, carry = ssv_sweep_plain(*t, rr, 3, 9, dump=want)
    dump = torch.full((P, L), 0xFF, dtype=torch.uint8, device=dev)
    res = ssv_cuda.ssv_sweep(*t, reset_rows=rr, row_offset=3, pos_offset=9,
                             dump=dump)
    undumped = ssv_cuda.ssv_sweep(*t, reset_rows=rr, row_offset=3,
                                  pos_offset=9)
    assert torch.equal(dump, want)
    assert res.count == undumped.count == keys.numel()
    assert torch.equal(torch.sort(res.keys).values, keys)
    assert torch.equal(torch.sort(undumped.keys).values, keys)
    for r in (res, undumped):
        assert torch.equal(r.final_state, state)
        assert torch.equal(r.final_carry, carry)


def test_percell_functions_on_the_card(dev):
    """dp_matrix_kernel (one dump launch, with a carry column and reset
    rows) and dp_matrix_rows (one launch per row) against dp_matrix_torch,
    all on the card."""
    rng = np.random.default_rng(7)
    L, P = 20_000, 96
    sym = torch.from_numpy(rng.integers(0, 4, L).astype(np.uint8)).to(dev)
    sc = torch.from_numpy(rng.integers(-40, 110, (P, 4)).astype(np.int8)
                          ).to(dev)
    icarry = torch.from_numpy(rng.integers(0, 256, P + 1).astype(np.int32)
                              ).to(dev)
    reset = torch.from_numpy((rng.random(P) < 0.1).astype(np.int32)).to(dev)
    want = dp_matrix_torch(sym, sc, icarry, reset)
    assert want.device.type == "cuda"
    assert torch.equal(dp_matrix_kernel(sym, sc, icarry, reset), want)
    launches = ssv_cuda.LAUNCHES
    rows = dp_matrix_rows(sym, sc)
    torch.cuda.synchronize()
    assert ssv_cuda.LAUNCHES == launches + P
    assert torch.equal(rows, dp_matrix_torch(sym, sc))


def test_scan_files_cuda_matches_cpu(dev, tmp_path):
    from havac_tpu_torch.io.hmm import write_hmm

    models, _ = generate_planted_fixture(seed=23, model_length=40,
                                         sequence_length=10, num_models=3)
    write_hmm(models, str(tmp_path / "m.hmm"))
    paths = []
    for i in range(3):
        _, recs = generate_planted_fixture(
            seed=23 + i, model_length=40, sequence_length=5000 + 1000 * i,
            num_models=3)
        paths.append(str(tmp_path / f"db{i}.fasta"))
        with open(paths[-1], "w") as f:
            f.write("".join(f">{n}\n{s}\n" for n, s in recs))
    scans = []
    for device in (dev, "cpu"):
        e = Havac(p_value=0.05, device=device, chunk_symbols=3001,
                  strand="both").load_phmm(str(tmp_path / "m.hmm"))
        scans.append([(p, h.as_tuples_stranded())
                      for p, h in e.scan_files(paths, prefetch=2)])
    assert scans[0] == scans[1]
    assert sum(len(h) for _, h in scans[0]) > 0


def test_scan_files_cuda_overlap_equals_per_file_runs(dev, tmp_path,
                                                      monkeypatch):
    """On the card, each file's launches are enqueued while the previous
    file's tail runs (made 0.2 s longer, so every later file overlaps) on
    the scan's one stream; every file equals a run of its own, column for
    column."""
    from havac_tpu_torch.engine import pipeline

    models, _ = generate_planted_fixture(seed=29, model_length=60,
                                         sequence_length=10, num_models=4)
    paths = []
    for i, n in enumerate((40_000, 90_000, 25_000, 70_000)):
        _, recs = generate_planted_fixture(seed=29 + i, model_length=60,
                                           sequence_length=n, num_models=4)
        paths.append(str(tmp_path / f"db{i}.fasta"))
        with open(paths[-1], "w") as f:
            f.write("".join(f">{name}\n{s}\n" for name, s in recs))
    kw = dict(p_value=0.05, device=dev, chunk_symbols=8192, chunk_rows=64)
    one = Havac(**kw).load_phmm(models)
    want = []
    for path in paths:
        one.load_sequence(path).run()
        want.append(one.hits().as_tuples_stranded())
    merge = pipeline._merge_resolved

    def slow(*args, **kwargs):
        time.sleep(0.2)
        return merge(*args, **kwargs)

    monkeypatch.setattr(pipeline, "_merge_resolved", slow)
    eng = Havac(**kw).load_phmm(models)
    got, ahead = [], []
    for path, hits in eng.scan_files(paths, prefetch=2):
        got.append(hits.as_tuples_stranded())
        prof = eng.stats.pipeline_prof
        assert prof["launches"] > 1
        ahead.append(prof["launched_ahead"])
    assert got == want and sum(len(h) for h in got) > 0
    assert ahead[0] == 0 and all(n > 0 for n in ahead[1:])


@pytest.mark.parametrize("name", roofline.VARIANTS)
@pytest.mark.parametrize("ws", ["8", "max"])
def test_roofline_kernels_match_plain(dev, name, ws):
    """Every copy of every roofline kernel equals the plain version exactly
    (zero tolerance), at reps 0-3, at WS 8 and at the variant's maximum WS
    (64, or 48 for mxumatch*), K = 30 and 7 (10 for
    mxumatch*, which run whole flushes)."""
    kernel = roofline.KERNEL_OF[name]
    ws = 8 if ws == "8" else roofline.max_ws(name, 30)
    for k in (30, 10 if name in roofline.MXU_VARIANTS else 7):
        x = roofline.make_inputs(name, ws, k, dev)
        for reps in range(4):
            before = roofline.ROOFLINE_LAUNCHES[kernel]
            got = roofline.op_mix(x, reps, copies=5)
            torch.cuda.synchronize()
            assert roofline.ROOFLINE_LAUNCHES[kernel] == before + 1
            assert got.shape == (5, *roofline.out_shape(name, ws))
            want = roofline.op_mix_plain(name, x, reps)
            for c in range(5):
                assert torch.equal(got[c], want), (name, ws, k, reps, c)


def test_roofline_kernel_refuses_what_it_cannot_hold(dev):
    x = roofline.make_inputs("current", 96, 30, dev)
    with pytest.raises(ValueError, match="--ws 96"):
        roofline.op_mix(x, 1)
    assert roofline.blocks_per_sm("current", roofline.MAX_WS, 30) >= 1
    # The library's shared-memory sizes against the card's 232,448 B a
    # block: stripmatch's ring (a plane a thread) fits WS 64 at every K, the
    # warps' match rings of mxumatch* cap them.
    for k in (10, 30, roofline.MAX_ROWS):
        assert roofline.max_ws("stripmatch", k) == roofline.MAX_WS
        assert roofline.blocks_per_sm("stripmatch", roofline.MAX_WS, k) >= 1
    for name in ("stripmatch", *roofline.MXU_VARIANTS):
        top = roofline.max_ws(name, 30)
        assert top == (64 if name == "stripmatch" else 48)
        with pytest.raises(ValueError, match=f"--ws {top + 4}"):
            roofline.op_mix(roofline.make_inputs(name, top + 4, 30, dev), 1)
        assert roofline.blocks_per_sm(name, top, 30) >= 1
    # mxumatch* stage only their warps' packed match words: 8 warps an SM
    # or more at every WS (a block is WS / 4 warps).
    for name in roofline.MXU_VARIANTS:
        for ws in (8, 12, 48):
            assert roofline.blocks_per_sm(name, ws, 30) * ws // 4 >= 8


@pytest.mark.parametrize("ws", [4, 12, 60, 64])
def test_strip_kernel_at_the_ring_edges(dev, ws):
    """stripmatch equals its plain version exactly, every one of 5 copies,
    at reps 0-3 and K 1 (every plane ahead is the next rep's), 7, 30 and
    128 (the most scalars the block holds beside WS 64's rings); WS 4 is
    one warp, 60 and 64 fifteen and sixteen."""
    kernel = roofline.KERNEL_OF["stripmatch"]
    for k in (1, 7, 30, roofline.MAX_ROWS):
        x = roofline.make_inputs("stripmatch", ws, k, dev)
        for reps in range(4):
            before = roofline.ROOFLINE_LAUNCHES[kernel]
            got = roofline.op_mix(x, reps, copies=5)
            torch.cuda.synchronize()
            assert roofline.ROOFLINE_LAUNCHES[kernel] == before + 1
            want = roofline.op_mix_plain("stripmatch", x, reps)
            for c in range(5):
                assert torch.equal(got[c], want), (ws, k, reps, c)


def test_strip_kernel_does_not_spill(dev, tmp_path):
    """ptxas' report for strip_mix_kernel, compiled as the probes' library
    is: no spill stores or loads and at most 128 registers, so 512 threads
    (WS 64) fit an SM."""
    src = os.path.join(ssv_cuda._CSRC, "roofline.cu")
    proc = ssv_cuda.compile_object(src, str(tmp_path / "roofline.o"))
    log = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, log
    entry = next(part for part in log.split("Compiling entry function")[1:]
                 if "strip_mix_kernel" in part.split("\n")[0])
    assert "0 bytes spill stores, 0 bytes spill loads" in entry, entry
    regs = int(entry.split("Used ")[1].split(" registers")[0])
    assert regs <= 128, entry


@pytest.mark.parametrize("name", roofline.MXU_VARIANTS)
def test_mxu_kernels_match_plain_at_ws_12(dev, name):
    x = roofline.make_inputs(name, 12, 30, dev)
    for reps in (1, 2, 3):
        got = roofline.op_mix(x, reps, copies=4)
        torch.cuda.synchronize()
        want = roofline.op_mix_plain(name, x, reps)
        for c in range(4):
            assert torch.equal(got[c], want), (name, reps, c)


@pytest.mark.parametrize("name", ["add8", "add16", "int8mix", "int16mix"])
@pytest.mark.parametrize("ws", [4, 12, 60, 64])
def test_narrow_kernels_at_the_layout_edges(dev, name, ws):
    """The narrow kernels equal their plain versions exactly, every one of 5
    copies, at reps 0-3 and K 1, 7 and 30: K < 8 keeps `bits` across reps
    (no flush), K = 30 leaves 6 rows a rep past its last flush. In the int8
    field layout (48 lanes a thread) 5 copies at WS 4 and 64 end in a thread
    that holds 16 of its lanes, and a thread's lanes cross from one copy
    into the next; at WS 12 and 60 they do not."""
    kernel = roofline.KERNEL_OF[name]
    for k in (1, 7, 30):
        x = roofline.make_inputs(name, ws, k, dev)
        for reps in range(4):
            before = roofline.ROOFLINE_LAUNCHES[kernel]
            got = roofline.op_mix(x, reps, copies=5)
            torch.cuda.synchronize()
            assert roofline.ROOFLINE_LAUNCHES[kernel] == before + 1
            want = roofline.op_mix_plain(name, x, reps)
            for c in range(5):
                assert torch.equal(got[c], want), (name, ws, k, reps, c)


def test_narrow_kernels_fill_the_card(dev):
    """fill_copies: one instance a block for add16 / int16mix; for the int8
    field kernels the copies whose lanes the resident threads hold."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in ("add8", "add16", "int8mix", "int16mix"):
        blocks = roofline.blocks_per_sm(name, 64, 30)
        copies = roofline.fill_copies(name, 64, 30, sms)
        if name in roofline.FIELD_VARIANTS:
            lanes = sms * blocks * roofline.FIELD_THREADS * roofline.FIELD_LANES
            assert copies == lanes // (64 * 512) >= 1
        else:
            assert copies == sms * blocks


def test_add16x2_wraps_every_halfword_pair(dev):
    """add16's add.u16x2 (SASS VIADD.16x2) on every pair of 16-bit values,
    in both halfwords, against the plain wrapping add, 2^28 pairs a launch."""
    lib = roofline.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    i = torch.arange(1 << 16, dtype=torch.int64, device=dev)
    step = 1 << 12
    for s0 in range(0, 1 << 16, step):
        s = torch.arange(s0, s0 + step, dtype=torch.int64, device=dev)
        lo = s.repeat_interleave(1 << 16)
        hi = i.repeat(step)
        a = lo | (hi << 16)  # the high halfwords take the pair swapped
        b = hi | (lo << 16)
        want = ((lo + hi) & 0xFFFF) * 0x10001
        a32 = (a - ((a >> 31) << 32)).to(torch.int32)
        b32 = (b - ((b >> 31) << 32)).to(torch.int32)
        out = torch.empty_like(a32)
        rc = lib.hv_roofline_add16x2(a32.data_ptr(), b32.data_ptr(),
                                     a32.numel(), out.data_ptr(), stream)
        assert rc == 0
        got = out.to(torch.int64) & 0xFFFFFFFF
        assert torch.equal(got, want), s0
        del lo, hi, a, b, a32, b32, out, got, want


def test_runtime_table_on_the_card_equals_the_cpu(dev, monkeypatch):
    """The tool's genomic rows on the card and on the CPU: the same hits;
    the card's launches counted and sampled hits re-derived."""
    made = []

    class Recording(Havac):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(runtime_table, "Havac", Recording)
    argv = ["--synthetic", "--lengths", "600", "--seq-len", "200000",
            "--composition", "genomic"]
    assert runtime_table.main([*argv, "--device", "cpu"]) == 0
    before = ssv_cuda.LAUNCHES
    assert runtime_table.main([*argv, "--verify-sample", "100"]) == 0
    assert ssv_cuda.LAUNCHES > before
    cpu, card = made
    assert card.device.type == "cuda" and len(card.hits()) > 0
    assert card.hits().as_tuples() == cpu.hits().as_tuples()


def test_scaling_mesh_on_the_card_counts_kernel_launches(dev, tmp_path):
    out = tmp_path / "mesh.json"
    assert scaling_mesh.main(["--seq-len", "131072", "--positions", "512",
                              "--rows-per-step", "128", "--devices", "1",
                              "4", "--iters", "1", "--json", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["kernel_launches"] - r["regrows"] for r in rows] == [4, 16]
    assert [r["steps"] for r in rows] == [4, 7]


@pytest.mark.parametrize("card,dense", [(4, False), (4, True), (20, True)])
def test_bench_chain_matches_plain(dev, card, dense):
    """kbench's chain on the card: each dispatch's keys and count, and the
    chain's state and carry, equal the plain version chained the same way,
    in the narrow and the wide geometry."""
    for B, W in ((2, 3072), (1, 1_000_003)):
        codes, scores = kbench.swar_inputs(B, 60, W, dense, card)
        chain = kbench.Chain(torch.from_numpy(codes).to(dev),
                             torch.from_numpy(scores).to(dev), n_hi=3)
        before = ssv_cuda.LAUNCHES
        chain.fit()
        assert ssv_cuda.LAUNCHES == before + 3
        want, st = chain.state0, chain.state0
        for k in range(3):
            st = chain.step(st, k)
            torch.cuda.synchronize()
            keys, want, carry = ssv_sweep_plain(chain.symbols, chain.scores,
                                                want, chain.carry0)
            n = int(chain.counts[k])
            assert n == keys.numel() == chain.expected[k]
            assert torch.equal(torch.sort(chain.keys[:n]).values, keys)
            assert torch.equal(st, want)
            assert torch.equal(chain.outs[k].final_carry, carry)


def test_bench_dense_cap_equals_the_count(dev, monkeypatch):
    monkeypatch.setattr(kbench, "FIRST_CAP", 64)
    codes, scores = kbench.swar_inputs(1, 300, 40_000, dense=True)
    p = kbench.bench_point(codes, scores, iters=2, device=dev)
    assert p["regrows"] == 1 and p["key_cap"] == max(p["counts"]) > 64
    assert p["launches"] == kbench.N_HI + 2 * (kbench.N_LO + kbench.N_HI)
    assert p["hits"] == ssv_cuda.ssv_sweep(
        torch.from_numpy(codes).to(dev), torch.from_numpy(scores).to(dev)
    ).count
    assert p["bound_ms"] > 0 and p["threads"] in (64, 256)
