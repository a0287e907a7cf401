"""Drive the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device  — the card's name and ``nvidia-smi`` name/power limit; fails
             without CUDA.
2. build   — compiles havac_tpu_torch/csrc/ssv_sweep.cu (nvcc, sm_90a)
             into the sweep's library, the one a search loads, and prints
             ptxas' registers, spills and shared memory a kernel.
3. kernel  — the CUDA sweep kernel against its plain PyTorch version on the
             card, exactly (sorted keys, count, final state and carry):
             card 4 and 20, with and without reset rows, non-zero boundary
             state, ragged sizes, a key buffer smaller than the hit count
             (the regrow path), one case against a numpy oracle, and the
             word kernel's edges: L not a multiple of a block's diagonals,
             P > L, P of 1, a block in both triangles, dense hits (many a
             warp and row), offsets at the key limits, card 20 and card 5
             (the table match) with reset rows, and a sequence long enough
             for the wide (256-thread) blocks, which the shorter cases leave
             to the narrow (64-thread) ones.
4. main    — the published 10k-position point: a 50,818,468-position random
             chromosome (chr22's length) against ~10k positions of synthetic
             models at p = 0.02, through Havac(device="cuda") load_phmm /
             load_sequence / warmup / run / hits. Checks that the kernel ran
             once per chunk, that the first column chunk's hits equal the
             plain version's on the card, and that a sample of raw hits
             re-derives by bounded re-SSV.
5. timing  — the kernel and the plain version at one main-path chunk shape,
             card 4 (the main path's) and card 20 (random codes and scores
             at the same shape); the interior hit window's SASS count
             (``havac_tpu_torch.tools.sass`` ``fast_path``) as SASS a word
             and row, and the issue share it implies at the measured time.
6. percell — the per-cell DP readouts of havac_tpu_torch.testing.percell on
             the card: dp_matrix_kernel (one launch of the row dump, the
             sweep's word body in the dump's geometry) against
             dp_matrix_torch (the plain version) cell for cell at full model
             width (the main path's 10,020 projected rows x the first
             262,144 positions of the chromosome), twice more into buffers
             prefilled with 0x00 and 0xFF (every cell written), each with
             keys, count, state and carry equal to an undumped launch's; a
             card-20 case and a case with reset rows and a non-zero carry
             column; a dump into a view 7 bytes into its buffer (nothing
             written around it); dp_matrix_rows (one launch per row) on 512
             rows against the dump; the dump's, the undumped kernel's and
             the plain version's times, the dump's geometry (warps an SM),
             SASS a cell and share of its byte bound.
7. scan    — the chromosome as 4 FASTA files through
             Havac(device="cuda").scan_files, each file's hits against a
             fresh run on that file; the ``serve`` subcommand as a
             subprocess answering two of the files, a missing path (an error
             line, the server stays up) and ``quit``; one ``benchmark``
             subcommand on one file.
8. roofline — builds havac_tpu_torch/csrc/roofline.cu into the probes' own
             library (printing ptxas' report as phase 2 does); the op-mix
             roofline kernels (roofline_op_mix, roofline_add_chain,
             roofline_narrow_mix, roofline_strip, roofline_mxu) at K = 30,
             each variant at its
             largest WS (64; 48 for mxumatch / mxumatch8, whose warps'
             rings of packed match words live in shared memory): every copy
             of every one of the 15 variants against its plain version on
             the card, exactly, at reps 1-3 (the three match-precompute
             variants also at WS 12 and 8); the plain versions' times; then
             the tool's own entry point (``python -m
             havac_tpu_torch.tools.roofline``) times each kernel
             differentially, stripmatch beside ``current`` at WS 64 and at
             WS 12 (filling the card, and at 132 copies), and mxumatch* at
             WS 8, 12 and 48 beside ``current`` at the same WS, with warps
             an SM and SASS a word and row (stripmatch's with its
             shared-memory bytes a clock); it fails a variant whose rate
             would need more instructions than the card issues, and a
             stripmatch whose row loop stores no plane or loads none. The narrow variants (add8, add16, int8mix, int16mix)
             print their row loops' SASS a 32-bit word and row split by
             pipe, with the issue and INT32 shares it implies, beside
             `current`'s; add16 and int16mix their bounds (the kernels
             line shows add8 and int8mix). Copies fill the card once
             (``roofline.fill_copies``). Prints the current/perrow
             GCUPS-equiv beside the main path's sweep GCUPS.
9. mesh    — the 1-D wavefront (havac_tpu_torch.parallel): (a) the main
             workload through Havac(device="cuda", mesh=ShardMesh([cuda:0] x
             4)) at 128 rows a step (the JAX default) and at 1,024: hits
             and raw keys equal phase 4's, one launch per active (shard,
             step) pair, a sample of hits re-derives; D, R, S, T,
             launches, sweep seconds, GCUPS beside phase 4's and the host
             phases printed; (b) NCCL at world size 1 (one process on a
             localhost TCP store, D = 1) equal to phase 4; (c) two
             processes on cuda:0 joined by gloo, two shards each
             (havac_tpu_torch.testing.multihost_worker, each under a
             timeout), over the chromosome's first 8 Mb at the full model
             width: their hits together equal a single-device run of the
             cut; (d) at that cut, D = 4 on cuda:0, a run aborted after its
             first step checkpoint ends ABORTED and a resume from it equals
             the single-device run. One GPU: no multi-GPU number comes from
             this phase (NCCL refuses two ranks on one GPU).
10. mesh2d — the 2-D (sequence x model) mesh
             (havac_tpu_torch.parallel.swar_dist2d), all on cuda:0: (a) the
             main workload through Havac(device="cuda",
             mesh=sequence_model_mesh(2, ...), isolate_models=True) at 2 x 2
             and 4 x 2 shards, R = 1,024: hits and raw keys equal a
             single-device isolated run, one launch per active (group,
             shard, step), a sample of hits re-derives; D_seq, D_model, the
             group bounds, rows and S, T, launches, sweep seconds, GCUPS
             beside phase 4's and the isolated run's, device time and idle
             share and the host phases printed; (b) at the 8 Mb cut, 2 x 2,
             R = 128, a run aborted after its first step checkpoint ends
             ABORTED and a resume equals the single-device isolated run of
             the cut; (c) two gloo processes on cuda:0, each one seq shard
             of both model groups (seams cross processes), at the cut with
             a checkpoint path: their hits together equal that run, each
             logs the single-process warning and writes no checkpoint; (d)
             the dry run, parallel.dryrun.dryrun_multichip(8, "cuda:0").
             Prints the phase's wall time.
11. tools  — the measurement tools (havac_tpu_torch.tools), each through
             its own entry point on the card: (a) runtime_table --synthetic
             --composition uniform at 1,007 / 10,122 / 50,120 / 150,043
             model positions against the 50,818,468-position chromosome,
             and (b) --composition genomic at 10,122 and 150,043: every
             row's hits equal the JAX engine's record
             (benchmarks/runtime_table_r5*.json), 10,000 sampled raw hits
             re-derive, the native core is active, launches = chunks +
             regrows; (c) the file form: (a)'s 10,122 workload written as
             .hmm / FASTA equals the record, hmm_db_by_length cuts a written
             150,043-position collection at 1,000 / 10,000 / 50,000 (each
             the shortest prefix), and runtime_table --hmm --fasta on the
             10,000 cut equals the same models loaded as objects; (d)
             scaling_mesh at 16,777,216 x 4,096, R = 1,024, D = 1, 2, 4, 8
             on cuda:0: hits equal across D, steps = S + D - 1, launches =
             S * D; (e) hostbench at 83,000 keys a chunk and at phase 4's
             hits a launch; and an amino search (a planted card-20
             collection of 4,000 positions against 6,000,000 residues):
             the first 262,144 residues' hits equal the CPU engine's,
             sampled hits re-derive, GCUPS beside phase 4's. Prints each
             row with its regrows and host phases, and the phase's wall.
12. bench  — the benchmarks' entry points: (a) ``python -m
             havac_tpu_torch.bench`` as a subprocess (the headline: the
             sweep kernel at 8,515,584 x 4,080, 9 against 1 dispatches
             chained through the row state, timed by CUDA events), its one
             JSON line checked (keys, the card's name and power limit, the
             59 launches it reports of its own); (b) at that shape one
             dispatch and a 2-dispatch chain equal the plain version
             exactly (keys, count, state, carry); (c)
             ``havac_tpu_torch.tools.kbench`` through its main at card 4
             for B = 2, 4, 8, 22 (W = 387,072), dense at B = 2, card 20 at
             W = 196,608 and the unpacked draw, its launches counted from
             0 just before and equal to 9 + 10 x iters a point, and each
             point's last timed chain (9 dispatches, at the timed shape)
             equal to the plain version chained the same way: every
             dispatch's count, the last one's keys, state and carry; (d)
             each point's GCUPS, kernel ms, bound, share, hits, key buffer
             and geometry, and the phase's wall.

Each path is driven with the launch counters set to 0 just before it and
read just after; the run fails if a kernel of the path did not launch. The
line before the last is the kernels' JSON record (the sweep's launches are
the main path's, phase 4's; phase 12's stand in fields of their own:
``bench_launches``, kbench's, counted from 0 just before its runs, and
``bench_process_launches_reported``, the bench subprocess's own count as
it printed it), with each kernel's bound:
the larger of its bytes over the card's memory rate and its operations over
the card's peak rate for them: ``MIN_OPS`` instructions a word and row over
the card's issue lanes, and its logic instructions over the INT32 lanes, at
the maximum SM clock (the sweep and the dump: ``current``'s counts, one
word per 3 cells). The sweep kernel's share of the measured ``current``
ceiling is printed beside it. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

from havac_tpu_torch import bench
from havac_tpu_torch.engine import Havac, HavacRunState, cli
from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.ops.ssv_torch import MAX_POS, MAX_ROW, ssv_sweep_plain
from havac_tpu_torch.parallel.dryrun import dryrun_multichip
from havac_tpu_torch.scoring.reprojection import project_models
from havac_tpu_torch.parallel.multihost import (ShardMesh,
                                                global_sequence_mesh,
                                                initialize,
                                                sequence_model_mesh)
from havac_tpu_torch.testing.multihost_worker import AbortAfterCheckpoint
from havac_tpu_torch.testing.percell import (compare_matrices,
                                             dp_matrix_kernel, dp_matrix_rows,
                                             dp_matrix_torch)
from havac_tpu_torch.io.hmm import read_hmm, write_hmm
from havac_tpu_torch.testing.generator import generate_planted_fixture
from havac_tpu_torch.testing.workload import (CHR22_LENGTH, write_fasta,
                                              write_workload)
from havac_tpu_torch.tools import (hmm_db_by_length, hostbench, kbench,
                                   narrow_time, roofline, runtime_table, sass,
                                   scaling_mesh)
from havac_tpu_torch.tools.roofline import HBM_BYTES_PER_S, bound

SEED = 7
MODEL_POSITIONS = 10020  # tools/runtime_table.py's 10k point
P_VALUE = 0.02
SOURCE = "havac_tpu_torch/csrc/ssv_sweep.cu"
REPLACES = "havac_tpu/ops/ssv_swar.py:542; havac_tpu/ops/ssv_pallas.py:167"
DUMP_REPLACES = ("havac_tpu/ops/ssv_swar.py:542 (debug_rows); "
                 "havac_tpu/testing/percell.py:62 (_ssv_pallas_jit row "
                 "readout)")
PERCELL_POSITIONS = 262_144
PERCELL_ROWS_BY_LAUNCH = 512
SCAN_FILES = 4
ROOT = os.path.dirname(os.path.abspath(__file__))
ROOFLINE_SOURCE = "havac_tpu_torch/csrc/roofline.cu"
ROOFLINE_REPLACES = {
    "roofline_op_mix": "tools/roofline.py:293 (make_variant -> kernel :241)",
    "roofline_add_chain": "tools/roofline.py:500 (make_variant -> kernel_add "
                          ":485)",
    "roofline_narrow_mix": "tools/roofline.py:569 (make_variant -> kernel8 "
                           ":520)",
    "roofline_strip": "tools/roofline.py:373 (make_variant -> kernel_strip "
                      ":323)",
    "roofline_mxu": "tools/roofline.py:464 (make_variant -> kernel_mxu :409)",
}
# The variant whose times stand for each kernel in the kernels line.
ROOFLINE_SHOWN = {"roofline_op_mix": "current", "roofline_add_chain": "add8",
                  "roofline_narrow_mix": "int8mix",
                  "roofline_strip": "stripmatch", "roofline_mxu": "mxumatch"}
ROOFLINE_ROWS = 30
ROOFLINE_LO, ROOFLINE_HI = 64, 4160
MATCH_PRECOMPUTE = ("stripmatch", "mxumatch", "mxumatch8")
STRIP_SMALL_WS = 12  # the largest WS whose K = 30 planes all fit a block
MESH_SHARDS = 4
MESH_ROWS = (128, 1024)  # rows a step: the JAX engine's default, and larger
MESH_CUT = 8_000_000  # positions of the chromosome in (c) and (d)
MESH_WORKERS = 2
WORKER_TIMEOUT = 300
MESH2D_GRIDS = ((2, 2), (4, 2))  # (D_seq, D_model) of phase 10 (a)
# Phase 11: the JAX engine's hit counts on runtime_table's synthetic
# workloads (p = 0.02, 50,818,468 positions), by model positions.
RUNTIME_RECORDS = {"uniform": "benchmarks/runtime_table_r5.json",
                   "genomic": "benchmarks/runtime_table_r5_genomic.json"}
RUNTIME_LENGTHS = {"uniform": (1007, 10122, 50120, 150043),
                   "genomic": (10122, 150043)}
VERIFY_SAMPLE = 10_000
FILE_POSITIONS = 10122  # (c): (a)'s workload at this size, written out
DB_CUTS = (1000, 10000, 50000)  # hmm_db_by_length cuts of 150,043 positions
SCALING_ARGS = ("--seq-len", "16777216", "--positions", "4096",
                "--rows-per-step", "1024", "--devices", "1", "2", "4", "8")
AMINO_MODELS, AMINO_LENGTH = 20, 200  # 4,000 model positions
AMINO_RESIDUES = 6_000_000
AMINO_PREFIX = 1 << 18  # residues the CPU engine (the plain route) sweeps
RESOLVED = ("sequence_index", "sequence_position", "phmm_index",
            "phmm_position")
# Phase 12: the headline's keys and kbench's runs (each through its main).
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "gcups_median",
                 "iters", "native_active", "device", "kernel_ms", "bound_ms",
                 "bound_share", "hits", "L", "P", "torch", "cuda")
KBENCH_RUNS = (["--sweep-blocks", "2", "4", "8", "22"],
               ["--dense", "--blocks", "2"],
               ["--card", "20", "--width", "196608"],
               ["--kernel", "unpacked"])


def log(msg: str) -> None:
    print(msg, flush=True)


def numpy_oracle(sym, scores, init_state, init_carry, reset):
    """Row-vectorised numpy SSV recurrence (hits as sorted keys)."""
    L, P = sym.shape[0], scores.shape[0]
    row = init_state.astype(np.int64).copy()
    carry = np.empty(P + 1, np.int64)
    carry[0] = row[L - 1]
    keys = []
    for j in range(P):
        shifted = np.concatenate([[init_carry[j]], row[:-1]])
        if reset is not None and reset[j]:
            shifted[:] = 0
        s = shifted + scores[j].astype(np.int64)[sym]
        hit = s >= 256
        row = np.where((s < 0) | hit, 0, s)
        keys.append((np.int64(j) << 38) | np.nonzero(hit)[0].astype(np.int64))
        carry[j + 1] = row[L - 1]
    return np.concatenate(keys), row, carry


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def compare(tag, got, want) -> int:
    """Exact comparison of (keys, state, carry); returns the max abs error.
    Keys are sorted where they lie (on the card for CUDA tensors)."""
    gk = torch.sort(torch.as_tensor(got[0])).values
    wk = torch.sort(torch.as_tensor(want[0]).to(gk.device)).values
    if gk.shape != wk.shape or not torch.equal(gk, wk):
        raise AssertionError(f"{tag}: hit keys differ "
                             f"({gk.numel()} vs {wk.numel()})")
    err = 0
    for name, g, w in (("final_state", got[1], want[1]),
                       ("final_carry", got[2], want[2])):
        d = np.abs(_np(g).astype(np.int64) - _np(w).astype(np.int64))
        err = max(err, int(d.max(initial=0)))
        if err:
            raise AssertionError(f"{tag}: {name} differs by {err}")
    return err


def phase_kernel(dev) -> int:
    rng = np.random.default_rng(SEED)
    cases = [  # (tag, L, P, card, reset, nonzero boundary, cap)
        ("card4", 100_003, 97, 4, False, True, 1 << 20),
        ("card4-reset", 77_777, 131, 4, True, True, 1 << 20),
        ("card20", 50_001, 203, 20, False, True, 1 << 20),
        ("card20-reset", 40_009, 61, 20, True, False, 1 << 20),
        ("regrow", 30_011, 45, 4, False, True, 17),
        ("tall-narrow", 300, 2_000, 4, False, True, 1 << 20),
        # the word kernel's edges (narrow blocks below ~811k positions)
        ("ragged-l", 3 * 1536 * 7 + 1001, 70, 4, False, True, 1 << 20),
        ("p-above-l", 900, 2_500, 4, True, True, 1 << 20),
        ("p-of-1", 50_000, 1, 4, False, True, 1 << 20),
        ("both-triangles", 1_000, 1_200, 20, False, True, 1 << 20),
        ("dense", 20_000, 40, 4, False, True, 1 << 20),
        ("key-limits", 9_000, 64, 4, True, True, 1 << 20),
        ("card5-tables", 12_345, 99, 5, True, True, 1 << 20),
        ("wide-blocks", 1_000_003, 37, 4, True, True, 1 << 20),
    ]
    worst = 0
    for tag, L, P, card, with_reset, boundary, cap in cases:
        sym = rng.integers(0, card, L).astype(np.uint8)
        sc = rng.integers(-40, 70, (P, card)).astype(np.int8)
        if tag == "dense":
            sc = np.maximum(sc, 100).astype(np.int8)
        offsets = ((MAX_ROW - P, MAX_POS - L) if tag == "key-limits"
                   else (5, 11))
        ist = (rng.integers(0, 256, L) if boundary
               else np.zeros(L)).astype(np.int32)
        icr = (rng.integers(0, 256, P + 1) if boundary
               else np.zeros(P + 1)).astype(np.int32)
        rr = ((rng.random(P) < 0.1).astype(np.int32) if with_reset
              else None)
        t = [torch.from_numpy(a).to(dev) for a in (sym, sc, ist, icr)]
        trr = None if rr is None else torch.from_numpy(rr).to(dev)
        res = ssv_cuda.ssv_sweep(*t, reset_rows=trr, row_offset=offsets[0],
                                 pos_offset=offsets[1], cap=cap)
        torch.cuda.synchronize()
        plain = ssv_sweep_plain(*t, trr, *offsets)
        err = compare(tag, (res.keys, res.final_state, res.final_carry),
                      plain)
        if res.count != plain[0].numel():
            raise AssertionError(f"{tag}: count {res.count} != "
                                 f"{plain[0].numel()}")
        if tag == "regrow" and not res.regrown:
            raise AssertionError("regrow case did not overflow its buffer")
        if tag == "dense" and res.count <= L * P // 4:
            raise AssertionError(f"dense case has only {res.count} hits")
        worst = max(worst, err)
        log(f"[kernel] {tag}: L={L} P={P} card={card} reset={with_reset} "
            f"hits={res.count} regrown={res.regrown} exact")
    # One small case against the independent numpy oracle.
    sym = rng.integers(0, 4, 2_000).astype(np.uint8)
    sc = rng.integers(-40, 120, (40, 4)).astype(np.int8)
    ist = rng.integers(0, 256, 2_000).astype(np.int32)
    icr = rng.integers(0, 256, 41).astype(np.int32)
    rr = (rng.random(40) < 0.2).astype(np.int32)
    res = ssv_cuda.ssv_sweep(
        *[torch.from_numpy(a).to(dev) for a in (sym, sc, ist, icr)],
        reset_rows=torch.from_numpy(rr).to(dev))
    want = numpy_oracle(sym, sc, ist, icr, rr)
    worst = max(worst, compare("numpy-oracle", (res.keys, res.final_state,
                                                res.final_carry), want))
    log(f"[kernel] numpy-oracle: hits={res.count} exact")
    return worst


def cuda_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    fn()  # warm
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over two (P, L) matrices, a band of rows at a time."""
    band = max(1, (1 << 24) // a.shape[1])
    err = 0
    for r0 in range(0, a.shape[0], band):
        d = a[r0:r0 + band].int() - b[r0:r0 + band].int()
        err = max(err, int(d.abs().max()))
    return err


def same_matrix(tag: str, want: torch.Tensor, got: torch.Tensor) -> int:
    if want.shape != got.shape:
        raise AssertionError(f"{tag}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = max_abs_err(want, got)
    if err:
        raise AssertionError(f"{tag}: cells differ by up to {err}; first: "
                             f"{compare_matrices(want, got, max_report=8)}")
    return err


def sweep_sass() -> dict:
    """SASS a word and row of the word kernel's interior hit window, per
    instantiation of its wide (256-thread, 2-word) blocks, which the main
    path's chunks run, and of the row dump (its own geometry): the smallest
    forward-branch pass of a window's loop, over the window's rows and a
    thread's words. A window's loop has no barrier (the dump's: one, its
    staged rows' hand-over), lies in no other such loop (the partial-window
    and replay loops lie in it) and its pass has the window's votes: the
    hit vote, and with reset rows the ballot of the window's reset rows."""
    kernels = sass.parse(sass.disassemble(ssv_cuda.library_path()))
    dump_geo = f"ELi{ssv_cuda.DUMP_THREADS}ELi{ssv_cuda.DUMP_WORDS}ELb1E"
    out = {}
    for tag, args, words, bars, votes in (
            ("card4", "ILb1ELb0ELi256ELi2ELb0E", ssv_cuda.KERNEL_WORDS, 0, 1),
            ("card4-reset", "ILb1ELb1ELi256ELi2ELb0E", ssv_cuda.KERNEL_WORDS,
             0, 2),
            ("tables", "ILb0ELb0ELi256ELi2ELb0E", ssv_cuda.KERNEL_WORDS, 0,
             1),
            ("dump", "ILb1ELb0" + dump_geo, ssv_cuda.DUMP_WORDS, 1, 1)):
        name = next(n for n in kernels
                    if "ssv_word_kernel" in n and args in n)
        spans = [(a, b) for a, b, counts, _ in sass.loops(kernels[name])
                 if counts["bar"] == bars]
        passes = [sass.fast_path(kernels[name], a, b) for a, b in spans
                  if not any(c <= a and b <= d and (c, d) != (a, b)
                             for c, d in spans)]
        out[tag] = min(p["total"] for p in passes if p["VOTE"] == votes) / (
            ssv_cuda.WINDOW_ROWS * words)
    return out


def roofline_sass() -> tuple[dict, dict, dict]:
    """SASS a word and row of `current` (op_mix_kernel<0>: its row loop, one
    barrier a row, over a thread's 16 words), of stripmatch
    (strip_mix_kernel: its row loop, one barrier a row, which also builds
    a plane ahead, over a thread's 16 words; the loop must store that plane
    and load the row's, or the probe prices nothing) and of
    mxumatch8 / mxumatch (mxu_mix_kernel<1> / <2>: the tile loop, 3
    products a tile, over a group's 32 tiles, plus the row loop over the
    group's 8 rows, all over the group's 8 rows x 16 words); and of the
    narrow variants (add8, add16, int8mix, int16mix: their row loops a
    32-bit output word, split by pipe, as
    ``havac_tpu_torch.tools.narrow_time`` counts them)."""
    kernels = sass.parse(sass.disassemble(
        ssv_cuda.library_path(*roofline.LIBRARY)))
    narrow = {name: narrow_time.row_sass(kernels, name)
              for name in narrow_time.NARROW}

    def loops_of(pattern):
        name = next(n for n in kernels if pattern in n)
        return sass.loops(kernels[name])

    row = min(n for _, _, c, n in loops_of("op_mix_kernelILi0E")
              if c["bar"] == 1)
    out = {"current": row / 16}
    kernel = kernels[next(n for n in kernels if "strip_mix_kernel" in n)]
    start, end, _, n = min((loop for loop in sass.loops(kernel)
                            if loop[2]["bar"] == 1), key=lambda x: x[3])
    ops = Counter(op for a, op, _ in kernel["insns"] if start <= a <= end)
    if ops["STS"] < 4 or ops["LDS"] < 4:  # a plane's 4 STS.128 / LDS.128
        raise AssertionError(f"strip_mix_kernel's row loop: {ops['STS']} STS, "
                             f"{ops['LDS']} LDS (4 each at least)")
    strip = {"loop": n / 16, "sts": ops["STS"], "lds": ops["LDS"],
             "imad": ops["IMAD"] / 16,
             "pass": sass.fast_path(kernel, start, end)["total"] / 16}
    out["stripmatch"] = strip["loop"]
    for name, b in (("mxumatch8", 1), ("mxumatch", 2)):
        ls = loops_of(f"mxu_mix_kernelILi{b}E")
        tile_n, mma = min((n, c["mma"]) for _, _, c, n in ls
                          if c["mma"] > 0 and c["bar"] == 0)
        row_n = min(n for _, _, c, n in ls if c["bar"] == 1 and c["mma"] == 0)
        out[name] = (tile_n * 32 / (mma / 3) + row_n * 8) / (8 * 16)
    for name, n in narrow.items():
        out[name] = n["total"]
    return out, narrow, strip


def phase_percell(dev, engine, smi, dump_sass: float) -> dict:
    db = engine.database
    start = int(db.starts[0])
    codes = torch.from_numpy(np.ascontiguousarray(
        db.codes[start:start + PERCELL_POSITIONS])).to(dev)
    scores = torch.from_numpy(engine.scores).to(dev)
    P, L = scores.shape[0], codes.shape[0]

    start_ev, end_ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
    start_ev.record()
    want = dp_matrix_torch(codes, scores)
    end_ev.record()
    torch.cuda.synchronize()
    plain_ms = start_ev.elapsed_time(end_ev)

    ssv_cuda.LAUNCHES = ssv_cuda.DUMP_LAUNCHES = 0
    got = dp_matrix_kernel(codes, scores)
    torch.cuda.synchronize()
    launches = ssv_cuda.DUMP_LAUNCHES
    if launches == 0 or ssv_cuda.LAUNCHES != 0:
        raise AssertionError(f"dp_matrix_kernel: DUMP_LAUNCHES={launches}, "
                             f"LAUNCHES={ssv_cuda.LAUNCHES}")
    err = same_matrix("full width", want, got)
    log(f"[percell] dp_matrix_kernel == dp_matrix_torch at {P} x {L} "
        f"({P * L} cells), DUMP_LAUNCHES={launches}")
    undumped = ssv_cuda.ssv_sweep(codes, scores)
    for fill in (0x00, 0xFF):  # the wrapper dp_matrix_kernel launches
        got.fill_(fill)
        res = ssv_cuda.ssv_sweep(codes, scores, dump=got)
        err = max(err, same_matrix(f"prefilled 0x{fill:02X}", want, got))
        if res.count != undumped.count:
            raise AssertionError(f"dump count {res.count} != undumped "
                                 f"{undumped.count}")
        err = max(err, compare(f"dump 0x{fill:02X} vs undumped",
                               (res.keys, res.final_state, res.final_carry),
                               (undumped.keys, undumped.final_state,
                                undumped.final_carry)))
    log("[percell] dumps into buffers prefilled with 0x00 and 0xFF: exact "
        "(every cell written); keys, count, state and carry == an undumped "
        f"launch's ({undumped.count} hits)")
    del undumped

    ssv_cuda.LAUNCHES = 0
    rows = dp_matrix_rows(codes, scores[:PERCELL_ROWS_BY_LAUNCH])
    torch.cuda.synchronize()
    if ssv_cuda.LAUNCHES != PERCELL_ROWS_BY_LAUNCH:
        raise AssertionError(f"dp_matrix_rows: LAUNCHES={ssv_cuda.LAUNCHES}")
    err = max(err, same_matrix("rows", got[:PERCELL_ROWS_BY_LAUNCH], rows))
    log(f"[percell] dp_matrix_rows ({PERCELL_ROWS_BY_LAUNCH} launches) == the "
        f"dump on {PERCELL_ROWS_BY_LAUNCH} x {L}")
    del rows

    # Timing: the dump variant and the plain version at the same shape.
    out = ssv_cuda.SweepBuffers.empty(L, P, 1 << 20, dev)
    zs = torch.zeros(L, dtype=torch.int32, device=dev)
    zc = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: ssv_cuda.launch(codes, scores, zs, zc, None, 0, 0,
                                         out, dump=got), reps=5)
    undumped_ms = cuda_ms(lambda: ssv_cuda.launch(codes, scores, zs, zc, None,
                                                  0, 0, out), reps=5)
    nbytes = L + P * 4 + P * L  # symbols and scores read, every cell
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    blocks = -(-(L + P - 1) // (3 * ssv_cuda.DUMP_THREADS
                                * ssv_cuda.DUMP_WORDS))
    card = roofline.Card.query(dev)
    log(f"[percell] {P} x {L}: dump kernel {ms:.3f} ms, undumped kernel "
        f"{undumped_ms:.3f} ms, plain dp_matrix_torch {plain_ms:.3f} ms; {smi}")
    log(f"[percell] dump geometry: {ssv_cuda.DUMP_THREADS} threads x "
        f"{ssv_cuda.DUMP_WORDS} word a block, {blocks} blocks = "
        f"{blocks * ssv_cuda.DUMP_THREADS / 32 / card.sms:.2f} warps an SM; "
        f"{dump_sass / 3:.4f} SASS a cell ({dump_sass:.4f} a word and row, "
        f"interior hit window); byte bound {byte_ms:.4f} ms = "
        f"{byte_ms / ms:.4f} of the dump's time; {smi}")
    del want, got, out

    rng = np.random.default_rng(SEED + 1)
    for tag, Lc, Pc, card, carry_reset in (("card20", 100_003, 2_000, 20, False),
                                           ("carry-reset", 100_003, 2_000, 4,
                                            True)):
        sym = torch.from_numpy(rng.integers(0, card, Lc).astype(np.uint8)
                               ).to(dev)
        sc = torch.from_numpy(rng.integers(-40, 70, (Pc, card))
                              .astype(np.int8)).to(dev)
        icr = rr = None
        if carry_reset:
            icr = torch.from_numpy(rng.integers(0, 256, Pc + 1)
                                   .astype(np.int32)).to(dev)
            rr = torch.from_numpy((rng.random(Pc) < 0.05).astype(np.int32)
                                  ).to(dev)
        err = max(err, same_matrix(tag, dp_matrix_torch(sym, sc, icr, rr),
                                   dp_matrix_kernel(sym, sc, icr, rr)))
        log(f"[percell] {tag}: {Pc} x {Lc} card={card} exact")
    # A dump view 7 bytes into its buffer: the staging aligns by address.
    buf = torch.full((Pc * Lc + 23,), 0xA5, dtype=torch.uint8, device=dev)
    view = buf[7:7 + Pc * Lc].view(Pc, Lc)
    ssv_cuda.ssv_sweep(sym, sc, dump=view)
    err = max(err, same_matrix("unaligned", dp_matrix_torch(sym, sc), view))
    if not ((buf[:7] == 0xA5).all() and (buf[7 + Pc * Lc:] == 0xA5).all()):
        raise AssertionError("unaligned dump wrote outside its view")
    log(f"[percell] unaligned: {Pc} x {Lc} dump 7 bytes into its buffer exact")
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "cells": P * L, "bytes": nbytes}


def phase_scan(dev, engine, hmm, work) -> None:
    db = engine.database
    start, n = int(db.starts[0]), int(db.lengths[0])
    parts = np.array_split(db.codes[start:start + n], SCAN_FILES)
    paths = []
    for i, part in enumerate(parts):
        paths.append(os.path.join(work, f"part{i}.fasta"))
        write_fasta(paths[-1], f"synth-chr-part{i}", part)

    scanner = Havac(p_value=P_VALUE, device=dev).load_phmm(hmm)
    chunks = 0
    scanned = []
    t0 = time.perf_counter()
    ssv_cuda.LAUNCHES = 0
    for path, hits in scanner.scan_files(paths, prefetch=1):
        chunks += scanner.stats.num_chunks
        scanned.append((path, hits))
    launches = ssv_cuda.LAUNCHES
    t_scan = time.perf_counter() - t0
    if launches == 0 or launches != chunks:
        raise AssertionError(f"scan_files: LAUNCHES={launches} != "
                             f"chunks={chunks}")
    if [p for p, _ in scanned] != paths:
        raise AssertionError("scan_files yielded other files")
    log(f"[scan] scan_files over {len(paths)} files ({n} positions) in "
        f"{t_scan:.3f} s: hits {[len(h) for _, h in scanned]}, "
        f"LAUNCHES={launches}")
    for path, hits in scanned:
        fresh = Havac(p_value=P_VALUE, device=dev).load_phmm(hmm)
        want = fresh.load_sequence(path).run().hits()
        if len(hits) == 0 or hits.as_tuples() != want.as_tuples():
            raise AssertionError(f"{path}: scan_files {len(hits)} hits, "
                                 f"a fresh run {len(want)}")
    log("[scan] every file's hits equal a fresh Havac(device='cuda') run")

    missing = os.path.join(work, "missing.fasta")
    req = f"{paths[0]}\n\n{paths[1]}\n{missing}\nquit\n"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "havac_tpu_torch.engine.cli", "serve",
         "--hmm", hmm, "--device", "cuda", "--pvalue", str(P_VALUE)],
        input=req, capture_output=True, text=True, timeout=600, cwd=ROOT)
    if res.returncode != 0:
        raise AssertionError(f"serve exited {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    lines = [json.loads(ln) for ln in res.stdout.splitlines()]
    want = [{"ready": True, "models": len(engine.models)}]
    if (len(lines) != 4 or lines[0] != want[0]
            or [ln.get("hits") for ln in lines[1:3]]
            != [len(h) for _, h in scanned[:2]]
            or lines[3].get("file") != missing or "error" not in lines[3]):
        raise AssertionError(f"serve answered {lines}")
    log(f"[scan] serve ({time.perf_counter() - t0:.3f} s): "
        + " | ".join(json.dumps(ln) for ln in lines))

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["benchmark", "--hmm", hmm, "--fasta", paths[0],
                       "--device", "cuda", "--pvalue", str(P_VALUE)])
    report = json.loads(buf.getvalue())
    if (rc != 0 or report["num_hits"] != len(scanned[0][1])
            or report["backend"] != "cuda"):
        raise AssertionError(f"benchmark rc={rc}: {report}")
    log(f"[scan] benchmark {os.path.basename(paths[0])}: "
        f"{json.dumps(report)}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def same_hits(tag, got, want) -> None:
    """Resolved columns in order and raw (row, position) pairs, exactly."""
    a, b = got.hits(), want.hits()
    if len(a) != len(b) or not all(
            np.array_equal(getattr(a, f), getattr(b, f)) for f in RESOLVED):
        raise AssertionError(f"{tag}: {len(a)} hits, want {len(b)}")
    for x, y in zip(got.raw_hits(), want.raw_hits()):
        if not np.array_equal(x, y):
            raise AssertionError(f"{tag}: raw hits differ ({x.size} vs "
                                 f"{y.size})")


def mesh_run(tag, dev, engine, mesh, rows, smi, main_gcups,
             label="mesh", yardstick="phase 4's", **kw) -> Havac:
    """The main workload on ``mesh`` (``kw``: more engine options); checks
    its launches (one per active (group, shard, step), plus regrows) and
    its hits against ``engine`` and prints its geometry, rate and host
    phases."""
    ssv_cuda.LAUNCHES = 0
    e = Havac(p_value=P_VALUE, device=dev, mesh=mesh, dist_rows_per_step=rows,
              **kw)
    e.load_phmm(engine.models).load_sequence(engine.database)
    t0 = time.perf_counter()
    e.run()
    wall = time.perf_counter() - t0
    launches = ssv_cuda.LAUNCHES
    st, geo = e.stats, e.stats.chunk_geometry
    active = geo["shards"] * sum(geo.get("group_row_chunks",
                                         [geo["row_chunks"]]))
    if (geo["launches"] != active
            or launches != geo["launches"] + st.overflow_retries):
        raise AssertionError(f"{tag}: LAUNCHES={launches}, geometry {geo}, "
                             f"regrows {st.overflow_retries}")
    same_hits(tag, e, engine)
    log(f"[{label}] {tag}: D={geo['shards']} R={geo['rows_per_step']} "
        f"S={geo['row_chunks']} T={geo['steps']} launches={geo['launches']} "
        f"(LAUNCHES={launches}, regrows={st.overflow_retries}) shard width "
        f"{geo['shard_width']}: sweep {st.sweep_seconds:.4f} s (run "
        f"{wall:.3f} s), {st.gcups:.2f} GCUPS beside phase 4's "
        f"{main_gcups:.2f}; hits {len(e.hits())} and raw keys == "
        f"{yardstick}; {smi}")
    log(f"[{label}] {tag} phases "
        f"{json.dumps({k: round(v, 4) for k, v in st.pipeline_prof.items()})}")
    # One launch at the run's shape (a shard of the chromosome x R rows),
    # timed alone: launches x its time is the run's device time, the rest
    # of the sweep the device's idle share.
    W, rows = geo["shard_width"], geo["rows_per_step"]
    start = int(engine.database.starts[0])
    sym = torch.from_numpy(np.ascontiguousarray(
        engine.database.codes[start:start + W])).to(dev)
    sc = torch.from_numpy(engine.scores[:rows]).to(dev)
    out = ssv_cuda.SweepBuffers.empty(sym.shape[0], rows, 1 << 20, dev)
    zs = torch.zeros(sym.shape[0], dtype=torch.int32, device=dev)
    zc = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: ssv_cuda.launch(sym, sc, zs, zc, None, 0, 0, out),
                 reps=5)
    busy = geo["launches"] * ms / 1e3
    log(f"[{label}] {tag}: one launch of {sym.shape[0]} x {rows} {ms:.4f} ms "
        f"({sym.shape[0] * rows / ms / 1e6:.2f} GCUPS); x {geo['launches']} "
        f"launches = {busy:.4f} s of device time, {busy / st.sweep_seconds:.4f}"
        f" of the sweep (idle {1 - busy / st.sweep_seconds:.4f}); {smi}")
    return e


def phase_mesh(dev, smi, engine, work, main_gcups) -> None:
    # (a) one process, D shards on cuda:0, at two step heights.
    for rows in MESH_ROWS:
        e = mesh_run(f"D={MESH_SHARDS} R={rows}", dev, engine,
                     ShardMesh([dev] * MESH_SHARDS), rows, smi, main_gcups)
        t0 = time.perf_counter()
        report = e.verify(sample=min(10_000, e.stats.num_raw_hits))
        if not report.all_verified:
            raise AssertionError(
                f"mesh R={rows}: {report.num_hits - report.num_verified} "
                "sampled hits failed")
        log(f"[mesh] R={rows}: verified {report.num_verified}/"
            f"{report.num_hits} sampled raw hits "
            f"({time.perf_counter() - t0:.3f} s)")
        del e

    # (b) NCCL at world size 1.
    import torch.distributed as dist

    initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl")
    try:
        mesh = global_sequence_mesh(devices=[dev])
        if mesh.backend != "nccl" or mesh.shape != {"seq": 1}:
            raise AssertionError(f"NCCL mesh {mesh}")
        mesh_run(f"NCCL world 1, {mesh}", dev, engine, mesh, MESH_ROWS[-1],
                 smi, main_gcups)
    finally:
        dist.destroy_process_group()

    # (c) two processes on cuda:0 joined by gloo, over a cut.
    db = engine.database
    start = int(db.starts[0])
    cut = os.path.join(work, "cut.fasta")
    write_fasta(cut, "synth-chr-cut", db.codes[start:start + MESH_CUT])
    hmm = os.path.join(work, "models.hmm")
    single = Havac(p_value=P_VALUE, device=dev).load_phmm(hmm)
    single.load_sequence(cut).run()
    t0 = time.perf_counter()
    ranks = run_workers("mesh", "engine", dev, 2,
                        os.path.join(work, "workers"), "--rows-per-step",
                        str(MESH_ROWS[0]), "--hmm", hmm, "--fasta", cut,
                        "--pvalue", str(P_VALUE))
    same_worker_hits("gloo workers", ranks, single)
    launches = [int(z["launches"]) for z in ranks]
    log(f"[mesh] {MESH_WORKERS} gloo processes x 2 shards on {dev} over "
        f"{MESH_CUT} positions x {engine.scores.shape[0]} rows "
        f"(R={MESH_ROWS[0]}): {len(single.hits())} hits together == a "
        f"single-device run's; launches {launches}; sweep seconds "
        f"{[round(float(z['sweep_seconds']), 4) for z in ranks]}, wall "
        f"{time.perf_counter() - t0:.3f} s with start-up; {smi}")

    # (d) abort after the first step checkpoint, then resume, at the cut.
    ckpt = os.path.join(work, "mesh.ckpt.npz")

    def cut_run(cls):
        e = cls(p_value=P_VALUE, device=dev,
                mesh=ShardMesh([dev] * MESH_SHARDS),
                dist_rows_per_step=MESH_ROWS[0], checkpoint_path=ckpt)
        return e.load_phmm(hmm).load_sequence(cut)

    first = cut_run(AbortAfterCheckpoint).run_async()
    if first.wait(timeout=600) != HavacRunState.ABORTED:
        raise AssertionError(f"aborted run ended {first.state}")
    if not os.path.exists(ckpt):
        raise AssertionError("no step checkpoint was written")
    ssv_cuda.LAUNCHES = 0
    second = cut_run(Havac).run()
    if second.resumed_chunks != 4 or os.path.exists(ckpt):
        raise AssertionError(f"resumed at {second.resumed_chunks}")
    if ssv_cuda.LAUNCHES != (second.stats.num_chunks
                             + second.stats.overflow_retries):
        raise AssertionError(f"resumed run: LAUNCHES={ssv_cuda.LAUNCHES}")
    same_hits("resumed mesh run", second, single)
    log(f"[mesh] abort after the step-4 checkpoint: {first.state.value}; the "
        f"resume from step {second.resumed_chunks} of "
        f"{second.stats.chunk_geometry['steps']} ({second.stats.num_chunks} "
        f"launches, LAUNCHES={ssv_cuda.LAUNCHES}) == the single-device run "
        f"({len(second.hits())} hits)")
    return cut


def run_workers(tag, case, dev, shards, out_dir, *args) -> list:
    """``MESH_WORKERS`` gloo processes of multihost_worker on ``dev``, each
    under ``WORKER_TIMEOUT``; their npz results in rank order."""
    os.makedirs(out_dir)
    init = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "havac_tpu_torch.testing.multihost_worker",
         "--case", case, "--init", init, "--world", str(MESH_WORKERS),
         "--rank", str(r), "--backend", "gloo", "--device", str(dev),
         "--shards", str(shards), "--out", out_dir, *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(MESH_WORKERS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{tag} worker {r} exited {p.returncode}:\n"
                                 f"{text[-4000:]}")
        log(f"[{tag}] gloo worker {r}: {text.strip().splitlines()[-1]}")
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
             for r in range(MESH_WORKERS)]
    for r, z in enumerate(ranks):
        prof = {k: round(v, 4) for k, v in json.loads(str(z["prof"])).items()}
        log(f"[{tag}] gloo worker {r} phases {json.dumps(prof)}")
    return ranks


def same_worker_hits(tag, ranks, single) -> None:
    """The workers' resolved and raw hits together == ``single``'s, and
    each worker's kernel count == its launches + regrows."""
    keys = ("si", "sp", "pi", "pp")
    cols = [np.concatenate([z[k] for z in ranks]) for k in keys]
    want = single.hits()
    order = np.lexsort((want.phmm_position, want.phmm_index,
                        want.sequence_position, want.sequence_index))
    got_order = np.lexsort(cols[::-1])
    if len(want) == 0 or not all(
            np.array_equal(c[got_order], getattr(want, f)[order])
            for c, f in zip(cols, RESOLVED)):
        raise AssertionError(f"{tag}: {cols[0].size} hits, a single "
                             f"device {len(want)}")
    raw = np.sort(np.concatenate([(z["rows"] << 38) | z["pos"]
                                  for z in ranks]))
    rows, pos = single.raw_hits()
    if not np.array_equal(raw, (rows << 38) | pos):
        raise AssertionError(f"{tag}: raw hits differ")
    launches = [int(z["launches"]) for z in ranks]
    if any(int(z["kernel_launches"]) != n + int(z["regrows"])
           for z, n in zip(ranks, launches)):
        raise AssertionError(f"{tag}: LAUNCHES "
                             f"{[int(z['kernel_launches']) for z in ranks]} "
                             f"!= launches {launches} + regrows")


def phase_mesh2d(dev, smi, engine, work, cut, main_gcups) -> None:
    t_phase = time.perf_counter()
    # (a) the main workload, isolated, on two 2-D meshes of cuda:0 shards,
    # against a single-device isolated run.
    ssv_cuda.LAUNCHES = 0
    iso = Havac(p_value=P_VALUE, device=dev, isolate_models=True)
    iso.load_phmm(engine.models).load_sequence(engine.database).run()
    if ssv_cuda.LAUNCHES != iso.stats.num_chunks + iso.stats.overflow_retries:
        raise AssertionError(f"isolated run: LAUNCHES={ssv_cuda.LAUNCHES}")
    log(f"[mesh2d] single-device isolated run: {iso.stats.num_chunks} "
        f"launches, sweep {iso.stats.sweep_seconds:.4f} s, "
        f"{iso.stats.gcups:.2f} GCUPS, {len(iso.hits())} hits; {smi}")
    prefix = engine.phmm_prefix
    for d_seq, d_model in MESH2D_GRIDS:
        mesh = sequence_model_mesh(d_model, devices=[dev] * (d_seq * d_model))
        tag = f"{d_seq}x{d_model} R={MESH_ROWS[-1]}"
        e = mesh_run(tag, dev, iso, mesh, MESH_ROWS[-1], smi, main_gcups,
                     label="mesh2d", yardstick="the isolated run's",
                     isolate_models=True)
        geo = e.stats.chunk_geometry
        b = geo["group_bounds"]
        rows = [int(prefix[b[m + 1]] - prefix[b[m]]) for m in range(d_model)]
        log(f"[mesh2d] {tag}: D_seq={d_seq} D_model={d_model} group bounds "
            f"{b} rows {rows} S {geo['group_row_chunks']} T={geo['steps']}; "
            f"{e.stats.gcups:.2f} GCUPS beside the isolated run's "
            f"{iso.stats.gcups:.2f} and phase 4's {main_gcups:.2f}")
        t0 = time.perf_counter()
        report = e.verify(sample=min(10_000, e.stats.num_raw_hits))
        if not report.all_verified:
            raise AssertionError(
                f"mesh2d {tag}: {report.num_hits - report.num_verified} "
                "sampled hits failed")
        log(f"[mesh2d] {tag}: verified {report.num_verified}/"
            f"{report.num_hits} sampled raw hits "
            f"({time.perf_counter() - t0:.3f} s)")
        del e
    del iso

    # (b) abort after the first step checkpoint, then resume, at the cut.
    hmm = os.path.join(work, "models.hmm")
    single = Havac(p_value=P_VALUE, device=dev, isolate_models=True)
    single.load_phmm(hmm).load_sequence(cut).run()
    ckpt = os.path.join(work, "mesh2d.ckpt.npz")

    def cut_run(cls):
        e = cls(p_value=P_VALUE, device=dev,
                mesh=sequence_model_mesh(2, devices=[dev] * 4),
                dist_rows_per_step=MESH_ROWS[0], isolate_models=True,
                checkpoint_path=ckpt)
        return e.load_phmm(hmm).load_sequence(cut)

    first = cut_run(AbortAfterCheckpoint).run_async()
    if first.wait(timeout=600) != HavacRunState.ABORTED:
        raise AssertionError(f"aborted 2-D run ended {first.state}")
    if not os.path.exists(ckpt):
        raise AssertionError("no 2-D step checkpoint was written")
    ssv_cuda.LAUNCHES = 0
    second = cut_run(Havac).run()
    if second.resumed_chunks != 4 or os.path.exists(ckpt):
        raise AssertionError(f"2-D resumed at {second.resumed_chunks}")
    if ssv_cuda.LAUNCHES != (second.stats.num_chunks
                             + second.stats.overflow_retries):
        raise AssertionError(f"resumed 2-D run: LAUNCHES={ssv_cuda.LAUNCHES}")
    same_hits("resumed 2-D mesh run", second, single)
    log(f"[mesh2d] 2x2 R={MESH_ROWS[0]} at {MESH_CUT} positions: abort after "
        f"the step-4 checkpoint: {first.state.value}; the resume from step "
        f"{second.resumed_chunks} of {second.stats.chunk_geometry['steps']} "
        f"({second.stats.num_chunks} launches, LAUNCHES={ssv_cuda.LAUNCHES}) "
        f"== the single-device isolated run ({len(second.hits())} hits)")

    # (c) two gloo processes, each one seq shard of both model groups.
    t0 = time.perf_counter()
    ranks = run_workers("mesh2d", "engine2d", dev, 2,
                        os.path.join(work, "workers2d"), "--rows-per-step",
                        str(MESH_ROWS[0]), "--hmm", hmm, "--fasta", cut,
                        "--pvalue", str(P_VALUE))
    same_worker_hits("mesh2d gloo workers", ranks, single)
    if not all(bool(z["warned"]) and z["ckpt_files"].size == 0
               for z in ranks):
        raise AssertionError("a 2-D worker wrote a checkpoint or did not "
                             "warn")
    log(f"[mesh2d] {MESH_WORKERS} gloo processes x 2 shards (2x2, each one "
        f"seq shard of both groups) on {dev} over {MESH_CUT} positions, "
        f"R={MESH_ROWS[0]}: hits together == the single-device isolated run "
        f"({len(single.hits())}); launches "
        f"{[int(z['launches']) for z in ranks]}, T={int(ranks[0]['steps'])};"
        f" each warned and wrote no checkpoint; sweep seconds "
        f"{[round(float(z['sweep_seconds']), 4) for z in ranks]}, wall "
        f"{time.perf_counter() - t0:.3f} s with start-up; {smi}")

    # (d) the dry run.
    ssv_cuda.LAUNCHES = 0
    out = dryrun_multichip(8, dev)
    if ssv_cuda.LAUNCHES == 0:
        raise AssertionError("the dry run launched no kernel")
    log(f"[mesh2d] dryrun_multichip(8, {dev}): {json.dumps(out)}, "
        f"LAUNCHES={ssv_cuda.LAUNCHES}")
    log(f"[mesh2d] phase 10 wall {time.perf_counter() - t_phase:.3f} s")


def records(composition: str) -> dict:
    """{model positions: num_hits} of the JAX engine's record."""
    with open(os.path.join(ROOT, RUNTIME_RECORDS[composition])) as f:
        rows = json.load(f)["rows"]
    return {r["model_positions"]: r["num_hits"] for r in rows}


def runtime_rows(tag, dev, work, argv) -> list:
    """Run runtime_table's entry point on ``dev`` with sampled hits
    re-derived; check every row's launches, verification and host core,
    and return the rows."""
    out = os.path.join(work, f"{tag}.json")
    ssv_cuda.LAUNCHES = 0
    rc = runtime_table.main([*argv, "--device", str(dev), "--verify-sample",
                             str(VERIFY_SAMPLE), "--json", out])
    launches = ssv_cuda.LAUNCHES
    with open(out) as f:
        rows = json.load(f)["rows"]
    want = sum(r["chunk_geometry"]["n_col"] * r["chunk_geometry"]["n_row"]
               + r["overflow_retries"] for r in rows)
    if rc != 0 or launches != want or not want:
        raise AssertionError(f"runtime_table {tag}: rc {rc}, LAUNCHES="
                             f"{launches}, want {want}")
    for r in rows:
        v = r["verify"]
        if not (v["verified"] == v["sampled"]
                == min(VERIFY_SAMPLE, r["num_raw_hits"]) > 0):
            raise AssertionError(f"runtime_table {tag}: verify {v}")
        if r["native_active"] is not True:
            raise AssertionError(f"runtime_table {tag}: no native core")
    return rows


def log_row(tag, r, smi, record=None) -> None:
    held = "" if record is None else f" == the JAX record's {record}"
    log(f"[tools] {tag} {r['model_positions']} positions: {r['num_hits']} "
        f"hits{held} ({r['num_raw_hits']} raw); seconds {r['seconds']:.4f} "
        f"(load {r['load_s']:.4f}, run {r['run_s']:.4f}, resolve "
        f"{r['resolve_s']:.4f}), sweep {r['sweep_seconds']:.4f} s, "
        f"gcups_sweep {r['gcups_sweep']:.2f}, gcups_e2e {r['gcups_e2e']:.2f};"
        f" overflow_retries {r['overflow_retries']}, key_cap "
        f"{r['chunk_geometry']['key_cap']}, chunks "
        f"{r['chunk_geometry']['n_col']} x {r['chunk_geometry']['n_row']}; "
        f"verified {r['verify']['verified']}/{r['verify']['sampled']} "
        f"({r['verify']['seconds']:.3f} s); {smi}")
    log(f"[tools] {tag} {r['model_positions']} phases "
        f"{json.dumps({k: round(v, 4) for k, v in r['phases'].items()})}")


def device_share(tag, dev, comp, r, smi) -> None:
    """The row's device time, estimated from one launch at its first full
    chunk (the workload's first column and row chunk, timed alone with CUDA
    events) scaled by the row's cells, beside its sweep seconds."""
    models, seq = runtime_table.synthetic_workload(
        r["requested_positions"], CHR22_LENGTH, comp)
    geo = r["chunk_geometry"]
    sym = torch.from_numpy(seq[:geo["chunk_symbols"]]).to(dev)
    sc = torch.from_numpy(project_models(models, P_VALUE)[
        :geo["chunk_rows"]]).to(dev)
    out = ssv_cuda.SweepBuffers.empty(sym.shape[0], sc.shape[0], 1 << 24, dev)
    zs = torch.zeros(sym.shape[0], dtype=torch.int32, device=dev)
    zc = torch.zeros(sc.shape[0] + 1, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: ssv_cuda.launch(sym, sc, zs, zc, None, 0, 0, out),
                 reps=5)
    cells = sym.shape[0] * sc.shape[0]
    busy = ms / 1e3 / cells * CHR22_LENGTH * r["model_positions"]
    log(f"[tools] {tag} {r['model_positions']}: one launch of "
        f"{sym.shape[0]} x {sc.shape[0]} ({int(out.count.item())} hits) "
        f"{ms:.4f} ms ({cells / ms / 1e6:.2f} GCUPS); x the row's cells = "
        f"{busy:.4f} s of device time (estimated), {busy / r['sweep_seconds']:.4f}"
        f" of the sweep, {busy / r['seconds']:.4f} of the search; {smi}")


def phase_tools(dev, smi, work, density, main_gcups) -> None:
    t_phase = time.perf_counter()
    # (a), (b) the reference's runtime curve, held to the JAX records.
    for comp in ("uniform", "genomic"):
        want = records(comp)
        rows = runtime_rows(comp, dev, work, [
            "--synthetic", "--composition", comp, "--lengths",
            *map(str, RUNTIME_LENGTHS[comp])])
        for r in rows:
            if r["num_hits"] != want[r["model_positions"]]:
                raise AssertionError(
                    f"runtime_table {comp} {r['model_positions']}: "
                    f"{r['num_hits']} hits, the JAX record "
                    f"{want[r['model_positions']]}")
            log_row(comp, r, smi, want[r["model_positions"]])
        device_share(comp, dev, comp, rows[-1], smi)

    # (c) the file form: (a)'s 10,122 workload written out, and a cut of a
    # written 150,043-position collection.
    models, seq = runtime_table.synthetic_workload(FILE_POSITIONS,
                                                   CHR22_LENGTH)
    hmm, fasta = (os.path.join(work, "workload.hmm"),
                  os.path.join(work, "workload.fa"))
    write_hmm(models, hmm)
    write_fasta(fasta, "synth-chr", seq)
    (r,) = runtime_rows("file", dev, work, ["--hmm", hmm, "--fasta", fasta])
    want = records("uniform")[r["model_positions"]]
    if r["model_positions"] != FILE_POSITIONS or r["num_hits"] != want:
        raise AssertionError(f"file form: {r['num_hits']} hits at "
                             f"{r['model_positions']} positions")
    log_row("file (workload.hmm, workload.fa)", r, smi, want)
    full, _ = runtime_table.synthetic_workload(150043, 1)
    whole = os.path.join(work, "collection.hmm")
    write_hmm(full, whole)
    cuts = os.path.join(work, "cuts")
    if hmm_db_by_length.main([whole, cuts, "--lengths",
                              *map(str, DB_CUTS)]) != 0:
        raise AssertionError("hmm_db_by_length failed")
    ends = np.cumsum([m.model_length for m in full])
    for size in DB_CUTS:
        got = read_hmm(os.path.join(cuts, f"db_{size}.hmm"))
        k = int(np.searchsorted(ends, size)) + 1  # the shortest prefix
        if [m.name for m in got] != [m.name for m in full[:k]]:
            raise AssertionError(f"db_{size}.hmm: {len(got)} models, want "
                                 f"the first {k}")
        log(f"[tools] db_{size}.hmm: the first {k} models, {int(ends[k - 1])}"
            " positions")
    cut = os.path.join(cuts, f"db_{DB_CUTS[1]}.hmm")
    (r,) = runtime_rows("cut", dev, work, ["--hmm", cut, "--fasta", fasta])
    ssv_cuda.LAUNCHES = 0
    direct = Havac(p_value=P_VALUE, device=dev)
    direct.load_phmm(full[:len(read_hmm(cut))]).load_sequence(fasta).run()
    if (ssv_cuda.LAUNCHES != direct.stats.num_chunks
            + direct.stats.overflow_retries
            or r["num_hits"] != len(direct.hits())):
        raise AssertionError(f"cut: {r['num_hits']} hits, the models as "
                             f"objects {len(direct.hits())}")
    log_row(f"cut db_{DB_CUTS[1]}.hmm x workload.fa", r, smi)
    log(f"[tools] the cut's hits == the same models loaded as objects "
        f"({len(direct.hits())})")
    del direct, models, seq, full

    # (d) the wavefront's step accounting on one card.
    out = os.path.join(work, "scaling.json")
    ssv_cuda.LAUNCHES = 0
    if scaling_mesh.main([*SCALING_ARGS, "--device", str(dev), "--json",
                          out]) != 0:
        raise AssertionError("scaling_mesh failed")
    launches = ssv_cuda.LAUNCHES
    with open(out) as f:
        mesh = json.load(f)
    S = mesh["num_strips"]
    want = 0
    for row in mesh["rows"]:
        D = row["devices"]
        if (row["steps"] != S + D - 1 or row["launches"] != S * D
                or row["kernel_launches"] != S * D + row["regrows"]):
            raise AssertionError(f"scaling_mesh D={D}: {row}")
        want += (1 + row["iters"]) * row["kernel_launches"]
        log(f"[tools] scaling_mesh D={D}: steps {row['steps']} == S + D - 1 "
            f"(S = {S}), launches {row['launches']} == S * D (kernel count "
            f"{row['kernel_launches']}, regrows {row['regrows']}), "
            f"{row['num_hits']} hits == D = 1's; wall min "
            f"{row['wall_s']:.4f} s, median {row['wall_median_s']:.4f} s, "
            f"ratio to D = 1 {row['measured_wall_ratio']:.4f} against T / S "
            f"{row['predicted_fill_ratio']:.4f} ({mesh['note']}); {smi}")
    if launches != want:
        raise AssertionError(f"scaling_mesh: LAUNCHES={launches}, want "
                             f"{want}")

    # (e) the collector pool's work a chunk, at its default density and at
    # phase 4's.
    for argv in ([], ["--hits-per-chunk", str(density)]):
        out = os.path.join(work, "hostbench.json")
        if hostbench.main([*argv, "--json", out]) != 0:
            raise AssertionError("hostbench failed")
        with open(out) as f:
            host = json.load(f)
        log(f"[tools] hostbench {host['hits_per_chunk']} keys a chunk, "
            f"{host['workers']} workers: " + ", ".join(
                f"{k} {v['ms_per_chunk']:.4f} ms"
                for k, v in host["variants"].items()) + f"; {smi}")

    # The amino search: a planted card-20 collection through the engine on
    # the card, against the CPU engine (the plain route) over a prefix.
    t0 = time.perf_counter()
    models, recs = generate_planted_fixture(
        seed=SEED, model_length=AMINO_LENGTH, sequence_length=AMINO_RESIDUES,
        num_models=AMINO_MODELS, alphabet="amino")
    name, residues = recs[0]
    fasta = os.path.join(work, "amino.fa")
    prefix = os.path.join(work, "amino_prefix.fa")
    for path, text in ((fasta, residues), (prefix, residues[:AMINO_PREFIX])):
        with open(path, "w") as f:
            f.write(f">{name}\n{text}\n")
    log(f"[tools] amino fixture: {AMINO_MODELS} models x {AMINO_LENGTH} "
        f"positions, {AMINO_RESIDUES} residues "
        f"({time.perf_counter() - t0:.3f} s)")
    ssv_cuda.LAUNCHES = 0
    amino = Havac(p_value=P_VALUE, device=dev).load_phmm(models)
    amino.load_sequence(fasta).run()
    st = amino.stats
    if (amino.alphabet != "amino" or not st.num_chunks
            or ssv_cuda.LAUNCHES != st.num_chunks + st.overflow_retries):
        raise AssertionError(f"amino: alphabet {amino.alphabet}, LAUNCHES="
                             f"{ssv_cuda.LAUNCHES}, chunks {st.num_chunks}")
    t0 = time.perf_counter()
    plain = Havac(p_value=P_VALUE, device="cpu").load_phmm(models)
    plain.load_sequence(prefix).run()
    got, want = amino.hits(), plain.hits()
    early = got.sequence_position < AMINO_PREFIX
    if not (len(want) > 0 and all(np.array_equal(getattr(got, f)[early],
                                                 getattr(want, f))
                                  for f in RESOLVED)):
        raise AssertionError(f"amino: {int(early.sum())} hits in the first "
                             f"{AMINO_PREFIX} residues, the CPU engine "
                             f"{len(want)}")
    report = amino.verify(sample=min(VERIFY_SAMPLE, st.num_raw_hits))
    if not report.all_verified:
        raise AssertionError(f"amino: {report.num_hits - report.num_verified}"
                             " sampled hits failed")
    log(f"[tools] amino: {len(got)} hits, {st.num_chunks} launches "
        f"(LAUNCHES={st.num_chunks + st.overflow_retries}); the first "
        f"{AMINO_PREFIX} residues' {len(want)} hits == the CPU engine's "
        f"({time.perf_counter() - t0:.3f} s); verified "
        f"{report.num_verified}/{report.num_hits} sampled raw hits; sweep "
        f"{st.sweep_seconds:.4f} s, {st.gcups:.2f} GCUPS (card 20) beside "
        f"phase 4's {main_gcups:.2f} (card 4); {smi}")
    log(f"[tools] phase 11 wall {time.perf_counter() - t_phase:.3f} s")


def phase_bench(dev, smi) -> dict:
    """Phase 12; returns its sweep launches (kbench's, counted here from 0
    just before, and the bench process's as it reported them) and its
    largest difference from the plain version."""
    t_phase = time.perf_counter()
    # (a) the headline entry point, as a user runs it.
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "havac_tpu_torch.bench"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"bench rc={res.returncode}: "
                             f"{res.stderr[-4000:]}")
    lines = res.stdout.strip().splitlines()
    head = json.loads(lines[-1])
    L, P = bench.CARD_SHAPE
    want_launches = kbench.N_HI + bench.ITERS * (kbench.N_LO + kbench.N_HI)
    missing = [k for k in HEADLINE_KEYS if k not in head]
    if (len(lines) != 1 or missing
            or head["metric"] != "ssv_sweep_throughput"
            or head["device"]["name"] != torch.cuda.get_device_name(0)
            or head["device"]["nvidia_smi"] != smi.splitlines()[0]
            or (head["L"], head["P"]) != (L, P)
            or head["launches"] != want_launches
            or head["value"] <= 0):
        raise AssertionError(f"bench printed {res.stdout!r} (missing "
                             f"{missing})")
    log(f"[bench] headline {head['value']:.2f} GCUPS (median "
        f"{head['gcups_median']:.2f}) at {L} x {P}, {head['vs_baseline']:.4f}"
        f" of the U50 FPGA's published 1,739; one launch "
        f"{head['kernel_ms']:.4f} ms against a bound of "
        f"{head['bound_ms']:.4f} ms ({head['bound_by']}) = "
        f"{head['bound_share']:.4f}; {head['hits']} hits, "
        f"{head['threads']}-thread blocks, {head['launches']} launches, "
        f"native_active={head['native_active']} "
        f"({time.perf_counter() - t0:.3f} s); {smi}")
    log(f"[bench] {lines[-1]}")

    # (b) one dispatch and a 2-dispatch chain at the bench shape, exactly.
    t0 = time.perf_counter()
    sym, sc = (torch.from_numpy(a).to(dev) for a in bench.inputs(L, P))
    chain = kbench.Chain(sym, sc, n_hi=2)
    got = want = chain.state0
    err = 0
    plain_ms = []
    for k in range(2):
        got = chain.step(got, k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plain = ssv_sweep_plain(sym, sc, want, chain.carry0)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t1) * 1e3)
        n = int(chain.counts[k])
        err = max(err, compare(f"bench dispatch {k + 1}", (
            chain.keys[:n], got, chain.outs[k].final_carry), plain))
        if n != plain[0].numel():
            raise AssertionError(f"bench dispatch {k + 1}: count {n} != "
                                 f"{plain[0].numel()}")
        want = plain[1]
    log(f"[bench] one dispatch and a 2-dispatch chain at {L} x {P} == plain "
        f"(keys, count, state, carry) exactly; plain "
        f"{plain_ms[0]:.3f} / {plain_ms[1]:.3f} ms a dispatch "
        f"({time.perf_counter() - t0:.3f} s); {smi}")
    del sym, sc, chain, want, got, plain

    # (c) kbench through its main, its launches counted from 0 just before;
    # each point's last timed chain (9 dispatches) held, at the timed
    # shape, to the plain version chained the same way.
    held = []

    def hold(chain) -> None:
        t0 = time.perf_counter()
        want, counts, ms = chain.state0, [], []
        for _ in range(kbench.N_HI):
            t1 = time.perf_counter()
            keys, want, carry = ssv_sweep_plain(chain.symbols, chain.scores,
                                                want, chain.carry0)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            counts.append(keys.numel())
        tag = f"kbench point {len(held) + 1}"
        if chain.counts.tolist() != counts or chain.expected != counts:
            raise AssertionError(f"{tag}: counts {chain.counts.tolist()}, "
                                 f"counting chain {chain.expected}, plain "
                                 f"{counts}")
        last = chain.outs[-1]
        e = compare(tag, (chain.keys[:counts[-1]], last.final_state,
                          last.final_carry), (keys, want, carry))
        held.append({"err": e, "plain_ms": ms,
                     "s": time.perf_counter() - t0})

    ssv_cuda.LAUNCHES = 0
    points = []
    for i, argv in enumerate(KBENCH_RUNS):
        path = os.path.join(ROOT, "build", f"kbench_smoke{i}.json")
        if kbench.main(argv + ["--json", path], inspect=hold) != 0:
            raise AssertionError(f"kbench {argv} failed")
        with open(path) as f:
            points += json.load(f)["points"]
        os.remove(path)
    launches = ssv_cuda.LAUNCHES
    per_point = kbench.N_HI + kbench.parse_args([]).iters * (
        kbench.N_LO + kbench.N_HI)
    if (len(held) != len(points) or launches != per_point * len(points)
            or launches != sum(p["launches"] for p in points)):
        raise AssertionError(f"kbench LAUNCHES={launches}, not {per_point} "
                             f"x {len(points)} points ({len(held)} held)")
    for p, h in zip(points, held):
        err = max(err, h["err"])
        log(f"[bench] {p['kernel']} B={p['B']} W={p['W']} P={p['P']} "
            f"card={p['card']}{' dense' if p['dense'] else ''}: its last "
            f"timed chain of {kbench.N_HI} dispatches == plain chained the "
            f"same way (counts {p['counts']}; last keys, state, carry), "
            f"plain {min(h['plain_ms']):.3f}-{max(h['plain_ms']):.3f} ms a "
            f"dispatch ({h['s']:.3f} s); {p['gcups']:.2f} GCUPS (median "
            f"{p['gcups_median']:.2f}), kernel {p['kernel_ms']:.4f} ms "
            f"against a bound of {p['bound_ms']:.4f} ms ({p['bound_by']}, "
            f"MIN_OPS {p['min_ops']}) = {p['bound_share']:.4f} (with 8-byte"
            f" keys {p['key_bound_ms']:.4f} ms = "
            f"{p['key_bound_ms'] / p['kernel_ms']:.4f}); {p['hits']} hits, "
            f"key buffer {p['key_cap']} ({p['regrows']} regrows), "
            f"{p['threads']}-thread blocks, {p['launches']} launches; {smi}")
    log(f"[bench] LAUNCHES={launches} over {len(points)} points, counted "
        f"here from 0; the bench process reported {head['launches']} of "
        f"its own; phase 12 wall {time.perf_counter() - t_phase:.3f} s")
    return {"bench_launches": launches,
            "bench_process_launches_reported": head["launches"],
            "bench_max_abs_err": err}


def run_paths(dev, smi, work, max_err) -> dict:
    # ---- main path at the published 10k point
    t0 = time.perf_counter()
    hmm, fasta = write_workload(work, MODEL_POSITIONS, CHR22_LENGTH, SEED)
    log(f"[main] workload written in {time.perf_counter() - t0:.3f} s")
    ssv_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    engine = Havac(p_value=P_VALUE, device=dev)
    engine.load_phmm(hmm)
    engine.load_sequence(fasta)
    t_load = time.perf_counter()
    engine.warmup()
    t_warm = time.perf_counter()
    engine.run()
    t_run = time.perf_counter()
    hits = engine.hits()
    t_end = time.perf_counter()
    launches = ssv_cuda.LAUNCHES
    st = engine.stats
    geo = st.chunk_geometry
    L, P = engine.database.padded_length, engine.scores.shape[0]
    log(f"[main] L={L} P={P} models={len(engine.models)} chunks={st.num_chunks} "
        f"geometry={json.dumps(geo)}")
    log(f"[main] load {t_load - t0:.3f} s, warmup {t_warm - t_load:.3f} s, "
        f"run {t_run - t_warm:.3f} s, hits {t_end - t_run:.3f} s, "
        f"wall {t_end - t0:.3f} s")
    log(f"[main] sweep_seconds={st.sweep_seconds:.4f} GCUPS={st.gcups:.2f} "
        f"raw_hits={st.num_raw_hits} hits={len(hits)} "
        f"native_active={st.native_active} regrows={st.overflow_retries} "
        f"LAUNCHES={launches}")
    if st.native_active is not True:
        raise AssertionError("the port's native host core did not load")
    log(f"[main] phases {json.dumps({k: round(v, 4) for k, v in st.pipeline_prof.items()})}")
    if launches != st.num_chunks:
        raise AssertionError(f"LAUNCHES={launches} != chunks={st.num_chunks}")
    if st.num_raw_hits == 0 or len(hits) == 0:
        raise AssertionError("main path found no hits")
    for f in ("sequence_index", "sequence_position", "phmm_index",
              "phmm_position"):
        col = getattr(hits, f)
        if col.shape != (len(hits),) or col.min(initial=0) < 0:
            raise AssertionError(f"hits.{f} malformed")

    # Completeness: every row over the first column chunk, plain on the card.
    chunk = geo["chunk_symbols"]
    codes = torch.from_numpy(engine.database.codes[:chunk]).to(dev)
    scores = torch.from_numpy(engine.scores).to(dev)
    t0 = time.perf_counter()
    pk, pstate, _ = ssv_sweep_plain(
        codes, scores, torch.zeros(codes.shape[0], dtype=torch.int32,
                                   device=dev),
        torch.zeros(P + 1, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    rows, pos = engine.raw_hits()
    mine = np.sort(((rows << 38) | pos)[pos < chunk])
    if not np.array_equal(mine, np.sort(pk.cpu().numpy())):
        raise AssertionError(
            f"first column chunk: engine {mine.size} hits, plain "
            f"{pk.numel()}")
    log(f"[main] first column chunk ({chunk} x {P}): {mine.size} hits equal "
        f"the plain version's ({time.perf_counter() - t0:.3f} s)")
    del pstate

    # Soundness: a sample of raw hits re-derives by bounded re-SSV.
    t0 = time.perf_counter()
    report = engine.verify(sample=min(10_000, st.num_raw_hits))
    if not report.all_verified:
        raise AssertionError(f"{report.num_hits - report.num_verified} of "
                             f"{report.num_hits} sampled hits failed")
    log(f"[main] verified {report.num_verified}/{report.num_hits} sampled raw "
        f"hits ({time.perf_counter() - t0:.3f} s)")

    # ---- timing at one main-path chunk shape (first column, first rows)
    rchunk = geo["chunk_rows"]
    tsc = scores[:rchunk].contiguous()
    ist = torch.zeros(codes.shape[0], dtype=torch.int32, device=dev)
    icr = torch.zeros(rchunk + 1, dtype=torch.int32, device=dev)
    out = ssv_cuda.SweepBuffers.empty(codes.shape[0], rchunk, 1 << 20, dev)
    ms = cuda_ms(lambda: ssv_cuda.launch(codes, tsc, ist, icr, None, 0, 0,
                                         out), reps=5)
    plain_ms = cuda_ms(lambda: ssv_sweep_plain(codes, tsc, ist, icr), reps=1)
    cells = codes.shape[0] * rchunk
    log(f"[timing] chunk {codes.shape[0]} x {rchunk}: kernel {ms:.3f} ms "
        f"({cells / ms / 1e6:.2f} GCUPS), plain {plain_ms:.3f} ms "
        f"({cells / plain_ms / 1e6:.2f} GCUPS); {smi}")
    # Bytes of the timed chunk: symbols, scores, the boundary state and
    # carry read, the final state and carry and the hit keys written.
    Lc = codes.shape[0]
    sweep_bytes = (Lc + rchunk * 4 + 2 * 4 * Lc + 2 * 4 * (rchunk + 1)
                   + 8 * int(out.count.item()))
    del codes, tsc, out

    # Card 20 at the same shape (the table match), held to the plain
    # version there too.
    rng = np.random.default_rng(SEED + 2)
    sym20 = torch.from_numpy(rng.integers(0, 20, Lc).astype(np.uint8)).to(dev)
    sc20 = torch.from_numpy(rng.integers(-30, 20, (rchunk, 20))
                            .astype(np.int8)).to(dev)
    out20 = ssv_cuda.SweepBuffers.empty(Lc, rchunk, 1 << 20, dev)
    ms20 = cuda_ms(lambda: ssv_cuda.launch(sym20, sc20, ist, icr, None, 0, 0,
                                           out20), reps=5)
    plain20 = []
    plain20_ms = cuda_ms(lambda: plain20.append(
        ssv_sweep_plain(sym20, sc20, ist, icr)), reps=1)
    n20 = int(out20.count.item())
    max_err = max(max_err, compare(
        "card20 chunk", (out20.keys[:n20], out20.final_state,
                         out20.final_carry), plain20[-1]))
    log(f"[timing] card 20, chunk {Lc} x {rchunk}: kernel {ms20:.3f} ms "
        f"({cells / ms20 / 1e6:.2f} GCUPS), plain {plain20_ms:.3f} ms, "
        f"{n20} hits == plain; {smi}")
    del sym20, sc20, out20, plain20, ist, icr

    card = roofline.Card.query(dev)
    issue = card.sms * roofline.ISSUE_LANES_PER_SM * card.max_sm_mhz * 1e6
    per_word = sweep_sass()
    for tag, t in (("card4", ms), ("tables", ms20)):
        share = per_word[tag] * cells / 3 / (t / 1e3) / issue
        log(f"[sass] {tag}: {per_word[tag]:.4f} SASS a word and row "
            f"(interior hit window), issue share {share:.4f} at {t:.3f} ms "
            f"of {issue:.4g} slots/s; {smi}")
    log(f"[sass] card4 with reset rows: {per_word['card4-reset']:.4f} SASS "
        f"a word and row")

    # ---- the per-cell readouts, then the multi-file paths
    dump = phase_percell(dev, engine, smi, per_word["dump"])
    phase_scan(dev, engine, hmm, work)
    cut = phase_mesh(dev, smi, engine, work, st.gcups)
    phase_mesh2d(dev, smi, engine, work, cut, st.gcups)
    phase_tools(dev, smi, work, st.num_raw_hits // launches, st.gcups)

    return {"kernels": [
        {"name": "ssv_sweep", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
         "ms": ms, "plain_ms": plain_ms, "cells": cells,
         "bytes": sweep_bytes},
        {"name": "ssv_sweep_dump", "route": "cuda", "source": SOURCE,
         "replaces": DUMP_REPLACES, **dump}]}, st.gcups


def log_ptxas(tag: str, build_log: str) -> None:
    """ptxas' registers, shared memory and spills of each kernel of a
    library's build (nothing when the library was built already)."""
    entry = ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            log(f"[{tag}] {entry}: {line.split(':', 1)[-1].strip()}")


def phase_roofline(dev, smi, card, main_gcups):
    t0 = time.perf_counter()
    path, text, seconds = ssv_cuda.build_library(*roofline.LIBRARY)
    log(f"[roofline] {os.path.relpath(path, ROOT)} in "
        f"{time.perf_counter() - t0:.3f} s (nvcc {seconds:.3f} s)")
    log_ptxas("roofline", text)
    k = ROOFLINE_ROWS
    err = dict.fromkeys(roofline.KERNELS, 0)
    plain = {}
    for name in roofline.VARIANTS:
        top = roofline.max_ws(name, k)
        wss = (top, 12, 8) if name in MATCH_PRECOMPUTE else (top,)
        for ws in dict.fromkeys(wss):
            x = roofline.make_inputs(name, ws, k, dev)
            copies = roofline.fill_copies(name, ws, k, card.sms)
            for reps in (1, 2, 3):
                got = roofline.op_mix(x, reps, copies)
                torch.cuda.synchronize()
                want = roofline.op_mix_plain(name, x, reps)
                d = int((got.long() - want.long()).abs().max())
                kernel = roofline.KERNEL_OF[name]
                err[kernel] = max(err[kernel], d)
                if d:
                    raise AssertionError(f"{name}: kernel differs from plain "
                                         f"by {d} at WS {ws}, reps={reps}")
            log(f"[roofline] {name}: WS {ws}, {copies} copies == plain "
                f"exactly at reps 1-3")
        x = roofline.make_inputs(name, top, k, dev)
        plain[name] = roofline.time_differential(
            lambda reps: roofline.op_mix_plain(name, x, reps), 1, 4, dev,
            iters=3).sec
        log(f"[roofline] {name}: plain {plain[name] * 1e3:.4f} ms/rep at "
            f"WS {top}")

    # The tool: every variant at its largest WS, then stripmatch and
    # `current` at WS 12 (like against like), filling the card and at one
    # block an SM (the most that all K = 30 planes in a block allowed), and
    # mxumatch* beside
    # `current` at WS 8, 12 and 48.
    ws_small = STRIP_SMALL_WS
    mxu_top = roofline.max_ws("mxumatch", k)
    span = ["--rows", str(k), "--lo", str(ROOFLINE_LO), "--hi",
            str(ROOFLINE_HI)]
    small = span + ["--ws", str(ws_small), "--variants", "current",
                    "stripmatch"]
    mxu = list(roofline.MXU_VARIANTS)
    argvs = [span, small, small + ["--copies", str(card.sms)],
             span + ["--ws", "8", "--variants", "current", *mxu],
             span + ["--ws", "12", "--variants", *mxu],
             span + ["--ws", str(mxu_top), "--variants", "current"]]
    paths = [os.path.join(ROOT, "build", f"roofline_smoke{i}.json")
             for i in range(len(argvs))]
    roofline.ROOFLINE_LAUNCHES.update(dict.fromkeys(roofline.KERNELS, 0))
    rcs = [roofline.main(argv + ["--json", path])
           for argv, path in zip(argvs, paths)]
    launches = dict(roofline.ROOFLINE_LAUNCHES)
    runs = []
    for path in paths:
        with open(path) as f:
            runs.append(json.load(f)["results"])
        os.remove(path)
    results, small, one_block, at8, at12, at_top = runs
    if (rcs != [0] * len(argvs)
            or sorted(results) != sorted(roofline.VARIANTS)):
        raise AssertionError(f"roofline tool rc={rcs}: {sorted(results)}")
    for kernel, n in launches.items():
        if n == 0:
            raise AssertionError(f"{kernel} was not launched by the tool")
    for name, r in results.items():
        log(f"[roofline] {name}: WS {r['ws']}, kernel "
            f"{r['sec_per_rep'] * 1e3:.6f} ms/rep ({r['copies']} copies, "
            f"{r['gcups_equiv_card']:.2f} GCUPS-equiv on the card, issue "
            f"share {r['issue_share']:.3f}, INT32 share "
            f"{r['int32_share']:.3f}), plain {plain[name] * 1e3:.4f} ms/rep "
            f"(1 instance); {smi}")
    per_word, narrow, strip = roofline_sass()
    log(f"[roofline] SASS a word and row: " + ", ".join(
        f"{n} {v:.4f}" for n, v in per_word.items()))
    clk = card.sms * card.max_sm_mhz * 1e6
    # stripmatch beside `current` at the same WS and copies, with warps an
    # SM, its loops' SASS and its shared-memory traffic (a 16-byte store
    # and load per 4 words and row: 8 B a word and row).
    log(f"[roofline] stripmatch SASS a word and row: its row loop, which "
        f"also builds a plane ahead, {strip['loop']:.4f} "
        f"({strip['imad']:.4f} IMAD; {strip['sts']} STS and {strip['lds']} "
        f"LDS a row; forward-branch pass {strip['pass']:.4f}) against "
        f"current's {per_word['current']:.4f}")
    for run in (results, small, one_block):
        r, cur = run["stripmatch"], run["current"]
        ws, copies = r["ws"], r["copies"]
        words_s = copies * k * ws * 128 / r["sec_per_rep"]
        blocks = min(roofline.blocks_per_sm("stripmatch", ws, k),
                     -(-copies // card.sms))
        log(f"[roofline] stripmatch at WS {ws}, {copies} copies: "
            f"{r['sec_per_rep'] * 1e3:.6f} ms/rep, "
            f"{r['gcups_equiv_card']:.2f} GCUPS-equiv = "
            f"{r['gcups_equiv_card'] / cur['gcups_equiv_card']:.4f} of "
            f"current's {cur['gcups_equiv_card']:.2f} ({cur['copies']} "
            f"copies, {cur['sec_per_rep'] * 1e3:.6f} ms/rep); {blocks * ws // 4}"
            f" warps an SM; SASS issue share "
            f"{per_word['stripmatch'] * words_s / (roofline.ISSUE_LANES_PER_SM * clk):.4f}"
            f"; shared memory {8 * words_s / clk:.2f} B a clock an SM of 128; "
            f"{smi}")
    # The narrow variants beside `current`: SASS a 32-bit word and row, and
    # the issue and INT32 shares their measured rates imply.
    for name in ("current", *narrow_time.NARROW):
        r = results[name]
        words_s = r["copies"] * k * r["ws"] * 128 / r["sec_per_rep"]
        n = narrow.get(name)
        if n is None:
            log(f"[roofline] {name}: {per_word[name]:.4f} SASS a word and "
                f"row, issue share {per_word[name] * words_s / (roofline.ISSUE_LANES_PER_SM * clk):.4f} "
                f"at {r['sec_per_rep'] * 1e3:.6f} ms/rep; {smi}")
            continue
        log(f"[roofline] {name}: {n['total']:.4f} SASS a word and row "
            f"({n['int32']:.4f} INT32-pipe, {n['imad']:.4f} IMAD, "
            f"{n['viadd']:.4f} VIADD), issue share "
            f"{n['total'] * words_s / (roofline.ISSUE_LANES_PER_SM * clk):.4f}, "
            f"INT32 share "
            f"{n['int32'] * words_s / (roofline.INT32_LANES_PER_SM * clk):.4f} "
            f"at {r['sec_per_rep'] * 1e3:.6f} ms/rep ({r['copies']} copies); "
            f"by MIN_OPS issue {r['issue_share']:.4f}, INT32 "
            f"{r['int32_share']:.4f}; {smi}")
    by_ws = {8: at8, 12: {**at12, "current": small["current"]},
             mxu_top: {**at_top, **{n: results[n] for n in mxu}}}
    for ws, run in by_ws.items():
        cur = run["current"]["gcups_equiv_card"]
        for name in mxu:
            r = run[name]
            warps = roofline.blocks_per_sm(name, ws, k) * ws // 4
            log(f"[roofline] {name} at WS {ws}: {r['sec_per_rep'] * 1e3:.6f} "
                f"ms/rep, {r['gcups_equiv_card']:.2f} GCUPS-equiv = "
                f"{r['gcups_equiv_card'] / cur:.4f} of current's {cur:.2f} "
                f"at WS {ws}; {warps} warps an SM, {per_word[name]:.4f} SASS "
                f"a word and row, issue share {r['issue_share']:.3f}; {smi}")
    log(f"[roofline] LAUNCHES={json.dumps(launches)}")
    for name in ("current", "perrow"):
        g = results[name]["gcups_equiv_card"]
        log(f"[roofline] main-path sweep {main_gcups:.2f} GCUPS = "
            f"{main_gcups / g:.4f} of {name}'s {g:.2f} GCUPS-equiv")

    entries = []
    for kernel in roofline.KERNELS:
        name = ROOFLINE_SHOWN[kernel]
        r = results[name]
        # One rep of every copy at the card's peak; no memory traffic
        # inside the loop.
        words = r["copies"] * k * r["ws"] * 128
        entries.append({
            "name": kernel, "route": "cuda", "source": ROOFLINE_SOURCE,
            "replaces": ROOFLINE_REPLACES[kernel],
            "launches": launches[kernel], "max_abs_err": err[kernel],
            "ms": r["sec_per_rep"] * 1e3, "plain_ms": plain[name] * 1e3,
            **bound(0, max(card.op_seconds(name, words))),
            "library_ms": None})
    # The kernels line shows add8 / int8mix; their int16 twins here.
    for name in ("add16", "int16mix"):
        r = results[name]
        b = bound(0, max(card.op_seconds(
            name, r["copies"] * k * r["ws"] * 128)))
        log(f"[roofline] {roofline.KERNEL_OF[name]} ({name}): "
            f"{json.dumps({'ms': r['sec_per_rep'] * 1e3, 'plain_ms': plain[name] * 1e3, 'copies': r['copies'], **b, 'share_of_bound': b['bound_ms'] / (r['sec_per_rep'] * 1e3)})}; "
            f"{smi}")
    return entries, results["current"]["gcups_equiv_card"]


def main() -> int:
    if not torch.cuda.is_available():
        log("CUDA is not available: this smoke test needs an NVIDIA GPU")
        return 2
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    log(smi)

    t0 = time.perf_counter()
    path = ssv_cuda.build()
    log(f"[build] {os.path.relpath(path, ROOT)} in "
        f"{time.perf_counter() - t0:.3f} s (nvcc {ssv_cuda.build_seconds:.3f} s)")
    log_ptxas("build", ssv_cuda.build_log)

    max_err = phase_kernel(dev)

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        record, main_gcups = run_paths(dev, smi, work, max_err)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    card = roofline.Card.query(dev)
    entries, current_gcups = phase_roofline(dev, smi, card, main_gcups)
    record["kernels"][0].update(phase_bench(dev, smi))
    for entry in record["kernels"]:  # `current`'s ops, one word per 3 cells
        cells = entry.pop("cells")
        entry.update(bound(entry.pop("bytes"),
                           max(card.op_seconds("current", cells / 3))),
                     library_ms=None)
        gcups = cells / entry["ms"] / 1e6
        log(f"[bound] {entry['name']}: {entry['ms']:.3f} ms against a bound "
            f"of {entry['bound_ms']:.3f} ms ({entry['bound_by']}) = "
            f"{entry['bound_ms'] / entry['ms']:.4f} of the bound; "
            f"{gcups:.2f} GCUPS = {gcups / current_gcups:.4f} of current's "
            f"measured {current_gcups:.2f} GCUPS-equiv; {smi}")
    record["kernels"] += entries
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
