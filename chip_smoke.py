"""Drive the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device  — the card's name and ``nvidia-smi`` name/power limit; fails
             without CUDA.
2. build   — compiles havac_tpu_torch/csrc/ssv_sweep.cu (nvcc, sm_90a).
3. kernel  — the CUDA sweep kernel against its plain PyTorch version on the
             card, exactly (sorted keys, count, final state and carry):
             card 4 and 20, with and without reset rows, non-zero boundary
             state, ragged sizes, a key buffer smaller than the hit count
             (the regrow path), and one case against a numpy oracle.
4. main    — the published 10k-position point: a 50,818,468-position random
             chromosome (chr22's length) against ~10k positions of synthetic
             models at p = 0.02, through Havac(device="cuda") load_phmm /
             load_sequence / warmup / run / hits. Checks that the kernel ran
             once per chunk, that the first column chunk's hits equal the
             plain version's on the card, and that a sample of raw hits
             re-derives by bounded re-SSV.
5. timing  — the kernel and the plain version at one main-path chunk shape.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from havac_tpu_torch.engine import Havac
from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.ops.ssv_torch import ssv_sweep_plain
from havac_tpu_torch.testing.workload import CHR22_LENGTH, write_workload

SEED = 7
MODEL_POSITIONS = 10020  # tools/runtime_table.py's 10k point
P_VALUE = 0.02
SOURCE = "havac_tpu_torch/csrc/ssv_sweep.cu"
REPLACES = "havac_tpu/ops/ssv_swar.py:542"
ROOT = os.path.dirname(os.path.abspath(__file__))


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
    """Exact comparison of (keys, state, carry); returns the max abs error."""
    gk, wk = np.sort(_np(got[0])), np.sort(_np(want[0]))
    if gk.shape != wk.shape or not np.array_equal(gk, wk):
        raise AssertionError(f"{tag}: hit keys differ "
                             f"({gk.size} vs {wk.size})")
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
    ]
    worst = 0
    for tag, L, P, card, with_reset, boundary, cap in cases:
        sym = rng.integers(0, card, L).astype(np.uint8)
        sc = rng.integers(-40, 70, (P, card)).astype(np.int8)
        ist = (rng.integers(0, 256, L) if boundary
               else np.zeros(L)).astype(np.int32)
        icr = (rng.integers(0, 256, P + 1) if boundary
               else np.zeros(P + 1)).astype(np.int32)
        rr = ((rng.random(P) < 0.1).astype(np.int32) if with_reset
              else None)
        t = [torch.from_numpy(a).to(dev) for a in (sym, sc, ist, icr)]
        trr = None if rr is None else torch.from_numpy(rr).to(dev)
        res = ssv_cuda.ssv_sweep(*t, reset_rows=trr, row_offset=5,
                                 pos_offset=11, cap=cap)
        torch.cuda.synchronize()
        plain = ssv_sweep_plain(*t, trr, row_offset=5, pos_offset=11)
        err = compare(tag, (res.keys, res.final_state, res.final_carry),
                      plain)
        if res.count != plain[0].numel():
            raise AssertionError(f"{tag}: count {res.count} != "
                                 f"{plain[0].numel()}")
        if tag == "regrow" and not res.regrown:
            raise AssertionError("regrow case did not overflow its buffer")
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
    for line in ssv_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")

    max_err = phase_kernel(dev)

    # ---- main path at the published 10k point
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
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
    finally:
        shutil.rmtree(work, ignore_errors=True)
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

    log(json.dumps({"kernels": [{
        "name": "ssv_sweep", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
