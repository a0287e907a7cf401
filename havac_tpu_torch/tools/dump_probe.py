"""Where the row dump's shape spends its time: per-block stamps of the sweep
kernel, its staged dump against byte stores, and the dump's write pattern
with no sweep.

    python -m havac_tpu_torch.tools.dump_probe [--rows 10020]
        [--positions 262144] [--json out.json]

``stamps``: builds ``csrc/ssv_sweep.cu`` with ``-DHV_BLOCK_STAMPS`` (a
``%globaltimer`` stamp at each block's start and end and a count of its
replayed hit windows), once for each dump design of ``DESIGNS``: the
shipped one (the rows staged in shared memory, 128 threads a block) and
byte stores straight from the word body (``-DHV_DUMP_BYTE_STORES``) at 128,
256 and 512 threads a block (``-DHV_DUMP_THREADS``), all under ``build/``
beside and never instead of the port's library. It runs them on the
smoke's workload (``testing/workload.py`` models and chromosome, seed 7:
its first ``--positions`` codes against its ``--rows`` projected model
rows) and on uniform random codes, undumped and dumped, checks each dump
against the port's own, and prints each launch's time, span, median block,
slowest blocks (index, edge or not, microseconds, replays) and total
replays.

``pattern``: times stores of the staged dump's write pattern alone: every
block of ``span`` diagonals writes its live run of every row (16-byte
stores of the run's 16-byte chunks, rows L + 1 bytes apart), for several
spans, beside a fill of the same (rows x positions) bytes.

Needs the CUDA toolkit and a card; prints one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from havac_tpu_torch.ops import ssv_cuda

# (name, dump threads a block, byte stores): the shipped design first.
DESIGNS = (("staged_128", 128, False), ("bytes_128", 128, True),
           ("bytes_256", 256, True), ("bytes_512", 512, True))

_PATTERN = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void span_write(uint8_t* dump, long long L, int P, int S) {
  const long long d0 = (long long)blockIdx.x * S - (P - 1);
  long long jlo = -(d0 + S - 1); if (jlo < 0) jlo = 0;
  long long jhi = L - d0; if (jhi > P) jhi = P;
  for (int j = (int)jlo; j < jhi; ++j) {
    long long lo = -(long long)j - d0; if (lo < 0) lo = 0;
    long long hi = L - j - d0; if (hi > S) hi = S;
    const long long g = (long long)j * (L + 1) + d0;
    const long long a = (g + lo + 15) & ~15LL, b = (g + hi + 15) & ~15LL;
    for (long long at = a + 16LL * threadIdx.x; at < b;
         at += 16LL * blockDim.x)
      if (at + 16 <= (long long)P * L)
        *reinterpret_cast<uint4*>(dump + at) = make_uint4(j, j, j, j);
  }
}
extern "C" int run_span(void* dump, long long L, int P, int S, int T) {
  span_write<<<(unsigned)((L + P - 1 + S - 1) / S), T>>>((uint8_t*)dump, L,
                                                         P, S);
  return (int)cudaGetLastError();
}
"""

PATTERN_SPANS = ((192, 64), (384, 128), (768, 128), (1536, 128),
                 (3072, 256))


def _build(jobs) -> dict:
    """nvcc for each (name, source path, extra flags), all at once."""
    out = os.path.join(ssv_cuda.BUILD_DIR, "probe")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, src, flags in jobs:
        lib = os.path.join(out, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [ssv_cuda._nvcc(), *ssv_cuda.NVCC_FLAGS, *flags, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def _ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def stamps(rows: int, positions: int, dev) -> list:
    from havac_tpu_torch.engine import Havac
    from havac_tpu_torch.testing.workload import write_workload

    src = os.path.join(ssv_cuda._CSRC, "ssv_sweep.cu")
    libs = _build([(f"ssv_stamped_{name}", src,
                    ["-DHV_BLOCK_STAMPS", f"-DHV_DUMP_THREADS={threads}"]
                    + (["-DHV_DUMP_BYTE_STORES"] if byte_stores else []))
                   for name, threads, byte_stores in DESIGNS])
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in libs.values():
        lib.hv_ssv_sweep.argtypes = [p, i64, p, i, i, p, p, p, i64, i64, p, p,
                                     p, ctypes.c_ulonglong, p, p, p]
        lib.hv_set_stamps.argtypes = [p]
    with tempfile.TemporaryDirectory(dir=ssv_cuda.BUILD_DIR) as work:
        hmm, fasta = write_workload(work, rows, positions, 7)
        engine = Havac(p_value=0.02, device=dev).load_phmm(hmm)
        engine.load_sequence(fasta)
    db = engine.database
    start = int(db.starts[0])
    scores = torch.from_numpy(engine.scores).to(dev)
    P, L = scores.shape[0], positions
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if (L + P - 1) // (3 * 256 * ssv_cuda.KERNEL_WORDS) >= 4 * sms:
        raise ValueError("the probe reads the short-sequence shapes, whose "
                         "undumped launch runs the 64-thread blocks")
    zs = torch.zeros(L, dtype=torch.int32, device=dev)
    zc = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    out = ssv_cuda.SweepBuffers.empty(L, P, 1 << 20, dev)
    dump = torch.empty((P, L), dtype=torch.uint8, device=dev)
    want = torch.empty((P, L), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []
    for tag, codes in (
            ("workload", db.codes[start:start + L]),
            ("random", np.random.default_rng(1).integers(0, 4, L)
             .astype(np.uint8))):
        sym = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
        ssv_cuda.ssv_sweep(sym, scores, dump=want)  # the port's own dump
        # The undumped launch does not depend on the dump's design.
        runs = [(None, DESIGNS[0][0], 0)] + [(name, name, threads)
                                             for name, threads, _ in DESIGNS]
        for design, lib_name, threads in runs:
            lib = libs[f"ssv_stamped_{lib_name}"]
            span = 3 * (threads if design else 64 * ssv_cuda.KERNEL_WORDS)
            nb = -(-(L + P - 1) // span)
            st = torch.zeros(4 * nb, dtype=torch.int64, device=dev)
            if lib.hv_set_stamps(st.data_ptr()) != 0:
                raise RuntimeError("hv_set_stamps failed")

            def go():
                rc = lib.hv_ssv_sweep(
                    sym.data_ptr(), L, scores.data_ptr(), P, 4,
                    zs.data_ptr(), zc.data_ptr(), None, 0, 0,
                    out.final_state.data_ptr(), out.final_carry.data_ptr(),
                    out.keys.data_ptr(), out.cap, out.count.data_ptr(),
                    dump.data_ptr() if design else None, stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed ({rc})")

            ms = _ms(go)
            st.zero_()
            dump.fill_(0xFF)
            go()
            torch.cuda.synchronize()
            if design and not torch.equal(dump, want):
                raise AssertionError(f"{tag}: the {design} dump differs "
                                     "from the port's")
            a = st.view(nb, 4).cpu().numpy()
            dur = (a[:, 1] - a[:, 0]) / 1e3
            slow = np.argsort(-dur)[:6]
            results.append({
                "codes": tag, "dump": design, "rows": P,
                "positions": L, "ms": ms, "blocks": nb,
                "hits": int(out.count.item()),
                "span_us": float((a[:, 1].max() - a[:, 0].min()) / 1e3),
                "median_block_us": float(np.median(dur)),
                "replays": int(a[:, 3].sum()),
                "slowest": [[int(b), bool(a[b, 2]), float(dur[b]),
                             int(a[b, 3])] for b in slow]})
    return results


def pattern(rows: int, positions: int, dev) -> dict:
    out_dir = os.path.join(ssv_cuda.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "dump_pattern.cu")
    with open(src, "w") as f:
        f.write(_PATTERN)
    lib = _build([("dump_pattern", src, [])])["dump_pattern"]
    lib.run_span.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int]
    buf = torch.zeros((rows, positions), dtype=torch.uint8, device=dev)
    out = {"fill_ms": _ms(lambda: buf.fill_(7), 3)}
    for span, threads in PATTERN_SPANS:
        out[f"span_{span}_ms"] = _ms(
            lambda: lib.run_span(buf.data_ptr(), positions, rows, span,
                                 threads), 3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=10_020)
    ap.add_argument("--positions", type=int, default=262_144)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("dump_probe needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    report = {"device": smi, "stamps": stamps(args.rows, args.positions, dev),
              "pattern": pattern(args.rows, args.positions, dev)}
    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
