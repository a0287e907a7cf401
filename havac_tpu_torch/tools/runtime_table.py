"""End-to-end runtime against collection size: the reference's headline curve.

The counterpart of `tools/runtime_table.py`. One chromosome-scale sequence
is searched against model collections of growing total length, each
through the engine's public path (``Havac(device=...)`` ``load_phmm`` /
``load_sequence`` / ``run`` / ``hits``), and each size's seconds, rates,
hits and host phases are printed as one JSON line.

With ``--synthetic`` the workload is generated from one seed,
draw for draw as the JAX tool generates it (``synthetic_workload``): a
50,818,468-position (chr22-length) chromosome, uniform random or with
``--composition genomic`` (GC isochores, diverged interspersed repeats,
tandem microsatellites, and every fifth model cut from a repeat family),
against synthetic DNA models of 60-200 positions. With ``--hmm`` and
``--fasta`` it reads real files (`tools/hmm_db_by_length.py` cuts a
collection into cumulative-length databases).

``--device`` defaults to ``cuda`` and raises where CUDA is missing; there
is no CPU fallback (``--device cpu`` runs the plain PyTorch sweep, which
the tests use). Without ``--allow-fallback`` the run fails unless the
port's native host core is loaded. ``--verify-sample N`` re-derives N
sampled raw hits by bounded re-SSV (``Havac.verify``) after ``hits()``;
its time is reported beside ``seconds``, never in it.

    python -m havac_tpu_torch.tools.runtime_table --synthetic \\
        --lengths 1007 10122 50120 150043 --verify-sample 10000
    python -m havac_tpu_torch.tools.runtime_table --hmm db_10000.hmm \\
        --fasta chr22.fa --json out.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from havac_tpu_torch import native
from havac_tpu_torch.engine import Havac
from havac_tpu_torch.io.fasta import SequenceDatabase
from havac_tpu_torch.io.hmm import ProfileHmm
from havac_tpu_torch.testing.generator import model_from_consensus
from havac_tpu_torch.testing.workload import CHR22_LENGTH
from havac_tpu_torch.utils.provenance import provenance

# The reference's published seconds at its model-collection sizes
# (`benchmark/runtime_table.py:5-9` of the reference): its FPGA
# implementation on an Alveo U50, and nhmmer's SSV on 32 threads. They are
# the reference's numbers, not this port's.
REFERENCE_SECONDS = {
    1007: (6.06, 2.36), 5055: (6.31, 8.32), 10122: (6.766, 20.53),
    20039: (6.88, 49.75), 30007: (7.41, 70.72), 50120: (8.02, 101.33),
    100048: (11.61, 281.54), 150043: (14.16, 434.84),
}
WORKLOAD_SEED = 7


def genomic_sequence(rng: np.random.Generator, seq_len: int,
                     repeat_families) -> np.ndarray:
    """A chromosome with genomic composition: GC-varying isochore blocks,
    interspersed repeat families copied with ~15 % divergence (repeats are
    what make real genomes dense in SSV hits) and tandem microsatellites,
    drawn from ``rng`` in the JAX tool's order."""
    seq = np.empty(seq_len, dtype=np.uint8)
    pos = 0
    while pos < seq_len:  # isochores: 50-300 kb blocks, GC 32-58 %
        blk = int(rng.integers(50_000, 300_000))
        gc = rng.uniform(0.32, 0.58)
        p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
        n = min(blk, seq_len - pos)
        seq[pos:pos + n] = rng.choice(4, size=n, p=p).astype(np.uint8)
        pos += n
    for fam, frac in repeat_families:  # interspersed repeats, diverged
        fam_len = fam.shape[0]
        ncopy = int(seq_len * frac) // fam_len
        starts = rng.integers(0, seq_len - fam_len, size=ncopy)
        for s in starts:
            copy = fam.copy()
            nmut = rng.binomial(fam_len, 0.15)
            idx = rng.integers(0, fam_len, size=nmut)
            copy[idx] = rng.integers(0, 4, size=nmut)
            seq[s:s + fam_len] = copy
    placed = 0
    while placed < int(seq_len * 0.03):  # tandem microsatellites, ~3 %
        unit = rng.integers(0, 4, size=int(rng.integers(2, 7))).astype(np.uint8)
        arr = np.tile(unit, int(rng.integers(10, 60)))
        s = int(rng.integers(0, seq_len - arr.shape[0]))
        seq[s:s + arr.shape[0]] = arr
        placed += arr.shape[0]
    return seq


def synthetic_workload(total_positions: int, seq_len: int,
                       composition: str = "uniform"
                       ) -> Tuple[List[ProfileHmm], np.ndarray]:
    """Models of ``total_positions`` positions and a ``seq_len`` chromosome
    of codes 0..3, from one ``default_rng(7)``: two repeat families, then
    the models, then the chromosome. ``composition="genomic"`` cuts every
    fifth model from a repeat family and builds the chromosome with
    :func:`genomic_sequence`."""
    rng = np.random.default_rng(WORKLOAD_SEED)
    families = [(rng.integers(0, 4, size=300).astype(np.uint8), 0.20),
                (rng.integers(0, 4, size=1500).astype(np.uint8), 0.10)]
    models = []
    cum = 0
    i = 0
    while cum < total_positions:
        length = int(rng.integers(60, 200))
        length = min(length, total_positions - cum) or 1
        if composition == "genomic" and i % 5 == 4:
            fam = families[i % len(families)][0]
            off = int(rng.integers(0, max(1, fam.shape[0] - length)))
            consensus = fam[off:off + max(length, 8)]
            if consensus.shape[0] < max(length, 8):
                consensus = np.tile(fam, 2)[:max(length, 8)]
        else:
            consensus = rng.integers(0, 4, size=max(length, 8)).astype(np.uint8)
        models.append(model_from_consensus(consensus, name=f"synth-{i}"))
        cum += models[-1].model_length
        i += 1
    if composition == "genomic":
        seq = genomic_sequence(rng, seq_len, families)
    else:
        seq = rng.integers(0, 4, size=seq_len).astype(np.uint8)
    return models, seq


def chromosome_database(seq: np.ndarray) -> SequenceDatabase:
    """One record of ``seq``'s codes, unpadded, as the JAX tool builds it."""
    return SequenceDatabase(codes=seq, starts=np.array([0, len(seq) + 1]),
                            lengths=np.array([len(seq)]),
                            names=["synth-chr"], seed=0)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hmm")
    ap.add_argument("--fasta")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--seq-len", type=int, default=CHR22_LENGTH)
    ap.add_argument("--lengths", type=int, nargs="+",
                    default=[1007, 10122, 50120, 150043],
                    help="model positions of each synthetic collection")
    ap.add_argument("--pvalue", type=float, default=0.02)
    ap.add_argument("--composition", choices=["uniform", "genomic"],
                    default="uniform",
                    help="synthetic chromosome: uniform random or genomic "
                    "(GC isochores + diverged repeats + tandems)")
    ap.add_argument("--json", default=None,
                    help="also write the provenance, rows and summary here")
    ap.add_argument("--repeat", type=int, default=1,
                    help="runs per size in one process; rows of iteration "
                    "> 0 are warm (the kernel library already loaded)")
    ap.add_argument("--allow-fallback", action="store_true",
                    help="run even when the native host core is unavailable "
                    "(rows tagged native_active=false); without it that "
                    "fails")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--verify-sample", type=int, default=0,
                    help="re-derive this many sampled raw hits of each run "
                    "(Havac.verify), timed apart from seconds")
    args = ap.parse_args(argv)
    if not args.synthetic and not (args.hmm and args.fasta):
        ap.error("give --synthetic, or --hmm and --fasta")
    return args


def run_point(args, device: torch.device, requested: Optional[int] = None,
              models=None, seq=None, it: int = 0) -> dict:
    """One search through the engine's public path; its JSON row. With
    ``models`` and ``seq`` (the synthetic collection of ``requested``
    positions) the load phase takes them as objects, else it reads
    ``args.hmm`` and ``args.fasta``."""
    engine = Havac(p_value=args.pvalue, device=device)
    t0 = time.perf_counter()
    if models is not None:
        engine.load_phmm(models)
        engine.load_sequence(chromosome_database(seq))
    else:
        engine.load_phmm(args.hmm)
        engine.load_sequence(args.fasta)
    t_load = time.perf_counter()
    engine.run()
    t_run = time.perf_counter()
    hits = engine.hits()
    elapsed = time.perf_counter() - t0
    st = engine.stats
    total = int(sum(m.model_length for m in engine.models))
    # A synthetic collection's last model has at least 8 positions, so it
    # may hold a few more than requested (50,121 for 50,120); the rows are
    # keyed by the size asked for, as the JAX tool's are.
    requested = total if requested is None else requested
    ref = REFERENCE_SECONDS.get(requested, (None, None))
    row = {
        "requested_positions": requested,
        "model_positions": total,
        "iter": it,
        "seconds": elapsed,
        "sweep_seconds": st.sweep_seconds,
        "gcups_e2e": st.cells / elapsed / 1e9,
        "gcups_sweep": st.gcups,
        "num_hits": len(hits),
        "num_raw_hits": st.num_raw_hits,
        "load_s": t_load - t0,
        "run_s": t_run - t_load,
        "resolve_s": elapsed - (t_run - t0),
        "reference_havac_s": ref[0],
        "reference_nhmmer32_s": ref[1],
        "phases": dict(st.pipeline_prof or {}),
        "composition": args.composition if args.synthetic else "file",
        "native_active": st.native_active,
        "overflow_retries": st.overflow_retries,
        "chunk_geometry": st.chunk_geometry,
        "device": str(device),
    }
    if args.verify_sample:
        t0 = time.perf_counter()
        report = engine.verify(sample=min(args.verify_sample,
                                          st.num_raw_hits))
        row["verify"] = {"sampled": report.num_hits,
                         "verified": report.num_verified,
                         "seconds": time.perf_counter() - t0}
    return row


def summarize(rows: List[dict]) -> List[dict]:
    """Min and median seconds of each requested size's cold (iteration 0)
    and warm (later) rows."""
    summary = []
    for total in dict.fromkeys(r["requested_positions"] for r in rows):
        same = [r for r in rows if r["requested_positions"] == total]
        for kind, sel in (("warm", [r for r in same if r["iter"] > 0]),
                          ("cold", [r for r in same if r["iter"] == 0])):
            if not sel:
                continue
            secs = sorted(r["seconds"] for r in sel)
            summary.append({
                "model_positions": total, "kind": kind, "n": len(secs),
                "min_s": secs[0], "median_s": secs[len(secs) // 2],
                "reference_havac_s": REFERENCE_SECONDS.get(total,
                                                           (None,))[0]})
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available on this "
                           "machine (there is no CPU fallback)")
    active = native.available()
    if not active and not args.allow_fallback:
        raise RuntimeError("the native host core is unavailable (g++ "
                           "builds it at first use); --allow-fallback runs "
                           "on the numpy host path, tagged "
                           "native_active=false")
    stamp = provenance(device, active)
    print(json.dumps({"provenance": stamp}), flush=True)
    rows = []
    sizes = args.lengths if args.synthetic else [None]
    for total in sizes:
        for it in range(args.repeat):
            models = seq = None
            if args.synthetic:
                models, seq = synthetic_workload(total, args.seq_len,
                                                 args.composition)
            rows.append(run_point(args, device, total, models, seq, it))
            print(json.dumps(rows[-1]), flush=True)
    summary = summarize(rows)
    for s in summary:
        print(json.dumps(s), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"provenance": stamp, "rows": rows,
                       "summary": summary}, f, indent=2)
    failed = [r for r in rows
              if "verify" in r and r["verify"]["verified"]
              != r["verify"]["sampled"]]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
