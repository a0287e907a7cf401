"""Command-line interface of the PyTorch engine.

  python -m havac_tpu_torch.engine.cli search --hmm models.hmm \
      --fasta db.fasta --device cuda --pvalue 0.02 --out hits.tsv
  python -m havac_tpu_torch.engine.cli benchmark --hmm models.hmm \
      --fasta db.fasta --device cuda
  python -m havac_tpu_torch.engine.cli scan --hmm models.hmm --device cuda \
      a.fasta b.fasta --out hits.tsv
  python -m havac_tpu_torch.engine.cli serve --hmm models.hmm --device cuda

The subcommands, arguments, outputs and exit codes of `havac_tpu.engine.cli`,
with ``--device`` (``cuda``, ``cuda:N`` or ``cpu``) in place of
``--backend``: ``search`` writes a TSV of resolved hits (sequence name,
position, model name/accession, model position, strand); ``benchmark``
prints phase timings and GCUPS as JSON; ``validate`` compares hits with
nhmmer ``--tblout`` windows or the float-SSV oracle; ``quantize`` rescores
nhmmer windows with int8 against float projections; ``scan`` streams many
FASTA files through :meth:`Havac.scan_files`; ``serve`` answers FASTA paths
read from stdin, one JSON status line per request, with one engine (and
one kernel build) for the whole process. ``--trace DIR`` writes a
``torch.profiler`` Chrome trace of the sweep to ``DIR/trace.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def _add_engine_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--pvalue", type=float, default=0.02,
                   help="hit p-value threshold (default 0.02)")
    p.add_argument("--device", required=True,
                   help="torch device: cuda, cuda:N (the CUDA kernel) or "
                        "cpu (the plain PyTorch sweep)")
    p.add_argument("--chunk-symbols", type=int, default=1 << 24,
                   help="sequence positions per kernel launch")
    p.add_argument("--chunk-rows", type=int, default=8160,
                   help="model rows per kernel launch")
    p.add_argument("--isolate-models", action="store_true",
                   help="reset DP chains at model boundaries")
    p.add_argument("--strand", default="forward", choices=["forward", "both"])
    p.add_argument("--verify", action="store_true",
                   help="re-derive every raw hit by bounded re-SSV and fail "
                        "if any is not reproduced")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="log engine phases to stderr")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--hmm", required=True, help="HMMER3 .hmm model collection")
    p.add_argument("--fasta", required=True, help="multi-FASTA database")
    _add_engine_args(p)
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace of the sweep to "
                        "DIR/trace.json")


def _build_engine(args):
    from havac_tpu_torch.engine.api import Havac

    if args.verbose:
        import logging

        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(message)s")
    return Havac(p_value=args.pvalue, device=args.device,
                 chunk_symbols=args.chunk_symbols,
                 chunk_rows=args.chunk_rows, strand=args.strand,
                 isolate_models=args.isolate_models,
                 verify_hits=args.verify)


@contextlib.contextmanager
def _maybe_trace(trace_dir, device):
    """A torch.profiler trace of the block (CPU on every thread, and the
    card's kernels on a CUDA device) written to ``trace_dir/trace.json``
    with the engine's spans and their arguments, or nothing."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity

    from havac_tpu_torch.engine import trace

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with trace.profiler(activities) as prof:
        yield
    trace.export_chrome_trace(prof, os.path.join(trace_dir, "trace.json"))


def _write_hits_tsv(engine, hits, out) -> None:
    out.write("#sequence\tseq_position\tmodel\tmodel_position\tstrand\n")
    names = engine.database.names
    models = engine.models
    for si, sp, mi, mp, st in hits.as_tuples_stranded():
        label = models[mi].accession or models[mi].name
        out.write(f"{names[si]}\t{sp}\t{label}\t{mp}\t{st}\n")


@contextlib.contextmanager
def _output(path):
    if path == "-":
        yield sys.stdout
    else:
        with open(path, "w") as out:
            yield out


def cmd_search(args) -> int:
    engine = _build_engine(args)
    engine.load_phmm(args.hmm)
    engine.load_sequence(args.fasta)
    with _maybe_trace(args.trace, engine.device):
        engine.run()
    hits = engine.hits()
    with _output(args.out) as out:
        _write_hits_tsv(engine, hits, out)
    print(f"{len(hits)} hits "
          f"({engine.stats.num_raw_hits} raw, "
          f"{engine.stats.gcups:.1f} GCUPS sweep)", file=sys.stderr)
    return 0


def cmd_benchmark(args) -> int:
    t0 = time.perf_counter()
    engine = _build_engine(args)
    t_build = time.perf_counter() - t0

    t0 = time.perf_counter()
    engine.load_phmm(args.hmm)
    engine.load_sequence(args.fasta)
    t_load = time.perf_counter() - t0

    t0 = time.perf_counter()
    with _maybe_trace(args.trace, engine.device):
        engine.run()
    t_run = time.perf_counter() - t0

    t0 = time.perf_counter()
    hits = engine.hits()
    t_hits = time.perf_counter() - t0

    total = t_build + t_load + t_run + t_hits
    report = {
        "phase_seconds": {
            "construction": round(t_build, 4),
            "data_load": round(t_load, 4),
            "sweep": round(t_run, 4),
            "hit_retrieval": round(t_hits, 4),
            "total": round(total, 4),
        },
        "cells": engine.stats.cells,
        "sweep_gcups": round(engine.stats.gcups, 2),
        "end_to_end_gcups": round(engine.stats.cells / max(total, 1e-9) / 1e9,
                                  2),
        "num_hits": len(hits),
        "num_raw_hits": engine.stats.num_raw_hits,
        "num_chunks": engine.stats.num_chunks,
        "backend": engine.backend,
    }
    if args.verify:
        report["verified_hits"] = engine.verification.num_verified
        report["unverified_hits"] = engine.stats.num_unverified
    print(json.dumps(report, indent=2))
    return 0


def cmd_validate(args) -> int:
    """Containment of the engine's hits in nhmmer windows: from a real
    ``--tblout`` file, or from the independent float-space SSV oracle on
    the same inputs."""
    from havac_tpu_torch.validation import (compare_containment,
                                      engine_hits_for_comparison, load_tblout)

    if not args.tblout and args.oracle != "float-ssv":
        print("validate: provide --tblout or --oracle float-ssv",
              file=sys.stderr)
        return 2
    engine = _build_engine(args)
    engine.load_phmm(args.hmm)
    engine.load_sequence(args.fasta)
    with _maybe_trace(args.trace, engine.device):
        engine.run()
    hits = engine_hits_for_comparison(engine)
    if args.tblout:
        windows = load_tblout(args.tblout)
    else:
        from havac_tpu_torch.validation.ssv_filter import float_ssv_windows

        windows = float_ssv_windows(engine.database, engine.models,
                                    engine.p_value)
    # Forward-only runs compare against '+' windows only (nhmmer --watson);
    # strand="both" runs keep '-' windows, matched by strand.
    report = compare_containment(hits, windows, slack=args.slack,
                                 watson_only=(engine.strand == "forward"))
    out = {
        "num_engine_hits": report.num_hits,
        "num_nhmmer_windows": report.num_windows,
        "hit_recall": round(report.hit_recall, 6),
        "window_recall": round(report.window_recall, 6),
        "uncontained_hits": len(report.uncontained_hits),
        "uncovered_windows": len(report.uncovered_windows),
    }
    if args.show_disagreements:
        out["uncontained_hit_list"] = report.uncontained_hits[:100]
        out["uncovered_window_list"] = [
            (w.target_name, w.query_name, w.seq_lo, w.seq_hi)
            for w in report.uncovered_windows[:100]]
    print(json.dumps(out, indent=2))
    return 0 if (report.hit_recall >= args.min_recall
                 and report.window_recall >= args.min_recall) else 1


def cmd_quantize(args) -> int:
    """Quantization forensics: rescore nhmmer windows with int8 against
    float projections (host-only; ``--device`` is not used)."""
    from havac_tpu_torch.io.fasta import load_fasta_database
    from havac_tpu_torch.io.hmm import read_hmm
    from havac_tpu_torch.validation import load_tblout, quantization_report

    models = read_hmm(args.hmm)
    db = load_fasta_database(args.fasta)
    windows_by_model = {}
    name_to_seq = {n: i for i, n in enumerate(db.names)}
    for w in load_tblout(args.tblout):
        label = w.query_accession or w.query_name
        si = name_to_seq.get(w.target_name)
        if si is None:
            continue
        s = int(db.starts[si])
        lo = s + max(0, w.seq_lo - 1)
        hi = s + min(int(db.lengths[si]), w.seq_hi)
        windows_by_model.setdefault(label, []).append(db.codes[lo:hi])

    out = {}
    for m in models:
        label = m.accession or m.name
        windows = windows_by_model.get(label, [])
        if not windows:
            continue
        rep = quantization_report(windows, m, args.pvalue)
        out[label] = {
            "num_windows": rep.num_windows,
            "int8_pass_256": rep.int8_pass_256,
            "int8_pass_250": rep.int8_pass_250,
            "float_pass_256": rep.float_pass_256,
            "disagreement_rate": round(rep.disagreement_rate, 6),
        }
    print(json.dumps(out, indent=2))
    return 0


def cmd_scan(args) -> int:
    """Streaming multi-file scan with prefetch (`Havac.scan_files`)."""
    engine = _build_engine(args)
    engine.load_phmm(args.hmm)
    total = 0
    with _output(args.out) as out, _maybe_trace(args.trace, engine.device):
        out.write("#file\tsequence\tseq_position\tmodel\tmodel_position"
                  "\tstrand\n")
        for path, hits in engine.scan_files(args.fastas,
                                            prefetch=args.prefetch):
            names = engine.database.names
            models = engine.models
            for si, sp, mi, mp, st in hits.as_tuples_stranded():
                label = models[mi].accession or models[mi].name
                out.write(f"{path}\t{names[si]}\t{sp}\t{label}\t{mp}\t{st}\n")
            total += len(hits)
            print(f"{path}: {len(hits)} hits", file=sys.stderr)
    print(f"{total} hits across {len(args.fastas)} files", file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """Warm-process server: scan FASTA databases on request.

    Reads one request per line from stdin — ``PATH`` or ``PATH<TAB>OUT.tsv``
    (default out: ``PATH.hits.tsv``) — and answers each with a JSON status
    line on stdout; blank lines are skipped and ``quit`` ends the server.
    The engine, and the kernel it built, persist across requests. A request
    whose input cannot be read or used answers ``{"file", "error"}`` and the
    server lives on; any other failure (a CUDA error among them) ends the
    process with a non-zero exit."""
    from havac_tpu_torch.hits.verify import HitVerificationError
    from havac_tpu_torch.engine.api import HavacUsageError

    engine = _build_engine(args)
    engine.load_phmm(args.hmm)
    print(json.dumps({"ready": True, "models": len(engine.models)}),
          flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line == "quit":
            break
        path, _, out_path = line.partition("\t")
        out_path = out_path or (path + ".hits.tsv")
        t0 = time.perf_counter()
        try:
            engine.load_sequence(path)
            engine.run()
            hits = engine.hits()
            with open(out_path, "w") as out:
                _write_hits_tsv(engine, hits, out)
        except (OSError, ValueError, HavacUsageError,
                HitVerificationError) as exc:
            print(json.dumps({"file": path, "error": str(exc)[:500]}),
                  flush=True)
            continue
        print(json.dumps({
            "file": path, "out": out_path, "hits": len(hits),
            "raw_hits": engine.stats.num_raw_hits,
            "seconds": round(time.perf_counter() - t0, 3),
            "gcups_sweep": round(engine.stats.gcups, 1),
        }), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="havac_tpu_torch",
        description="SSV homology search on one device (PyTorch / CUDA)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("search", help="search a FASTA database, write hits")
    _add_common(p)
    p.add_argument("--out", default="-", help="hits TSV path (- = stdout)")
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("benchmark", help="phase-timed end-to-end run")
    _add_common(p)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser(
        "validate", help="containment comparison vs nhmmer --tblout output "
        "or the independent float-SSV oracle")
    _add_common(p)
    p.add_argument("--tblout", default=None,
                   help="nhmmer --tblout file for the same hmm/fasta "
                        "(omit to validate against --oracle float-ssv)")
    p.add_argument("--oracle", default="float-ssv", choices=["float-ssv"],
                   help="window source when no --tblout is given")
    p.add_argument("--slack", type=int, default=0,
                   help="window-edge tolerance in positions")
    p.add_argument("--min-recall", type=float, default=0.98,
                   help="exit nonzero if either recall falls below this")
    p.add_argument("--show-disagreements", action="store_true")
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("quantize",
                       help="int8-vs-float rescoring of nhmmer windows")
    _add_common(p)
    p.add_argument("--tblout", required=True,
                   help="nhmmer --tblout windows to rescore")
    p.set_defaults(fn=cmd_quantize)

    p = sub.add_parser(
        "scan", help="streaming scan over many FASTA files with prefetch")
    p.add_argument("--hmm", required=True, help="HMMER3 .hmm model collection")
    p.add_argument("fastas", nargs="+", help="FASTA files to scan")
    _add_engine_args(p)
    p.add_argument("--prefetch", type=int, default=1,
                   help="files parsed ahead of the one sweeping")
    p.add_argument("--trace", metavar="DIR", default=None)
    p.add_argument("--out", default="-", help="hits TSV path (- = stdout)")
    p.set_defaults(fn=cmd_scan)

    p = sub.add_parser(
        "serve",
        help="warm-process server: FASTA paths on stdin, JSON status per "
             "request")
    p.add_argument("--hmm", required=True, help="HMMER3 .hmm model collection")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
