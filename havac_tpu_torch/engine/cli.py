"""Command-line interface of the PyTorch engine (``search`` only).

  python -m havac_tpu_torch.engine.cli search --hmm models.hmm \
      --fasta db.fasta --device cuda --pvalue 0.02 --out hits.tsv

``search`` writes a TSV of resolved hits (sequence name, position, model
name/accession, model position, strand), as `havac_tpu.engine.cli` does.
"""

from __future__ import annotations

import argparse
import sys


def _write_hits_tsv(engine, hits, out) -> None:
    out.write("#sequence\tseq_position\tmodel\tmodel_position\tstrand\n")
    names = engine.database.names
    models = engine.models
    for si, sp, mi, mp, st in hits.as_tuples_stranded():
        label = models[mi].accession or models[mi].name
        out.write(f"{names[si]}\t{sp}\t{label}\t{mp}\t{st}\n")


def cmd_search(args) -> int:
    from havac_tpu_torch.engine.api import Havac

    if args.verbose:
        import logging

        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(message)s")
    engine = Havac(p_value=args.pvalue, device=args.device,
                   chunk_symbols=args.chunk_symbols,
                   chunk_rows=args.chunk_rows, strand=args.strand,
                   isolate_models=args.isolate_models,
                   verify_hits=args.verify)
    engine.load_phmm(args.hmm)
    engine.load_sequence(args.fasta)
    engine.run()
    hits = engine.hits()
    out = open(args.out, "w") if args.out != "-" else sys.stdout
    try:
        _write_hits_tsv(engine, hits, out)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"{len(hits)} hits "
          f"({engine.stats.num_raw_hits} raw, "
          f"{engine.stats.gcups:.1f} GCUPS sweep)", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="havac_tpu_torch",
        description="SSV homology search on one device (PyTorch / CUDA)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("search", help="search a FASTA database, write hits")
    p.add_argument("--hmm", required=True, help="HMMER3 .hmm model collection")
    p.add_argument("--fasta", required=True, help="multi-FASTA database")
    p.add_argument("--device", required=True,
                   help="torch device: cuda, cuda:N (the CUDA kernel) or "
                        "cpu (the plain PyTorch sweep)")
    p.add_argument("--pvalue", type=float, default=0.02,
                   help="hit p-value threshold (default 0.02)")
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
    p.add_argument("--out", default="-", help="hits TSV path (- = stdout)")
    p.add_argument("--verbose", "-v", action="store_true")
    p.set_defaults(fn=cmd_search)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
