"""Time the narrow roofline kernels (add8, add16, int8mix, int16mix) and
count their row loops' SASS, for comparing two trees on one card.

    python -m havac_tpu_torch.tools.narrow_time [--ws 64] [--rows 30]
        [--lo 64] [--hi 4160] [--iters 5] [--copies N]

Each variant is timed as ``havac_tpu_torch.tools.roofline`` times it
(differential, CUDA events), by default at the copies that fill the card
once (``fill_copies`` where the tree has it, else SMs x resident blocks).
The SASS of each kernel's row loop (``cuobjdump``, via ``tools/sass.py``) is
counted a 32-bit output word (4 int8 or 2 int16 lanes) and row: the loop's
forward-branch pass (a row without the flush) plus the flush block once in 8
rows, split into the INT32 pipe's opcodes (:data:`INT32_PIPE`) and the rest,
with the issue and INT32 shares that the measured time implies. It imports
whichever ``havac_tpu_torch`` is first on the path, so two trees are compared
on one card by running it with ``PYTHONPATH`` set to each in turn (parent,
change, change, parent). Prints one JSON object with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

import torch

from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.tools import roofline, sass

NARROW = ("add8", "add16", "int8mix", "int16mix")
# Opcodes that issue on the INT32 pipe only (logic, shifts, permutes,
# compares, 3-input adds). IMAD runs on the FMA pipe; VIADD (Hopper's add,
# with its .16x2 form) is counted apart, its pipe not being documented.
INT32_PIPE = ("LOP3", "SHF", "IADD3", "LEA", "ISETP", "SEL", "PRMT", "IMNMX",
              "VIMNMX", "VIADDMNMX", "FLO", "POPC", "BMSK", "SGXT", "PLOP3",
              "IABS", "BREV")
KERNEL = {"add8": "add_chain_kernelILi1E", "add16": "add_chain_kernelILi2E",
          "int8mix": "narrow_mix_kernelILi1E",
          "int16mix": "narrow_mix_kernelILi2E"}


def words_per_thread(name: str) -> int:
    """A thread's 32-bit output words: 12 (48 int8 lanes in 16 field words)
    in the field layout, else 16."""
    return 12 if name in getattr(roofline, "FIELD_VARIANTS", ()) else 16


def row_loop(kernel: dict, name: str) -> tuple[int, int, int]:
    """The row loop: the smallest loop that reads a row's scores from shared
    memory (int*mix) or the smallest loop over a thread's words (add*)."""
    found = [(n, s, e) for s, e, c, n in sass.loops(kernel)
             if c["bar"] == 0 and c["sts"] == 0
             and (c["lds"] >= 1 if "mix" in name else n > 16)]
    n, s, e = min(found)
    return s, e, n


def row_sass(kernels: dict, name: str) -> dict:
    """SASS a word and row of the variant's row loop: {"total", "int32",
    "viadd", "imad", "opcodes"} (opcodes: a row's count of each)."""
    kname = next(n for n in kernels if KERNEL[name] in n)
    kernel = kernels[kname]
    start, end, n = row_loop(kernel, name)
    fast = sass.fast_path(kernel, start, end)
    body = Counter(op for a, op, _ in kernel["insns"] if start <= a <= end)
    # A row: the pass without the flush, plus the flush once in 8 rows.
    per_row = Counter({op: fast[op] + (body[op] - fast[op]) / 8
                       for op in body})
    words = words_per_thread(name)
    total = sum(per_row.values())
    return {"total": total / words,
            "int32": sum(per_row[o] for o in INT32_PIPE) / words,
            "viadd": per_row["VIADD"] / words,
            "imad": per_row["IMAD"] / words,
            "opcodes": {o: v / words for o, v in sorted(per_row.items())},
            "loop_instructions": n, "words_per_thread": words}


def default_copies(name: str, ws: int, k: int, sms: int) -> int:
    if hasattr(roofline, "fill_copies"):
        return roofline.fill_copies(name, ws, k, sms)
    return sms * roofline.blocks_per_sm(name, ws, k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ws", type=int, default=64)
    ap.add_argument("--rows", type=int, default=30)
    ap.add_argument("--lo", type=int, default=64)
    ap.add_argument("--hi", type=int, default=4160)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--copies", type=int, default=None)
    ap.add_argument("--variants", nargs="*", default=list(NARROW))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("narrow_time needs a CUDA device")
    dev = torch.device("cuda:0")
    card = roofline.Card.query(dev)
    kernels = sass.parse(sass.disassemble(
        ssv_cuda.build_library(*roofline.LIBRARY)[0]))
    clk = card.sms * card.max_sm_mhz * 1e6
    report = {"device": card.smi, "package": ssv_cuda.__file__,
              "ws": args.ws, "rows": args.rows, "results": {}}
    for name in args.variants:
        copies = args.copies or default_copies(name, args.ws, args.rows,
                                               card.sms)
        r = roofline.run_variant(name, args.ws, args.rows, args.lo, args.hi,
                                 args.iters, dev, copies, card)
        words_per_s = copies * args.rows * args.ws * 128 / r["sec_per_rep"]
        bound_s = max(card.op_seconds(
            name, copies * args.rows * args.ws * 128))
        s = row_sass(kernels, name)
        report["results"][name] = {
            "ms_per_rep": r["sec_per_rep"] * 1e3, "copies": copies,
            "gcups_equiv_card": r["gcups_equiv_card"],
            "bound_ms": bound_s * 1e3,
            "share_of_bound": bound_s / r["sec_per_rep"],
            "sass_per_word_row": s["total"],
            "int32_per_word_row": s["int32"],
            "viadd_per_word_row": s["viadd"],
            "imad_per_word_row": s["imad"],
            "sass_issue_share": s["total"] * words_per_s
            / (roofline.ISSUE_LANES_PER_SM * clk),
            "sass_int32_share": s["int32"] * words_per_s
            / (roofline.INT32_LANES_PER_SM * clk),
            "opcodes_per_word_row": s["opcodes"],
            "loop_instructions": s["loop_instructions"],
            "words_per_thread": s["words_per_thread"]}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
