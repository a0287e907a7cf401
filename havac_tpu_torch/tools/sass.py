"""The loops of the port's compiled kernels, as SASS instruction counts.

    python -m havac_tpu_torch.tools.sass [--lib PATH] [--match SUBSTR]

Runs ``cuobjdump -sass`` on a kernel library (by default the roofline
probes', ``tools/roofline.py`` ``LIBRARY``, built first if missing) and
prints, for every kernel whose name contains ``--match``, its instruction
count and each loop (a backward branch and the instructions from its
target up to it): the loop's address range, instruction count, and how many
of them are barriers (``BAR``, one a row in the roofline kernels' row
loops), tensor-core products (``HMMA``/``IMMA``), shared-memory loads and
stores, and integer, conversion, shuffle and move instructions (``int``).
Loops nest: an outer loop's counts include its inner loops'. Dividing a
row loop's count by its rows (its barriers) and by the 16 words a thread
updates gives the roofline kernels' SASS per word and row that ``PERF.md``
reports. Each loop also shows its forward-branch pass (:func:`fast_path`):
the instructions one iteration issues when it takes every forward branch,
which in the sweep kernel's hit window skips the partial-window and replay
blocks; over the window's rows and words that is the sweep's SASS per word
and row. Needs the CUDA toolkit (``cuobjdump``).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function : (\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA\s+(?:\S+\s+)?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")

CLASSES = {
    "bar": ("BAR",),
    "mma": ("HMMA", "IMMA"),
    "lds": ("LDS",),
    "sts": ("STS",),
    "int": ("IMAD", "IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT",
            "IMNMX", "I2F", "F2I", "SHFL", "MOV", "IABS", "POPC", "FLO"),
}


def _opcode(text: str) -> str:
    tok = text.split()
    if tok and tok[0].startswith("@"):
        tok = tok[1:]
    return tok[0].split(".")[0] if tok else ""


def parse(sass: str) -> dict:
    """{kernel: [(address, opcode, text), ...]} plus label addresses."""
    kernels, cur, pending = {}, None, []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = kernels.setdefault(m.group(1), {"insns": [], "labels": {}})
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                cur["labels"][lab] = addr
            pending = []
            cur["insns"].append((addr, _opcode(m.group(2)), m.group(2)))
    return kernels


def loops(kernel: dict) -> list:
    """Every backward branch as (start, end, Counter of instruction classes,
    instruction count)."""
    out = []
    insns = kernel["insns"]
    for addr, op, text in insns:
        if op != "BRA":
            continue
        m = _TARGET.search(text)
        if not m:
            continue
        target = (kernel["labels"].get(m.group(1)) if m.group(1)
                  else int(m.group(2), 16))
        if target is None or target > addr:
            continue
        body = [o for a, o, _ in insns if target <= a <= addr]
        counts = Counter()
        for o in body:
            for cls, prefixes in CLASSES.items():
                if o.startswith(prefixes):
                    counts[cls] += 1
        out.append((target, addr, counts, len(body)))
    return sorted(out)


def fast_path(kernel: dict, start: int, end: int) -> Counter:
    """Opcodes of one pass through the loop [start, end] that takes every
    forward branch: a pass that skips each guarded block, such as the sweep
    kernel's partial-window and hit-replay code. ``Counter["total"]`` holds
    the instruction count."""
    at = {a: i for i, (a, _, _) in enumerate(kernel["insns"])}
    counts, i = Counter(), at[start]
    while True:
        addr, op, text = kernel["insns"][i]
        counts[op] += 1
        counts["total"] += 1
        if addr >= end:
            return counts
        m = _TARGET.search(text) if op == "BRA" else None
        target = None
        if m:
            target = (kernel["labels"].get(m.group(1)) if m.group(1)
                      else int(m.group(2), 16))
        i = at[target] if target is not None and target > addr else i + 1


def disassemble(lib: str) -> str:
    """``cuobjdump -sass`` of a kernel library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", default=None,
                    help="kernel library (default: the roofline probes', "
                    "built if missing; the sweep's: ops/ssv_cuda "
                    "library_path())")
    ap.add_argument("--match", default="roofline",
                    help="only kernels whose mangled name contains this")
    args = ap.parse_args(argv)
    lib = args.lib
    if lib is None:
        from havac_tpu_torch.ops import ssv_cuda
        from havac_tpu_torch.tools import roofline
        lib = ssv_cuda.build_library(*roofline.LIBRARY)[0]
    for name, kernel in parse(disassemble(lib)).items():
        if args.match not in name:
            continue
        print(f"{name}: {len(kernel['insns'])} instructions")
        for start, end, counts, n in loops(kernel):
            detail = " ".join(f"{c}={counts[c]}" for c in CLASSES)
            path = fast_path(kernel, start, end)["total"]
            print(f"  loop 0x{start:05x}-0x{end:05x}: {n} instructions, "
                  f"{detail}, forward-branch pass {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
