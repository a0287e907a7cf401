"""Op-mix roofline of the SWAR SSV row update on an NVIDIA GPU: the port of
``tools/roofline.py``.

Each variant runs the exact per-row op sequence of one candidate row update
over a fixed buffer, K rows per rep, ``reps`` times, and is timed
differentially, ``(t(hi) - t(lo)) / (hi - lo)`` with one launch at each rep
count, so that launch and transfer costs cancel. The kernels are
``havac_tpu_torch/csrc/roofline.cu`` (one instance per block, ``copies``
blocks), built into a library of their own, apart from the sweep's
(:func:`load_library`); their plain PyTorch versions are
:func:`op_mix_plain`. Inputs come from ``np.random.default_rng(0)`` in the
JAX tool's order, so a kernel's output equals ``tools/roofline.py``
``make_variant(name, ws, k)``'s word for word.

Variants (the JAX tool's; see its docstring for what each prices):

  int32, 3 cells per word (kernel ``roofline_op_mix``): current, perrow,
      leanhit, nomatch, noroll, addonly, mulcost, andmatch;
  add chain on int8 / int16 (``roofline_add_chain``): add8, add16;
  full row update on int8 / int16 (``roofline_narrow_mix``): int8mix,
      int16mix;
  match precompute (``roofline_strip``): stripmatch, ``current`` with the
      strip's match planes built a row ahead into a per-thread ring in
      shared memory;
  match product (``roofline_mxu``): mxumatch (bf16) and mxumatch8 (int8),
      the match words of each flush of 10 rows from one tensor-core product
      (scores x one-hot), repacked into 10-bit fields.

``mxumatch*`` keep their warps' packed match words in shared memory, so
they take a smaller WS than the others: :func:`max_ws` (48 at K = 30).
``mxumatch*`` need K a multiple of 10 (the JAX tool silently runs
10 * (K // 10) rows and reports K).

Usage::

    python -m havac_tpu_torch.tools.roofline [--ws WS] [--rows 30]
        [--lo 64] [--hi 4160] [--iters 5] [--copies N]
        [--variants current perrow ...] [--device cuda|cpu] [--json out.json]

On ``cuda`` the kernels run (``--copies`` defaults to :func:`fill_copies`,
the copies that fill the card once) and a variant whose rate would need more integer
operations than the card can issue fails the run; ``cpu`` times the plain
versions (defaults ``--lo 1 --hi 3``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from havac_tpu_torch.ops import ssv_cuda

FMASK = 0x00100401  # bit 0 of each 10-bit field
ROWS_PER_FLUSH = 10  # int32 variants
NARROW_ROWS_PER_FLUSH = 8  # int8mix / int16mix
NS = 16  # score strips; rep r uses strip r % NS (anti-hoisting)
INT32_MIN = -(1 << 31)  # what the TPU kernel's unwritten carry queue holds

INT32_VARIANTS = ("current", "perrow", "leanhit", "nomatch", "noroll",
                  "addonly", "mulcost", "andmatch")
ADD_VARIANTS = ("add8", "add16")
MIX_VARIANTS = ("int8mix", "int16mix")
MXU_VARIANTS = ("mxumatch", "mxumatch8")
VARIANTS = (INT32_VARIANTS + ADD_VARIANTS + MIX_VARIANTS + ("stripmatch",)
            + MXU_VARIANTS)

KERNELS = ("roofline_op_mix", "roofline_add_chain", "roofline_narrow_mix",
           "roofline_strip", "roofline_mxu")
KERNEL_OF = {**dict.fromkeys(INT32_VARIANTS, KERNELS[0]),
             **dict.fromkeys(ADD_VARIANTS, KERNELS[1]),
             **dict.fromkeys(MIX_VARIANTS, KERNELS[2]),
             "stripmatch": KERNELS[3],
             **dict.fromkeys(MXU_VARIANTS, KERNELS[4])}
ROOFLINE_LAUNCHES = dict.fromkeys(KERNELS, 0)  # CUDA launches per kernel
# The probes' library (ops/ssv_cuda.build_library): its stem and sources.
LIBRARY = ("libhavac_roofline", ("roofline.cu",))
_lib = None
_lib_lock = threading.Lock()

MAX_WS = 64  # one instance per block: 512 threads of 16 words
MAX_ROWS = 128
# add8 / int8mix keep three int8 lanes in the 10-bit fields of a word; their
# lanes are independent, so their kernels spread the copies' lanes over
# 256-thread blocks, 48 lanes (16 field words) a thread.
FIELD_VARIANTS = ("add8", "int8mix")
FIELD_THREADS = 256
FIELD_LANES = 48
# Variants whose shared memory caps WS below MAX_WS (the warps' rings of
# match words): the kernel library decides how large a WS fits a block.
# stripmatch's ring (a plane a thread) fits WS 64 at every K; its launch
# still fails loudly if the card refuses it.
SMEM_VARIANTS = MXU_VARIANTS

# Lower bounds on the integer instructions per 32-bit word and row that an
# exact compile of each mix must issue, with Hopper's fusions (LOP3 takes any
# 3-input logic, IADD3 three addends, IMAD a multiply and an add): (all,
# logic-only). Logic ops have no FMA-pipe form, so they issue on the INT32
# pipe; adds, multiplies and left shifts may issue as IMAD on the FMA pipe.
MIN_OPS = {
    "current": (11, 3), "perrow": (11, 3), "noroll": (11, 3),
    "leanhit": (10, 3), "nomatch": (8, 3), "andmatch": (12, 6),
    "addonly": (2, 1), "mulcost": (2, 1),
    # add8 / add16, a 32-bit word's 4 int8 or 2 int16 lanes: an instruction
    # writes at most 32 bits, and (s + i) ^ s folds into nothing, so a word
    # and row takes at least one add and one xor, the xor a logic op, for
    # any layout of the lanes (packed, or 3 a word in fields: more words).
    "add8": (2, 1), "add16": (2, 1),
    # int8mix / int16mix, a word's lanes and row, any layout: the 4:1
    # select (one PRMT of the row's four scores at the word's selector at
    # best), the add, the carry-out (one LOP3 of state, match and sum), the
    # reset lanes' mask (one instruction, an IMAD at best), the state (one
    # LOP3), the hit (one LOP3: carry and not the match's sign), the hit
    # moved to the lane's bit 0 (a right shift) and 2 bits + hit (an IMAD):
    # 8, of which the PRMT, the three LOP3s and the shift have no FMA-pipe
    # form. The flush (one xor in 8 rows) is left out. A field layout, 3
    # lanes a word, needs 4/3 as many of each per 4 int8 lanes.
    "int8mix": (8, 5), "int16mix": (8, 5),
    # stripmatch: `current` with the 3 match IMADs moved to the plane
    # build (still 3 a word and row), the row keeping its add (1),
    # SHF (1), bits (2), keep mask (2) and state (2); plus one 16-byte
    # shared store (build) and load (row) per 4 words: 8 + 3 + 0.5.
    "stripmatch": (11.5, 3),
    # mxumatch8: the repack m0 + (m1 << 10) + (m2 << 20) + bias fuses into
    # 2 IMADs and the row's add into an IADD3 (3), the rest of the row as
    # `current` (7); the product, one mma per 8 columns, 3 columns a word,
    # once in 10 rows (3/80). mxumatch the same: an f32 accumulator started
    # at 1.5 * 2^23 carries the integer in its bits, so the work has no
    # conversion. The work's count, not a design's: staging the product in
    # shared memory is not counted.
    "mxumatch8": (10 + 3 / 80, 3),
    "mxumatch": (10 + 3 / 80, 3),
}
INT32_LANES_PER_SM = 64  # INT32 pipe lanes per SM (Hopper)
ISSUE_LANES_PER_SM = 128  # 4 schedulers x one 32-thread instruction a clock
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def _check_name(name: str) -> None:
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}")


def _check_rows(name: str, k: int) -> None:
    if name in MXU_VARIANTS and k % ROWS_PER_FLUSH:
        raise ValueError(f"{name} runs whole flushes of {ROWS_PER_FLUSH} "
                         f"rows: K = {k} is not a multiple")


def _dtype(name: str) -> torch.dtype:
    """The output's dtype (and the planes', but for ``mxumatch*``)."""
    if name in INT32_VARIANTS or name == "stripmatch" or name in MXU_VARIANTS:
        return torch.int32
    return torch.int8 if name in ("add8", "int8mix") else torch.int16


def _input_dtype(name: str) -> torch.dtype:
    """The dtype of the planes (the one-hot for ``mxumatch*``) and, for
    ``mxumatch*``, of the scores."""
    return {"mxumatch": torch.bfloat16,
            "mxumatch8": torch.int8}.get(name, _dtype(name))


def _plane_shape(name: str, ws: int) -> tuple[int, ...]:
    return (4, 3 * ws, 128) if name in MXU_VARIANTS else out_shape(name, ws)


def _scores_shape(name: str, k: int) -> tuple[int, ...]:
    if name in MXU_VARIANTS:
        return (NS * (k // ROWS_PER_FLUSH), ROWS_PER_FLUSH, 4)
    return (NS, k, 4)


def out_shape(name: str, ws: int) -> tuple[int, int]:
    """The TPU kernel's output shape: (WS, 128) int32, (4 WS, 128) int8 or
    (2 WS, 128) int16 (the same bytes)."""
    return (ws * 4 // _dtype(name).itemsize, 128)


def cells_per_rep(name: str, ws: int, k: int) -> int:
    """Cells one instance updates per rep (the JAX tool's count)."""
    if _dtype(name) == torch.int32:
        return k * 3 * ws * 128  # 3 cells per int32 word
    return k * out_shape(name, ws)[0] * 128


def layout(name: str) -> str:
    """The JAX tool's layout string."""
    if name in INT32_VARIANTS:
        return "3 cells / int32 lane"
    if name == "stripmatch":
        return "3 cells / int32 lane, strip planes"
    if name in MXU_VARIANTS:
        return ("3 cells / int32 lane, MXU match "
                f"({'int8' if name == 'mxumatch8' else 'bf16'})")
    if name in ADD_VARIANTS:
        return f"1 elt / {_dtype(name).itemsize}-byte lane"
    return "4 cells / lane (int8)" if name == "int8mix" else \
        "2 cells / lane (int16)"


@dataclass(frozen=True)
class OpMixInputs:
    """One variant's inputs: the planes (i1, i2, i3; i1 alone for the add
    chains) in the output's shape and dtype, and the (NS, K, 4) int32
    scores (None for the add chains). ``mxumatch*`` take the (4, 3 WS, 128)
    one-hot of the symbols as their one plane and (NS K / 10, 10, 4) scores,
    both bf16 or int8."""

    name: str
    ws: int
    k: int
    planes: tuple[torch.Tensor, ...]
    scores: Optional[torch.Tensor]

    @property
    def device(self) -> torch.device:
        return self.planes[0].device


def make_inputs(name: str, ws: int, k: int, device="cpu") -> OpMixInputs:
    """The inputs ``tools/roofline.py`` ``make_variant(name, ws, k)`` builds,
    from ``np.random.default_rng(0)`` in its order."""
    _check_name(name)
    _check_rows(name, k)
    rng = np.random.default_rng(0)
    rows = out_shape(name, ws)[0]
    np_dt = {torch.int32: np.int32, torch.int16: np.int16,
             torch.int8: np.int8}[_dtype(name)]
    scores = None
    if name in MXU_VARIANTS:
        sym3 = rng.integers(0, 4, size=(3 * ws, 128))
        onehot = sym3[None] == np.arange(4)[:, None, None]
        sc = rng.integers(-128, 128, size=_scores_shape(name, k))
        dt = _input_dtype(name)  # both exact in bf16 and in int8
        return OpMixInputs(
            name, ws, k, (torch.from_numpy(onehot.astype(np.float32)).to(
                dt).to(device),),
            torch.from_numpy(sc.astype(np.float32)).to(dt).to(device))
    if name in INT32_VARIANTS or name == "stripmatch":
        sym = rng.integers(0, 4, size=(ws, 128))
        # andmatch takes full-field indicator masks, the others bit 0.
        pbit = 0x3FFFFFFF if name == "andmatch" else FMASK
        planes = [((sym == a) * pbit).astype(np.int32) for a in (1, 2, 3)]
        scores = rng.integers(128, 384, size=(NS, k, 4)).astype(np.int32)
    elif name in ADD_VARIANTS:
        planes = [rng.integers(0, 3, size=(rows, 128)).astype(np_dt)]
    else:
        planes = [rng.integers(0, 2, size=(rows, 128)).astype(np_dt)
                  for _ in range(3)]
        scores = rng.integers(-40, 110, size=(NS, k, 4)).astype(np.int32)
    return OpMixInputs(
        name, ws, k, tuple(torch.from_numpy(p).to(device) for p in planes),
        None if scores is None else torch.from_numpy(scores).to(device))


# ---------------------------------------------------------------- plain

def _i32(x: int) -> int:
    """A Python int wrapped to int32, as the TPU's scalar arithmetic does."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def shift_stitch(state: torch.Tensor, cin) -> torch.Tensor:
    """The TPU kernel's two ``pltpu.roll``s and two selects: a flat roll of
    the row-major buffer by one word, word 0 taking the seam stitch
    ``(state[-1, -1] << 10) | cin``."""
    flat = state.reshape(-1)
    out = torch.roll(flat, 1)
    out[0] = (flat[-1] << 10) | cin
    return out.view_as(state)


def initial_queue(k: int, device="cpu") -> torch.Tensor:
    """``perrow``'s (2, K+1) carry queue as the TPU kernel first reads it:
    7 at k = 0 in both slots, INT32_MIN (unwritten scratch) elsewhere."""
    q = torch.full((2, k + 1), INT32_MIN, dtype=torch.int32, device=device)
    q[:, 0] = 7
    return q


def _row(state: torch.Tensor, bits: torch.Tensor, match: torch.Tensor,
         cin) -> tuple[torch.Tensor, torch.Tensor]:
    """``current``'s row update: roll with the seam stitch, biased add, bit-9
    hit into ``bits``, keep mask."""
    fm = FMASK
    w = shift_stitch(state, cin) + match
    t9 = w >> 9
    bits = (bits << 1) | (t9 & fm)
    kmask = (w >> 8) & ~t9 & fm
    return w & (kmask * 255), bits


def _plain_int32(x: OpMixInputs, reps: int) -> torch.Tensor:
    name, K = x.name, x.k
    i1, i2, i3 = x.planes
    sc = x.scores.tolist()
    fm = FMASK
    state, bits, acc = i1.clone(), torch.zeros_like(i1), torch.zeros_like(i1)
    inz8 = (i1 | i2 | i3) & (fm * 256)  # andmatch: 256 per nonzero field
    q = initial_queue(K, i1.device) if name == "perrow" else None
    for r in range(reps):
        strip, rslot = sc[r % NS], r % 2
        for k in range(K):
            m0, m1, m2, m3 = strip[k]
            if name == "addonly":
                state = (state + i1) ^ state
            elif name == "mulcost":
                state = (state * i1) ^ state
            else:
                c = _i32(m0 * fm)
                if name == "nomatch":
                    match = c
                elif name == "andmatch":
                    s1, s2, s3 = (_i32(((m - m0 + 256) & 0x3FF) * fm)
                                  for m in (m1, m2, m3))
                    match = (i1 & s1) + (i2 & s2) + (i3 & s3) - inz8 + c
                else:
                    match = (i1 * _i32(m1 - m0) + i2 * _i32(m2 - m0)
                             + i3 * _i32(m3 - m0) + c)
                cin = q[rslot, k] if q is not None else 7
                if name == "leanhit":
                    w = shift_stitch(state, cin) + match
                    b9 = w & (fm << 9)
                    bits = (bits >> 1) | b9
                    keep = (w & (fm << 8)) & ~(b9 >> 1)
                    state = w & (keep - (keep >> 8))
                elif name == "noroll":
                    w = state + match
                    t9 = w >> 9
                    bits = (bits << 1) | (t9 & fm)
                    kmask = (w >> 8) & ~t9 & fm
                    state = w & (kmask * 255)
                else:
                    state, bits = _row(state, bits, match, cin)
                if q is not None:  # the per-row scalar side
                    q[1 - rslot, k + 1] = state.view(-1)[-1] >> 20
            if (k + 1) % ROWS_PER_FLUSH == 0:
                acc = acc ^ bits
                bits = torch.zeros_like(state)
    return state + bits + acc


def _plain_add(x: OpMixInputs, reps: int) -> torch.Tensor:
    i1 = x.planes[0]
    state = i1.clone()
    for _ in range(reps * x.k):
        state = (state + i1) ^ state
    return state


def _plain_narrow_mix(x: OpMixInputs, reps: int) -> torch.Tensor:
    dt = x.planes[0].dtype
    b1, b2, b3 = (p != 0 for p in x.planes)
    sc = x.scores.to(dt)  # astype: truncates
    zero = torch.zeros((), dtype=dt, device=sc.device)
    state = b1.to(dt)
    bits, acc = torch.zeros_like(state), torch.zeros_like(state)
    for r in range(reps):
        strip = sc[r % NS]
        for k in range(x.k):
            m = strip[k]
            match = torch.where(b1, m[1], m[0])  # 4:1 select tree
            match = torch.where(b2, m[2], match)
            match = torch.where(b3, m[3], match)
            sumw = state + match
            cvec = (state & match) | ((state | match) & ~sumw)
            carry_neg, msign = cvec < 0, match < 0
            reset = carry_neg ^ msign
            hit = carry_neg & ~msign
            bits = bits + bits + hit.to(dt)
            state = torch.where(reset, zero, sumw)
            if (k + 1) % NARROW_ROWS_PER_FLUSH == 0:
                acc = acc ^ bits
                bits = torch.zeros_like(state)
    return state + bits + acc


def _plain_strip(x: OpMixInputs, reps: int) -> torch.Tensor:
    i1, i2, i3 = x.planes
    sc = x.scores.tolist()
    state, bits, acc = i1.clone(), torch.zeros_like(i1), torch.zeros_like(i1)
    for r in range(reps):
        planes = [_i32(m0 * FMASK) + i1 * _i32(m1 - m0) + i2 * _i32(m2 - m0)
                  + i3 * _i32(m3 - m0) for m0, m1, m2, m3 in sc[r % NS]]
        for k in range(x.k):  # the hot loop: the match is a plane
            state, bits = _row(state, bits, planes[k], 7)
            if (k + 1) % ROWS_PER_FLUSH == 0:
                acc = acc ^ bits
                bits = torch.zeros_like(state)
    return state + bits + acc


def _plain_mxu(x: OpMixInputs, reps: int) -> torch.Tensor:
    ws, nf = x.ws, x.k // ROWS_PER_FLUSH
    # The product in float64: every sum is a small integer, so it is exact,
    # as the kernel's f32 / int32 accumulator is.
    onehot = x.planes[0].to(torch.float64).reshape(4, -1)
    scores = x.scores.to(torch.float64)
    state = torch.zeros((ws, 128), dtype=torch.int32, device=onehot.device)
    bits, acc = torch.zeros_like(state), torch.zeros_like(state)
    bias = 256 * FMASK
    for r in range(reps):
        for f in range(nf):
            mdot = (scores[(r % NS) * nf + f] @ onehot).to(torch.int32)
            mdot = mdot.reshape(ROWS_PER_FLUSH, 3 * ws, 128)
            for k in range(ROWS_PER_FLUSH):
                m0, m1, m2 = mdot[k, :ws], mdot[k, ws:2 * ws], mdot[k, 2 * ws:]
                match = m0 + (m1 << 10) + (m2 << 20) + bias
                state, bits = _row(state, bits, match, 7)
            acc = acc ^ bits
            bits = torch.zeros_like(state)
    return state + bits + acc


def op_mix_plain(name: str, inputs: OpMixInputs, reps: int) -> torch.Tensor:
    """The plain PyTorch version of variant ``name``: what the TPU kernel's
    ``out_ref`` holds after ``reps`` reps, on the inputs' device."""
    _check_name(name)
    if name != inputs.name:
        raise ValueError(f"inputs are {inputs.name!r}'s, not {name!r}'s")
    _check_rows(name, inputs.k)
    if name in INT32_VARIANTS:
        return _plain_int32(inputs, reps)
    if name == "stripmatch":
        return _plain_strip(inputs, reps)
    if name in MXU_VARIANTS:
        return _plain_mxu(inputs, reps)
    if name in ADD_VARIANTS:
        return _plain_add(inputs, reps)
    return _plain_narrow_mix(inputs, reps)


# ---------------------------------------------------------------- kernels

def load_library() -> ctypes.CDLL:
    """The probes' library, built at the first call of the process and
    loaded once, its C entry points typed."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path = ssv_cuda.build_library(*LIBRARY)[0]
            p, i = ctypes.c_void_p, ctypes.c_int
            _lib = ssv_cuda.open_library(path, (
                ("hv_roofline_op_mix", i, [i, p, p, p, p, i, i, i, i, p, p]),
                ("hv_roofline_add_chain", i, [i, p, i, i, i, i, p, p]),
                ("hv_roofline_narrow_mix", i, [i, p, p, p, p, i, i, i, i, p,
                                               p]),
                ("hv_roofline_strip", i, [p, p, p, p, i, i, i, i, p, p]),
                ("hv_roofline_mxu", i, [i, p, p, i, i, i, i, p, p]),
                ("hv_roofline_add16x2", i, [p, p, ctypes.c_longlong, p, p]),
                ("hv_roofline_blocks_per_sm", i,
                 [i, i, i, i, ctypes.POINTER(i)]),
                ("hv_roofline_error_string", ctypes.c_char_p, [i])))
        return _lib


def _occupancy(name: str, ws: int, k: int) -> int:
    """The library's resident blocks per SM of the variant's kernel at
    (ws, k); 0 where a block of that shape does not fit the SM (its shared
    memory above what a block may use)."""
    kernel = KERNELS.index(KERNEL_OF[name])
    which = (INT32_VARIANTS.index(name) if kernel == 0
             else _input_dtype(name).itemsize)
    n = ctypes.c_int(0)
    lib = load_library()
    rc = lib.hv_roofline_blocks_per_sm(kernel, which, ws, k, ctypes.byref(n))
    return n.value if rc == 0 else 0


def max_ws(name: str, k: int = 30) -> int:
    """The largest WS the variant's kernel takes at K = k: MAX_WS, or for
    ``mxumatch*`` the largest multiple of 4 whose match rings fit a block's
    shared memory, as the kernel library reports it for the current card
    (48 at K = 30 on an H100)."""
    _check_name(name)
    _check_rows(name, k)
    if name not in SMEM_VARIANTS:
        return MAX_WS
    for ws in range(MAX_WS, 3, -4):
        if _occupancy(name, ws, k) >= 1:
            return ws
    raise ValueError(f"{name}: no WS fits a block at K = {k}")


def check_kernel_shape(ws: int, k: int, name: str = "current") -> None:
    """Raise unless the variant's kernel holds a (ws, 128) buffer at K = k:
    one instance per block of ws * 8 threads, 16 words in registers each,
    WS at most :func:`max_ws`."""
    _check_name(name)
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"--rows {k}: the CUDA kernels take 1..{MAX_ROWS}")
    _check_rows(name, k)
    top = max_ws(name, k) if 4 <= ws <= MAX_WS else MAX_WS
    if not (4 <= ws <= top and ws % 4 == 0):
        raise ValueError(f"--ws {ws}: the CUDA kernel of {name} holds WS in "
                         f"4..{top} at K = {k}, a multiple of 4 (one "
                         f"instance per block)")


def _check(x: OpMixInputs, reps: int, copies: int) -> None:
    def need(ok, msg):
        if not ok:
            raise ValueError(msg)

    need(reps >= 0 and copies >= 1, "reps must be >= 0 and copies >= 1")
    _check_rows(x.name, x.k)
    shape, dt = _plane_shape(x.name, x.ws), _input_dtype(x.name)
    need(len(x.planes) == (1 if x.name in ADD_VARIANTS + MXU_VARIANTS
                           else 3), "wrong number of planes")
    for p in x.planes:
        need(p.dtype == dt and tuple(p.shape) == shape,
             f"planes must be {dt} {shape}")
    if x.name in ADD_VARIANTS:
        need(x.scores is None, "the add chains take no scores")
    else:
        sdt = dt if x.name in MXU_VARIANTS else torch.int32
        sshape = _scores_shape(x.name, x.k)
        need(x.scores is not None and x.scores.dtype == sdt
             and tuple(x.scores.shape) == sshape,
             f"scores must be {sdt} {sshape}")
    tensors = [*x.planes] + ([] if x.scores is None else [x.scores])
    for t in tensors:
        need(t.device == x.device, "all tensors must be on one device")
        need(t.is_contiguous(), "all tensors must be contiguous")


def op_mix(inputs: OpMixInputs, reps: int, copies: int = 1) -> torch.Tensor:
    """``copies`` instances of the variant's output, (copies, *shape). On
    CUDA tensors this launches the variant's kernel once on the current
    stream (no synchronisation) and counts it in ``ROOFLINE_LAUNCHES``; CPU
    tensors take the plain version."""
    name = inputs.name
    _check_name(name)
    _check(inputs, reps, copies)
    dev = inputs.device
    if dev.type == "cpu":
        return op_mix_plain(name, inputs, reps).unsqueeze(0).repeat(
            copies, 1, 1)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_kernel_shape(inputs.ws, inputs.k, name)
    out = torch.empty((copies, *out_shape(name, inputs.ws)),
                      dtype=_dtype(name), device=dev)
    lib = load_library()
    ptrs = [p.data_ptr() for p in inputs.planes]
    kernel = KERNEL_OF[name]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        shape = (inputs.ws, inputs.k, reps, copies, out.data_ptr(), stream)
        if kernel == "roofline_op_mix":
            rc = lib.hv_roofline_op_mix(INT32_VARIANTS.index(name),
                                        inputs.scores.data_ptr(), *ptrs,
                                        *shape)
        elif kernel == "roofline_add_chain":
            rc = lib.hv_roofline_add_chain(out.element_size(), *ptrs, *shape)
        elif kernel == "roofline_strip":
            rc = lib.hv_roofline_strip(inputs.scores.data_ptr(), *ptrs,
                                       *shape)
        elif kernel == "roofline_mxu":
            rc = lib.hv_roofline_mxu(_input_dtype(name).itemsize,
                                     inputs.scores.data_ptr(), *ptrs, *shape)
        else:
            rc = lib.hv_roofline_narrow_mix(out.element_size(),
                                            inputs.scores.data_ptr(), *ptrs,
                                            *shape)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.hv_roofline_error_string(rc).decode()}")
    ROOFLINE_LAUNCHES[kernel] += 1
    return out


def blocks_per_sm(name: str, ws: int, k: int) -> int:
    """Resident blocks per SM of the variant's kernel (CUDA occupancy)."""
    check_kernel_shape(ws, k, name)
    n = _occupancy(name, ws, k)
    if n < 1:
        raise RuntimeError(f"occupancy query failed for {name}")
    return n


def fill_copies(name: str, ws: int, k: int, sms: int) -> int:
    """The copies that fill the card once: SMs x resident blocks where a
    block runs one instance; for :data:`FIELD_VARIANTS`, whose blocks share
    the copies' lanes, the copies whose lanes the resident threads hold (99
    at WS 64 on 132 SMs), at least 1."""
    blocks = blocks_per_sm(name, ws, k)
    if name not in FIELD_VARIANTS:
        return sms * blocks
    return max(1, sms * blocks * FIELD_THREADS * FIELD_LANES // (ws * 512))


# ---------------------------------------------------------------- timing

def _seconds(fn: Callable[[], object], device: torch.device) -> float:
    if device.type == "cuda":
        with torch.cuda.device(device):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


@dataclass(frozen=True)
class Timing:
    """Seconds of every timed run of ``lo`` reps and of ``hi`` reps."""

    lo: int
    hi: int
    t_lo: List[float]
    t_hi: List[float]

    @property
    def sec(self) -> float:
        """Seconds a rep, ``(t(hi) - t(lo)) / (hi - lo)`` from the fastest
        run of each count."""
        return (min(self.t_hi) - min(self.t_lo)) / (self.hi - self.lo)

    @property
    def sec_median(self) -> float:
        """Seconds a rep from the median run of each count."""
        lo, hi = sorted(self.t_lo), sorted(self.t_hi)
        return (hi[len(hi) // 2] - lo[len(lo) // 2]) / (self.hi - self.lo)


def time_differential(run: Callable[[int], object], lo: int, hi: int,
                      device: torch.device, iters: int = 5, *,
                      warm: bool = True,
                      check: Optional[Callable[[int], None]] = None
                      ) -> Timing:
    """Time ``iters`` runs of ``run(lo)``, then ``iters`` of ``run(hi)``,
    so a run's fixed cost cancels in :attr:`Timing.sec`. On CUDA each run
    lies between two CUDA events on the current stream and ends in one
    synchronise; on the CPU a host clock times it. ``run(hi)`` warms (and
    builds) first unless ``warm`` is false (the caller warmed up);
    ``check(n)``, if given, runs after each timed run of ``n`` reps,
    outside its timing."""
    if not 0 <= lo < hi:
        raise ValueError("need 0 <= lo < hi")
    if warm:
        run(hi)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(n: int) -> float:
        sec = _seconds(lambda: run(n), device)
        if check is not None:
            check(n)
        return sec

    t_lo = [timed(lo) for _ in range(iters)]
    t_hi = [timed(hi) for _ in range(iters)]
    return Timing(lo, hi, t_lo, t_hi)


@dataclass(frozen=True)
class Card:
    """What the issue-rate check needs: SMs and the maximum SM clock."""

    name: str
    smi: str  # nvidia-smi name, power limit
    sms: int
    max_sm_mhz: float

    @staticmethod
    def query(device: torch.device) -> "Card":
        def smi(fields):
            return subprocess.run(
                ["nvidia-smi", f"--id={device.index or 0}",
                 f"--query-gpu={fields}", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60,
                check=True).stdout.strip()

        mhz = smi("clocks.max.sm").split()[0]
        return Card(torch.cuda.get_device_name(device),
                    smi("name,power.limit"),
                    torch.cuda.get_device_properties(device)
                    .multi_processor_count, float(mhz))

    def op_seconds(self, name: str, words: float):
        """The least seconds the card takes for ``words`` word-rows of the
        variant at its lower-bound op counts and the maximum clock: (all
        ops over the schedulers' 128 lanes, logic ops over the INT32 pipe's
        64 lanes)."""
        return self.count_seconds(*MIN_OPS[name], words)

    def count_seconds(self, total: float, logic: float, words: float):
        """The least seconds for ``words`` word-rows of ``total``
        instructions each, ``logic`` of them logic ops, at the maximum
        clock: (all over the issue lanes, logic over the INT32 lanes)."""
        clk = self.sms * self.max_sm_mhz * 1e6
        return (total * words / (ISSUE_LANES_PER_SM * clk),
                logic * words / (INT32_LANES_PER_SM * clk))

    def issue_shares(self, name: str, words_per_second: float):
        """The shares of the card's issue and INT32 rates that a rate of
        ``words_per_second`` needs: :meth:`op_seconds` of one second's
        words."""
        return self.op_seconds(name, words_per_second)


def bound(nbytes: float, op_seconds: float) -> dict:
    """The least time for the work: bytes over the memory rate or the
    operations' time at the card's rate, whichever is larger."""
    byte_s = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(byte_s, op_seconds) * 1e3,
            "bound_by": "bytes" if byte_s >= op_seconds else "operations"}


def run_variant(name: str, ws: int, k: int, lo: int, hi: int, iters: int,
                device: torch.device, copies: int,
                card: Optional[Card] = None) -> dict:
    """Time one variant; on CUDA through its kernel (``copies`` instances)
    and checked against the card's issue rate, on the CPU through the plain
    version. Any failure raises."""
    x = make_inputs(name, ws, k, device)
    timing = time_differential(
        lambda reps: op_mix(x, reps, copies), lo, hi, device, iters)
    sec, t_lo, t_hi = timing.sec, min(timing.t_lo), min(timing.t_hi)
    if sec <= 0:
        raise RuntimeError(f"{name}: t(hi) {t_hi} <= t(lo) {t_lo}")
    cells = cells_per_rep(name, ws, k)
    res = {"ws": ws, "sec_per_rep": sec, "t_lo": t_lo, "t_hi": t_hi,
           "gcups_equiv": cells / sec / 1e9, "layout": layout(name),
           "copies": copies, "gcups_equiv_card": copies * cells / sec / 1e9}
    if card is not None:
        issue, int32 = card.issue_shares(name, copies * k * ws * 128 / sec)
        res.update(min_ops_per_word_row=list(MIN_OPS[name]),
                   issue_share=issue, int32_share=int32)
        if issue > 1 or int32 > 1:
            raise RuntimeError(
                f"{name}: {res['gcups_equiv_card']:.1f} GCUPS-equiv would need "
                f"{issue:.2f}x the card's issue rate and {int32:.2f}x its "
                f"INT32 rate: the compiler shortened the mix")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ws", type=int, default=None,
                    help="sublane rows of the (WS, 128) buffer (default: "
                         "each variant's max_ws on cuda, 64 or 48 at "
                         "K = 30; 64 on cpu)")
    ap.add_argument("--rows", type=int, default=30,
                    help="rows per rep (K)")
    ap.add_argument("--lo", type=int, default=None,
                    help="low rep count (default 64 on cuda, 1 on cpu)")
    ap.add_argument("--hi", type=int, default=None,
                    help="high rep count (default 4160 on cuda, 3 on cpu)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--copies", type=int, default=None,
                    help="instances per launch (default: fill_copies on "
                         "cuda, 1 on cpu)")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device")
    device = torch.device("cuda:0" if cuda else "cpu")
    lo = args.lo if args.lo is not None else (64 if cuda else 1)
    hi = args.hi if args.hi is not None else (4160 if cuda else 3)
    card = Card.query(device) if cuda else None
    head = {"backend": args.device, "ws": args.ws, "rows": args.rows,
            "lo": lo, "hi": hi}
    if card is not None:
        head.update(device=card.name, nvidia_smi=card.smi, sms=card.sms,
                    max_sm_mhz=card.max_sm_mhz)
    print(f"# {json.dumps(head)} (differential)", flush=True)
    results = {}
    for name in args.variants:
        _check_name(name)
        ws = args.ws or (max_ws(name, args.rows) if cuda else MAX_WS)
        copies = args.copies or (
            fill_copies(name, ws, args.rows, card.sms) if cuda else 1)
        r = run_variant(name, ws, args.rows, lo, hi, args.iters, device,
                        copies, card)
        results[name] = r
        print(f"{name:10s} WS {ws:2d} {r['sec_per_rep'] * 1e6:12.4f} us/rep "
              f"{r['gcups_equiv']:10.3f} GCUPS-equiv x {copies} = "
              f"{r['gcups_equiv_card']:10.2f} on the card   [{r['layout']}] "
              f"(t_lo={r['t_lo'] * 1e3:.4f} ms t_hi={r['t_hi'] * 1e3:.4f} ms)",
              flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({**head, "results": results}, f, indent=2)
        print(f"# wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
