"""A numpy emulation of the tensor-core match probe (`csrc/roofline.cu`
`mxu_mix_kernel`): the mma.sync fragments, the in-register repack and the
warp's ring.

The kernel takes a product's rows 8 at a time and the product transposed,
D^T (16 x 8) = one-hot^T (16 x K) x scores^T (K x 8): M is one thread's 16
words, N 8 rows, K the 4 symbols padded with zeros (16 for bf16 m16n8k16,
32 for s8 m16n8k32). PTX lays the fragments out by lane, with ``g = lane //
4`` and ``q = lane % 4``:

  * A (row-major): ``a0`` holds A[g][k..] and ``a1`` A[g + 8][k..] at the
    K columns ``2q, 2q + 1`` (bf16, two halves) or ``4q .. 4q + 3`` (s8,
    four bytes); ``a2``, ``a3`` (K columns 8+ / 16+) are zero here.
  * B (column-major): ``b0`` holds B[k..][g] at the same K columns.
  * D: ``d0, d1`` = D[g][2q], D[g][2q + 1]; ``d2, d3`` = D[g + 8][2q],
    D[g + 8][2q + 1].

So lane (g, q) holds words g and g + 8 of the tile at rows 2q and 2q + 1,
and it holds the same four of each third, which it repacks as d0 + (d1 <<
10) + (d2 << 20). The A fragments come from one byte a column (the code's
shift: ``shl(1, 8 code)`` in lane q = 0 for s8, ``shl(0x3F80, 16 code -
32 q)`` for bf16, a shift above 31 giving 0 as PTX's ``shl`` does). bf16
accumulates from 1.5 * 2^23, so the f32 bits are 0x4B400000 + the integer
and the bias takes the offset. The packed words go to the warp's ring,
``[row][quad][thread]`` with strides 532 and 132 words, whose banks this
emulation checks for every store and load instruction.

:func:`mxu_words` returns what ``tools/roofline.py`` ``_plain_mxu`` returns
(the TPU kernel's output); the CPU tests hold the two, and the JAX tool,
to exact equality.
"""

from __future__ import annotations

import numpy as np

FMASK = 0x00100401
U32 = 0xFFFFFFFF
NS = 16
FLUSH = 10
GROUP = 8  # rows a product (the mma's N)
QUAD_STRIDE = 132
ROW_STRIDE = 532
WORDS = 16  # a thread's words: one tile
MAGIC = np.float32(12582912.0)  # 1.5 * 2^23
MAGIC_BITS = 0x4B400000
BANKS = 32


def shl_clamp(x, s):
    """PTX ``shl.b32``: the shift read as unsigned, above 31 giving 0."""
    x = np.asarray(x, np.int64) & U32
    s = np.asarray(s, np.int64) & U32
    return np.where(s > 31, 0, (x << np.minimum(s, 31)) & U32)


def codes(onehot: np.ndarray, nbytes: int) -> np.ndarray:
    """The one-hot (4, 3 WS, 128) compressed to one byte a column: the
    code's shift in a fragment, 8 code (s8) or 16 code (bf16)."""
    flat = onehot.reshape(4, -1)
    code = np.zeros(flat.shape[1], np.int64)
    for a in range(1, 4):
        code[flat[a] != 0] = a
    return code * 8 * nbytes


def _bf16_halves(word) -> np.ndarray:
    """A 32-bit fragment word's two bf16 halves (low first) as floats."""
    w = np.asarray(word, np.int64) & U32
    lo, hi = (w & 0xFFFF).astype(np.uint32), (w >> 16).astype(np.uint32)
    return np.stack([(lo << 16).view(np.float32),
                     (hi << 16).view(np.float32)], -1).astype(np.float64)


def _s8_bytes(word) -> np.ndarray:
    w = np.asarray(word, np.int64) & U32
    return np.stack([((w >> (8 * i)) & 0xFF).astype(np.uint8).view(np.int8)
                     for i in range(4)], -1).astype(np.float64)


def mma(a0, a1, b0, nbytes: int) -> np.ndarray:
    """One warp's mma.sync from its lanes' (32,) fragments a0, a1, b0 (the
    others zero): returns the (32, 4) D fragments as 32-bit words (the f32
    bits for bf16, accumulated from 1.5 * 2^23; s32 for s8)."""
    kdim, per = (16, 2) if nbytes == 2 else (32, 4)
    unpack = _bf16_halves if nbytes == 2 else _s8_bytes
    lane = np.arange(32)
    g, q = (lane // 4)[:, None], lane % 4
    cols = per * q[:, None] + np.arange(per)  # each lane's K columns
    A = np.zeros((16, kdim))
    B = np.zeros((kdim, 8))
    A[g, cols] = unpack(a0)
    A[g + 8, cols] = unpack(a1)
    B[cols, g] = unpack(b0)
    D = A @ B  # small integers: exact in float64
    g = g[:, 0]
    vals = np.stack([D[g, 2 * q], D[g, 2 * q + 1], D[g + 8, 2 * q],
                     D[g + 8, 2 * q + 1]], 1)
    if nbytes == 2:
        return (vals.astype(np.float32) + MAGIC).view(np.uint32).astype(
            np.int64)
    return vals.astype(np.int64) & U32


def _check_banks(addresses) -> None:
    """One 4-byte access a lane: all 32 lanes on distinct banks."""
    banks = np.asarray(addresses) % BANKS
    assert np.unique(banks).size == banks.size, "shared-memory bank conflict"


def _row(state, bits, match):
    """``current``'s row: flat roll with the seam stitch (cin 7), biased
    add, bit-9 hit, keep mask; int64 arrays of 32-bit words."""
    flat = state.reshape(-1)
    shifted = np.roll(flat, 1)
    shifted[0] = ((flat[-1] << 10) | 7) & U32
    w = (shifted.reshape(state.shape) + match) & U32
    signed = np.where(w >= 1 << 31, w - (1 << 32), w)  # int32 shifts
    t9 = signed >> 9
    bits = ((bits << 1) | (t9 & FMASK)) & U32
    kmask = (signed >> 8) & ~t9 & FMASK
    return w & (kmask * 255), bits


def mxu_words(onehot: np.ndarray, scores: np.ndarray, ws: int, k: int,
              reps: int, nbytes: int) -> np.ndarray:
    """The kernel's output for one instance: (WS, 128) int32. ``onehot``
    (4, 3 WS, 128) and ``scores`` (NS K / 10, 10, 4) as numbers (float
    arrays of the bf16 / int8 values); ``nbytes`` 2 (mxumatch, bf16) or 1
    (mxumatch8, int8)."""
    threads = ws * 8
    warps = threads // 32
    words = threads * WORDS
    code = codes(onehot, nbytes)
    sc = np.asarray(scores, np.float64).reshape(-1, 4)  # row (rep % NS) K + k
    if nbytes == 2:
        raw = np.asarray(sc, np.float32).view(np.uint32) >> 16
        sc_words = raw[:, 0::2] | (raw[:, 1::2] << 16)  # (rows, 2)
    else:
        b = sc.astype(np.int8).view(np.uint8).astype(np.int64)
        sc_words = (b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24
                    )[:, None]
    bias = (256 * FMASK - (MAGIC_BITS if nbytes == 2 else 0)) & U32
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    one = np.where(q == 0, 1, 0) if nbytes == 1 else np.full(32, 0x3F80)
    qshift = np.zeros(32, np.int64) if nbytes == 1 else 32 * q
    put = 2 * q * ROW_STRIDE + (g // 4) * QUAD_STRIDE + (g % 4)
    ring = np.zeros((warps, GROUP * ROW_STRIDE), np.int64)
    state = np.zeros((ws, 128), np.int64)
    bits, acc = np.zeros_like(state), np.zeros_like(state)
    total, f = reps * k, 0
    for r0 in range(0, total, GROUP):
        row = r0 + g
        ok = (row < total) & (q < (1 if nbytes == 1 else 2))
        rr = np.where(ok, row, 0)
        srow = (rr // k % NS) * k + rr % k
        b0 = np.where(ok, sc_words[srow, np.minimum(q, sc_words.shape[1] - 1)],
                      0)
        for w in range(warps):
            for t in range(32):
                d = []
                for th in range(3):
                    col = th * words + (w * 32 + t) * WORDS + g
                    a0 = shl_clamp(one, code[col] - qshift)
                    a1 = shl_clamp(one, code[col + 8] - qshift)
                    d.append(mma(a0, a1, b0, nbytes))
                m = (d[0] + (d[1] << 10) + (d[2] << 20)) & U32
                for e, off in enumerate((0, ROW_STRIDE, 2 * QUAD_STRIDE,
                                         2 * QUAD_STRIDE + ROW_STRIDE)):
                    addr = put + t * 4 + off
                    _check_banks(addr)
                    ring[w, addr] = m[:, e]
        for kk in range(min(GROUP, total - r0)):
            match = np.zeros_like(state).reshape(warps, 32, WORDS)
            for i in range(WORDS // 4):
                base = kk * ROW_STRIDE + i * QUAD_STRIDE + 4 * lane
                # A 16-byte load a lane, 8 lanes a phase: their 32 words
                # on distinct banks.
                for p in range(0, 32, 8):
                    _check_banks((base[p:p + 8, None] + np.arange(4))
                                 .reshape(-1))
                for e in range(4):
                    match[:, :, 4 * i + e] = ring[:, base + e]
            match = (match.reshape(ws, 128) + bias) & U32
            state, bits = _row(state, bits, match)
            f += 1
            if f == FLUSH:
                f = 0
                acc ^= bits
                bits = np.zeros_like(state)
    out = (state + bits + acc) & U32
    return np.where(out >= 1 << 31, out - (1 << 32), out).astype(np.int32)
