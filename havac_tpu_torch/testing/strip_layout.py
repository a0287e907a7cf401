"""A numpy emulation of the match-precompute probe (`csrc/roofline.cu`
`strip_mix_kernel`): the per-thread ring of match planes in shared memory,
each plane built :data:`AHEAD` rows before the row that reads it back.

A block runs one (WS, 128) instance with ``WS * 8`` threads, thread ``t``
owning the flat words ``16 t .. 16 t + 15``; the rows' scalars ``{c = m0
FM, d_s = m_s - m0}`` are built once a block. The rows of all reps run in
order, row ``k`` of rep ``r`` at flat position ``n = r K + k`` with the
scalars of strip ``r % 16``. Before the first row each thread builds the
planes of flat rows ``0 .. AHEAD - 1`` (``c + a1 d1 + a2 d2 + a3 d3`` a
word) into ring slots ``0 .. AHEAD - 1``, four 16-byte stores a plane.
Row ``n`` then reads its plane from slot ``n % AHEAD`` (four 16-byte loads,
before the roll: ``left_word``, a shuffle within the warp, one edge word a
warp across warps, the seam stitch for thread 0), builds the plane of row
``n + AHEAD`` into that slot (the next rep's rows at the end of a rep;
past the last row, planes no row reads) and runs its update. The ring is
the warp's, ``[slot][quad][lane]`` int4 (:func:`ring_word`), so the 32
lanes of a warp touch 512 consecutive bytes; this emulation checks the
banks of every store and load, a phase of 8 lanes at a time, and that every
load reads the plane of its own row.

:func:`strip_words` returns what ``tools/roofline.py`` ``_plain_strip``
returns (the TPU kernel's output); the CPU tests hold the two, and the JAX
tool, to exact equality. :func:`smem_bytes` is the kernel's shared memory a
block (``strip_smem``).
"""

from __future__ import annotations

import numpy as np

FMASK = 0x00100401
U32 = 0xFFFFFFFF
NS = 16
FLUSH = 10
WORDS = 16  # a thread's words
AHEAD = 1  # ring slots a thread: roofline.cu kStripAhead
MAX_WARPS = 16
BANKS = 32
SMEM_PER_BLOCK = 232_448  # an H100 block's shared memory (opt-in)


def ring_word(slot, quad, tid):
    """The 32-bit word where a thread's int4 (slot, quad) of the ring
    starts: its warp's ring, ``[slot][quad][lane]``."""
    return (((tid // 32 * AHEAD + slot) * 4 + quad) * 32 + tid % 32) * 4


def smem_bytes(ws: int, k: int) -> int:
    """A block's shared memory: the rows' scalars (NS x K int4), the
    double-buffered edge words and the threads' rings."""
    return 4 * (NS * k * 4 + 2 * MAX_WARPS) + 16 * AHEAD * 4 * ws * 8


def _check_banks(words) -> None:
    """One 16-byte access a lane, 8 lanes a phase: each phase's 32 words on
    distinct banks."""
    words = np.asarray(words)
    for p in range(0, words.size, 8):
        banks = ((words[p:p + 8, None] + np.arange(4)) % BANKS).reshape(-1)
        assert np.unique(banks).size == banks.size, \
            "shared-memory bank conflict"


def _signed(w):
    return np.where(w >= 1 << 31, w - (1 << 32), w)


def _left_words(st, warps):
    """``left_word`` for every thread: the word left of its first one in
    the previous row. Lanes 1-31 shuffle up the last word of the lane
    before; lane 0 reads the edge word of the warp before, warp 0 the seam
    stitch ``(edge[last warp] << 10) | 7``."""
    last = st[:, WORDS - 1]
    left = np.roll(last, 1)  # __shfl_up_sync within each warp, below
    edge = last.reshape(warps, 32)[:, 31]  # lane 31 stores its warp's word
    lane0 = np.arange(warps) * 32
    left[lane0[1:]] = edge[:-1]
    left[0] = ((edge[-1] << 10) | 7) & U32
    return left


def _row(st, bits, match, left):
    """``row_update``: words from the last to the first, word j adding word
    j - 1 of the previous row (``left`` for word 0), bit-9 hit into
    ``bits``, keep mask."""
    shifted = np.concatenate([left[:, None], st[:, :-1]], 1)
    w = (shifted + match) & U32
    t9 = _signed(w) >> 9
    bits = ((bits << 1) | (t9 & FMASK)) & U32
    kmask = (_signed(w) >> 8) & ~t9 & FMASK
    return w & ((kmask * 255) & U32), bits


def strip_words(planes, scores: np.ndarray, ws: int, k: int,
                reps: int) -> np.ndarray:
    """The kernel's output for one instance: (WS, 128) int32. ``planes``
    the three (WS, 128) int32 indicator planes, ``scores`` (NS, K, 4)
    int32."""
    threads = ws * 8
    warps = threads // 32
    a = [np.asarray(p, np.int64).reshape(threads, WORDS) & U32
         for p in planes]
    sc = np.asarray(scores, np.int64)
    rows = np.stack([sc[..., 0] * FMASK, sc[..., 1] - sc[..., 0],
                     sc[..., 2] - sc[..., 0], sc[..., 3] - sc[..., 0]], -1)
    tid = np.arange(threads)
    ring = np.zeros(AHEAD * WORDS * threads, np.int64)
    tag = np.full(ring.size, -1, np.int64)  # the flat row each word holds

    def access(slot, q):
        at = ring_word(slot, q, tid)
        for w0 in range(0, threads, 32):
            _check_banks(at[w0:w0 + 32])
        return at

    def build(n):  # flat row n's plane into slot n % AHEAD
        c, *d = (int(v) for v in rows.reshape(NS * k, 4)[n % (NS * k)])
        match = (c + a[0] * d[0] + a[1] * d[1] + a[2] * d[2]) & U32
        for q in range(WORDS // 4):
            at = access(n % AHEAD, q)
            for e in range(4):
                ring[at + e] = match[:, 4 * q + e]
                tag[at + e] = n

    st = a[0].copy()
    bits, acc = np.zeros_like(st), np.zeros_like(st)
    for n in range(AHEAD):
        build(n)
    for r in range(reps):
        f = 0
        for kk in range(k):
            n = r * k + kk
            match = np.zeros_like(st)
            for q in range(WORDS // 4):
                at = access(n % AHEAD, q)
                for e in range(4):
                    assert (tag[at + e] == n).all(), \
                        "a row read another row's plane"
                    match[:, 4 * q + e] = ring[at + e]
            left = _left_words(st, warps)  # the barrier
            build(n + AHEAD)
            st, bits = _row(st, bits, match, left)
            f += 1
            if f == FLUSH:
                f = 0
                acc ^= bits
                bits = np.zeros_like(st)
    out = (st + bits + acc) & U32
    return _signed(out).astype(np.int32).reshape(ws, 128)
