"""A numpy emulation of the narrow roofline kernels (`csrc/roofline.cu`
`add_chain_kernel<B>`, `narrow_mix_kernel<B>`): their per-thread layouts and
their instruction sequences, with a tally of the instructions by pipe.

int8 (B = 1, add8 / int8mix): three lanes in the 10-bit fields of a 32-bit
word (``FM`` = bit 0 of each field). The copies' flat buffer of ``copies x
WS x 512`` lanes is cut into threads of 48 lanes (16 field words, 12 output
words), thread t owning bytes [48 t, 48 t + 48) and reading the instance at
that offset modulo ``WS x 512``, 16 bytes at a time; the last thread may
hold only 16 or 32 of its lanes. Field j of field word w holds the thread's
lane 16 j + w. The add chain is ``((s + i) ^ s) & 0xFF`` a field; the row
update is ``current``'s without the roll: ``w = u + c + e1 d1 + e2 d2 +
e3 d3`` with one-hot fields ``e`` of the winning symbol and per-row scalars
``c = (m0 + 256) FM``, ``d = m - m0`` (``m`` the truncated int8 scores), a
hit at bit 9 and the state kept iff bit 8 and not bit 9. ``bits`` doubles in
its field; at the start of a rep only its low ``8 - K`` bits are kept (none
when K >= 8).

int16 (B = 2, add16 / int16mix): two lanes packed a word, 16 words a
thread, one instance a block. The add is ``add.u16x2`` (a wrapping add per
halfword); the match is the same three multiply-adds with one-hot LSBs of
each lane; the reset is the sign bits of one 3-input function of (state,
match, sum), the hit one more of that and the match; ``bits`` is masked to
its low ``16 - K`` bits at the start of a rep when K < 8.

Both build the rows' scalars ``{c, d1, d2, d3}`` once (:func:`row_scalars`,
the kernels' shared memory) and read one a row at strip ``r % 16``.

Each emulated instruction is tallied once a thread by its pipe: ``int32``
(logic, right shifts, byte permutes: the INT32 pipe only), ``imad``
(multiply-adds: the FMA pipe), ``add`` (adds: either pipe), ``vadd``
(``add.u16x2``) and ``other`` (shared-memory loads, register zeroing). An
instruction on a thread's words counts once per word; one on the row's
scalars once. :func:`per_word_row` divides by a thread's 32-bit output words
and the rows; loop counters and branches are not emulated.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

FM = 0x00100401
FIELD_BYTES = 0xFF * FM
H16 = 0x80008000
LSB16 = 0x00010001
U32 = 0xFFFFFFFF
NS = 16
FLUSH = 8
FIELD_LANES = 48
FIELD_WORDS = FIELD_LANES // 3
FIELD_OUT_WORDS = FIELD_LANES // 4
WORDS = 16  # B = 2: words a thread
PIPES = ("int32", "imad", "add", "vadd", "other")


class Tally:
    """Instructions a thread issues, by pipe (see the module's docstring)."""

    def __init__(self):
        self.counts = Counter()
        self.rows = 0

    def __call__(self, pipe: str, x):
        """Count one instruction that computed ``x`` and return ``x`` as
        uint32 bits."""
        assert pipe in PIPES
        x = np.asarray(x, np.int64) & U32
        self.counts[pipe] += x.shape[-1] if x.ndim == 2 else 1
        return x

    def per_word_row(self, words_per_thread: int) -> dict:
        """The tally a 32-bit output word and row: {pipe: n, "total": n}."""
        scale = 1 / (words_per_thread * max(self.rows, 1))
        out = {p: self.counts[p] * scale for p in PIPES}
        out["total"] = sum(out.values())
        return out


# ---------------------------------------------------------------- int8 fields

def field_index(ws: int, copies: int):
    """(src, valid, dst) of the (threads, 48) lanes: the instance lane each
    reads, whether its 16-byte chunk lies inside the copies' buffer, and its
    flat output lane."""
    n = ws * 512
    total = n * copies
    threads = -(-total // FIELD_LANES)
    dst = (np.arange(threads)[:, None] * FIELD_LANES
           + np.arange(FIELD_LANES)[None, :])
    chunk0 = dst - dst % 16
    valid = chunk0 < total
    return dst % n, valid, dst


def pack_fields(lanes: np.ndarray) -> np.ndarray:
    """(threads, 48) bytes -> (threads, 16) field words: field j of word w
    is lane 16 j + w."""
    b = lanes.astype(np.int64) & 0xFF
    return b[:, 0:16] | (b[:, 16:32] << 10) | (b[:, 32:48] << 20)


def unpack_fields(f: np.ndarray) -> np.ndarray:
    """(threads, 16) field words -> (threads, 48) bytes, the inverse."""
    return np.concatenate([(f >> (10 * j)) & 0xFF for j in range(3)], axis=1)


def _load(plane: np.ndarray, ws: int, copies: int) -> np.ndarray:
    src, valid, _ = field_index(ws, copies)
    lanes = np.where(valid, plane.reshape(-1).view(np.uint8)[src], 0)
    return pack_fields(lanes)


def _store(f: np.ndarray, ws: int, copies: int) -> np.ndarray:
    _, valid, dst = field_index(ws, copies)
    out = np.zeros(ws * 512 * copies, np.uint8)
    out[dst[valid]] = unpack_fields(f)[valid].astype(np.uint8)
    return out.view(np.int8).reshape(copies, 4 * ws, 128)


def nonzero_fields(f):
    """Bit 0 of every field whose byte is non-zero."""
    return (((np.asarray(f, np.int64) + FIELD_BYTES) & U32) >> 8) & FM


def add_chain_fields(i1: np.ndarray, ws: int, k: int, reps: int,
                     copies: int = 1, tally: Tally | None = None):
    """add8's kernel: (copies, 4 WS, 128) int8."""
    t = tally or Tally()
    a = _load(i1, ws, copies)
    s = a.copy()
    for _ in range(reps * k):
        s = t("int32", (t("add", s + a) ^ s) & FIELD_BYTES)
        t.rows += 1
    return _store(s, ws, copies)


def field_row(st, bits, e, c, d, t: Tally):
    """One row of int8mix's field words: (state, bits)."""
    w = t("add", st + c)
    for es, ds in zip(e, d):
        w = t("imad", es * ds + w)
    t9 = t("int32", w >> 9)
    bits = t("imad", bits * 2 + t("int32", t9 & FM))
    kmask = t("int32", t("int32", w >> 8) & ~t9 & FM)
    st = t("int32", w & t("imad", kmask * 255))
    return st, bits


def row_scalars(scores: np.ndarray, nbytes: int) -> np.ndarray:
    """The (NS, K, 4) uint32 row scalars a block builds once into shared
    memory: {c, d1, d2, d3}, d_s = m_s - m0 of the scores truncated to int8
    (nbytes 1) or int16 (2), c = (m0 + 256) FM or m0 * 0x10001."""
    bits = 8 * nbytes
    m = np.asarray(scores, np.int64) & ((1 << bits) - 1)
    if nbytes == 1:
        m = (m ^ 0x80) - 0x80  # int8: signed
        c = (m[..., 0] + 256) * FM
    else:
        c = m[..., 0] * LSB16  # int16: the lane's 16 bits, unsigned
    d = m[..., 1:] - m[..., :1]
    return np.concatenate([c[..., None], d], axis=-1) & U32


def narrow_mix_fields(planes, scores: np.ndarray, ws: int, k: int, reps: int,
                      copies: int = 1, tally: Tally | None = None):
    """int8mix's kernel: (copies, 4 WS, 128) int8."""
    t = tally or Tally()
    z1, z2, z3 = (nonzero_fields(_load(p, ws, copies)) for p in planes)
    e3 = z3
    e2 = z2 & ~e3
    st = z1  # where(i1, 1, 0)
    e1 = st & ~(e2 | e3)
    bits = np.zeros_like(st)
    acc = np.zeros_like(st)
    keep = (0xFF >> k) * FM if k < FLUSH else 0
    rows = row_scalars(scores, 1)
    for r in range(reps):
        strip = rows[r % NS]
        bits = t("int32", bits & keep)
        for row in range(k):
            c, *d = (int(v) for v in t("other", strip[row]))  # 16-byte LDS
            st, bits = field_row(st, bits, (e1, e2, e3), c, d, t)
            t.rows += 1
            if (row + 1) % FLUSH == 0:
                acc = t("int32", acc ^ bits)
                bits = t("other", np.zeros_like(bits))
    return _store(st + bits + acc, ws, copies)


# ---------------------------------------------------------------- int16 packed

def add16x2(a, b):
    """add.u16x2: a wrapping add per halfword."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    return (((a + b) & 0xFFFF)
            | ((((a >> 16) + (b >> 16)) & 0xFFFF) << 16))


def sign_mask16(x):
    """prmt's sign replication: all ones in every halfword whose sign bit
    is set."""
    x = np.asarray(x, np.int64)
    return (((x >> 15) & 1) * 0xFFFF) | (((x >> 31) & 1) * 0xFFFF0000)


def nonzero_mask16(x):
    x = np.asarray(x, np.int64) & U32
    return (((x & 0xFFFF) != 0) * 0xFFFF) | (((x >> 16) != 0) * 0xFFFF0000)


def _words16(plane: np.ndarray) -> np.ndarray:
    """(2 WS, 128) int16 -> (threads, 16) packed words, as op_mix lays
    them out: a thread's 16 consecutive words."""
    return (plane.reshape(-1).view(np.uint32).astype(np.int64)
            .reshape(-1, WORDS))


def _out16(words: np.ndarray, ws: int) -> np.ndarray:
    return (words.astype(np.uint32).reshape(-1).view(np.int16)
            .reshape(2 * ws, 128))


def add_chain_packed(i1: np.ndarray, ws: int, k: int, reps: int,
                     tally: Tally | None = None):
    """add16's kernel (one instance): (2 WS, 128) int16."""
    t = tally or Tally()
    a = _words16(i1)
    s = a.copy()
    for _ in range(reps * k):
        s = t("int32", t("vadd", add16x2(s, a)) ^ s)
        t.rows += 1
    return _out16(s, ws)


def packed_row(st, bits, e, c, d, t: Tally):
    """One row of int16mix's words: (state, bits)."""
    mt = c
    for es, ds in zip(e, d):
        mt = t("imad", es * ds + mt)
    s = t("vadd", add16x2(st, mt))
    # One LOP3 of (state, match, sum): carry-out ^ match sign at the lanes'
    # sign bits, which is the reset; & ~match sign, the hit.
    x = t("int32", ((st & mt) | ((st | mt) & ~s)) ^ mt)
    hit = t("int32", x & ~mt & H16)
    bits = t("int32", t("imad", bits * 2) + (hit >> 15))  # LEA.HI
    st = t("int32", s & ~t("int32", sign_mask16(x)))
    return st, bits


def narrow_mix_packed(planes, scores: np.ndarray, ws: int, k: int, reps: int,
                      tally: Tally | None = None):
    """int16mix's kernel (one instance): (2 WS, 128) int16."""
    t = tally or Tally()
    n1, n2, n3 = (nonzero_mask16(_words16(p)) for p in planes)
    e3 = n3
    e2 = n2 & ~e3
    e1 = n1 & ~(e2 | e3) & LSB16
    e2 &= LSB16
    e3 &= LSB16
    st = n1 & LSB16
    bits = np.zeros_like(st)
    acc = np.zeros_like(st)
    keep = (0xFFFF >> k) * LSB16 if k < FLUSH else U32
    rows = row_scalars(scores, 2)
    for r in range(reps):
        strip = rows[r % NS]
        bits = t("int32", bits & keep)
        for row in range(k):
            c, *d = (int(v) for v in t("other", strip[row]))
            st, bits = packed_row(st, bits, (e1, e2, e3), c, d, t)
            t.rows += 1
            if (row + 1) % FLUSH == 0:
                acc = t("int32", acc ^ bits)
                bits = t("other", np.zeros_like(bits))
    return _out16(add16x2(add16x2(st, bits), acc), ws)


# ---------------------------------------------------------------- variants

def emulate(name: str, planes, scores, ws: int, k: int, reps: int,
            copies: int = 1, tally: Tally | None = None) -> np.ndarray:
    """The kernel of variant ``name`` on numpy planes / scores (as
    ``tools/roofline.py`` ``make_inputs`` builds them): (copies, *shape)."""
    if name == "add8":
        return add_chain_fields(planes[0], ws, k, reps, copies, tally)
    if name == "int8mix":
        return narrow_mix_fields(planes, scores, ws, k, reps, copies, tally)
    if name == "add16":
        one = add_chain_packed(planes[0], ws, k, reps, tally)
    elif name == "int16mix":
        one = narrow_mix_packed(planes, scores, ws, k, reps, tally)
    else:
        raise ValueError(f"not a narrow variant: {name!r}")
    return np.repeat(one[None], copies, axis=0)


def words_per_thread(name: str) -> int:
    """A thread's 32-bit output words: 12 for the field layout, else 16."""
    return FIELD_OUT_WORDS if name in ("add8", "int8mix") else WORDS
