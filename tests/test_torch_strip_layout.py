"""The numpy emulation of the match-precompute probe
(`havac_tpu_torch/testing/strip_layout.py`: the chunks of rows, the
per-thread ring of match planes in shared memory, the row reading it back)
against the plain PyTorch version and the JAX tool `tools/roofline.py` in
interpret mode, word for word: the tolerance is zero. The CUDA kernel is
held to the plain version on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).
"""

import functools
import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

from havac_tpu_torch.testing import strip_layout as SL
from havac_tpu_torch.tools import roofline as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def jax_runner(ws, k):
    spec = importlib.util.spec_from_file_location(
        "jax_roofline_tool", os.path.join(ROOT, "tools", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_variant("stripmatch", ws, k, interpret=True)[0]


def emulated(ws, k, reps):
    x = R.make_inputs("stripmatch", ws, k)
    return x, SL.strip_words([p.numpy() for p in x.planes], x.scores.numpy(),
                             ws, k, reps)


@pytest.mark.parametrize("ws", [4, 8, 12])
@pytest.mark.parametrize("k", [1, 6, 7, 10, 30])
@pytest.mark.parametrize("reps", [0, 1, 2, 3])
def test_emulation_equals_plain_and_jax_tool(ws, k, reps):
    """K 1 (every plane ahead is a later rep's), 6, 7 and 10 (a flush at the
    rep's end) and 30; WS 4 is one warp (the seam stitch and the shuffle
    only), WS 8 and 12 two and three (edge words across warps)."""
    x, got = emulated(ws, k, reps)
    want = R.op_mix_plain("stripmatch", x, reps).numpy()
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    run = jax_runner(ws, k)
    np.testing.assert_array_equal(
        got, np.asarray(run(jnp.asarray([reps], jnp.int32))))


@pytest.mark.parametrize("ahead", [2, 6])
@pytest.mark.parametrize("k", [1, 4, 7, 30])
def test_a_deeper_ring_gives_the_same_words(monkeypatch, ahead, k):
    """Planes built further ahead (K below, equal to and not a multiple of
    the ring's depth: a plane up to six reps ahead, at another strip) read
    back the same words; the check that every row reads its own row's
    plane holds at any depth."""
    monkeypatch.setattr(SL, "AHEAD", ahead)
    x, got = emulated(8, k, 3)
    np.testing.assert_array_equal(
        got, R.op_mix_plain("stripmatch", x, 3).numpy())


def thread_major(slot, quad, tid):
    return ((tid * SL.AHEAD + slot) * 4 + quad) * 4


@pytest.mark.parametrize("ahead", [1, 6])
def test_a_thread_major_ring_fails_the_bank_check(monkeypatch, ahead):
    """With each thread's ring contiguous, a warp's lanes are AHEAD * 64
    bytes apart and their 16-byte accesses pile onto the same banks; the
    kernel's [slot][quad][lane] order passes the same check."""
    monkeypatch.setattr(SL, "AHEAD", ahead)
    emulated(8, 7, 1)
    monkeypatch.setattr(SL, "ring_word", thread_major)
    with pytest.raises(AssertionError, match="bank conflict"):
        emulated(8, 7, 1)


def test_a_ring_one_slot_short_reads_another_rows_plane(monkeypatch):
    """Building AHEAD rows on into a ring of AHEAD - 1 slots would overwrite
    a plane before its row reads it: the emulation's row check fails."""
    monkeypatch.setattr(SL, "AHEAD", 3)
    ring_word = SL.ring_word
    monkeypatch.setattr(SL, "ring_word",
                        lambda s, q, t: ring_word(s % 2, q, t))
    with pytest.raises(AssertionError, match="another row's plane"):
        emulated(8, 7, 1)


def test_ahead_is_the_kernels_and_the_ring_fits_every_shape():
    """AHEAD is roofline.cu's kStripAhead, and the ring lets one block of
    every WS 4..64 hold any K's scalars in an H100 block's shared memory:
    the ring does not grow with K, the scalars only 256 B a row."""
    with open(os.path.join(ROOT, "havac_tpu_torch", "csrc",
                           "roofline.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kStripAhead = (\d+);",
                         src).group(1)) == SL.AHEAD
    for ws in range(4, R.MAX_WS + 1, 4):
        for k in (1, 30, R.MAX_ROWS):
            assert SL.smem_bytes(ws, k) <= SL.SMEM_PER_BLOCK
    assert SL.smem_bytes(12, 30) - SL.smem_bytes(12, 1) == 16 * 16 * 29
    # The bound counts the work (3 IMADs, the row, a store and a load per
    # 4 words), whatever the ring's depth.
    assert R.MIN_OPS["stripmatch"] == (11.5, 3)
