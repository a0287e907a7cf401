"""The port's op-mix roofline (`havac_tpu_torch/tools/roofline.py`) against
the JAX tool `tools/roofline.py`.

For each of the 15 variants, the plain PyTorch version on the inputs
`make_inputs` builds equals the JAX tool's Pallas kernel, run in interpret
mode at WS = 8, K = 30 (and K = 10 for the match-precompute variants), word
for word and in dtype and shape: the tolerance is zero. The CUDA kernels are held to the same plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import functools
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from havac_tpu_torch.testing import mxu_layout as ML
from havac_tpu_torch.tools import roofline as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WS, K = 8, 30


@functools.lru_cache(maxsize=None)
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_roofline_tool", os.path.join(ROOT, "tools", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def jax_runner(name, ws, k):
    return jax_tool().make_variant(name, ws, k, interpret=True)


def jax_out(name, reps, ws=WS, k=K):
    run, _, _ = jax_runner(name, ws, k)
    return np.asarray(run(jnp.asarray([reps], jnp.int32)))


CASES = [(n, r) for n in R.VARIANTS for r in (1, 3)] + [("perrow", 2)]


@pytest.mark.parametrize("name,reps", CASES)
def test_plain_equals_jax_tool(name, reps):
    want = jax_out(name, reps)
    got = R.op_mix_plain(name, R.make_inputs(name, WS, K), reps).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert tuple(got.shape) == R.out_shape(name, WS)
    np.testing.assert_array_equal(got, want)


def test_counts_and_layouts_match_the_jax_tool():
    for name in R.VARIANTS:
        _, cells, layout = jax_runner(name, WS, K)
        assert R.cells_per_rep(name, WS, K) == cells
        assert R.layout(name) == layout


def test_stitch_is_a_flat_roll_with_the_seam_word():
    """The two pltpu.rolls + selects = a one-word roll of the row-major
    buffer; word 0 gets (state[-1, -1] << 10) | cin, with int32 wrap."""
    state = torch.arange(3 * 128, dtype=torch.int32).reshape(3, 128) * 977
    state[-1, -1] = 0x7FFFFFFF
    got = R.shift_stitch(state, 7).reshape(-1)
    flat = state.reshape(-1)
    assert torch.equal(got[1:], flat[:-1])
    assert int(got[0]) == ((0x7FFFFFFF << 10) & 0xFFFFFFFF) - (1 << 32) | 7


def test_perrow_queue_starts_at_int32_min():
    """The TPU kernel's unwritten carry-queue scratch reads INT32_MIN in
    interpret mode; only q[., 0] is seeded with 7."""
    q = R.initial_queue(4)
    assert q.dtype == torch.int32 and q.shape == (2, 5)
    assert q[:, 0].tolist() == [7, 7]
    assert (q[:, 1:] == R.INT32_MIN).all()
    # Rep 0 reads INT32_MIN at rows 1..K-1 (bit 31 alone, which the update
    # masks drop); from rep 1 on the queue carries the tails, and perrow
    # leaves current.
    per = R.op_mix_plain("perrow", R.make_inputs("perrow", WS, K), 1)
    np.testing.assert_array_equal(per.numpy(), jax_out("perrow", 1))
    assert not torch.equal(
        R.op_mix_plain("perrow", R.make_inputs("perrow", WS, K), 2),
        R.op_mix_plain("current", R.make_inputs("current", WS, K), 2))
    # At K = 1 only the seeded 7 is ever read: perrow == current.
    assert torch.equal(
        R.op_mix_plain("perrow", R.make_inputs("perrow", WS, 1), 3),
        R.op_mix_plain("current", R.make_inputs("current", WS, 1), 3))


MATCH_PRECOMPUTE = ("stripmatch", "mxumatch", "mxumatch8")


@pytest.mark.parametrize("name", MATCH_PRECOMPUTE)
@pytest.mark.parametrize("k", [10, 30])
@pytest.mark.parametrize("reps", [0, 1, 2, 3])
def test_match_precompute_plain_equals_jax_tool(name, k, reps):
    """stripmatch (the strip's planes, then the hot loop) and mxumatch /
    mxumatch8 (one product a flush, repacked) at one and three flushes."""
    want = jax_out(name, reps, k=k)
    got = R.op_mix_plain(name, R.make_inputs(name, WS, k), reps).numpy()
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_mxumatch_needs_whole_flushes():
    """The JAX tool runs 10 * (K // 10) rows and reports K rows of cells: at
    K = 15 its output is the port's at K = 10 (the same inputs). The port
    refuses such a K."""
    np.testing.assert_array_equal(
        jax_out("mxumatch8", 2, k=15),
        R.op_mix_plain("mxumatch8", R.make_inputs("mxumatch8", WS, 10),
                       2).numpy())
    assert jax_runner("mxumatch8", WS, 15)[1] == R.cells_per_rep(
        "mxumatch8", WS, 15) == 15 * 3 * WS * 128
    for name in R.MXU_VARIANTS:
        for k in (7, 25):
            with pytest.raises(ValueError, match="multiple"):
                R.make_inputs(name, WS, k)
            with pytest.raises(ValueError, match="multiple"):
                R.check_kernel_shape(WS, k, name)
        with pytest.raises(ValueError, match="multiple"):
            R.main(["--device", "cpu", "--ws", "8", "--rows", "7",
                    "--variants", name])
        x = R.make_inputs(name, WS, 10)
        with pytest.raises(ValueError, match="multiple"):
            R.op_mix_plain(name, R.OpMixInputs(name, WS, 7, x.planes,
                                               x.scores), 1)


def mxu_emulated(name, ws, k, reps):
    x = R.make_inputs(name, ws, k)
    return x, ML.mxu_words(x.planes[0].float().numpy(),
                           x.scores.float().numpy(), ws, k, reps,
                           R._input_dtype(name).itemsize)


@pytest.mark.parametrize("name", R.MXU_VARIANTS)
@pytest.mark.parametrize("k,reps", [(10, 0), (10, 1), (30, 2), (30, 3)])
def test_mxu_fragment_emulation_equals_plain_and_jax_tool(name, k, reps):
    """The kernel's mma.sync fragment mapping (transposed product, 8 rows a
    product), in-register repack (the bf16 magic-number accumulator, its
    offset in the bias) and the warp's ring, emulated in numpy with every
    shared-memory access checked for bank conflicts: word for word the
    plain version and the JAX tool's Pallas kernel."""
    x, got = mxu_emulated(name, WS, k, reps)
    assert got.dtype == np.int32 and got.shape == R.out_shape(name, WS)
    np.testing.assert_array_equal(got, R.op_mix_plain(name, x, reps).numpy())
    np.testing.assert_array_equal(got, jax_out(name, reps, k=k))


@pytest.mark.parametrize("name", R.MXU_VARIANTS)
def test_mxu_fragment_emulation_at_three_warps(name):
    """WS 12: three warps, each with its own ring and tiles; 7 groups of 8
    rows over two reps of K = 30, the last group ragged."""
    x, got = mxu_emulated(name, 12, 30, 2)
    np.testing.assert_array_equal(got, R.op_mix_plain(name, x, 2).numpy())


@pytest.mark.parametrize("row,quad", [(532, 128), (528, 132)])
def test_mxu_ring_padding_is_what_avoids_bank_conflicts(monkeypatch, row,
                                                        quad):
    """The ring's strides (532 words a row, 132 a quad) put each store
    instruction's 32 lanes and each 16-byte load phase on distinct banks;
    without either padding the emulation's bank check fails."""
    monkeypatch.setattr(ML, "ROW_STRIDE", row)
    monkeypatch.setattr(ML, "QUAD_STRIDE", quad)
    with pytest.raises(AssertionError, match="bank conflict"):
        mxu_emulated("mxumatch8", WS, 10, 1)


def test_mxu_fragment_helpers():
    """PTX shl.b32 clamps: the bf16 one-hot fragment of code c in lane q is
    1.0 in the half c - 2q when that is 0 or 1, else 0; s8 puts 1 in byte
    c of lane 0 only. The magic accumulator's bits carry the integer."""
    for c in range(4):
        for q in range(4):
            frag = int(ML.shl_clamp(0x3F80, 16 * c - 32 * q))
            want = {0: 0x3F80, 1: 0x3F800000}.get(c - 2 * q, 0)
            assert frag == want
        assert int(ML.shl_clamp(1, 8 * c)) == 1 << (8 * c)
    x = np.arange(-128, 128, dtype=np.float32)
    bits = (x + ML.MAGIC).view(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(bits - ML.MAGIC_BITS, x.astype(np.int64))
    assert (ML.MAGIC_BITS << 10) & ML.U32 == 0
    assert (ML.MAGIC_BITS << 20) & ML.U32 == 0
    # The bound counts the work, not a design's staging (PERF.md section 2).
    assert R.MIN_OPS["mxumatch8"] == (10 + 3 / 80, 3)
    # bf16 too: the magic accumulator leaves no conversion to count.
    assert R.MIN_OPS["mxumatch"] == (10 + 3 / 80, 3)


def test_unknown_variants_raise():
    with pytest.raises(ValueError, match="unknown variant"):
        R.make_inputs("bogus", WS, K)
    with pytest.raises(ValueError, match="unknown variant"):
        R.main(["--device", "cpu", "--ws", "8", "--variants", "bogus"])


def test_wrapper_takes_the_plain_version_on_cpu():
    before = dict(R.ROOFLINE_LAUNCHES)
    for name in ("perrow", "add16", "int8mix", "stripmatch", "mxumatch8"):
        x = R.make_inputs(name, WS, 10 if name in R.MXU_VARIANTS else 12)
        out = R.op_mix(x, 2, copies=3)
        assert out.shape == (3, *R.out_shape(name, WS))
        for c in range(3):
            assert torch.equal(out[c], R.op_mix_plain(name, x, 2))
    assert R.ROOFLINE_LAUNCHES == before  # no kernel launched


def test_wrapper_checks_inputs_and_kernel_shapes():
    x = R.make_inputs("current", WS, K)
    bad = R.OpMixInputs("current", WS, K,
                        tuple(p.to(torch.int16) for p in x.planes), x.scores)
    with pytest.raises(ValueError, match="planes"):
        R.op_mix(bad, 1)
    with pytest.raises(ValueError, match="scores"):
        R.op_mix(R.OpMixInputs("current", WS, K, x.planes, x.scores[:, :3]),
                 1)
    with pytest.raises(ValueError, match="reps"):
        R.op_mix(x, -1)
    R.check_kernel_shape(R.MAX_WS, K)
    for ws, k in ((336, K), (6, K), (0, K), (8, 0), (8, R.MAX_ROWS + 1)):
        with pytest.raises(ValueError):
            R.check_kernel_shape(ws, k)
    mx = R.OpMixInputs("mxumatch", WS, K, (x.planes[0],), x.scores)
    with pytest.raises(ValueError, match="planes"):
        R.op_mix(mx, 1)


def test_only_the_match_precompute_ws_asks_the_kernel_library():
    """The match rings of mxumatch* grow with WS in shared memory, so the
    kernel library caps their WS on the card (tests/test_torch_cuda.py);
    stripmatch's ring of a plane a thread fits WS 64 at every K, so it keeps
    WS 64 without asking the library, as every other variant does (no
    library exists here to ask)."""
    assert set(R.SMEM_VARIANTS) == set(MATCH_PRECOMPUTE) - {"stripmatch"}
    for k in (1, 30, R.MAX_ROWS):
        assert R.max_ws("stripmatch", k) == R.MAX_WS
    for name in R.VARIANTS:
        if name not in R.SMEM_VARIANTS:
            assert R.max_ws(name, K) == R.MAX_WS
            R.check_kernel_shape(R.MAX_WS, K, name)
            with pytest.raises(ValueError, match=f"--ws {R.MAX_WS + 4}"):
                R.check_kernel_shape(R.MAX_WS + 4, K, name)


def test_cli_on_cpu(tmp_path):
    out = tmp_path / "roofline.json"
    names = ["current", "add8", "int16mix", "stripmatch", "mxumatch8"]
    assert R.main(["--device", "cpu", "--ws", "8", "--rows", "10", "--lo",
                   "0", "--hi", "8", "--iters", "2", "--variants", *names,
                   "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["backend"] == "cpu" and report["ws"] == 8
    assert list(report["results"]) == names
    for name, r in report["results"].items():
        assert r["sec_per_rep"] > 0 and r["t_hi"] > r["t_lo"]
        assert r["layout"] == R.layout(name) and r["copies"] == 1
        assert r["ws"] == 8
        assert r["gcups_equiv"] == pytest.approx(
            R.cells_per_rep(name, 8, 10) / r["sec_per_rep"] / 1e9)
        assert r["gcups_equiv_card"] == pytest.approx(r["gcups_equiv"])
    # Without --ws the plain versions run at WS 64 (no shared memory caps
    # them; on cuda each variant takes its max_ws).
    assert R.main(["--device", "cpu", "--rows", "10", "--lo", "0", "--hi",
                   "1", "--iters", "1", "--variants", "stripmatch",
                   "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["ws"] is None
    assert report["results"]["stripmatch"]["ws"] == R.MAX_WS


SASS = """\
\tcode for sm_90a
\t\tFunction : _Z3rowPi
        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x0 */
.L_x_1:
        /*0010*/                   LDS.128 R4, [R2] ;       /* 0x0 */
        /*0020*/                   IMAD R5, R5, R6, R7 ;    /* 0x0 */
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;  /* 0x0 */
        /*0040*/                   HMMA.16816.F32.BF16 R8, R4, R6, RZ ;
        /*0050*/               @P0 BRA `(.L_x_1) ;          /* 0x0 */
        /*0060*/                   LOP3.LUT R5, R5, 0x3, RZ, 0xc0, !PT ;
        /*0070*/               @P1 BRA 0x20 ;               /* 0x0 */
        /*0080*/                   EXIT ;                   /* 0x0 */
"""


def test_sass_loops_are_the_backward_branches():
    from havac_tpu_torch.tools import sass

    kernels = sass.parse(SASS)
    assert list(kernels) == ["_Z3rowPi"]
    assert len(kernels["_Z3rowPi"]["insns"]) == 9
    (s1, e1, c1, n1), (s2, e2, c2, n2) = sass.loops(kernels["_Z3rowPi"])
    assert (s1, e1, n1) == (0x10, 0x50, 5)
    assert (c1["lds"], c1["int"], c1["bar"], c1["mma"]) == (1, 1, 1, 1)
    assert (s2, e2, n2) == (0x20, 0x70, 6) and c2["int"] == 2


WINDOW_SASS = """\
\t\tFunction : _Z6windowPi
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/               @P0 BRA 0x40 ;
        /*0020*/                   LDS R4, [R2] ;
        /*0030*/                   BRA 0x10 ;
        /*0040*/                   IMAD R5, R5, R6, R7 ;
        /*0050*/                   VOTE.ANY P0, P0 ;
        /*0060*/               @P0 BRA 0x90 ;
        /*0070*/                   ATOMG.E.ADD.64 R8, [R2.64], R4 ;
        /*0080*/                   LOP3.LUT R5, R5, 0x3, RZ, 0xc0, !PT ;
        /*0090*/               @P1 BRA 0x10 ;
        /*00a0*/                   EXIT ;
"""


def test_sass_fast_path_takes_every_forward_branch():
    """One pass of the loop [0x10, 0x90] that skips the partial block
    (0x20-0x30) and the replay block (0x70-0x80)."""
    from havac_tpu_torch.tools import sass

    kernel = sass.parse(WINDOW_SASS)["_Z6windowPi"]
    loops = sass.loops(kernel)
    assert [(s, e) for s, e, _, _ in loops] == [(0x10, 0x30), (0x10, 0x90)]
    path = sass.fast_path(kernel, 0x10, 0x90)
    assert path["total"] == 5
    assert (path["BRA"], path["IMAD"], path["VOTE"]) == (3, 1, 1)
    assert path["LDS"] == path["ATOMG"] == path["LOP3"] == 0


def test_cli_cuda_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.main(["--device", "cuda", "--variants", "current"])


def test_probes_build_apart_from_the_sweep(tmp_path, monkeypatch):
    """The probes (csrc/roofline.cu) and the sweep (csrc/ssv_sweep.cu) are
    two libraries: an edited probe moves only the probes' library, an
    edited sweep only the sweep's, and each loader types its own entry
    points alone (the sweep's none of the probes')."""
    import ctypes
    import shutil
    import types

    from havac_tpu_torch.ops import ssv_cuda

    csrc = tmp_path / "csrc"
    shutil.copytree(ssv_cuda._CSRC, csrc)
    monkeypatch.setattr(ssv_cuda, "_CSRC", str(csrc))
    sweep, probes = ssv_cuda.library_path(), ssv_cuda.library_path(*R.LIBRARY)
    assert os.path.basename(sweep).startswith("libhavac_ssv_")
    assert os.path.basename(probes).startswith("libhavac_roofline_")
    with open(csrc / "roofline.cu", "a") as f:
        f.write("// edited\n")
    assert ssv_cuda.library_path() == sweep
    edited = ssv_cuda.library_path(*R.LIBRARY)
    assert edited != probes
    with open(csrc / "ssv_sweep.cu", "a") as f:
        f.write("// edited\n")
    assert ssv_cuda.library_path() != sweep
    assert ssv_cuda.library_path(*R.LIBRARY) == edited

    typed = {}

    class Library:  # ctypes.CDLL's stand-in: records what gets typed
        def __init__(self, path):
            typed[path] = set()
            self.path = path

        def __getattr__(self, name):
            typed[self.path].add(name)
            return types.SimpleNamespace()

    monkeypatch.setattr(ctypes, "CDLL", Library)
    monkeypatch.setattr(ssv_cuda, "build", lambda: "sweep.so")
    monkeypatch.setattr(ssv_cuda, "build_library",
                        lambda stem, sources: (f"{stem}.so", "", 0.0))
    monkeypatch.setattr(ssv_cuda, "_lib", None)
    monkeypatch.setattr(R, "_lib", None)
    assert R.load_library() is R.load_library()
    assert list(typed) == ["libhavac_roofline.so"]  # the sweep's not loaded
    assert ssv_cuda.load_library() is ssv_cuda.load_library()
    assert typed == {
        "sweep.so": {"hv_ssv_sweep", "hv_error_string",
                     "hv_ssv_block_threads"},
        "libhavac_roofline.so": {
            "hv_roofline_op_mix", "hv_roofline_add_chain",
            "hv_roofline_narrow_mix", "hv_roofline_strip", "hv_roofline_mxu",
            "hv_roofline_add16x2", "hv_roofline_blocks_per_sm",
            "hv_roofline_error_string"}}
