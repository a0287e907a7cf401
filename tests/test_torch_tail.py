"""The pipeline's tail (`havac_tpu_torch/engine/pipeline.py`
`_merge_resolved`): per-chunk tables placed by the rectangles their
launches swept equal the comparison order (an argsort of every kept key,
then a gather) column for column; tables without rectangles, or with
rectangles that overlap, take the comparison merge; the native copy
(`native.place_i32_native`) equals a scatter segment by segment; and a
``scan_files`` run cut into several column chunks answers as one chunk
does."""

import numpy as np
import pytest

from havac_tpu_torch import native
from havac_tpu_torch.engine import Havac
from havac_tpu_torch.engine.pipeline import (_RESOLVED_FIELDS, collector,
                                             _merge_resolved, keys_from_pairs)
from havac_tpu_torch.io.hmm import write_hmm
from havac_tpu_torch.testing.generator import generate_planted_fixture
from havac_tpu_torch.tools import hostbench

P = 900  # model rows


@pytest.fixture(scope="module")
def pool():
    """The collector pool's work item over a database of ~60 sequences
    (separators among the positions, so some hits are dropped)."""
    rng = np.random.default_rng(17)
    db, total = hostbench.fake_db(rng, nseq=60)
    return collector(db, hostbench.model_prefix(rng, P)), total


def draw(rng, rect, n, rows=None):
    """``n`` distinct unsorted keys in ``rect`` (rows from ``rows`` when
    given)."""
    r0, r1, lo, hi = rect
    if n == 0:
        return np.empty(0, np.uint64)
    rr = (rng.integers(r0, r1, n) if rows is None else rng.choice(rows, n))
    keys = np.unique(keys_from_pairs(rr, rng.integers(lo, hi, n)))
    rng.shuffle(keys)
    return keys


def grid(col_edges, row_edges):
    """Column-major launch rectangles, as the pipelined sweep runs them."""
    return [(row_edges[r], row_edges[r + 1], col_edges[c], col_edges[c + 1])
            for c in range(len(col_edges) - 1)
            for r in range(len(row_edges) - 1)]


def wavefront(D, width, row_edges, groups=((0, 0),)):
    """Mesh launches in step order: at step t shard k sweeps row chunk
    t - k of each model group, whose rows start at its offset."""
    S = len(row_edges) - 1
    out = []
    for t in range(D + S - 1):
        for g0, _ in groups:
            for k in range(D):
                s = t - k
                if 0 <= s < S:
                    out.append((g0 + row_edges[s], g0 + row_edges[s + 1],
                                k * width, (k + 1) * width))
    return out


def table(results):
    """The comparison order: every kept key argsorted, the columns
    gathered through it."""
    kept = np.concatenate([r.kept_keys for r in results])
    order = np.argsort(kept, kind="stable")
    return [np.concatenate([getattr(r.resolved, f) for r in results])[order]
            for f in _RESOLVED_FIELDS]


def tail(results):
    prof = dict.fromkeys(("tail", "tail_merge", "tail_gather"), 0.0)
    prof["tail_segments"] = 0
    return _merge_resolved(results, prof, 0), prof


def assert_same(got, want):
    for f, w in zip(_RESOLVED_FIELDS, want):
        np.testing.assert_array_equal(getattr(got, f), w, err_msg=f)
        assert getattr(got, f).dtype == w.dtype


def case_runs(name, pool_, rng):
    """(keys, rect) a launch for each geometry the tail meets."""
    c, total = pool_
    if name == "one_column":
        rects = grid([0, total], [0, 300, 600, P])
        return [(draw(rng, r, 3000), r) for r in rects]
    if name == "uneven_columns":
        rects = grid([0, 7_000, 41_000, 42_500, total],
                     [0, 250, 500, 740, P])
        return [(draw(rng, r, int(rng.integers(200, 4000))), r)
                for r in rects]
    if name == "empty_and_sparse":
        rects = grid([0, 30_000, 60_000, total], [0, 450, P])
        out = []
        for i, r in enumerate(rects):
            if i % 3 == 1:
                out.append((draw(rng, r, 0), r))  # an empty run
            elif i % 3 == 2:  # hits in three rows only of this run
                out.append((draw(rng, r, 500, rows=[r[0], r[0] + 7,
                                                    r[1] - 1]), r))
            else:
                out.append((draw(rng, r, 2500), r))
        return out
    if name == "resume":
        chunk = 25_000
        first = (0, P, 0, 2 * chunk)  # the done column chunks, every row
        later = grid([2 * chunk, 3 * chunk, total], [0, 300, 600, P])
        return ([(draw(rng, first, 6000), first)]
                + [(draw(rng, r, 1500), r) for r in later])
    if name == "mesh_wavefront":
        width = -(-total // 4)
        rects = wavefront(4, width, [0, 128, 256, 384, 450])
        return [(draw(rng, (r0, r1, lo, min(hi, total)), 1200),
                 (r0, r1, lo, hi)) for r0, r1, lo, hi in rects]
    if name == "mesh2d_wavefront":
        width = -(-total // 2)
        rects = wavefront(2, width, [0, 100, 200, 300, 450],
                          groups=((0, 0), (450, 0)))
        return [(draw(rng, (r0, r1, lo, min(hi, total)), 1200),
                 (r0, r1, lo, hi)) for r0, r1, lo, hi in rects]
    raise AssertionError(name)


CASES = ["one_column", "uneven_columns", "empty_and_sparse", "resume",
         "mesh_wavefront", "mesh2d_wavefront"]


@pytest.mark.parametrize("name", CASES)
def test_placed_tail_equals_the_comparison_order(pool, name):
    """Each geometry is placed (``tail_segments`` > 0) and gives the
    argsorted table column for column; one column chunk is a plain
    concatenation, one segment a run with hits."""
    c, _ = pool
    rng = np.random.default_rng(CASES.index(name))
    results = [c._resolve_chunk(k, rect=r)
               for k, r in case_runs(name, pool, rng)]
    assert all(r.rect is not None for r in results)
    got, prof = tail(results)
    assert_same(got, table(results))
    assert len(got) == sum(r.kept_keys.size for r in results) > 0
    assert prof["tail_segments"] > 0
    if name == "one_column":
        assert prof["tail_segments"] == len(results)
    else:
        assert prof["tail_segments"] > len(results)


@pytest.mark.parametrize("fault", ["overlap", "no_rect", "rows_outside"])
def test_tail_falls_back_to_the_merge(pool, fault):
    """Rectangles that overlap, a run without one, or a rectangle that
    does not hold its run's rows take the comparison merge: the same
    table, no segment counted."""
    c, total = pool
    rng = np.random.default_rng(99)
    rects = grid([0, 40_000, total], [0, 450, P])
    runs = [(draw(rng, r, 2000), r) for r in rects]
    if fault == "overlap":  # the first two runs' keys share one rectangle
        both = (0, P, 0, 40_000)
        keys = draw(rng, both, 4000)
        runs[:2] = [(keys[::2].copy(), both), (keys[1::2].copy(), both)]
    results = [c._resolve_chunk(k, rect=None if fault == "no_rect"
                                and i == 1 else r)
               for i, (k, r) in enumerate(runs)]
    assert (results[1].rect is None) == (fault == "no_rect")
    if fault == "rows_outside":  # claims a rectangle one row short
        k, (r0, r1, lo, hi) = runs[0]
        results[0] = c._resolve_chunk(k, rect=(r0, r1 - 1, lo, hi))
        assert results[0].row_offs[-1] < results[0].kept_keys.size
    got, prof = tail(results)
    assert_same(got, table(results))
    assert prof["tail_segments"] == 0
    assert prof["tail_merge"] > 0 and prof["tail_gather"] > 0


def scatter(runs, seg_run, seg_src, seg_dst):
    """The copy segment by segment, in a loop."""
    out = [np.full(int(seg_dst[-1]), -1, np.int32)
           for _ in range(len(runs[0]))]
    for j, s, a, b in zip(seg_run, seg_src, seg_dst[:-1], seg_dst[1:]):
        for o, col in zip(out, runs[j]):
            o[a:b] = col[s:s + b - a]
    return out


def segments(rng, sizes, nseg):
    """``nseg`` random segments inside runs of ``sizes``."""
    seg_run = rng.integers(0, len(sizes), nseg)
    lens = np.array([rng.integers(0, sizes[j] + 1) for j in seg_run])
    seg_src = np.array([rng.integers(0, sizes[j] - n + 1)
                        for j, n in zip(seg_run, lens)])
    seg_dst = np.concatenate([[0], np.cumsum(lens)])
    return seg_run, seg_src, seg_dst


@pytest.mark.parametrize("shape", ["fewer_segments_than_threads",
                                   "many_segments", "zero_hits",
                                   "zero_length_segments"])
def test_native_copy_equals_a_scatter(shape):
    """Eight threads over 3 long segments (each thread's range inside or
    across one), over many short ones crossing the ranges' edges, and over
    no hits give the loop's columns."""
    if not native.available():
        pytest.skip("the native host core did not build")
    rng = np.random.default_rng(5)
    sizes = {"fewer_segments_than_threads": [300_000, 200_000, 90_000],
             "many_segments": [40_000] * 9, "zero_hits": [0, 0],
             "zero_length_segments": [70_000, 10]}[shape]
    runs = [[rng.integers(-2**31, 2**31, n, dtype=np.int32)
             for _ in range(4)] for n in sizes]
    if shape == "fewer_segments_than_threads":
        plan = (np.array([1, 0, 2]), np.array([0, 1, 0]),
                np.array([0, 200_000, 499_999, 589_999]))
    elif shape == "many_segments":
        plan = segments(rng, sizes, 3000)
    elif shape == "zero_hits":
        plan = (np.array([0, 1]), np.array([0, 0]), np.array([0, 0, 0]))
    else:
        plan = (np.array([1, 0, 1, 0]), np.array([0, 3, 5, 10]),
                np.array([0, 0, 69_990, 69_990, 69_990]))
    got = native.place_i32_native(runs, *plan, nthreads=8)
    want = scatter(runs, *plan)
    assert int(plan[2][-1]) == got[0].shape[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_copy_refuses_a_segment_outside_its_run():
    runs = [[np.arange(10, dtype=np.int32)]]
    if not native.available():
        pytest.skip("the native host core did not build")
    with pytest.raises(ValueError, match="outside"):
        native.place_i32_native(runs, [0], [5], [0, 6])
    with pytest.raises(ValueError, match="int32"):
        native.place_i32_native([[np.arange(10, dtype=np.int64)]], [0], [0],
                                [0, 10])


@pytest.fixture(scope="module")
def fasta_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tail")
    models, _ = generate_planted_fixture(seed=31, model_length=40,
                                         sequence_length=10, num_models=3)
    write_hmm(models, str(d / "m.hmm"))
    paths = []
    for i, seed in enumerate((31, 32)):
        _, recs = generate_planted_fixture(
            seed=seed, model_length=40, sequence_length=1800 + 500 * i,
            num_models=3)
        path = d / f"db{i}.fasta"
        path.write_text("".join(f">{n}-{k}\n{s}\n"
                                for k, (n, s) in enumerate(recs)))
        paths.append(str(path))
    return str(d / "m.hmm"), paths


def test_scan_in_column_chunks_equals_one_chunk(fasta_files):
    """``scan_files`` with at least three column chunks a file answers as
    a one-chunk engine does, column for column, and places its tail."""
    hmm, paths = fasta_files

    def scan(**chunks):
        eng = Havac(p_value=0.05, device="cpu", **chunks).load_phmm(hmm)
        return [(h, eng.stats) for _, h in eng.scan_files(paths)]

    cut = scan(chunk_symbols=900, chunk_rows=50)
    whole = scan(chunk_symbols=1 << 24, chunk_rows=1 << 20)
    for (h, st), (w, wst) in zip(cut, whole):
        assert st.chunk_geometry["n_col"] >= 3
        assert wst.chunk_geometry["n_col"] == 1
        assert len(h) == len(w) > 0
        for f in _RESOLVED_FIELDS + ("strand",):
            np.testing.assert_array_equal(getattr(h, f), getattr(w, f))
        assert st.pipeline_prof["tail_segments"] > st.chunk_geometry["n_row"]
        assert wst.pipeline_prof["tail_segments"] == 1
