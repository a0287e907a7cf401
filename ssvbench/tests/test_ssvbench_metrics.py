"""The metric arithmetic on synthetic searches and spans."""

import numpy as np
import pytest

from ssvbench import trace
from ssvbench.kernel_cost import peaks, ssv_sweep
from ssvbench.run import Search, Window, end_to_end, metric_reader

H100 = "NVIDIA H100 80GB HBM3"


def _window(spans, deadline, rows=1_000):
    """Closed-loop searches (ask, got, positions) until one ends at or past
    ``deadline``; the window runs to that one's end."""
    searches = []
    for ask, got, n in spans:
        searches.append(Search(0, n, 10, ask, got, sweep_seconds=0.5 * (got - ask),
                               prof={"fetch": 0.1, "regrow": 0.0,
                                     "drain": 0.05, "tail": 0.05}))
        if got >= deadline:
            break
    return Window(searches, searches[-1].got, rows, H100)


def test_gcups_counts_the_search_that_straddles_the_deadline():
    # 4-s searches from t = 0; the deadline at 10 s falls in the third.
    w = _window([(0, 4, 10**9), (4, 8, 10**9), (8, 12, 10**9),
                 (12, 16, 10**9)], deadline=10)
    assert len(w.searches) == 3 and w.seconds == 12
    m = end_to_end(w, setup_s=7.5)
    assert m["search_gcups"] == pytest.approx(3 * 10**9 * 1_000 / 12 / 1e9)
    assert m["setup_s"] == 7.5


def test_p95_is_over_every_request():
    secs = list(np.linspace(0.1, 0.2, 199)) + [5.0]
    t, spans = 0.0, []
    for s in secs:
        spans.append((t, t + s, 1_000))
        t += s
    w = _window(spans, deadline=t)
    assert len(w.searches) == 200
    assert end_to_end(w, 0)["search_p95_s"] == pytest.approx(
        float(np.percentile(secs, 95)))


def test_device_ms_is_the_busy_union_over_every_search():
    w = _window([(0, 4, 10**9), (4, 8, 10**9), (8, 12, 10**9)], deadline=10)
    assert "search_device_ms" not in end_to_end(w, 0)
    w.device_busy_s = 0.6
    assert end_to_end(w, 0)["search_device_ms"] == pytest.approx(200.0)


@pytest.mark.parametrize("with_window", [True, False])
def test_busy_seconds_of_a_device_only_trace(with_window):
    """The union of kernels and copies: clipped to the window's span where
    the trace holds it, all of the trace's where it does not (a profiler of
    device activity alone)."""
    k = "void ssv_word_kernel<true>(int)"
    ev = _events([(k, 0.0, 3_000.0), (k, 100_000.0, 200_000.0),
                  ("Memcpy HtoD", 250_000.0, 100_000.0),
                  (k, 1_900_000.0, 500_000.0)])
    if not with_window:
        ev = [e for e in ev if e["name"] != trace.WINDOW_SPAN]
        busy = 3_000.0 + 250_000.0 + 500_000.0
    else:
        busy = 2_000.0 + 250_000.0 + 100_000.0
    assert trace.busy_seconds(ev) == pytest.approx(busy * 1e-6)
    if with_window:
        assert trace.busy_seconds(ev) == pytest.approx(
            trace.reduce_events(ev).busy_s)


def test_host_gcups_reads_the_end_to_end_arithmetic():
    w = _window([(0, 4, 10**9), (4, 8, 10**9), (8, 12, 10**9),
                 (12, 16, 10**9)], deadline=10)
    assert metric_reader("host.search_gcups")(w) == pytest.approx(
        end_to_end(w, 0)["search_gcups"])


def test_host_shares():
    w = _window([(0, 2, 10), (2, 4, 10)], deadline=3)
    assert metric_reader("pipeline.hit_host_share")(w) == pytest.approx(0.1)
    assert metric_reader("api.outside_sweep_share")(w) == pytest.approx(0.5)


def _events(kernels, window=(1_000.0, 2_000_000.0), host=()):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN,
           "ts": window[0], "dur": window[1] - window[0]}]
    for name, ts, dur in kernels:
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur})
    for name, ts, dur in host:
        ev.append({"ph": "X", "cat": "cpu_op", "name": name, "ts": ts,
                   "dur": dur})
    return ev


def test_idle_is_one_minus_the_union():
    k = "void ssv_word_kernel<true>(int)"
    s = trace.reduce_events(_events(
        [(k, 0.0, 3_000.0),            # starts before the window
         (k, 100_000.0, 200_000.0),
         ("Memcpy DtoH", 250_000.0, 100_000.0),  # overlaps the kernel
         (k, 1_900_000.0, 500_000.0)],  # ends after it
        host=[("aten::copy_", 400_000.0, 1_000_000.0)]))
    busy = 2_000.0 + 250_000.0 + 100_000.0
    assert s.window_s == pytest.approx(1.999)
    assert s.busy_s == pytest.approx(busy * 1e-6)
    assert s.seconds_of("ssv_word_kernel") == pytest.approx(
        (2_000 + 200_000 + 100_000) * 1e-6)
    label, longest = s.idle_gaps[0]
    assert longest == pytest.approx(1.55)
    assert label == f"{trace.WINDOW_SPAN} / aten::copy_"


def test_roofline_share_and_bound():
    peak = peaks(H100)
    least = ssv_sweep.least_seconds([(50_818_468, 150_043, 42_000_000)],
                                    peak)
    assert least["bound"] == "operations"
    issue = 132 * 128 * 1.98e9
    assert least["seconds"] == pytest.approx(
        0.5 * 50_818_468 * 150_043 / issue)
    # hits past the bitmap's bytes are charged the bitmap's
    ops, nbytes = ssv_sweep.work([(1_000, 100, 10**9)])
    assert nbytes == pytest.approx(1_000 / 4 + 400 + 1_000 * 100 / 8)
    w = _window([(0, 4, 50_818_468)], deadline=1, rows=150_043)
    w.searches[0].hits = 42_000_000
    w.trace = trace.reduce_events(_events(
        [("ssv_word_kernel<x>", 2_000.0, 1_500_000.0)]))
    share = metric_reader("ssv_word_kernel_roofline")(w)
    assert share == pytest.approx(100 * least["seconds"] / 1.5)


def test_roofline_counts_the_alphabet():
    """Codes at ⌈log2 card⌉ bits and scores at ``card`` bytes a row; the
    operations do not depend on the alphabet, and the reader passes the
    window's alphabet through."""
    peak = peaks(H100)
    assert ssv_sweep.work([(1_000, 100, 0)]) == ssv_sweep.work(
        [(1_000, 100, 0)], card=4) == (0.5 * 1_000 * 100, 1_000 / 4 + 400)
    assert ssv_sweep.work([(1_000, 100, 0)], card=20) == (
        0.5 * 1_000 * 100, 1_000 * 5 / 8 + 100 * 20)
    searches = [(1_400_000, 3_300_000, 5_000_000)]
    w = _window([(0, 4, 1_400_000)], deadline=1, rows=3_300_000)
    w.searches[0].hits = 5_000_000
    w.card = 20
    w.trace = trace.reduce_events(_events(
        [("ssv_word_kernel<false, true>", 2_000.0, 1_500_000.0)]))
    least = ssv_sweep.least_seconds(searches, peak, card=20)
    assert metric_reader("ssv_word_kernel_roofline")(w) == pytest.approx(
        100 * least["seconds"] / 1.5)


def test_roofline_device_is_the_same_reading():
    w = _window([(0, 4, 50_818_468)], deadline=1, rows=10_122)
    w.searches[0].hits = 2_900_000
    w.trace = trace.reduce_events(_events(
        [("ssv_word_kernel<x>", 2_000.0, 95_000.0)]))
    assert metric_reader("ssv_word_kernel_roofline.device")(w) == (
        metric_reader("ssv_word_kernel_roofline")(w))
    assert metric_reader("ssv_word_kernel_roofline.device")(
        _window([(0, 4, 10**6)], deadline=1)) is None


def test_roofline_fails_without_the_kernel():
    w = _window([(0, 4, 10**6)], deadline=1)
    w.trace = trace.reduce_events(_events([("other", 2_000.0, 5.0)]))
    with pytest.raises(RuntimeError):
        metric_reader("ssv_word_kernel_roofline")(w)


def test_readers_give_nothing_without_a_trace():
    w = _window([(0, 4, 10**6)], deadline=1)
    assert metric_reader("ssv_word_kernel_roofline")(w) is None
    assert metric_reader("device.idle_share")(w) is None
