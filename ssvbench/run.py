"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m ssvbench.run --workload rfam150k.chr22-genomic --seed 12345 \\
        --seconds 40 --trace 0

Set-up (timed from process start to the window's first request): the cell's
inputs drawn from ``--seed`` and written under ``$TMPDIR`` (removed at
exit), one warm ``Havac(device="cuda", p_value, strand, isolate_models)``
as the configuration's ``search`` states it, that loads the models
(``load_phmm``), and ``scan_files`` over the traffic's
files, cycled, whose first search (file 0) builds and warms everything.
The window is a closed loop: the caller takes each file's hits before it
asks for the next; the search in flight at the deadline is finished and
counted, then the generator is closed. With ``--trace 1`` the window runs
under ``torch.profiler`` and the line carries the cell's per-layer metrics
and a ``breakdown``; with ``--trace 0`` its end-to-end metrics. Once the
window has closed and the program's state is freed, the sampled files'
first answers are held to the plain reference on the card, and their later
answers to the first (``ssvbench/check.py``).

Earlier lines of standard output carry each search's host phases; the last
line is the result. The run exits non-zero, with no result, without CUDA or
the port's native host core, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()  # process start, before the heavy imports

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from ssvbench import check, trace as trace_mod, workload  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "ssvbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "havac_tpu")
CACHE = os.path.join(ROOT, "build", "ssvbench")


@dataclass
class Search:
    """One request of the window: file, size, answer and the program's
    counters for it."""

    file: int
    positions: int  # residues searched
    hits: int
    ask: float
    got: float
    sweep_seconds: float = 0.0
    prof: Optional[Dict[str, float]] = None
    geometry: Optional[dict] = None
    overflow_retries: int = 0
    native_active: Optional[bool] = None

    @property
    def seconds(self) -> float:
        return self.got - self.ask


@dataclass
class Window:
    searches: List[Search]
    seconds: float
    rows: int
    device_kind: str
    trace: Optional[trace_mod.TraceSummary] = None
    notes: dict = field(default_factory=dict)
    card: int = 4  # the alphabet's size: 4 nucleotide, 20 amino
    device_busy_s: Optional[float] = None  # the device trace's busy seconds


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int = 1


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration's file,
    its traffic's ``traffic/<name>.json``, and the metrics it reports."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, config, traffic, mine(bench["end_to_end"]),
                mine(bench["per_layer"]), int(w["chips"]))


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "ssvbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(window: Window, setup_s: float) -> Dict[str, float]:
    """The end-to-end metrics: by the host's clock, and, where the window
    ran under a device trace, the device's busy milliseconds a search."""
    secs = [s.seconds for s in window.searches]
    values = {
        "setup_s": setup_s,
        "search_gcups": sum(s.positions for s in window.searches)
        * window.rows / window.seconds / 1e9,
        "search_p95_s": float(np.percentile(secs, 95)),
    }
    if window.device_busy_s is not None:
        values["search_device_ms"] = (1e3 * window.device_busy_s
                                      / len(window.searches))
    return values


def nvidia_smi() -> dict:
    """The card's name, clocks and power as ``nvidia-smi`` reads them."""
    keys = ("name", "clocks.sm", "clocks.max.sm", "power.draw",
            "power.limit")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(keys),
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    return {k.replace(".", "_"): v.strip()
            for k, v in zip(keys, out[0].split(","))}


def _all_threads() -> dict:
    """Profile every thread (the engine sweeps on its own thread and
    resolves in a pool), where this torch can."""
    try:
        from torch.profiler import _ExperimentalConfig

        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), compared whole: ``havac_tpu_torch`` is not ``havac_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def measure(cell: Cell, seed: int, seconds: float, traced: bool,
            device: str, tmp: str, out=sys.stdout) -> dict:
    """Set up, run the window, judge; the result (``checks`` last)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from havac_tpu_torch import native
    from havac_tpu_torch.engine import Havac
    from havac_tpu_torch.ops import ssv_cuda

    search_cfg = cell.config["search"]
    cuda = device.startswith("cuda")
    t = time.perf_counter()
    setup = {"imports_s": t - _T_START}
    inputs = workload.make_inputs(cell.config, cell.traffic, seed, tmp)
    files = inputs.files
    sizes = [f.residues + len(f.names) for f in files]
    pl = check.plan(seed, sizes, cell.traffic["sample"])
    setup["generate_s"] = time.perf_counter() - t
    if not native.available():
        raise RuntimeError("the port's native host core is not loaded: "
                           "the benchmark measures no fallback")
    t = time.perf_counter()
    isolate = search_cfg.get("isolate_models", False)
    engine = Havac(p_value=search_cfg["p_value"], device=device,
                   strand=search_cfg["strand"], isolate_models=isolate)
    engine.load_phmm(inputs.hmm_path)
    setup["load_phmm_s"] = time.perf_counter() - t
    paths = [f.path for f in files]
    gen = engine.scan_files(itertools.cycle(paths))
    t = time.perf_counter()
    next(gen)  # the warm search: file 0
    if cuda:
        torch.cuda.synchronize()
    setup["warm_search_s"] = time.perf_counter() - t
    setup["nvcc_build_s"] = ssv_cuda.build_seconds
    setup_s = time.perf_counter() - _T_START

    # An untraced window whose cell reports an end-to-end metric from the
    # device trace runs under a profiler of device activity alone.
    device_clock = cuda and not traced and any(
        m["source"] == "device_trace" for m in cell.end_to_end)
    prof = None
    if traced:
        acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
        prof = profile(activities=acts, **_all_threads())
        prof.start()
    elif device_clock:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    searches: List[Search] = []
    kept = {}  # sampled file -> its first answer
    later = {}  # sampled file -> its later answers' columns
    failed = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    got = t0
    with record_function(trace_mod.WINDOW_SPAN):
        for i in itertools.count(1):
            k = i % len(files)
            ask = time.perf_counter()
            try:
                with record_function("ssvbench.request"):
                    path, hits = next(gen)
            except Exception:  # the request failed: counted, window ends
                traceback.print_exc()
                failed += 1
                break
            got = time.perf_counter()
            if path != paths[k]:
                failed += 1
                break
            st = engine.stats
            searches.append(Search(
                k, files[k].residues, len(hits), ask, got, st.sweep_seconds,
                dict(st.pipeline_prof or {}), st.chunk_geometry,
                st.overflow_retries, st.native_active))
            if k in kept:
                later.setdefault(k, []).append(
                    tuple(getattr(hits, c) for c in check.COLUMNS))
            elif k in pl.windows:
                kept[k] = hits
            del hits
            if got >= deadline:
                break
    window_s = got - t0
    gen.close()
    smi = nvidia_smi() if cuda else {}
    summary = None
    device_busy_s = None
    if prof is not None:
        prof.stop()
        tpath = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(tpath)
        del prof
        if traced:
            summary = trace_mod.reduce_file(tpath)
            device_busy_s = summary.busy_s
        else:
            device_busy_s = trace_mod.busy_file(tpath)
        os.remove(tpath)
        if cuda and not device_busy_s:
            raise RuntimeError("the device trace holds no kernel, copy or "
                               "fill in the window")
    if cuda:
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name()
    else:
        peak, kind = 0, "cpu"
    program_scores = np.asarray(engine.scores).copy()
    del engine, gen
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if any(s.native_active is False for s in searches):
        raise RuntimeError("a search ran without the native host core")

    window = Window(searches, window_s, inputs.model_positions, kind,
                    summary, card=inputs.card, device_busy_s=device_busy_s)
    for s in searches:
        out.write(json.dumps({
            "search": s.file, "positions": s.positions, "hits": s.hits,
            "seconds": s.seconds, "sweep_seconds": s.sweep_seconds,
            "pipeline_prof": s.prof, "chunk_geometry": s.geometry,
            "overflow_retries": s.overflow_retries}) + "\n")
    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(window) if searches else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = end_to_end(window, setup_s) if searches else {}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}

    t = time.perf_counter()
    answers = {f: check.answer_columns(h) for f, h in kept.items()}
    del kept
    verdict = check.judge(answers, program_scores, inputs.hmm_path,
                          {f: files[f].path for f in pl.files}, pl,
                          search_cfg["p_value"], failed, device, later,
                          isolate)
    del later
    reference_s = time.perf_counter() - t
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    dev.update(smi)
    result = {"correct": bool(verdict["ok"] and failed == 0 and searches),
              "attempted": len(searches) + failed, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary.device_ops],
            "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
    result["setup"] = setup
    result["host_rss_peak_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    result["window_s"] = window_s
    result["notes"] = window.notes
    result["sample"] = dict(verdict["sample"], reference_s=reference_s)
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in verdict["readings"].items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"ssvbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    os.makedirs(CACHE, exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    tmp = tempfile.mkdtemp(prefix="ssvbench-")
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        result = measure(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print("ssvbench: loaded in the measuring process: "
              + ", ".join(found), file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
