"""``BENCHMARK.json`` resolves to its files by name, keeps the contract's
shape, and nothing the harness or the reference loads is JAX or the JAX
package."""

import json
import os
import re
import subprocess
import sys

import pytest

from ssvbench.run import HERE, ROOT, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["ssvbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_every_entry_resolves(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ssvbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        used.add(w["config"])
        with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
            assert json.load(f)["name"] == w["traffic"]
    assert used == set(configs)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert callable(metric_reader(m["name"]))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))


def test_every_cell_reports_what_its_metrics_move(bench):
    """Each cell reports setup_s, another end-to-end metric and a per-layer
    metric, and each per-layer metric's cells report the end-to-end metric
    that it moves."""
    cells = [w["name"] for w in bench["workloads"]]

    def of(metric, cell):
        return cell in metric.get("workloads", cells)

    for cell in cells:
        e2e = {m["name"] for m in bench["end_to_end"] if of(m, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        per_layer = [m for m in bench["per_layer"] if of(m, cell)]
        assert per_layer, cell
        for m in per_layer:
            assert m["moves"] in e2e, (cell, m["name"])


def test_no_jax_is_loaded():
    """A CPU run of a tiny cell, every harness module imported: no module
    whose top-level name is jax, jaxlib, flax or havac_tpu (compared whole),
    and nothing of the program under the reference."""
    code = """
import sys, tempfile
from ssvbench import check, control, run, trace, workload
from ssvbench.reference import ssv
import ssvbench.kernel_cost.ssv_sweep
ref_only = sorted({m.split('.')[0] for m in sys.modules})
from ssvbench.tests.tiny import tiny_cell
res = run.measure(tiny_cell(), 5, 0.5, True, 'cpu', tempfile.mkdtemp())
for m in ('ssv_word_kernel_roofline', 'device.idle_share',
          'pipeline.hit_host_share', 'api.outside_sweep_share'):
    run.metric_reader(m)
print('RESULT', res['correct'], run.forbidden_modules(),
      'havac_tpu_torch' in ref_only)
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    line = [s for s in out.stdout.splitlines() if s.startswith("RESULT")]
    assert line, out.stderr[-3000:]
    assert line[0] == "RESULT True [] False"


def test_forbidden_names_compare_whole_top_levels():
    from ssvbench import run

    assert run.forbidden_modules(["havac_tpu_torch", "havac_tpu_torch.ops",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "havac_tpu.engine",
                                  "flax", "jaxlib"]) == [
        "flax", "havac_tpu", "jax", "jaxlib"]
