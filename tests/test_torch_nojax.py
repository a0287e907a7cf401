"""The port runs without JAX and without the JAX package: a CPU search, the
same search on a 3-shard mesh and (isolated) on a 2 x 2 sequence x model
mesh, the mesh dry run, a multi-file scan, a per-cell dump, the op-mix
roofline and a benchmark point (``bench`` / ``tools/kbench``) in a fresh
interpreter leave `jax` and `havac_tpu` out of sys.modules; and no module
of the port, nor `chip_smoke.py`, names either in an import."""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys
import havac_tpu_torch
from havac_tpu_torch.testing.generator import generate_planted_fixture
from havac_tpu_torch.engine import Havac

models, records = generate_planted_fixture(seed=7, model_length=40,
                                           sequence_length=2000)
fasta = "".join(f">{n}\n{s}\n" for n, s in records)
engine = Havac(p_value=0.05, device="cpu", chunk_symbols=700)
engine.load_phmm(models).load_sequence(fasta, is_text=True).run()

from havac_tpu_torch.parallel.multihost import ShardMesh
import havac_tpu_torch.parallel.engine_dist
import havac_tpu_torch.testing.multihost_worker

mesh = Havac(p_value=0.05, device="cpu", mesh=ShardMesh(["cpu"] * 3),
             dist_rows_per_step=16)
mesh.load_phmm(models).load_sequence(fasta, is_text=True).run()

from havac_tpu_torch.parallel.dryrun import dryrun_multichip
from havac_tpu_torch.parallel.multihost import sequence_model_mesh

isolated = Havac(p_value=0.05, device="cpu", isolate_models=True)
isolated.load_phmm(models).load_sequence(fasta, is_text=True).run()
mesh2d = Havac(p_value=0.05, device="cpu", isolate_models=True,
               mesh=sequence_model_mesh(2, devices=["cpu"] * 4),
               dist_rows_per_step=16)
mesh2d.load_phmm(models).load_sequence(fasta, is_text=True).run()
dry = dryrun_multichip(4, "cpu")

import os
import numpy as np
from havac_tpu_torch.testing.percell import dp_matrix_kernel

paths = []
for i in range(2):
    paths.append(os.path.join(sys.argv[1], f"db{i}.fasta"))
    with open(paths[-1], "w") as f:
        f.write(fasta)
scanned = [len(h) for _, h in engine.scan_files(paths)]
rng = np.random.default_rng(0)
matrix = dp_matrix_kernel(rng.integers(0, 4, 300).astype(np.uint8),
                          rng.integers(-40, 110, (9, 4)).astype(np.int8))
from havac_tpu_torch.tools import roofline

mix = roofline.op_mix(roofline.make_inputs("perrow", 4, 10), 2, copies=2)
from havac_tpu_torch import bench
from havac_tpu_torch.tools import kbench

point = kbench.bench_point(*bench.inputs(600, 30), iters=1, device="cpu")
print(json.dumps({"hits": len(engine.hits()), "scanned": scanned,
                  "mesh": mesh.hits().as_tuples() == engine.hits().as_tuples(),
                  "mesh2d": (mesh2d.hits().as_tuples()
                             == isolated.hits().as_tuples()),
                  "dryrun": sorted(dry),
                  "cells": matrix.numel(), "roofline": list(mix.shape),
                  "bench": point["cells"],
                  "jax": sorted(m for m in sys.modules
                                if m == "jax" or m.startswith("jax.")),
                  "havac_tpu": sorted(m for m in sys.modules
                                      if m == "havac_tpu"
                                      or m.startswith("havac_tpu."))}))
"""


def test_port_search_imports_no_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["hits"] > 0
    assert out["scanned"] == [out["hits"]] * 2
    assert out["mesh"] is True
    assert out["mesh2d"] is True and out["dryrun"] == ["1d", "2d"]
    assert out["cells"] == 9 * 300
    assert out["roofline"] == [2, 4, 128]
    assert out["bench"] == 600 * 30
    assert out["jax"] == []
    assert out["havac_tpu"] == []


def _imported_roots(path):
    """Top-level packages named by every import statement in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def _port_sources():
    pkg = os.path.join(ROOT, "havac_tpu_torch")
    for d, _, files in os.walk(pkg):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(d, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_import_neither_jax_nor_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 30
    bad = [f"{os.path.relpath(p, ROOT)}:{line} imports {root}"
           for p in sources for root, line in _imported_roots(p)
           if root in ("jax", "jaxlib", "havac_tpu")]
    assert bad == []


def test_import_walk_sees_a_jax_package_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from havac_tpu.io import hmm\n"
                     "import jax.numpy as jnp\n")
    assert sorted(_imported_roots(str(probe))) == [("havac_tpu", 2),
                                                    ("jax", 3)]
