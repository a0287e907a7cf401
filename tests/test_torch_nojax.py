"""The port runs without JAX: a CPU search in a fresh interpreter leaves
`jax` out of sys.modules."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys
import havac_tpu_torch
from havac_tpu.testing.generator import generate_planted_fixture
from havac_tpu_torch.engine import Havac

models, records = generate_planted_fixture(seed=7, model_length=40,
                                           sequence_length=2000)
fasta = "".join(f">{n}\n{s}\n" for n, s in records)
engine = Havac(p_value=0.05, device="cpu", chunk_symbols=700)
engine.load_phmm(models).load_sequence(fasta, is_text=True).run()
print(json.dumps({"hits": len(engine.hits()),
                  "jax": sorted(m for m in sys.modules
                                if m == "jax" or m.startswith("jax."))}))
"""


def test_port_search_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["hits"] > 0
    assert out["jax"] == []
