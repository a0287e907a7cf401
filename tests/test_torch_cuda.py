"""The CUDA sweep kernel against its plain PyTorch version, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips (the decision
is made inside the fixture, never at import). On the card:
``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from havac_tpu.testing.generator import generate_planted_fixture
from havac_tpu_torch.engine import Havac
from havac_tpu_torch.ops import ssv_cuda
from havac_tpu_torch.ops.ssv_torch import ssv_sweep_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("card,reset,cap", [(4, False, 1 << 20),
                                            (4, True, 1 << 20),
                                            (20, False, 1 << 20),
                                            (20, True, 1 << 20),
                                            (4, False, 3)])
def test_kernel_matches_plain(dev, card, reset, cap):
    rng = np.random.default_rng(card + 2 * reset + cap)
    L, P = 20_011, 77
    arrays = (rng.integers(0, card, L).astype(np.uint8),
              rng.integers(-40, 70, (P, card)).astype(np.int8),
              rng.integers(0, 256, L).astype(np.int32),
              rng.integers(0, 256, P + 1).astype(np.int32))
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    rr = (torch.from_numpy((rng.random(P) < 0.1).astype(np.int32)).to(dev)
          if reset else None)
    before = ssv_cuda.LAUNCHES
    res = ssv_cuda.ssv_sweep(*t, reset_rows=rr, row_offset=3, pos_offset=9,
                             cap=cap)
    assert ssv_cuda.LAUNCHES == before + (2 if res.regrown else 1)
    keys, state, carry = ssv_sweep_plain(*t, rr, 3, 9)
    assert res.count == keys.numel() > 0
    assert res.regrown == (cap < keys.numel())
    assert torch.equal(torch.sort(res.keys).values, keys)
    assert torch.equal(res.final_state, state)
    assert torch.equal(res.final_carry, carry)


def test_cuda_engine_matches_cpu_engine(dev):
    models, records = generate_planted_fixture(
        seed=19, model_length=25, sequence_length=6000, num_models=5)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    runs = []
    for device in (dev, "cpu"):
        e = Havac(p_value=0.05, device=device, chunk_symbols=1777,
                  chunk_rows=37)
        e.load_phmm(models).load_sequence(fasta, is_text=True).run()
        runs.append(e)
    assert runs[0].backend == "cuda" and runs[1].backend == "torch"
    assert runs[0].hits().as_tuples() == runs[1].hits().as_tuples()
    for x, y in zip(runs[0].raw_hits(), runs[1].raw_hits()):
        np.testing.assert_array_equal(x, y)
