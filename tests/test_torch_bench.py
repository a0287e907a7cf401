"""The port's headline benchmark (`havac_tpu_torch/bench.py`) and kernel
micro-benchmark (`havac_tpu_torch/tools/kbench.py`) against the root
`bench.py` and `tools/kbench.py` on the CPU.

The JAX tools are loaded by path and left as they are. Their kernels are
replaced by stand-ins that record their inputs and stop the run, so each
test compares what the JAX tool would have launched with the port's draw,
array for array. A 2-dispatch chain of the port's plain version is held
exactly to the JAX kernels in interpret mode. The card cases are in
`tests/test_torch_cuda.py`.
"""

import importlib.util
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import havac_tpu.ops.ssv_pallas as jax_pallas
import havac_tpu.ops.ssv_swar as jax_swar
import havac_tpu.ops.ssv_xla as jax_xla
import havac_tpu.utils.backend as jax_backend
from havac_tpu.ops.common import SsvKernelConfig
from havac_tpu_torch import bench
from havac_tpu_torch.ops.ssv_torch import ssv_sweep_plain
from havac_tpu_torch.tools import kbench, roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P, W = 2, 60, 3072  # the smallest SWAR shape: WS 8, two strips
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "gcups_median",
                 "iters", "native_active", "device", "kernel_ms", "bound_ms",
                 "bound_share", "hits", "L", "P", "torch", "cuda")


def load(path, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Launched(Exception):
    """Raised by a JAX kernel's stand-in once it has its inputs."""


def recorder(record):
    def stand_in(*args, **kwargs):
        record.append(([np.asarray(a) for a in args], kwargs))
        raise Launched
    return stand_in


# ------------------------------------------------------------- the draws


def test_bench_draw_equals_the_root_bench(monkeypatch):
    record = []
    monkeypatch.setattr(jax_backend, "bounded_backend_init",
                        lambda **kw: "cpu")
    monkeypatch.setattr(jax_xla, "ssv_scan_xla", recorder(record))
    with pytest.raises(Launched):
        load("bench.py", "jax_bench").main()
    (sym, scores, state, carry), _ = record[0]
    L, P_ = bench.CPU_SHAPE
    codes, sc = bench.inputs(L, P_)
    np.testing.assert_array_equal(sym, codes)
    np.testing.assert_array_equal(scores, sc)
    assert sym.shape == (1 << 18,) and scores.shape == (256, 4)
    assert not state.any() and state.shape == (L,)
    assert not carry.any() and carry.shape == (P_ + 1,)


@pytest.mark.parametrize("card,dense", [(4, False), (4, True), (20, False),
                                        (20, True)])
def test_kbench_swar_draw_equals_the_jax_tool(monkeypatch, card, dense):
    record = []
    monkeypatch.setattr(jax_swar, "_ssv_swar_jit", recorder(record))
    with pytest.raises(Launched):
        load("tools/kbench.py", "jax_kbench").bench_swar(
            B, P, W, dense=dense, card=card)
    (symw, strips, state, carry), kw = record[0]
    codes, scores = kbench.swar_inputs(B, P, W, dense, card)
    np.testing.assert_array_equal(jax_swar.unpack_state(symw), codes)
    np.testing.assert_array_equal((strips - 256).reshape(P, card), scores)
    assert kw["block_words"] == W // 3
    assert not state.any() and not carry.any() and carry.shape == (P + 1,)


def test_kbench_unpacked_draw_equals_the_jax_tool(monkeypatch):
    record = []
    monkeypatch.setattr(jax_pallas, "_ssv_pallas_jit", recorder(record))
    with pytest.raises(Launched):
        load("tools/kbench.py", "jax_kbench").bench_unpacked(B, P, W, K=30)
    (sym, strips, state, carry), kw = record[0]
    codes, scores = kbench.unpacked_inputs(B, P, W, 30)
    assert sym.shape == (B, W // 128, 128) and strips.shape == (2, 30, 4)
    np.testing.assert_array_equal(sym.reshape(-1), codes)
    np.testing.assert_array_equal(strips.reshape(-1, 4), scores)
    assert kw["rows_per_strip"] == 30
    assert not state.any() and not carry.any()


# ------------------------------------------------------------ the chains


def port_chain(codes, scores, n=2):
    """The port's chain of ``n`` dispatches on the CPU: each dispatch's
    sorted keys, and the last state and carry."""
    chain = kbench.Chain(torch.from_numpy(codes), torch.from_numpy(scores),
                         n_hi=n)
    keys, st = [], chain.state0
    for k in range(n):
        st = chain.step(st, k)
        keys.append(np.sort(chain.keys[:int(chain.counts[k])].numpy()))
    return keys, st.numpy(), chain.outs[n - 1].final_carry.numpy()


@pytest.mark.parametrize("card,dense", [(4, False), (4, True), (20, True)])
def test_chain_equals_the_swar_kernel_in_interpret_mode(card, dense):
    codes, scores = kbench.swar_inputs(B, P, W, dense, card)
    keys, state, carry = port_chain(codes, scores)
    W3, S = W // 3, P // jax_swar.ROWS_PER_STRIP
    symw = jnp.asarray(jax_swar.pack_symbols(codes, W3))
    strips = jnp.asarray((scores.astype(np.int32) + 256).reshape(S, 30, card))
    st = jnp.zeros((B, W3 // 128, 128), jnp.int32)
    zero = jnp.zeros(P + 1, jnp.int32)
    for k in range(2):
        ost, ocarry, ometa, ocount, otiles, _ = jax_swar._ssv_swar_jit(
            symw, strips, st, zero, block_words=W3, max_hit_tiles=B * S * 3,
            interpret=True)
        n = int(ocount[0])
        rows, pos = (jax_swar.decode_swar_tiles(
            np.asarray(ometa), np.asarray(otiles[:n]).reshape(n, -1), n, S,
            W3) if n else (np.empty(0, np.int64),) * 2)
        np.testing.assert_array_equal(np.sort((rows << 38) | pos), keys[k])
        st = ost
    assert (len(keys[1]) > 0) == dense
    np.testing.assert_array_equal(jax_swar.unpack_state(np.asarray(st)),
                                  state)
    np.testing.assert_array_equal(np.asarray(ocarry), carry)


def test_chain_equals_the_unpacked_kernel_in_interpret_mode():
    K = 30
    codes, scores = kbench.unpacked_inputs(B, P, W, K)
    _, state, carry = port_chain(codes, scores)
    cfg = SsvKernelConfig(block_width=W, rows_per_strip=K)
    sym = jnp.asarray(codes.astype(np.int8).reshape(B, W // 128, 128))
    strips = jnp.asarray(scores.astype(np.int32).reshape(P // K, K, 4))
    st = jnp.zeros((B, W // 128, 128), jnp.int32)
    zero = jnp.zeros(P + 1, jnp.int32)
    for _ in range(2):
        st, ocarry = jax_pallas._ssv_pallas_jit(
            sym, strips, st, zero, block_width=W, rows_per_strip=K,
            max_hit_tiles=cfg.max_hit_tiles, interpret=True)[:2]
    np.testing.assert_array_equal(np.asarray(st).reshape(-1), state)
    np.testing.assert_array_equal(np.asarray(ocarry), carry)


def test_chain_alternates_its_state_buffers():
    codes, scores = kbench.swar_inputs(1, 30, 300, dense=True)
    chain = kbench.Chain(torch.from_numpy(codes), torch.from_numpy(scores))
    reads, st = [], chain.state0
    for k in range(chain.n_hi):
        reads.append(st.data_ptr())
        st = chain.step(st, k)
        assert st.data_ptr() != reads[-1]
    assert len({o.final_state.data_ptr() for o in chain.outs}) == 2
    assert len({o.keys.data_ptr() for o in chain.outs}) == 1
    # Each dispatch of the chain is the plain sweep of the one before.
    want = chain.state0
    for _ in range(chain.n_hi):
        _, want, _ = ssv_sweep_plain(chain.symbols, chain.scores, want,
                                     chain.carry0)
    assert torch.equal(st, want)


# ---------------------------------------------------------------- timing


@pytest.mark.parametrize("warm", [False, True])
def test_time_differential_on_a_stub_clock(monkeypatch, warm):
    t_lo, t_hi = [1.2, 1.0, 1.1], [9.5, 9.0, 9.7]
    ticks = []
    for d in t_lo + t_hi:
        ticks += [100.0, 100.0 + d]
    clock = iter(ticks)
    stub = types.SimpleNamespace(perf_counter=lambda: next(clock))
    monkeypatch.setattr(roofline, "time", stub)
    runs, checks = [], []
    timing = roofline.time_differential(runs.append, 1, 9,
                                        torch.device("cpu"), iters=3,
                                        warm=warm, check=checks.append)
    assert timing.t_lo == pytest.approx(t_lo)
    assert timing.t_hi == pytest.approx(t_hi)
    assert timing.sec == pytest.approx((9.0 - 1.0) / 8)
    assert timing.sec_median == pytest.approx((9.5 - 1.1) / 8)
    assert runs == [9] * warm + [1] * 3 + [9] * 3
    assert checks == [1] * 3 + [9] * 3


def test_inspect_sees_the_last_chain_of_nine():
    """The chain ``inspect`` sees ends in a chain of ``N_HI`` dispatches:
    its last buffers hold the plain version's ninth dispatch."""
    seen = []
    p = kbench.bench_swar(1, 60, 3072, iters=2, dense=True, device="cpu",
                          inspect=seen.append)
    (chain,) = seen
    last = chain.outs[-1]
    want = chain.state0
    for _ in range(kbench.N_HI):
        keys, want, carry = ssv_sweep_plain(chain.symbols, chain.scores, want,
                                            chain.carry0)
    n = int(last.count)
    assert n == keys.numel() == p["counts"][-1] > 0
    assert torch.equal(torch.sort(chain.keys[:n]).values,
                       torch.sort(keys).values)
    assert torch.equal(last.final_state, want)
    assert torch.equal(last.final_carry, carry)


def test_sweep_bound_counts():
    assert kbench.sweep_min_ops(4) == roofline.MIN_OPS["current"] == (11, 3)
    assert kbench.sweep_min_ops(20) == (9, 3)  # the row update and one read
    L, P = 3000, 40
    fixed = L + P * 4 + 8 * L + 8 * (P + 1) + 8
    assert kbench.sweep_bytes(L, P, 4, 0) == fixed
    assert kbench.sweep_bytes(L, P, 4, 7) == fixed + 56
    # Dense: a bitmap of L x P bits is fewer bytes than the keys.
    assert kbench.sweep_bytes(L, P, 4, 20_000) == fixed + L * P // 8
    assert kbench.sweep_bytes(L, P, 4, 20_000, keys=True) == fixed + 160_000


# ----------------------------------------------------------- entry points


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
@pytest.mark.parametrize("main", [bench.main, kbench.main],
                         ids=["bench", "kbench"])
def test_entry_points_raise_without_cuda(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(kbench, "bench_point",
                        lambda *a, **kw: calls.append(a))
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        main(argv)
    assert calls == []


def test_bench_cpu_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "CPU_SHAPE", (4000, 45))
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(HEADLINE_KEYS) <= set(out)
    assert out["metric"] == "ssv_sweep_throughput" and out["unit"] == "GCUPS"
    assert out["L"] == 4000 and out["P"] == 45 and out["iters"] == 5
    assert out["value"] > 0 and out["gcups_median"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / 1739.0)
    assert out["device"]["type"] == "cpu" and out["route"] == "plain"
    assert out["bound_ms"] is None and out["hits"] == 0
    assert out["cuda"] == torch.version.cuda


def test_kbench_cpu_points(tmp_path, capsys):
    path = tmp_path / "kb.json"
    assert kbench.main(["--device", "cpu", "--width", "3072", "--rows", "60",
                        "--sweep-blocks", "1", "2", "--iters", "1", "--dense",
                        "--card", "20", "--json", str(path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "swar B=  1 W=3072 P=60 card=20 dense",
        "swar B=  2 W=3072 P=60 card=20 dense"]
    points = json.loads(path.read_text())["points"]
    for B_, p in zip((1, 2), points):
        assert p["L"] == B_ * 3072 and p["card"] == 20 and p["hits"] > 0
        assert len(p["counts"]) == kbench.N_HI and p["counts"][0] == p["hits"]
        assert len(p["t_lo"]) == len(p["t_hi"]) == 1
        assert p["route"] == "plain" and p["launches"] == 0


def test_kbench_unpacked_runs_s_times_k_rows(capsys):
    assert kbench.main(["--device", "cpu", "--kernel", "unpacked", "--width",
                        "1000", "--rows", "70", "--rows-per-strip", "32",
                        "--blocks", "1", "--iters", "1"]) == 0
    assert capsys.readouterr().out.startswith("unpacked B=  1 W=1000 P=64 ")


@pytest.mark.parametrize("argv", [["--kernel", "unpacked", "--dense"],
                                  ["--kernel", "unpacked", "--card", "20"],
                                  ["--kernel", "unpacked", "--rows", "10"],
                                  ["--width", "0"]])
def test_kbench_refuses_bad_arguments(argv):
    with pytest.raises(SystemExit):
        kbench.parse_args(["--device", "cpu", *argv])


# ----------------------------------------------------------- the key buffer


def test_dense_point_regrows_its_keys_to_the_count(monkeypatch):
    monkeypatch.setattr(kbench, "FIRST_CAP", 16)
    codes, scores = kbench.swar_inputs(1, 60, 3072, dense=True)
    chain = kbench.Chain(torch.from_numpy(codes), torch.from_numpy(scores))
    chain.fit()
    assert chain.regrows == 1 and chain.cap == max(chain.expected) > 16
    assert len(set(chain.expected)) > 1  # dispatch 0 starts from zeros
    timing = roofline.time_differential(chain.run, 1, chain.n_hi,
                                        torch.device("cpu"), 1, warm=False,
                                        check=chain.check)
    assert timing.sec > 0


def test_dense_point_refuses_keys_past_the_free_memory(monkeypatch):
    monkeypatch.setattr(kbench, "FIRST_CAP", 16)
    monkeypatch.setattr(kbench, "free_bytes", lambda dev: 1000)
    with pytest.raises(MemoryError, match=r"need \d+ bytes; the device has "
                       r"1000 bytes free"):
        kbench.bench_swar(1, 60, 3072, iters=1, dense=True, device="cpu")


def test_chain_fails_when_a_count_changes(monkeypatch):
    codes, scores = kbench.swar_inputs(1, 60, 3072, dense=True)
    chain = kbench.Chain(torch.from_numpy(codes), torch.from_numpy(scores))
    chain.fit()
    chain.expected[3] += 1
    chain.check(3)
    with pytest.raises(RuntimeError, match="hit counts changed"):
        chain.check(9)
