"""The hand-written Hopper SSV sweep kernel: build, binding and checked wrapper.

The sweep, ``havac_tpu_torch/csrc/ssv_sweep.cu``, is compiled with ``nvcc``
for sm_90a into a shared library with a plain C interface of its own, at
first use, under ``build/havac_tpu_torch/`` beside the package, and bound
with ``ctypes`` (:func:`load_library`). :func:`build_library` builds any
``csrc`` sources so (keyed by a hash of the flags and the sources, so an
edited ``.cu`` rebuilds; one ``nvcc`` a source, all started together, then
one link): the roofline probes, ``roofline.cu``, are
:mod:`havac_tpu_torch.tools.roofline`'s library, not the sweep's.

:func:`launch` enqueues one sweep on the current CUDA stream without
synchronising; :func:`ssv_sweep` is the synchronous form that reads the
exact hit count and, when it exceeds the key buffer, regrows the buffer
once to that count and launches again. Both dispatch on the tensors'
device: CPU tensors go to the plain version
(:func:`havac_tpu_torch.ops.ssv_torch.ssv_sweep_plain`), CUDA tensors to the
kernel, anything else raises. Given a ``dump`` tensor, either form also
writes every post-update state into it (the kernel's row dump, for per-cell
debugging: the same word body in the dump's own geometry, with its stores).
``LAUNCHES`` counts sweep launches, ``DUMP_LAUNCHES`` launches of the row
dump.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from havac_tpu_torch.ops.ssv_torch import MAX_POS, MAX_ROW, ssv_sweep_plain

# The sweep kernel's geometry (csrc/ssv_sweep.cu kWords, kWin, kDumpT,
# kDumpW): words a thread updates each row and rows of a hit window, which
# turn a window's SASS count into SASS a word and row; the row dump's
# threads a block and words a thread.
KERNEL_WORDS = 2
WINDOW_ROWS = 16
DUMP_THREADS = 128
DUMP_WORDS = 1

LAUNCHES = 0  # sweep kernel launches (CUDA tensors only) in this process
DUMP_LAUNCHES = 0  # row-dump variant launches (CUDA tensors only)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "havac_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The sweep's library: its file name's stem and its sources in csrc/.
STEM, SOURCES = "libhavac_ssv", ("ssv_sweep.cu",)

_lib = None
_lib_lock = threading.Lock()
build_log = ""  # the sweep's nvcc output (ptxas register/shared-memory report)
build_seconds = 0.0  # 0.0 when the sweep's library was already built


def library_path(stem: str = STEM, sources=SOURCES) -> str:
    """Where the library of ``sources`` (file names in ``csrc/``) lives for
    their current text and the flags: the sweep's by default."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sources:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA sweep kernel is built "
            "from havac_tpu_torch/csrc at first use")
    return found


def compile_object(src: str, obj: str) -> subprocess.Popen:
    """Start ``nvcc -c`` of one source into ``obj`` (the library's flags,
    ptxas' report included); stdout carries nvcc's output."""
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    return subprocess.Popen([_nvcc(), *flags, "-c", "-o", obj, src],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_library(stem: str = STEM, sources=SOURCES) -> Tuple[str, str, float]:
    """Compile the library of ``sources`` (file names in ``csrc/``) if it is
    missing, into a temporary file renamed into place; returns its path,
    nvcc's output and the build's seconds ("" and 0.0 when it was built
    already)."""
    path = library_path(stem, sources)
    if os.path.exists(path):
        return path, "", 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
    procs = []
    try:
        procs = [compile_object(os.path.join(_CSRC, name), obj)
                 for name, obj in zip(sources, objs)]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        rc = max(p.returncode for p in procs)
        if rc == 0:
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs],
                                 capture_output=True, text=True, timeout=600)
            logs.append(res.stdout + res.stderr)
            rc = res.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    log = "".join(logs)
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{log}")
    os.replace(tmp, path)
    return path, log, time.perf_counter() - t0


def build() -> str:
    """Compile the sweep's library if it is missing; returns its path."""
    global build_log, build_seconds
    path, log, seconds = build_library()
    if seconds:
        build_log, build_seconds = log, seconds
    return path


def open_library(path: str, entry_points) -> ctypes.CDLL:
    """``ctypes``' handle on the library at ``path``, each of its
    ``entry_points`` ((name, restype, argtypes), ...) typed."""
    lib = ctypes.CDLL(path)
    for fn, restype, args in entry_points:
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = args
    return lib


def load_library() -> ctypes.CDLL:
    """The sweep's library, built at the first call of the process and
    loaded once, its C entry points typed."""
    global _lib
    with _lib_lock:
        if _lib is None:
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            _lib = open_library(build(), (
                ("hv_ssv_sweep", i, [p, i64, p, i, i, p, p, p, i64, i64, p, p,
                                     p, ctypes.c_ulonglong, p, p, p]),
                ("hv_error_string", ctypes.c_char_p, [i]),
                ("hv_ssv_block_threads", i, [i64, i, ctypes.POINTER(i)])))
        return _lib


@dataclass
class SweepBuffers:
    """Outputs of one sweep: ``keys`` (cap,) int64 hit keys (unordered from
    the kernel), ``count`` (1,) int64 exact hit count (may exceed cap),
    ``final_state`` int32 (L,), ``final_carry`` int32 (P+1,)."""

    keys: torch.Tensor
    count: torch.Tensor
    final_state: torch.Tensor
    final_carry: torch.Tensor

    @property
    def cap(self) -> int:
        return self.keys.shape[0]

    @staticmethod
    def empty(L: int, P: int, cap: int, device) -> "SweepBuffers":
        return SweepBuffers(
            keys=torch.empty(cap, dtype=torch.int64, device=device),
            count=torch.empty(1, dtype=torch.int64, device=device),
            final_state=torch.empty(L, dtype=torch.int32, device=device),
            final_carry=torch.empty(P + 1, dtype=torch.int32, device=device))


def _check(symbols, scores, init_state, init_carry, reset_rows, row_offset,
           pos_offset, out: SweepBuffers, dump) -> None:
    def need(ok, msg):
        if not ok:
            raise ValueError(msg)

    need(symbols.dtype == torch.uint8 and symbols.dim() == 1,
         "symbols must be a 1-D uint8 tensor")
    need(scores.dtype == torch.int8 and scores.dim() == 2,
         "scores must be a (P, card) int8 tensor")
    L, (P, card) = symbols.shape[0], scores.shape
    need(L >= 1 and P >= 1, "empty sweep")
    need(2 <= card <= 32, f"cardinality {card} unsupported (2..32)")
    need(L < (1 << 31), "sequence chunk must be shorter than 2^31")
    need(row_offset >= 0 and row_offset + P <= MAX_ROW,
         "hit rows must be < 2^25 (key layout)")
    need(pos_offset >= 0 and pos_offset + L <= MAX_POS,
         "hit positions must be < 2^38 (key layout)")
    need(init_state.dtype == torch.int32 and init_state.shape == (L,),
         "init_state must be int32 (L,)")
    need(init_carry.dtype == torch.int32 and init_carry.shape == (P + 1,),
         "init_carry must be int32 (P+1,)")
    if reset_rows is not None:
        need(reset_rows.dtype == torch.int32 and reset_rows.shape == (P,),
             "reset_rows must be int32 (P,)")
    need(out.final_state.shape == (L,) and out.final_carry.shape == (P + 1,)
         and out.count.shape == (1,), "output buffers do not match the sweep")
    if dump is not None:
        need(dump.dtype == torch.uint8 and dump.shape == (P, L),
             "dump must be a (P, L) uint8 tensor")
    tensors = [symbols, scores, init_state, init_carry, *out.__dict__.values()]
    tensors += [t for t in (reset_rows, dump) if t is not None]
    dev = symbols.device
    for t in tensors:
        need(t.device == dev, "all tensors must be on one device")
        need(t.is_contiguous(), "all tensors must be contiguous")


def launch(symbols: torch.Tensor, scores: torch.Tensor,
           init_state: torch.Tensor, init_carry: torch.Tensor,
           reset_rows: Optional[torch.Tensor], row_offset: int,
           pos_offset: int, out: SweepBuffers,
           dump: Optional[torch.Tensor] = None) -> None:
    """Enqueue one sweep into ``out``; on CUDA tensors this launches the
    kernel on the current stream and does not synchronise. ``out.keys``
    receives the first ``out.cap`` hit keys, ``out.count`` the exact count.
    ``dump`` (P, L) uint8, when given, receives every post-update state
    (row-major: dump[j, i] = S[j][i]) and selects the row dump.
    Symbol codes must be < card (the engine checks them once on the host),
    and the boundary states ``init_state`` / ``init_carry`` lie in [0, 255],
    as every state the sweep produces does."""
    global LAUNCHES, DUMP_LAUNCHES
    _check(symbols, scores, init_state, init_carry, reset_rows, row_offset,
           pos_offset, out, dump)
    dev = symbols.device
    if dev.type == "cpu":
        keys, state, carry = ssv_sweep_plain(symbols, scores, init_state,
                                             init_carry, reset_rows,
                                             row_offset, pos_offset, dump)
        n = keys.shape[0]
        out.count.fill_(n)
        out.keys[:min(n, out.cap)] = keys[:out.cap]
        out.final_state.copy_(state)
        out.final_carry.copy_(carry)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hv_ssv_sweep(
            symbols.data_ptr(), symbols.shape[0], scores.data_ptr(),
            scores.shape[0], scores.shape[1], init_state.data_ptr(),
            init_carry.data_ptr(),
            None if reset_rows is None else reset_rows.data_ptr(),
            row_offset, pos_offset, out.final_state.data_ptr(),
            out.final_carry.data_ptr(), out.keys.data_ptr(), out.cap,
            out.count.data_ptr(), None if dump is None else dump.data_ptr(),
            stream)
    if dump is None:
        LAUNCHES += 1
    else:
        DUMP_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(
            f"ssv_sweep kernel launch failed: {lib.hv_error_string(rc).decode()}")


def block_threads(L: int, P: int, device) -> int:
    """Threads a block of the kernel's launch of an undumped (P x L) sweep
    on ``device`` (a CUDA device): 256 where those blocks fill every SM
    four times over, else 64 (the kernel's own rule)."""
    lib = load_library()
    threads = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.hv_ssv_block_threads(L, P, ctypes.byref(threads))
    if rc != 0:
        raise RuntimeError(
            f"ssv_sweep geometry query failed: {lib.hv_error_string(rc).decode()}")
    return threads.value


@dataclass
class SweepResult:
    keys: torch.Tensor  # int64 (count,), unordered on CUDA
    count: int
    final_state: torch.Tensor
    final_carry: torch.Tensor
    regrown: bool  # the first key buffer was too small


def ssv_sweep(symbols: torch.Tensor, scores: torch.Tensor,
              init_state: Optional[torch.Tensor] = None,
              init_carry: Optional[torch.Tensor] = None,
              reset_rows: Optional[torch.Tensor] = None, row_offset: int = 0,
              pos_offset: int = 0, cap: int = 1 << 20,
              dump: Optional[torch.Tensor] = None) -> SweepResult:
    """Synchronous sweep returning every hit key. Zero boundary conditions
    when ``init_state`` / ``init_carry`` are None. If the exact count exceeds
    ``cap`` the key buffer is regrown once to that count and the sweep runs
    again. ``dump`` as for :func:`launch`."""
    dev = symbols.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    L, P = symbols.shape[0], scores.shape[0]
    if init_state is None:
        init_state = torch.zeros(L, dtype=torch.int32, device=dev)
    if init_carry is None:
        init_carry = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    if int(symbols.max()) >= scores.shape[1]:
        raise ValueError("symbol code >= alphabet cardinality")
    out = SweepBuffers.empty(L, P, max(cap, 1), dev)
    launch(symbols, scores, init_state, init_carry, reset_rows, row_offset,
           pos_offset, out, dump)
    n = int(out.count.item())
    regrown = n > out.cap
    if regrown:
        out = SweepBuffers.empty(L, P, n, dev)
        launch(symbols, scores, init_state, init_carry, reset_rows,
               row_offset, pos_offset, out, dump)
        n2 = int(out.count.item())
        if n2 != n:
            raise RuntimeError(f"hit count changed on relaunch ({n} -> {n2})")
    return SweepResult(out.keys[:n], n, out.final_state, out.final_carry,
                       regrown)
