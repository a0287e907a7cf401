"""ctypes bindings for the port's native ingestion core (libhavac_native).

The native library mirrors the reference's native C I/O layer (FastaVector +
P7HmmReader, SURVEY.md §2.4). It is the port's own copy of the JAX
package's host core: ``havac_native.cc`` beside this file is compiled with
``g++`` at first use into ``build/havac_tpu_torch/`` beside the package
(keyed by a hash of the source and flags, never into a source directory),
or by :func:`build`. Everything degrades gracefully, and loudly, to the
pure-Python parsers in ``havac_tpu_torch.io`` when the library cannot be
built or loaded (``HAVAC_NATIVE_BUILD=0`` opts out of the build).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "havac_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "havac_tpu_torch")
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
            "-shared"]
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_load_lock = threading.Lock()
_last_build_error = ""  # stderr tail of the most recent failed build
_logger = logging.getLogger("havac_tpu_torch.native")


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhavac_native_{h.hexdigest()[:16]}.so")


def build(quiet: bool = True) -> bool:
    """Compile the shared library into ``BUILD_DIR``; returns True on
    success.

    The compiler writes a PID-unique temp file that is renamed into place,
    so an interrupted or concurrent build can never leave a partial .so
    behind. On failure the captured stderr tail is kept in
    ``_last_build_error`` for the one-time fallback warning in _load()."""
    global _last_build_error
    so = library_path()
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
        res = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, _SRC],
                             capture_output=quiet, timeout=300)
        if res.returncode != 0:
            tail = (res.stderr or b"").decode(errors="replace")[-800:]
            _last_build_error = tail or f"{cxx} exited {res.returncode}"
            return False
        os.replace(tmp, so)
        return True
    except Exception as e:
        _last_build_error = repr(e)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _fail(reason: str) -> None:
    """Record a load failure LOUDLY: a silent numpy fallback in production
    costs ~2x end to end at dense hits and once shipped an invalid
    benchmark artifact."""
    global _load_failed
    _load_failed = True
    _logger.warning(
        "havac_tpu_torch native library unavailable (%s); falling back to "
        "the ~2x-slower pure-Python decode/sort/resolve paths. Build with "
        "`python -c 'import havac_tpu_torch.native as n; n.build()'`.%s",
        reason,
        ("\nlast build stderr tail:\n" + _last_build_error)
        if _last_build_error else "")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _load_lock:  # first load may race from collector-pool workers
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:  # double-checked under the lock
        return _lib
    so = library_path()
    if not os.path.exists(so):
        # Build on first use: a silent numpy fallback costs ~2x end to end
        # at dense hits (decode/resolve/sort are the host-side hot paths).
        # Failure (no toolchain) degrades to the pure-Python paths.
        if os.environ.get("HAVAC_NATIVE_BUILD", "1") == "0":
            _fail("not built and HAVAC_NATIVE_BUILD=0")
            return None
        if not build():
            _fail("build failed")
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:  # stale/foreign-arch .so: rebuild once and retry
        rebuilt = False
        if os.environ.get("HAVAC_NATIVE_BUILD", "1") != "0":
            try:
                os.remove(so)
            except OSError:
                pass
            rebuilt = build()
        if not rebuilt:
            _fail(f"dlopen failed: {e}")
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e2:  # pragma: no cover - toolchain emits bad .so
            _fail(f"dlopen failed after rebuild: {e2}")
            return None
    c = ctypes.c_char_p
    i64 = ctypes.c_int64
    p = ctypes.c_void_p
    lib.hv_fasta_open.restype = p
    lib.hv_fasta_open.argtypes = [c]
    lib.hv_fasta_error.restype = c
    lib.hv_fasta_error.argtypes = [p]
    lib.hv_fasta_num.restype = i64
    lib.hv_fasta_num.argtypes = [p]
    lib.hv_fasta_lengths.argtypes = [p, ctypes.POINTER(i64)]
    lib.hv_fasta_name.restype = c
    lib.hv_fasta_name.argtypes = [p, i64]
    lib.hv_fasta_encode.restype = i64
    lib.hv_fasta_encode.argtypes = [p, ctypes.POINTER(ctypes.c_uint8), i64,
                                    ctypes.c_uint64]
    lib.hv_fasta_close.argtypes = [p]
    lib.hv_hmm_open.restype = p
    lib.hv_hmm_open.argtypes = [c]
    lib.hv_hmm_error.restype = c
    lib.hv_hmm_error.argtypes = [p]
    lib.hv_hmm_count.restype = i64
    lib.hv_hmm_count.argtypes = [p]
    for fn in ("hv_hmm_leng", "hv_hmm_maxl"):
        getattr(lib, fn).restype = i64
        getattr(lib, fn).argtypes = [p, i64]
    for fn in ("hv_hmm_mu", "hv_hmm_lambda"):
        getattr(lib, fn).restype = ctypes.c_double
        getattr(lib, fn).argtypes = [p, i64]
    lib.hv_hmm_card.restype = ctypes.c_int
    lib.hv_hmm_card.argtypes = [p, i64]
    for fn in ("hv_hmm_name", "hv_hmm_acc", "hv_hmm_desc", "hv_hmm_alph"):
        getattr(lib, fn).restype = c
        getattr(lib, fn).argtypes = [p, i64]
    lib.hv_hmm_scores.argtypes = [p, i64, ctypes.POINTER(ctypes.c_float)]
    lib.hv_hmm_close.argtypes = [p]
    pi64 = ctypes.POINTER(i64)
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    lib.hv_decode_swar_flat.restype = i64
    lib.hv_decode_swar_flat.argtypes = [pi64, pi64, pu32, i64, i64, i64,
                                        pi64, pi64]
    try:  # v2 (threaded expand, optional sort); stale builds lack it
        lib.hv_decode_swar_flat_v2.restype = i64
        lib.hv_decode_swar_flat_v2.argtypes = [
            pi64, pi64, pu32, i64, i64, i64, pi64, pi64, ctypes.c_int,
            ctypes.c_int]
    except AttributeError:  # pragma: no cover - rebuilt on demand
        pass
    lib.hv_sort_hits.argtypes = [pi64, pi64, i64, ctypes.c_int]
    try:  # added after the first release of the .so; stale builds lack them
        lib.hv_sort_order.argtypes = [pi64, pi64, i64, ctypes.c_int, pi64]
        lib.hv_permute_i64.argtypes = [pi64, pi64, i64, pi64, ctypes.c_int]
        lib.hv_merge_runs.argtypes = [pi64, pi64, i64, pi64, i64,
                                      ctypes.c_int, pi64]
    except AttributeError:  # pragma: no cover - rebuilt on demand
        pass
    lib.hv_resolve_hits.restype = i64
    lib.hv_resolve_hits.argtypes = [pi64, pi64, i64, pi64, pi64, i64,
                                    pi64, i64, pi64, pi64, pi64, pi64,
                                    ctypes.c_int]
    pu64 = ctypes.POINTER(ctypes.c_uint64)
    pi32 = ctypes.POINTER(ctypes.c_int32)
    try:  # round-5 fused key-form chunk path; stale builds lack it
        lib.hv_chunk_count.restype = i64
        lib.hv_chunk_count.argtypes = [pi64, pu32, i64, pi32, i64, i64,
                                       i64, i64, i64, ctypes.c_int]
        lib.hv_chunk_keys.restype = i64
        lib.hv_chunk_keys.argtypes = [pi64, pu32, i64, pi32, i64, i64, i64,
                                      i64, i64, i64, i64, pu64, ctypes.c_int]
        lib.hv_resolve_keys.restype = i64
        lib.hv_resolve_keys.argtypes = [pu64, i64, pi64, pi64, i64, pi64,
                                        i64, pi32, pi32, pi32, pi32, pu64,
                                        ctypes.c_int]
        lib.hv_merge_runs_u64.argtypes = [pu64, i64, pi64, i64, ctypes.c_int,
                                          pi64]
        lib.hv_permute_i32.argtypes = [pi32, pi64, i64, pi32, ctypes.c_int]
        lib.hv_place_i32.argtypes = [p, i64, pi64, pi64, pi64, i64, p,
                                     ctypes.c_int]
        lib.hv_keys_to_pairs.argtypes = [pu64, i64, pi64, pi64, ctypes.c_int]
    except AttributeError:  # pragma: no cover - rebuilt on demand
        pass
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class NativeParseError(ValueError):
    pass


def read_fasta_encoded(
    path: str, pad_multiple: int = 1, seed: int = 0x5A5A
) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]:
    """Parse + encode a FASTA file natively.

    Returns (names, lengths int64 (n,), starts int64 (n+1,), codes uint8
    (padded_len,)) — the exact fields of io.fasta.SequenceDatabase.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built; see havac_tpu_torch.native.build")
    h = lib.hv_fasta_open(path.encode())
    try:
        err = lib.hv_fasta_error(h)
        if err:
            raise NativeParseError(err.decode())
        n = lib.hv_fasta_num(h)
        lengths = np.empty(n, dtype=np.int64)
        lib.hv_fasta_lengths(h, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        names = [lib.hv_fasta_name(h, i).decode() for i in range(n)]
        starts = np.concatenate([[0], np.cumsum(lengths + 1)])
        concat_len = int(starts[-1])
        padded_len = -(-max(concat_len, 1) // pad_multiple) * pad_multiple
        codes = np.empty(padded_len, dtype=np.uint8)
        wrote = lib.hv_fasta_encode(
            h, codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            padded_len, seed & 0xFFFFFFFFFFFFFFFF)
        if wrote != padded_len:
            raise NativeParseError(
                f"{path}: encode buffer mismatch (wrote {wrote}, "
                f"expected {padded_len})")
        return names, lengths, starts, codes
    finally:
        lib.hv_fasta_close(h)


def read_hmm_native(path: str):
    """Parse a HMMER3 .hmm file natively → list[io.hmm.ProfileHmm]."""
    from havac_tpu_torch.io.hmm import ProfileHmm

    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built; see havac_tpu_torch.native.build")
    h = lib.hv_hmm_open(path.encode())
    try:
        err = lib.hv_hmm_error(h)
        if err:
            raise NativeParseError(err.decode())
        models = []
        for i in range(lib.hv_hmm_count(h)):
            leng = lib.hv_hmm_leng(h, i)
            card = lib.hv_hmm_card(h, i)
            scores = np.empty(leng * card, dtype=np.float32)
            lib.hv_hmm_scores(
                h, i, scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            models.append(ProfileHmm(
                name=lib.hv_hmm_name(h, i).decode(),
                accession=lib.hv_hmm_acc(h, i).decode(),
                description=lib.hv_hmm_desc(h, i).decode(),
                model_length=int(leng),
                max_length=int(lib.hv_hmm_maxl(h, i)),
                alphabet=lib.hv_hmm_alph(h, i).decode(),
                msv_mu=lib.hv_hmm_mu(h, i),
                msv_lambda=lib.hv_hmm_lambda(h, i),
                match_scores=scores.reshape(leng, card),
            ))
        return models
    finally:
        lib.hv_hmm_close(h)


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def decode_swar_flat_native(tile_ids, word_idx, words, num_strips: int,
                            block_words: int, sort: bool = True,
                            nthreads: int = 4):
    """Native SWAR record decode → (rows, positions), sorted by (row, pos)
    when ``sort`` (record-ordered otherwise — callers that globally re-sort
    merged chunks pass sort=False and skip the per-chunk sort entirely);
    None when the library is unavailable (callers fall back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    n = int(words.shape[0])
    if n == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    ids = np.ascontiguousarray(tile_ids, dtype=np.int64)
    widx = np.ascontiguousarray(word_idx, dtype=np.int64)
    # The native decode sorts with the same (row << 38) | pos composite key
    # as hv_sort_hits; bound the decoded coordinates from the tile geometry
    # (max row = strips·30, max pos < (max block + 1)·3·block_words) and
    # fall back to numpy (which guards itself) rather than mis-sort.
    if sort:
        max_row = num_strips * 30
        max_pos = ((int(ids.max()) // 3 // max(num_strips, 1) + 1)
                   * 3 * block_words)
        if max_row >= _MAX_KEY_ROW or max_pos >= _MAX_KEY_POS:
            return None
    w = np.ascontiguousarray(words).view(np.uint32)
    rows = np.empty(30 * n, dtype=np.int64)
    pos = np.empty(30 * n, dtype=np.int64)
    if hasattr(lib, "hv_decode_swar_flat_v2"):
        m = lib.hv_decode_swar_flat_v2(
            _i64p(ids), _i64p(widx),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            n, num_strips, block_words, _i64p(rows), _i64p(pos),
            nthreads, 1 if sort else 0)
    elif not sort:  # pragma: no cover - stale .so lacks unsorted decode
        return None
    else:
        m = lib.hv_decode_swar_flat(
            _i64p(ids), _i64p(widx),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            n, num_strips, block_words, _i64p(rows), _i64p(pos))
    return rows[:m].copy(), pos[:m].copy()


# The native composite sort key is (row << 38) | pos; beyond these bounds
# the key would overlap fields, so wrappers fall back to the numpy paths
# (which switch to np.lexsort themselves) instead of mis-sorting.
_MAX_KEY_ROW = 1 << 25
_MAX_KEY_POS = 1 << 38


def sort_hits_native(rows, pos, nthreads: int = 8) -> bool:
    """In-place parallel (row, position) sort; False when unavailable or
    when the composite key would overflow (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return False
    if rows.size and (int(rows.max()) >= _MAX_KEY_ROW
                      or int(pos.max()) >= _MAX_KEY_POS):
        return False
    assert rows.dtype == np.int64 and pos.dtype == np.int64
    assert rows.flags.c_contiguous and pos.flags.c_contiguous
    lib.hv_sort_hits(_i64p(rows), _i64p(pos), rows.shape[0], nthreads)
    return True


def sort_order_native(rows, pos, nthreads: int = 8):
    """Permutation sorting (rows, pos) by (row, position) — the parallel
    analog of ops.common.hit_sort_order; None when unavailable or when the
    composite key would overflow (caller falls back to numpy)."""
    lib = _load()
    if lib is None or not hasattr(lib, "hv_sort_order"):
        return None
    if rows.size and (int(rows.max()) >= _MAX_KEY_ROW
                      or int(pos.max()) >= _MAX_KEY_POS):
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    order = np.empty(rows.shape[0], dtype=np.int64)
    lib.hv_sort_order(_i64p(rows), _i64p(pos), rows.shape[0], nthreads,
                      _i64p(order))
    return order


def merge_runs_native(rows, pos, offsets, nthreads: int = 4):
    """Permutation merging k already-(row, pos)-sorted runs (run r spans
    [offsets[r], offsets[r+1]) of the concatenated arrays); None when
    unavailable or when the composite key would overflow — callers fall
    back to a full sort."""
    lib = _load()
    if lib is None or not hasattr(lib, "hv_merge_runs"):
        return None
    if rows.size and (int(rows.max()) >= _MAX_KEY_ROW
                      or int(pos.max()) >= _MAX_KEY_POS):
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    k = offs.shape[0] - 1
    order = np.empty(rows.shape[0], dtype=np.int64)
    lib.hv_merge_runs(_i64p(rows), _i64p(pos), rows.shape[0], _i64p(offs),
                      k, nthreads, _i64p(order))
    return order


def permute_i64_native(src, order, out=None, nthreads: int = 8):
    """dst[i] = src[order[i]] with a threaded native gather; None when the
    library is unavailable (caller uses numpy fancy indexing). ``out`` may
    be a contiguous int64 view to write into (e.g. a slice of a
    preallocated result column, saving one full copy)."""
    lib = _load()
    if lib is None or not hasattr(lib, "hv_permute_i64"):
        return None
    src = np.ascontiguousarray(src, dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    if out is None:
        out = np.empty(order.shape[0], dtype=np.int64)
    assert (out.dtype == np.int64 and out.flags.c_contiguous
            and out.shape[0] == order.shape[0])
    lib.hv_permute_i64(_i64p(src), _i64p(order), order.shape[0], _i64p(out),
                       nthreads)
    return out


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def chunk_keys_native(idx, words, ometa, tile_words: int, num_strips: int,
                      block_words: int, Pc: int, Lc: int, r0: int, lo: int,
                      nthreads: int = 1):
    """Fused chunk decode (round 5): expand SWAR records straight to SORTED
    global uint64 hit keys ((row + r0) << 38 | (pos + lo)), applying the
    (row < Pc, pos < Lc) bounds filter during expansion — replaces the
    decode → numpy-keep → add → per-chunk-sort chain with one pass sized
    exactly by a popcount prepass. ``ometa`` is the slot → tile-id map
    (None ⇒ identity, the dense-chunk case). None when unavailable (caller
    falls back to the legacy path)."""
    lib = _load()
    if lib is None or not hasattr(lib, "hv_chunk_keys"):
        return None
    n = int(words.shape[0])
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    w = np.ascontiguousarray(words).view(np.uint32)
    om = (None if ometa is None
          else np.ascontiguousarray(ometa, dtype=np.int32))
    omp = None if om is None else _i32p(om)
    m1 = lib.hv_chunk_count(_i64p(idx), w.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint32)), n, omp, tile_words, num_strips,
        block_words, Pc, Lc, nthreads)
    keys = np.empty(m1, dtype=np.uint64)
    if m1:
        m = lib.hv_chunk_keys(_i64p(idx), w.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint32)), n, omp, tile_words,
            num_strips, block_words, Pc, Lc, r0, lo, _u64p(keys), nthreads)
        assert m == m1
    return keys


def resolve_keys_native(keys, starts, lengths, prefix, nthreads: int = 1):
    """Resolve SORTED global uint64 hit keys to four int32 local-coordinate
    columns plus the kept keys (padding/separator hits dropped) — the
    key-form analog of resolve_hits_native. None when unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "hv_resolve_keys"):
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    prefix = np.ascontiguousarray(prefix, dtype=np.int64)
    n = keys.shape[0]
    cols = [np.empty(n, dtype=np.int32) for _ in range(4)]
    kout = np.empty(n, dtype=np.uint64)
    m = 0
    if n:
        m = lib.hv_resolve_keys(
            _u64p(keys), n, _i64p(starts), _i64p(lengths),
            starts.shape[0] - 1, _i64p(prefix), prefix.shape[0] - 1,
            _i32p(cols[0]), _i32p(cols[1]), _i32p(cols[2]), _i32p(cols[3]),
            _u64p(kout), nthreads)
    return tuple(a[:m] for a in cols) + (kout[:m],)


def merge_runs_u64_native(keys, offsets, nthreads: int = 4):
    """Permutation merging k already-sorted runs of uint64 keys; None when
    unavailable (callers fall back to an argsort)."""
    lib = _load()
    if lib is None or not hasattr(lib, "hv_merge_runs_u64"):
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    order = np.empty(keys.shape[0], dtype=np.int64)
    lib.hv_merge_runs_u64(_u64p(keys), keys.shape[0], _i64p(offs),
                          offs.shape[0] - 1, nthreads, _i64p(order))
    return order


def permute_i32_native(src, order, out=None, nthreads: int = 8):
    """dst[i] = src[order[i]] over int32 columns; None when unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "hv_permute_i32"):
        return None
    src = np.ascontiguousarray(src, dtype=np.int32)
    order = np.ascontiguousarray(order, dtype=np.int64)
    if out is None:
        out = np.empty(order.shape[0], dtype=np.int32)
    assert (out.dtype == np.int32 and out.flags.c_contiguous
            and out.shape[0] == order.shape[0])
    lib.hv_permute_i32(_i32p(src), _i64p(order), order.shape[0], _i32p(out),
                       nthreads)
    return out


def place_i32_native(runs, seg_run, seg_src, seg_dst, nthreads: int = 8):
    """Columns placed from segments of runs: ``runs[r]`` is run r's list of
    int32 columns (every run the same number); segment s copies
    ``seg_dst[s+1] - seg_dst[s]`` entries of each of run ``seg_run[s]``'s
    columns, from ``seg_src[s]``, to ``seg_dst[s]`` of the output columns.
    ``seg_dst`` is ascending from 0 and ends at the output's length. None
    when unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "hv_place_i32"):
        return None
    ncols = len(runs[0]) if runs else 0
    if any(len(cols) != ncols or any(c.dtype != np.int32 for c in cols)
           for cols in runs):
        raise ValueError("every run needs the same number of int32 columns")
    runs = [[np.ascontiguousarray(c) for c in cols] for cols in runs]
    seg_run = np.ascontiguousarray(seg_run, dtype=np.int64)
    seg_src = np.ascontiguousarray(seg_src, dtype=np.int64)
    seg_dst = np.ascontiguousarray(seg_dst, dtype=np.int64)
    nseg = seg_run.shape[0]
    if seg_src.shape != (nseg,) or seg_dst.shape != (nseg + 1,):
        raise ValueError("segments need a run and a source each and "
                         "nseg + 1 destination offsets")
    lens = np.diff(seg_dst)
    sizes = np.array([min((c.shape[0] for c in cols), default=0)
                      for cols in runs], dtype=np.int64)
    if nseg and (seg_dst[0] != 0 or (lens < 0).any() or (seg_src < 0).any()
                 or (seg_run < 0).any() or (seg_run >= len(runs)).any()
                 or (seg_src + lens > sizes[seg_run]).any()):
        raise ValueError("a segment lies outside its run or the output")
    n = int(seg_dst[-1])
    out = [np.empty(n, dtype=np.int32) for _ in range(ncols)]
    if n and ncols:
        srcs = np.array([c.ctypes.data for cols in runs for c in cols],
                        dtype=np.uintp)
        dsts = np.array([c.ctypes.data for c in out], dtype=np.uintp)
        lib.hv_place_i32(srcs.ctypes.data, ncols, _i64p(seg_run),
                         _i64p(seg_src), _i64p(seg_dst), nseg,
                         dsts.ctypes.data, nthreads)
    return out


def keys_to_pairs_native(keys, nthreads: int = 8):
    """uint64 hit keys → int64 (rows, positions); None when unavailable
    (callers use numpy shifts)."""
    lib = _load()
    if lib is None or not hasattr(lib, "hv_keys_to_pairs"):
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = keys.shape[0]
    rows = np.empty(n, dtype=np.int64)
    pos = np.empty(n, dtype=np.int64)
    if n:
        lib.hv_keys_to_pairs(_u64p(keys), n, _i64p(rows), _i64p(pos),
                             nthreads)
    return rows, pos


def resolve_hits_native(rows, pos, starts, lengths, prefix,
                        nthreads: int = 8):
    """Native coordinate resolution; returns (seq_idx, seq_pos, model_idx,
    model_pos) or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    prefix = np.ascontiguousarray(prefix, dtype=np.int64)
    n = rows.shape[0]
    out = [np.empty(n, dtype=np.int64) for _ in range(4)]
    m = lib.hv_resolve_hits(
        _i64p(rows), _i64p(pos), n, _i64p(starts), _i64p(lengths),
        starts.shape[0] - 1, _i64p(prefix), prefix.shape[0] - 1,
        _i64p(out[0]), _i64p(out[1]), _i64p(out[2]), _i64p(out[3]), nthreads)
    return tuple(a[:m].copy() for a in out)
