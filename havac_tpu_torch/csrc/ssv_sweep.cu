// SSV sweep for NVIDIA Hopper (sm_90a): three DP diagonals in each 32-bit
// word, a word's diagonals owned by one thread for all rows.
//
// Replaces the Pallas TPU kernel havac_tpu/ops/ssv_swar.py
// `_ssv_swar_kernel` / `_ssv_swar_body` (launched by `_ssv_swar_jit`) and the
// XLA record compaction around it (havac_tpu/engine/pipeline.py
// `_compact_tiles_core`, `_compact_tiles_packed16`, `fused_batch`): the
// kernel sweeps the (P rows x L positions) SSV matrix and appends every hit
// as a u64 key itself, so there is no dirty-tile drain and no compaction.
// It also stands for the unpacked Pallas kernel havac_tpu/ops/ssv_pallas.py
// `_ssv_kernel` (launched by `_ssv_pallas_jit`): the same recurrence one
// cell per int32, whose strip bitmaps the hit keys replace.
//
//   S[j][i] = S[j-1][i-1] + scores[j][sym[i]]   (0 at a reset row's input)
//   S < 0 -> 0;  S >= 256 -> 0 and hit (j, i)
//
// What bounds it on the H100: instruction issue. The one-cell-per-thread
// loop this kernel replaced issued 27.25 SASS a cell (two dependent shared
// loads, the live-range test, add, clamp, a vote and their branches; python
// -m havac_tpu_torch.tools.sass), 0.79 of the card's issue slots at
// 86.26 ms for 8.4e10 cells: issue-bound, neither shared-memory- nor
// latency-bound. This design issues 12.66 SASS a word and row in an
// interior hit window, 4.22 a cell: the word update alone, with no roll, no
// per-row vote and no per-row branch (PERF.md has the counts and times).
// Device memory carries a few symbol bytes per hundred cells, mostly from
// L2, and the hit keys.
//
// Design (the SWAR algebra of ssv_swar.py, without its roll): a block of
// kT threads owns kV = kT * kWords words; word v holds the
// diagonals d0 + v, d0 + kV + v and d0 + 2 kV + v in its 10-bit fields 0-2
// (ssv_swar.py `pack_state`'s split-block layout with W3 = kV), so a
// diagonal's state stays in its field for every row: no roll, no shuffle,
// no barrier a row. Fields are biased so that one add and two shifts decide
// all three cells: w = st + match (match = score + 256 a field), hit = bit 9,
// keep = (w >> 8) & ~(w >> 9) & FM, st = w & (keep * 255). Per tile of kRows
// rows the block stages, per window position x, the symbols at x, kV + x and
// 2 kV + x packed at the field offsets; word v reads entry v + k at row k.
//   card 4: the staged entry is the two code-bit planes {b0, b1} (bit 0 of
//     each field), and match = c + b0 e1 + b1 e2 + (b0 & b1) e3 from the
//     row's four scalars (c = m0 FM, e1 = m1 - m0, e2 = m2 - m0,
//     e3 = m3 - m2 - m1 + m0): one 8-byte shared load, one AND and three
//     IMADs a word, exact modulo 2^32 (PERF.md: the inline IMAD match beat
//     both match-precompute designs on this card).
//   other cards (<= 32): the staged entry holds the three codes, and the
//     match is three conflict-free reads of the row's tables of biased
//     scores pre-shifted to each field.
// Hits: each row ORs w & (bit 9 of every field) into one word; every kWin
// rows one __any_sync asks the warp, and only a warp that saw a hit replays
// the window from its saved state, decoding hits row by row and appending
// keys with one warp-aggregated atomicAdd a row. The count is exact past
// `cap`. Edges: a block that touches the left triangle (diagonal d < 0
// starts at row -d with init_carry[-d]), the right triangle (a diagonal ends
// at position L - 1 before row P - 1) or the ragged end runs the same row
// with per-field live masks (a field outside its rows neither changes nor
// hits); the choice is per block, by its index. Blocks have kT = 256
// threads, or 64 where 256-thread blocks would not fill every SM four times
// (a short sequence), chosen per launch from the grid size.
//
// Row-dump variant (a non-null `dump`, dispatched explicitly to
// ssv_dump_kernel): the per-cell debug readout keeps the one-cell-per-thread
// body. It replaces the SWAR kernel's `debug_rows` output (the packed state
// after every row, havac_tpu/ops/ssv_swar.py `_ssv_swar_jit(debug_rows=True)`)
// and the row-by-row `_ssv_pallas_jit` readout of havac_tpu/testing/percell.py
// `dp_matrix_pallas`. Every active cell's post-update state is stored to
// dump[j * L + i] as one byte (a post-update state lies in [0, 255]).
// Consecutive threads own consecutive diagonals, hence consecutive positions
// of a row, so a warp's 32 stores fill one 32-byte sector: the byte a cell
// of device-memory writes is what grows with the matrix. It is a debug path:
// its time is recorded in PERF.md, not tuned. Keys, the exact count,
// final_state and final_carry are the same as an undumped launch's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCard = 32;
constexpr uint32_t kFM = 0x00100401u;  // bit 0 of each 10-bit field
constexpr uint32_t kHM = kFM << 9;     // bit 9: the hit bit
constexpr uint32_t kField = 0x3FFu;

struct Sweep {
  const uint8_t* symbols;
  long long L;
  const int8_t* scores;
  int P, card;
  const int32_t* init_state;
  const int32_t* init_carry;
  const int32_t* reset_rows;
  long long row_offset, pos_offset;
  int32_t* final_state;
  int32_t* final_carry;
  unsigned long long* keys;
  unsigned long long cap;
  unsigned long long* count;
};

// ---------------------------------------------------------------- words

// Threads a block: kWide, or kNarrow where kWide blocks (3 * kWide * kWords
// diagonals each) would be too few to fill the card (a short sequence).
constexpr int kWide = 256;
constexpr int kNarrow = 64;
constexpr int kWords = 2;               // words a thread
constexpr int kRows = 64;               // model rows a staged tile
constexpr int kWin = 16;                // rows a hit window

template <bool kCard4, int kT>
struct Tile {
  // card 4: {b0, b1} planes; other cards: .x = the three codes
  uint2 sym[kT * kWords + kRows];
  int4 row[kCard4 ? kRows : 1];  // card 4: {c, e1, e2, e3}
  // other cards: [k][f][code] = (score + 256) << 10 f; the slack keeps an
  // (invalid) code up to 255 inside the array
  uint32_t tab[kCard4 ? 1 : kRows * 3 * kMaxCard + 256];
  int32_t reset[kRows];
};

// Per-field geometry of one word, for the masked (edge) update.
struct Fields {
  long long d[3];  // diagonals
  int js[3], je[3];  // live rows [js, je)
};

template <bool kCard4, int kT>
__device__ __forceinline__ uint32_t match_word(const Tile<kCard4, kT>& t, int v,
                                               int k) {
  const uint2 p = t.sym[v + k];
  if (kCard4) {
    const int4 r = t.row[k];
    return (uint32_t)r.x + p.x * (uint32_t)r.y + p.y * (uint32_t)r.z +
           (p.x & p.y) * (uint32_t)r.w;
  } else {
    const uint32_t* tab = t.tab + k * 3 * kMaxCard;
    return tab[p.x & kField] + tab[kMaxCard + ((p.x >> 10) & kField)] +
           tab[2 * kMaxCard + (p.x >> 20)];
  }
}

// One row of one word: the new state; `hit` gets the live fields' bit 9.
template <bool kCard4, bool kReset, bool kEdge, int kT>
__device__ __forceinline__ uint32_t row_word(uint32_t st,
                                             const Tile<kCard4, kT>& t,
                                             int v, int k, int j,
                                             const Fields& g,
                                             const int32_t* init_carry,
                                             uint32_t& hit) {
  uint32_t lm = 0;
  if (kEdge) {
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      if ((unsigned)(j - g.js[f]) < (unsigned)(g.je[f] - g.js[f]))
        lm |= kField << (10 * f);
      // A negative diagonal enters at row -d with the incoming carry (its
      // field is 0 until then).
      if (j == g.js[f] && j > 0) st |= (uint32_t)init_carry[j] << (10 * f);
    }
  }
  uint32_t in = st;
  if (kReset && t.reset[k]) in = 0;
  const uint32_t w = in + match_word<kCard4, kT>(t, v, k);
  const uint32_t t9 = w >> 9;
  const uint32_t keep = (w >> 8) & ~t9 & kFM;
  uint32_t nst = w & (keep * 255u);
  hit = w & kHM;
  if (kEdge) {
    nst = (nst & lm) | (st & ~lm);
    hit &= lm;
  }
  return nst;
}

// A warp's hits of one row: one atomicAdd for all of them.
__device__ __forceinline__ void emit(const uint32_t (&hit)[kWords],
                                     const Fields (&g)[kWords], int j,
                                     const Sweep& a) {
  const unsigned lane = threadIdx.x & 31;
  unsigned m[kWords * 3];
  unsigned total = 0;
#pragma unroll
  for (int q = 0; q < kWords * 3; ++q) {
    m[q] = __ballot_sync(0xffffffffu, (hit[q / 3] >> (10 * (q % 3) + 9)) & 1u);
    total += __popc(m[q]);
  }
  if (total == 0) return;
  unsigned long long base = 0;
  if (lane == 0) base = atomicAdd(a.count, (unsigned long long)total);
  base = __shfl_sync(0xffffffffu, base, 0);
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kWords * 3; ++q) {
    if ((m[q] >> lane) & 1u) {
      const unsigned long long idx = base + __popc(m[q] & lt);
      if (idx < a.cap) {
        a.keys[idx] = ((unsigned long long)(j + a.row_offset) << 38) |
                      (unsigned long long)(g[q / 3].d[q % 3] + j + a.pos_offset);
      }
    }
    base += __popc(m[q]);
  }
}

template <bool kCard4, int kT>
__device__ __forceinline__ void stage(Tile<kCard4, kT>& t, const Sweep& a,
                                      long long w0, int j0, int nrows) {
  constexpr int kV = kT * kWords;
  const int tid = threadIdx.x;
  for (int x = tid; x < kV + nrows - 1; x += kT) {
    uint32_t p = 0;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const long long i = w0 + x + (long long)f * kV;
      if (i >= 0 && i < a.L) p |= (uint32_t)a.symbols[i] << (10 * f);
    }
    t.sym[x] = kCard4 ? make_uint2(p & kFM, (p >> 1) & kFM) : make_uint2(p, 0);
  }
  const int8_t* src = a.scores + (long long)j0 * a.card;
  if (kCard4) {
    for (int k = tid; k < nrows; k += kT) {
      const int m0 = src[4 * k] + 256, m1 = src[4 * k + 1] + 256;
      const int m2 = src[4 * k + 2] + 256, m3 = src[4 * k + 3] + 256;
      t.row[k] = make_int4((int)((uint32_t)m0 * kFM), m1 - m0, m2 - m0,
                           m3 - m2 - m1 + m0);
    }
  } else {
    for (int x = tid; x < nrows * a.card; x += kT) {
      const int k = x / a.card, code = x - k * a.card;
      const uint32_t m = (uint32_t)(src[x] + 256);
#pragma unroll
      for (int f = 0; f < 3; ++f)
        t.tab[(k * 3 + f) * kMaxCard + code] = m << (10 * f);
    }
  }
  if (a.reset_rows != nullptr) {
    for (int k = tid; k < nrows; k += kT) t.reset[k] = a.reset_rows[j0 + k];
  }
}

template <bool kCard4, bool kReset, bool kEdge, int kT>
__device__ __forceinline__ void sweep_block(Tile<kCard4, kT>& t, const Sweep& a,
                                            long long d0) {
  constexpr int kV = kT * kWords;
  const int tid = threadIdx.x;
  const long long L = a.L;
  const int P = a.P;
  uint32_t st[kWords];
  Fields g[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    st[w] = 0;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const long long d = d0 + (long long)f * kV + w * kT + tid;
      g[w].d[f] = d;
      g[w].js[f] = d < 0 ? (int)(-d) : 0;
      g[w].je[f] = d <= L - 1 ? (int)(L - d < (long long)P ? L - d : P) : 0;
      uint32_t v = 0;
      if (d <= L - 1) v = d >= 1 ? a.init_state[d - 1] : (d == 0 ? a.init_carry[0] : 0);
      st[w] |= v << (10 * f);
    }
  }
  // Rows where any field of this block is live.
  long long jlo = -(d0 + 3 * kV - 1);
  if (jlo < 0) jlo = 0;
  long long jhi = L - d0;
  if (jhi > P) jhi = P;

  for (int j0 = (int)jlo; j0 < jhi; j0 += kRows) {
    const int nrows = (int)(jhi - j0 < kRows ? jhi - j0 : kRows);
    __syncthreads();  // the previous tile is fully consumed
    stage<kCard4, kT>(t, a, d0 + j0, j0, nrows);
    __syncthreads();
    for (int k0 = 0; k0 < nrows; k0 += kWin) {
      uint32_t saved[kWords], acc[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        saved[w] = st[w];
        acc[w] = 0;
      }
      const int n = nrows - k0 < kWin ? nrows - k0 : kWin;
      if (n == kWin) {
#pragma unroll
        for (int r = 0; r < kWin; ++r) {
#pragma unroll
          for (int w = 0; w < kWords; ++w) {
            uint32_t h;
            st[w] = row_word<kCard4, kReset, kEdge, kT>(
                st[w], t, w * kT + tid, k0 + r, j0 + k0 + r, g[w],
                a.init_carry, h);
            acc[w] |= h;
          }
        }
      } else {
#pragma unroll 1
        for (int r = 0; r < n; ++r) {
#pragma unroll
          for (int w = 0; w < kWords; ++w) {
            uint32_t h;
            st[w] = row_word<kCard4, kReset, kEdge, kT>(
                st[w], t, w * kT + tid, k0 + r, j0 + k0 + r, g[w],
                a.init_carry, h);
            acc[w] |= h;
          }
        }
      }
      uint32_t any = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) any |= acc[w];
      if (__any_sync(0xffffffffu, any != 0)) {
        // Rare: replay the window from its saved state and emit its hits.
#pragma unroll 1
        for (int r = 0; r < n; ++r) {
          uint32_t h[kWords];
#pragma unroll
          for (int w = 0; w < kWords; ++w)
            saved[w] = row_word<kCard4, kReset, kEdge, kT>(
                saved[w], t, w * kT + tid, k0 + r, j0 + k0 + r, g[w],
                a.init_carry, h[w]);
          emit(h, g, j0 + k0 + r, a);
        }
      }
    }
  }

  // Each field holds its diagonal's state after its last live row.
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const long long d = g[w].d[f];
      const int je = g[w].je[f];
      if (d > L - 1) continue;
      const int32_t val = (int32_t)((st[w] >> (10 * f)) & kField);
      if (je == P) a.final_state[d + P - 1] = val;  // bottom edge
      if (d + je - 1 == L - 1) a.final_carry[je] = val;  // right edge
    }
  }
}

// At most 64 registers a thread: 1024 / kT blocks of kT threads an SM.
template <bool kCard4, bool kReset, int kT>
__global__ void __launch_bounds__(kT, 1024 / kT)
ssv_word_kernel(const Sweep a) {
  constexpr int kSpan = 3 * kT * kWords;  // diagonals a block
  __shared__ __align__(16) Tile<kCard4, kT> t;
  const long long d0 = (long long)blockIdx.x * kSpan - (a.P - 1);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.final_carry[0] = a.init_state[a.L - 1];
  // Interior: every field live from row 0 to row P - 1.
  if (d0 >= 0 && d0 + kSpan - 1 <= a.L - a.P)
    sweep_block<kCard4, kReset, false, kT>(t, a, d0);
  else
    sweep_block<kCard4, kReset, true, kT>(t, a, d0);
}

template <int kT>
void launch_words(const Sweep& a, bool reset, cudaStream_t s) {
  constexpr int kSpan = 3 * kT * kWords;
  const unsigned grid = (unsigned)((a.L + a.P - 1 + kSpan - 1) / kSpan);
  if (a.card == 4 && reset)
    ssv_word_kernel<true, true, kT><<<grid, kT, 0, s>>>(a);
  else if (a.card == 4)
    ssv_word_kernel<true, false, kT><<<grid, kT, 0, s>>>(a);
  else if (reset)
    ssv_word_kernel<false, true, kT><<<grid, kT, 0, s>>>(a);
  else
    ssv_word_kernel<false, false, kT><<<grid, kT, 0, s>>>(a);
}

// ----------------------------------------------------------- row dump

constexpr int kDumpThreads = 256;  // diagonals a block
constexpr int kDumpRows = 64;

template <bool kReset>
__global__ void __launch_bounds__(kDumpThreads)
ssv_dump_kernel(const Sweep a, uint8_t* __restrict__ dump) {
  // A symbol code >= card must not read outside the tile (the engine
  // validates codes on the host; the slack keeps any byte in bounds).
  __shared__ int32_t s_scores[kDumpRows * kMaxCard + 256];
  __shared__ int32_t s_reset[kDumpRows];
  __shared__ uint8_t s_sym[kDumpThreads + kDumpRows];

  const int tid = threadIdx.x;
  const unsigned lane = tid & 31;
  const long long L = a.L;
  const int P = a.P, card = a.card;
  // Diagonals d in [-(P-1), L-1]; block b covers [d0, d0 + kDumpThreads).
  const long long d0 = (long long)blockIdx.x * kDumpThreads - (P - 1);
  const long long d = d0 + tid;
  const bool valid = d <= L - 1;
  // Rows this thread's diagonal occupies: [jstart, jend).
  const int jstart = d < 0 ? (int)(-d) : 0;
  const int jend = valid ? (int)(L - d < (long long)P ? L - d : P) : 0;
  int32_t state = 0;
  if (valid) state = d >= 1 ? a.init_state[d - 1] : a.init_carry[-d];
  if (blockIdx.x == 0 && tid == 0) a.final_carry[0] = a.init_state[L - 1];

  long long jlo = -(d0 + kDumpThreads - 1);
  if (jlo < 0) jlo = 0;
  long long jhi = L - d0;
  if (jhi > P) jhi = P;

  for (int j0 = (int)jlo; j0 < jhi; j0 += kDumpRows) {
    const int nrows = (int)(jhi - j0 < kDumpRows ? jhi - j0 : kDumpRows);
    __syncthreads();  // the previous tile is fully consumed
    const int8_t* src = a.scores + (long long)j0 * card;
    for (int t = tid; t < nrows * card; t += kDumpThreads) s_scores[t] = src[t];
    if (kReset) {
      for (int t = tid; t < nrows; t += kDumpThreads) s_reset[t] = a.reset_rows[j0 + t];
    }
    const long long w0 = d0 + j0;  // global position of s_sym[0]
    for (int t = tid; t < kDumpThreads + nrows - 1; t += kDumpThreads) {
      const long long i = w0 + t;
      s_sym[t] = (i >= 0 && i < L) ? a.symbols[i] : 0;
    }
    __syncthreads();

    for (int k = 0; k < nrows; ++k) {
      const int j = j0 + k;
      const bool active = (unsigned)(j - jstart) < (unsigned)(jend - jstart);
      bool hit = false;
      if (active) {
        int32_t in = state;
        if (kReset && s_reset[k]) in = 0;
        const int32_t s = in + s_scores[k * card + s_sym[tid + k]];
        hit = s >= 256;
        state = (s < 0 || hit) ? 0 : s;
        // 64-bit offset: a full-width dump exceeds 2^31 cells.
        dump[(long long)j * L + d + j] = (uint8_t)state;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (mask) {
        const int leader = __ffs(mask) - 1;
        unsigned long long base = 0;
        if ((int)lane == leader) base = atomicAdd(a.count, (unsigned long long)__popc(mask));
        base = __shfl_sync(0xffffffffu, base, leader);
        if (hit) {
          const unsigned long long idx = base + __popc(mask & ((1u << lane) - 1u));
          if (idx < a.cap) {
            a.keys[idx] = ((unsigned long long)(j + a.row_offset) << 38) |
                          (unsigned long long)(d + j + a.pos_offset);
          }
        }
      }
    }
  }

  // The register holds the diagonal's state after its last row.
  if (valid) {
    if (jend == P) a.final_state[d + P - 1] = state;         // bottom edge
    if (d + jend - 1 == L - 1) a.final_carry[jend] = state;  // right edge
  }
}

}  // namespace

// `reset_rows` and `dump` may be null: no reset rows, no row dump. `dump`
// is (P, L) uint8, row-major. The body is chosen explicitly: a non-null
// `dump` runs the one-cell-per-thread dump kernel, otherwise card 4 runs the
// word kernel's bit-plane match and every other card its table match.
extern "C" int hv_ssv_sweep(const void* symbols, long long L, const void* scores,
                            int P, int card, const void* init_state,
                            const void* init_carry, const void* reset_rows,
                            long long row_offset, long long pos_offset,
                            void* final_state, void* final_carry, void* keys,
                            unsigned long long cap, void* count, void* dump,
                            void* stream) {
  if (L <= 0 || P <= 0 || card < 2 || card > kMaxCard) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  const Sweep a{(const uint8_t*)symbols, L, (const int8_t*)scores, P, card,
                (const int32_t*)init_state, (const int32_t*)init_carry,
                (const int32_t*)reset_rows, row_offset, pos_offset,
                (int32_t*)final_state, (int32_t*)final_carry,
                (unsigned long long*)keys, cap, (unsigned long long*)count};
  const long long ndiag = L + P - 1;
  const bool reset = reset_rows != nullptr;
  if (dump != nullptr) {
    const unsigned grid = (unsigned)((ndiag + kDumpThreads - 1) / kDumpThreads);
    if (reset)
      ssv_dump_kernel<true><<<grid, kDumpThreads, 0, s>>>(a, (uint8_t*)dump);
    else
      ssv_dump_kernel<false><<<grid, kDumpThreads, 0, s>>>(a, (uint8_t*)dump);
    return (int)cudaGetLastError();
  }
  // Wide blocks when they fill every SM four times over (their residency).
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (ndiag / (3 * kWide * kWords) >= 4LL * sms)
    launch_words<kWide>(a, reset, s);
  else
    launch_words<kNarrow>(a, reset, s);
  return (int)cudaGetLastError();
}

extern "C" const char* hv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
