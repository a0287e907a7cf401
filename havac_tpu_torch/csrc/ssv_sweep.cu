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
// kT threads owns kV = kT * kW words; word v holds the
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
//   other cards (<= 32): the staged entry holds, in byte f, 4 x field f's
//     code: the byte offset of its entry in field f's table of the row's
//     biased scores pre-shifted to the field. One 4-byte shared load, one
//     LOP3, one PRMT and one shift (or LEA.HI) extract the three offsets,
//     and the three table reads are conflict-free (a 128-byte table a field
//     and row), each at its offset plus the window's base in a uniform
//     register plus the row's and field's base as an immediate: 15.9 SASS
//     a word and row and four shared wavefronts a warp, word and row, where
//     the three codes of an 8-byte entry took 10-bit extraction and address
//     arithmetic a field (21.6 and five; PERF.md).
// Reset rows (a model start, whose input is 0): one ballot a window gathers
// its reset rows into a warp-uniform mask, and a window without one, most of
// them, runs its rows with no reset test.
// Hits: each row ORs w & (bit 9 of every field) into one word; every kWin
// rows one __any_sync asks the warp, and only a warp that saw a hit replays
// the window from its saved state, decoding hits row by row and appending
// keys with one warp-aggregated atomicAdd a row. The count is exact past
// `cap`. Edges: a block that touches the left triangle (diagonal d < 0
// starts at row -d with init_carry[-d]), the right triangle (a diagonal ends
// at position L - 1 before row P - 1) or the ragged end runs the same row
// with per-field live masks (a field outside its rows neither changes nor
// hits), but only in the staged tiles where some field enters or leaves:
// the rows where all of its fields are live take the unmasked row. (Masking
// every row made the triangle blocks next to the interior, which walk
// nearly all P rows at several times an interior block's cycles a row, the
// launch's span at a short sequence; PERF.md.) Blocks have kT = 256
// threads and kW = 2 words a thread, or 64 threads where 256-thread blocks
// would not fill every SM four times (a short sequence), chosen per launch
// from the grid size.
//
// Row dump (a non-null `dump`): the same templates with kDump set. In the
// fast pass of every hit window each live field's post-update state (at most
// 255: field 0 is the word's low byte, fields 1 and 2 take one shift each)
// goes to the cell's byte dump[j * L + d + j]; the replay stores nothing,
// and a field outside its rows is never stored, so every cell is written
// exactly once. It replaces the SWAR kernel's `debug_rows` output (the
// packed state after every row, havac_tpu/ops/ssv_swar.py
// `_ssv_swar_jit(debug_rows=True)`) and the row-by-row `_ssv_pallas_jit`
// readout of havac_tpu/testing/percell.py `dp_matrix_pallas`.
// What bounds it: the bytes, one a cell, and in practice their pattern. A
// block's live cells at row j are one run of at most 3 kV bytes starting at j
// (L + 1) + d0 + lo, an alignment that moves every row, and the block's runs
// of successive rows lie L + 1 bytes apart. Byte stores of the live fields
// straight from the word body (a warp's 32 lanes write 32 consecutive bytes a
// field) are the simplest form and drained the slowest, measured on the card
// against this design (CHANGES.md). So a hit window's rows are staged in
// shared memory, each at its destination's alignment mod 16; after one barrier
// a window, one thread a row writes the run's 16-byte-aligned middle with
// cp.async.bulk (shared to global, the async proxy) and the ragged head and
// tail (under 16 bytes each) go by byte stores, two buffers in turn so that a
// window's copies run behind the next window's rows. Alignment is that of the
// address, so the dump may start anywhere. Even those whole-chunk writes
// drained slower the narrower the run (the bare write pattern, timed alone),
// and the dump's geometry is its own (kDumpT, kDumpW): 128 threads of one
// word, a 384-byte run a row, the widest whose card-20 tables and two staging
// buffers fit a block's 48 KB of static shared memory, one word a thread
// keeping the row under 64 registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  // The row dump (kDump instantiations only): (P, L) row-major from
  // dump + skew, where dump is 16-byte aligned and skew < 16.
  uint8_t* dump;
  int skew;
};

// ---------------------------------------------------------------- words

// Threads a block: kWide, or kNarrow where kWide blocks (3 * kWide * kWords
// diagonals each) would be too few to fill the card (a short sequence).
constexpr int kWide = 256;
constexpr int kNarrow = 64;
constexpr int kWords = 2;               // words a thread
constexpr int kDumpT = 128;             // the row dump's threads a block
constexpr int kDumpW = 1;               // and words a thread
constexpr int kRows = 64;               // model rows a staged tile
constexpr int kWin = 16;                // rows a hit window

// Bytes from one row's first table to the next (other cards).
constexpr int kTabRow = 3 * kMaxCard * 4;

template <bool kCard4, int kT, int kW>
struct Tile {
  // card 4: {b0, b1} planes; other cards: byte f = 4 x (code f & 63), the
  // byte offset of the code's entry in field f's table
  typename std::conditional<kCard4, uint2, uint32_t>::type sym[kT * kW + kRows];
  int4 row[kCard4 ? kRows : 1];  // card 4: {c, e1, e2, e3}
  // other cards: [k][f][code] = (score + 256) << 10 f; the slack keeps any
  // code (6 bits of it staged) inside the array
  uint32_t tab[kCard4 ? 1 : kRows * 3 * kMaxCard + 64];
  int32_t reset[kRows];
};

// Per-field geometry of one word, for the masked (edge) update.
struct Fields {
  long long d[3];  // diagonals
  int js[3], je[3];  // live rows [js, je)
};

template <bool kCard4, int kT, int kW>
__device__ __forceinline__ uint32_t match_word(const Tile<kCard4, kT, kW>& t,
                                               int v, int k) {
  if constexpr (kCard4) {
    const uint2 p = t.sym[v + k];
    const int4 r = t.row[k];
    return (uint32_t)r.x + p.x * (uint32_t)r.y + p.y * (uint32_t)r.z +
           (p.x & p.y) * (uint32_t)r.w;
  } else {
    // Each field's byte is its entry's offset in its table: one LOP3, one
    // PRMT and one shift extract them; the table bases need no arithmetic a
    // word (the window's is uniform, the row's and field's immediate).
    const uint32_t p = t.sym[v + k];
    const char* tab = reinterpret_cast<const char*>(t.tab) + k * kTabRow;
    auto at = [tab](uint32_t off) {
      return *reinterpret_cast<const uint32_t*>(tab + off);
    };
    return at(p & 0xFFu) + at(4 * kMaxCard + __byte_perm(p, 0, 0x4441)) +
           at(8 * kMaxCard + (p >> 16));
  }
}

// One row of one word: the new state; `hit` gets the live fields' bit 9,
// `lm` (kMask only) the live fields' 10-bit masks. `rz` (kReset only): the
// row is a reset row, whose input is 0.
template <bool kCard4, bool kReset, bool kMask, int kT, int kW>
__device__ __forceinline__ uint32_t row_word(uint32_t st,
                                             const Tile<kCard4, kT, kW>& t,
                                             int v, int k, int j, bool rz,
                                             const Fields& g,
                                             const int32_t* init_carry,
                                             uint32_t& hit, uint32_t& lm) {
  lm = 0;
  if (kMask) {
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
  if (kReset && rz) in = 0;
  const uint32_t w = in + match_word<kCard4, kT, kW>(t, v, k);
  const uint32_t t9 = w >> 9;
  const uint32_t keep = (w >> 8) & ~t9 & kFM;
  uint32_t nst = w & (keep * 255u);
  hit = w & kHM;
  if (kMask) {
    nst = (nst & lm) | (st & ~lm);
    hit &= lm;
  }
  return nst;
}

// The row dump's staging: a window's rows, each at the alignment (mod 16)
// of its destination, two windows' buffers in turn. (A ring of four drained
// no faster: the write pattern, not the wait, sets the pace; PERF.md.)
template <int kSpan>
struct DumpStage {
  static constexpr int kStride = (kSpan + 31) / 16 * 16;  // >= kSpan + 15
  uint8_t row[2][kWin][kStride];
};

// Row j's live run of a block's span [lo, hi): diagonal d0 + x is live at
// row j when its position d0 + x + j lies in [0, L).
template <int kSpan>
__device__ __forceinline__ void live_run(long long d0, int j, long long L,
                                         int& lo, int& hi) {
  const long long a = -(long long)j - d0, b = L - j - d0;
  lo = a > 0 ? (int)a : 0;
  hi = b < kSpan ? (int)(b > 0 ? b : 0) : kSpan;
}

// A window's staged rows to the dump: the 16-byte-aligned middle of each
// row's live run by one cp.async.bulk (thread r issues row r, so each of the
// first kWin threads owns a bulk async-group a window), the ragged head and
// tail (under 16 bytes each) by byte stores. Offsets count from the aligned
// `dump` (the matrix starts at dump + skew). Called after the barrier that
// publishes the buffer; the copies read it while the next window runs.
template <int kSpan, int kStride, int kT>
__device__ __forceinline__ void dump_window(const uint8_t (&buf)[kWin][kStride],
                                            uint8_t* dump, int skew,
                                            long long L, long long d0, int j0,
                                            int n) {
  const int tid = threadIdx.x;
  if (tid < n) {
    const int j = j0 + tid;
    int lo, hi;
    live_run<kSpan>(d0, j, L, lo, hi);
    const long long g = (long long)j * (L + 1) + d0 + skew;  // span position 0
    const long long a = (g + lo + 15) & ~15LL, b = (g + hi) & ~15LL;
    if (a < b) {
      const uint8_t* src = &buf[tid][(int)(g & 15) + (int)(a - g)];
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
              "l"(dump + a),
          "r"((uint32_t)__cvta_generic_to_shared(src)), "r"((uint32_t)(b - a))
          : "memory");
    }
  }
  if (tid < kWin) asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  for (int e = tid; e < n * 32; e += kT) {
    const int r = e >> 5, i = e & 31, j = j0 + r;
    int lo, hi;
    live_run<kSpan>(d0, j, L, lo, hi);
    const long long g = (long long)j * (L + 1) + d0 + skew;
    const long long a = (g + lo + 15) & ~15LL, b = (g + hi) & ~15LL;
    long long at = -1;  // byte i of the head (i < 16) or tail (i >= 16)
    if (a >= b) {
      if (i < hi - lo) at = g + lo + i;
    } else if (i < 16) {
      if (g + lo + i < a) at = g + lo + i;
    } else if (b + (i - 16) < g + hi) {
      at = b + (i - 16);
    }
    if (at >= 0) dump[at] = buf[r][(int)(g & 15) + (int)(at - g)];
  }
}

// A warp's hits of one row: one atomicAdd for all of them.
template <int kW>
__device__ __forceinline__ void emit(const uint32_t (&hit)[kW],
                                     const Fields (&g)[kW], int j,
                                     const Sweep& a) {
  const unsigned lane = threadIdx.x & 31;
  unsigned m[kW * 3];
  unsigned total = 0;
#pragma unroll
  for (int q = 0; q < kW * 3; ++q) {
    m[q] = __ballot_sync(0xffffffffu, (hit[q / 3] >> (10 * (q % 3) + 9)) & 1u);
    total += __popc(m[q]);
  }
  if (total == 0) return;
  unsigned long long base = 0;
  if (lane == 0) base = atomicAdd(a.count, (unsigned long long)total);
  base = __shfl_sync(0xffffffffu, base, 0);
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kW * 3; ++q) {
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

template <bool kCard4, int kT, int kW>
__device__ __forceinline__ void stage(Tile<kCard4, kT, kW>& t, const Sweep& a,
                                      long long w0, int j0, int nrows) {
  constexpr int kV = kT * kW;
  const int tid = threadIdx.x;
  for (int x = tid; x < kV + nrows - 1; x += kT) {
    uint32_t p = 0;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const long long i = w0 + x + (long long)f * kV;
      if (i >= 0 && i < a.L)
        p |= kCard4 ? (uint32_t)a.symbols[i] << (10 * f)
                    : ((uint32_t)a.symbols[i] & 63u) << (8 * f + 2);
    }
    if constexpr (kCard4)
      t.sym[x] = make_uint2(p & kFM, (p >> 1) & kFM);
    else
      t.sym[x] = p;
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

// The row dump's stores of one word into a row of the span: field f of word
// w is span position f kV + w kT + tid of `row` (the staged row at its
// destination's alignment).
template <bool kMask, int kT, int kW>
__device__ __forceinline__ void stage_word(uint8_t* row, uint32_t st,
                                           uint32_t lm, int w) {
#pragma unroll
  for (int f = 0; f < 3; ++f)
    if (!kMask || ((lm >> (10 * f)) & 1u))
      row[f * kT * kW + w * kT + threadIdx.x] = (uint8_t)(st >> (10 * f));
}

// The rows of one hit window, rows k0 .. k0 + n - 1 of the tile (all kWin
// of them unrolled when n == kWin): the state, the hit bits into `acc`, and
// in the dump each row's live fields into `buf` at the alignment of
// a.dump + gpos (`gpos` advances a row at a time). kTest: bit r
// of `rm` marks row k0 + r a reset row; without it the rows run no reset
// test.
template <bool kCard4, bool kReset, bool kMask, int kT, int kW, bool kDump,
          bool kTest, typename Buf>
__device__ __forceinline__ void window_rows(uint32_t (&st)[kW],
                                            uint32_t (&acc)[kW],
                                            const Tile<kCard4, kT, kW>& t,
                                            Buf& buf, const Sweep& a,
                                            const Fields (&g)[kW],
                                            long long& gpos, int j0, int k0,
                                            int n, uint32_t rm) {
  const int tid = threadIdx.x;
  if (n == kWin) {
#pragma unroll
    for (int r = 0; r < kWin; ++r) {
      const bool rz = kTest && ((rm >> r) & 1u);
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        uint32_t h, lm;
        st[w] = row_word<kCard4, kReset, kMask, kT, kW>(
            st[w], t, w * kT + tid, k0 + r, j0 + k0 + r, rz, g[w],
            a.init_carry, h, lm);
        acc[w] |= h;
        if (kDump)
          stage_word<kMask, kT, kW>(&buf[r][(int)(gpos & 15)], st[w], lm, w);
      }
      if (kDump) gpos += a.L + 1;
    }
  } else {
#pragma unroll 1
    for (int r = 0; r < n; ++r) {
      const bool rz = kTest && ((rm >> r) & 1u);
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        uint32_t h, lm;
        st[w] = row_word<kCard4, kReset, kMask, kT, kW>(
            st[w], t, w * kT + tid, k0 + r, j0 + k0 + r, rz, g[w],
            a.init_carry, h, lm);
        acc[w] |= h;
        if (kDump)
          stage_word<kMask, kT, kW>(&buf[r][(int)(gpos & 15)], st[w], lm, w);
      }
      if (kDump) gpos += a.L + 1;
    }
  }
}

// The hit windows of one staged tile (rows j0 .. j0 + nrows - 1), with the
// per-field live masks where kMask.
template <bool kCard4, bool kReset, bool kMask, int kT, int kW, bool kDump>
__device__ __forceinline__ void tile_rows(uint32_t (&st)[kW],
                                          const Tile<kCard4, kT, kW>& t,
                                          DumpStage<3 * kT * kW>& ds,
                                          int& win, const Sweep& a,
                                          const Fields (&g)[kW], long long d0,
                                          int j0, int nrows) {
  const int tid = threadIdx.x;
  for (int k0 = 0; k0 < nrows; k0 += kWin) {
    uint32_t saved[kW], acc[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      saved[w] = st[w];
      acc[w] = 0;
    }
    const int n = nrows - k0 < kWin ? nrows - k0 : kWin;
    // The dump: row r of the window goes to buffer `win & 1`, at the
    // alignment of its cell of diagonal d0, a.dump + gpos.
    auto& buf = ds.row[win & 1];
    long long gpos = (long long)(j0 + k0) * (a.L + 1) + d0 + a.skew;
    // The window's reset rows (bit r: row k0 + r), the same in every lane:
    // a window without a model start runs its rows without the test.
    uint32_t rm = 0;
    if (kReset)
      rm = __ballot_sync(0xffffffffu,
                         (tid & 31) < n && t.reset[k0 + (tid & 31)] != 0);
    if (kReset && rm != 0)
      window_rows<kCard4, kReset, kMask, kT, kW, kDump, true>(
          st, acc, t, buf, a, g, gpos, j0, k0, n, rm);
    else
      window_rows<kCard4, kReset, kMask, kT, kW, kDump, false>(
          st, acc, t, buf, a, g, gpos, j0, k0, n, 0);
    if (kDump) {
      // The staged rows become visible to the bulk copies (async proxy);
      // the previous window's copies, which read the other buffer, have
      // finished reading it before anyone writes there again (each issuing
      // thread has one group a window).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (tid < kWin)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncthreads();
      dump_window<3 * kT * kW, DumpStage<3 * kT * kW>::kStride, kT>(
          buf, a.dump, a.skew, a.L, d0, j0 + k0, n);
      ++win;
    }
    uint32_t any = 0;
#pragma unroll
    for (int w = 0; w < kW; ++w) any |= acc[w];
    if (__any_sync(0xffffffffu, any != 0)) {
      // Rare: replay the window from its saved state and emit its hits.
#pragma unroll 1
      for (int r = 0; r < n; ++r) {
        uint32_t h[kW], lm;
        const bool rz = kReset && ((rm >> r) & 1u);
#pragma unroll
        for (int w = 0; w < kW; ++w)
          saved[w] = row_word<kCard4, kReset, kMask, kT, kW>(
              saved[w], t, w * kT + tid, k0 + r, j0 + k0 + r, rz, g[w],
              a.init_carry, h[w], lm);
        emit<kW>(h, g, j0 + k0 + r, a);
      }
    }
  }
}

template <bool kCard4, bool kReset, bool kEdge, int kT, int kW, bool kDump>
__device__ __forceinline__ void sweep_block(Tile<kCard4, kT, kW>& t,
                                            DumpStage<3 * kT * kW>& ds,
                                            const Sweep& a, long long d0) {
  constexpr int kV = kT * kW;
  const int tid = threadIdx.x;
  const long long L = a.L;
  const int P = a.P;
  uint32_t st[kW];
  Fields g[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) {
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
  // Rows [ja, jb) where every field of the block is live and none enters
  // (the last negative diagonal, d0, enters at row -d0): an edge block runs
  // its tiles inside them unmasked.
  const long long ja = d0 < 0 ? 1 - d0 : 0;
  long long jb = L - (d0 + 3 * kV - 1);
  if (jb > P) jb = P;

  int win = 0;  // windows so far: the dump's buffer parity
  for (int j0 = (int)jlo; j0 < jhi; j0 += kRows) {
    const int nrows = (int)(jhi - j0 < kRows ? jhi - j0 : kRows);
    __syncthreads();  // the previous tile is fully consumed
    stage<kCard4, kT, kW>(t, a, d0 + j0, j0, nrows);
    __syncthreads();
    if (kEdge && !(j0 >= ja && j0 + nrows <= jb))
      tile_rows<kCard4, kReset, true, kT, kW, kDump>(st, t, ds, win, a, g, d0,
                                                     j0, nrows);
    else
      tile_rows<kCard4, kReset, false, kT, kW, kDump>(st, t, ds, win, a, g,
                                                      d0, j0, nrows);
  }
  // The dump's last bulk copies are done before the block's shared memory
  // goes.
  if (kDump && tid < kWin)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  // Each field holds its diagonal's state after its last live row.
#pragma unroll
  for (int w = 0; w < kW; ++w) {
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
template <bool kCard4, bool kReset, int kT, int kW, bool kDump>
__global__ void __launch_bounds__(kT, 1024 / kT)
ssv_word_kernel(const Sweep a) {
  constexpr int kSpan = 3 * kT * kW;  // diagonals a block
  __shared__ __align__(16) Tile<kCard4, kT, kW> t;
  // The row dump's staging (declared, and unused, without the dump: 16
  // bytes of shared memory is what it costs then).
  __shared__ __align__(16)
      uint8_t ds_raw[kDump ? sizeof(DumpStage<kSpan>) : 16];
  auto& ds = *reinterpret_cast<DumpStage<kSpan>*>(ds_raw);
  const long long d0 = (long long)blockIdx.x * kSpan - (a.P - 1);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.final_carry[0] = a.init_state[a.L - 1];
  // Interior: every field live from row 0 to row P - 1.
  const bool interior = d0 >= 0 && d0 + kSpan - 1 <= a.L - a.P;
  if (interior)
    sweep_block<kCard4, kReset, false, kT, kW, kDump>(t, ds, a, d0);
  else
    sweep_block<kCard4, kReset, true, kT, kW, kDump>(t, ds, a, d0);
}

template <int kT, int kW, bool kDump>
void launch_words(const Sweep& a, bool reset, cudaStream_t s) {
  constexpr int kSpan = 3 * kT * kW;
  const unsigned grid = (unsigned)((a.L + a.P - 1 + kSpan - 1) / kSpan);
  if (a.card == 4 && reset)
    ssv_word_kernel<true, true, kT, kW, kDump><<<grid, kT, 0, s>>>(a);
  else if (a.card == 4)
    ssv_word_kernel<true, false, kT, kW, kDump><<<grid, kT, 0, s>>>(a);
  else if (reset)
    ssv_word_kernel<false, true, kT, kW, kDump><<<grid, kT, 0, s>>>(a);
  else
    ssv_word_kernel<false, false, kT, kW, kDump><<<grid, kT, 0, s>>>(a);
}

}  // namespace

// Threads a block of an undumped sweep of (P rows x L positions) on the
// current device: wide blocks when they fill every SM four times over (their
// residency), else narrow ones.
extern "C" int hv_ssv_block_threads(long long L, int P, int* threads) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long ndiag = L + P - 1;
  *threads = ndiag / (3 * kWide * kWords) >= 4LL * sms ? kWide : kNarrow;
  return (int)cudaSuccess;
}

// `reset_rows` and `dump` may be null: no reset rows, no row dump. `dump`
// is (P, L) uint8, row-major. Card 4 runs the bit-plane match and every
// other card the table match; a non-null `dump` runs the same body in the
// dump's geometry with its stores.
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
  const int skew = (int)((uintptr_t)dump & 15);
  const Sweep a{(const uint8_t*)symbols, L, (const int8_t*)scores, P, card,
                (const int32_t*)init_state, (const int32_t*)init_carry,
                (const int32_t*)reset_rows, row_offset, pos_offset,
                (int32_t*)final_state, (int32_t*)final_carry,
                (unsigned long long*)keys, cap, (unsigned long long*)count,
                (uint8_t*)dump - skew, skew};
  const bool reset = reset_rows != nullptr;
  if (dump != nullptr) {
    launch_words<kDumpT, kDumpW, true>(a, reset, s);
    return (int)cudaGetLastError();
  }
  int threads = 0;
  err = (cudaError_t)hv_ssv_block_threads(L, P, &threads);
  if (err != cudaSuccess) return (int)err;
  if (threads == kWide)
    launch_words<kWide, kWords, false>(a, reset, s);
  else
    launch_words<kNarrow, kWords, false>(a, reset, s);
  return (int)cudaGetLastError();
}

extern "C" const char* hv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
