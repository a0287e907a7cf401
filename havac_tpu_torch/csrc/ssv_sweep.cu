// SSV sweep for NVIDIA Hopper (sm_90a): one thread per DP diagonal.
//
// Replaces the Pallas TPU kernel havac_tpu/ops/ssv_swar.py
// `_ssv_swar_kernel` / `_ssv_swar_body` (launched by `_ssv_swar_jit`) and the
// XLA record compaction around it (havac_tpu/engine/pipeline.py
// `_compact_tiles_core`, `_compact_tiles_packed16`, `fused_batch`): the
// kernel sweeps the (P rows x L positions) SSV matrix and appends every hit
// as a u64 key itself, so there is no dirty-tile drain and no compaction.
//
//   S[j][i] = S[j-1][i-1] + scores[j][sym[i]]   (0 at a reset row's input)
//   S < 0 -> 0;  S >= 256 -> 0 and hit (j, i)
//
// What bounds it on the H100: int32 ALU/LSU issue. A cell costs about eight
// warp instructions per 32 cells (symbol and score loads from shared memory,
// add, threshold test, select, ballot, loop bookkeeping); device-memory
// traffic is one byte of symbol per 256 x R cells and the hit keys.
//
// Design: the recurrence depends only on the diagonal (S[j][i] needs
// S[j-1][i-1] alone), so each thread owns one diagonal d = i - j and keeps
// its state in a register while it walks the rows. Blocks share nothing and
// need no launch order. Per tile of kRows rows the block stages the score
// rows (the same for the whole warp: a broadcast-free gather of at most
// `card` words), the reset flags, and its sliding symbol window (kThreads +
// kRows - 1 bytes) in shared memory. Hits are appended with one
// warp-aggregated atomicAdd per row (ballot + popc) to a capped key buffer;
// the count is exact past the cap so the caller can regrow once.
// Several diagonals per 32-bit word (__vadd4 / __vmaxs4), DPX and persistent
// blocks are later work.
//
// The same kernel also stands for the unpacked Pallas kernel
// havac_tpu/ops/ssv_pallas.py `_ssv_kernel` (launched by `_ssv_pallas_jit`):
// it computes the same recurrence one cell per int32, and its strip bitmaps
// are what the hit keys replace here.
//
// Row-dump variant (kDump, a non-null `dump`): the per-cell debug readout.
// It replaces the SWAR kernel's `debug_rows` output (the packed state after
// every row, havac_tpu/ops/ssv_swar.py `_ssv_swar_jit(debug_rows=True)`) and
// the row-by-row `_ssv_pallas_jit` readout of havac_tpu/testing/percell.py
// `dp_matrix_pallas`. Every active cell's post-update state is stored to
// dump[j * L + i] as one byte: a post-update state lies in [0, 255] (a sum
// >= 256 is a hit and resets to 0, a sum < 0 floors to 0), so uint8 is exact.
// Consecutive threads own consecutive diagonals, hence consecutive positions
// of a row, so a warp's 32 stores fill one 32-byte sector. What bounds it:
// the arithmetic stays at about eight warp instructions per 32 cells, and
// the dump adds one store instruction and one 32-byte sector of device-memory
// writes per 32 cells, a byte per cell where the undumped sweep writes almost
// nothing; the write traffic is what grows with the matrix. It is a debug
// path: its time is recorded in PERF.md, not tuned. Keys, the exact count,
// final_state and final_carry are the same as an undumped launch's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // diagonals per block
constexpr int kRows = 64;      // model rows staged per shared-memory tile
constexpr int kMaxCard = 32;

template <bool kReset, bool kDump>
__global__ void __launch_bounds__(kThreads)
ssv_sweep_kernel(const uint8_t* __restrict__ symbols, long long L,
                 const int8_t* __restrict__ scores, int P, int card,
                 const int32_t* __restrict__ init_state,
                 const int32_t* __restrict__ init_carry,
                 const int32_t* __restrict__ reset_rows,
                 long long row_offset, long long pos_offset,
                 int32_t* __restrict__ final_state,
                 int32_t* __restrict__ final_carry,
                 unsigned long long* __restrict__ keys,
                 unsigned long long cap,
                 unsigned long long* __restrict__ count,
                 uint8_t* __restrict__ dump) {
  // A symbol code >= card must not read outside the tile (the engine
  // validates codes on the host; the slack keeps any byte in bounds).
  __shared__ int32_t s_scores[kRows * kMaxCard + 256];
  __shared__ int32_t s_reset[kRows];
  __shared__ uint8_t s_sym[kThreads + kRows];

  const int tid = threadIdx.x;
  const unsigned lane = tid & 31;
  // Diagonals d in [-(P-1), L-1]; block b covers [d0, d0 + kThreads).
  const long long d0 = (long long)blockIdx.x * kThreads - (P - 1);
  const long long d = d0 + tid;
  const bool valid = d <= L - 1;
  // Rows this thread's diagonal occupies: [jstart, jend).
  const int jstart = d < 0 ? (int)(-d) : 0;
  const int jend = valid ? (int)(L - d < (long long)P ? L - d : P) : 0;
  int32_t state = 0;
  if (valid) state = d >= 1 ? init_state[d - 1] : init_carry[-d];
  if (blockIdx.x == 0 && tid == 0) final_carry[0] = init_state[L - 1];

  // Rows where any diagonal of this block is live.
  long long jlo = -(d0 + kThreads - 1);
  if (jlo < 0) jlo = 0;
  long long jhi = L - d0;
  if (jhi > P) jhi = P;

  for (int j0 = (int)jlo; j0 < jhi; j0 += kRows) {
    const int nrows = (int)(jhi - j0 < kRows ? jhi - j0 : kRows);
    __syncthreads();  // the previous tile is fully consumed
    const int8_t* src = scores + (long long)j0 * card;
    for (int t = tid; t < nrows * card; t += kThreads) s_scores[t] = src[t];
    if (kReset) {
      for (int t = tid; t < nrows; t += kThreads) s_reset[t] = reset_rows[j0 + t];
    }
    const long long w0 = d0 + j0;  // global position of s_sym[0]
    for (int t = tid; t < kThreads + nrows - 1; t += kThreads) {
      const long long i = w0 + t;
      s_sym[t] = (i >= 0 && i < L) ? symbols[i] : 0;
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
        if (kDump) dump[(long long)j * L + d + j] = (uint8_t)state;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (mask) {
        const int leader = __ffs(mask) - 1;
        unsigned long long base = 0;
        if ((int)lane == leader) base = atomicAdd(count, (unsigned long long)__popc(mask));
        base = __shfl_sync(0xffffffffu, base, leader);
        if (hit) {
          const unsigned long long idx = base + __popc(mask & ((1u << lane) - 1u));
          if (idx < cap) {
            keys[idx] = ((unsigned long long)(j + row_offset) << 38) |
                        (unsigned long long)(d + j + pos_offset);
          }
        }
      }
    }
  }

  // The register holds the diagonal's state after its last row.
  if (valid) {
    if (jend == P) final_state[d + P - 1] = state;         // bottom edge
    if (d + jend - 1 == L - 1) final_carry[jend] = state;  // right edge
  }
}

template <bool kReset, bool kDump, typename... Args>
void launch(unsigned grid, cudaStream_t s, Args... args) {
  ssv_sweep_kernel<kReset, kDump><<<grid, kThreads, 0, s>>>(args...);
}

}  // namespace

// `reset_rows` and `dump` may be null: no reset rows, no row dump. `dump`
// is (P, L) uint8, row-major.
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
  const long long ndiag = L + P - 1;
  const unsigned grid = (unsigned)((ndiag + kThreads - 1) / kThreads);
  auto* sym = (const uint8_t*)symbols;
  auto* sc = (const int8_t*)scores;
  auto* ist = (const int32_t*)init_state;
  auto* icr = (const int32_t*)init_carry;
  auto* rst = (const int32_t*)reset_rows;
  auto* fst = (int32_t*)final_state;
  auto* fcr = (int32_t*)final_carry;
  auto* k = (unsigned long long*)keys;
  auto* c = (unsigned long long*)count;
  auto* dmp = (uint8_t*)dump;
  if (rst != nullptr && dmp != nullptr) {
    launch<true, true>(grid, s, sym, L, sc, P, card, ist, icr, rst, row_offset,
                       pos_offset, fst, fcr, k, cap, c, dmp);
  } else if (rst != nullptr) {
    launch<true, false>(grid, s, sym, L, sc, P, card, ist, icr, rst, row_offset,
                        pos_offset, fst, fcr, k, cap, c, dmp);
  } else if (dmp != nullptr) {
    launch<false, true>(grid, s, sym, L, sc, P, card, ist, icr, rst, row_offset,
                        pos_offset, fst, fcr, k, cap, c, dmp);
  } else {
    launch<false, false>(grid, s, sym, L, sc, P, card, ist, icr, rst, row_offset,
                         pos_offset, fst, fcr, k, cap, c, dmp);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
