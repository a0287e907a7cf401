// Op-mix roofline probes for NVIDIA Hopper (sm_90a): what the SM's integer
// pipes sustain on the exact per-row op sequence of the SWAR SSV update.
//
// Five kernels, the counterparts of the Pallas TPU kernels of
// tools/roofline.py `make_variant`:
//
//   op_mix_kernel<V>      replaces `kernel` (tools/roofline.py:241, launched
//                         at :293): the eight int32 variants (current, perrow,
//                         leanhit, nomatch, noroll, addonly, mulcost,
//                         andmatch) over a (WS, 128) word buffer, K rows per
//                         rep, a flush every 10 rows, out = state+bits+acc.
//   add_chain_kernel<B>   replaces `kernel_add` (:485, launched at :500):
//                         the (s + i) ^ s chain on int8 (B = 1, add8) or
//                         int16 (B = 2, add16) elements.
//   narrow_mix_kernel<B>  replaces `kernel8` (:520, launched at :569): the
//                         full row update in int8 / int16 (4:1 select match,
//                         wrapping add, carry-out logic), a flush every 8
//                         rows.
//   strip_mix_kernel      replaces `kernel_strip` (:323, launched at :373):
//                         stripmatch, `current` with the strip's match
//                         planes built a chunk of rows ahead into a
//                         per-thread ring in shared memory.
//   mxu_mix_kernel<B>     replaces `kernel_mxu` (:409, launched at :464):
//                         mxumatch (bf16) / mxumatch8 (int8), the match
//                         words from tensor-core products (mma.sync),
//                         repacked in registers.
//
// Each block computes one instance, equal word for word to the TPU kernel's
// output on the same inputs; `copies` blocks compute `copies` identical
// instances so that the grid fills the card (the int8 narrow kernels instead
// spread the copies' lanes over 256-thread blocks, 48 lanes a thread: see
// kFieldLanes). `reps` is a runtime argument,
// so one build serves the differential timing (t(hi) - t(lo)) / (hi - lo).
//
// What bounds them on the H100: integer issue. Per SM and clock the four
// schedulers issue 4 warp instructions (128 lanes); the INT32 pipe takes 64
// lanes (logic ops, shifts, 3-input adds), IMAD runs on the FMA pipe. There
// is no device-memory traffic inside the loop: the planes and the state live
// in registers, the scores (16 x K x 4 words) in shared memory. The int32
// variants also pay for the roll: word p of row k needs word p-1 of row
// k-1, a flat one-word shift of the whole (WS x 128) buffer every row.
//
// Design: a thread owns kWords = 16 consecutive words, so the roll is a
// register rename inside the thread (words are updated from the last to the
// first), one __shfl_up_sync across the warp, and one shared-memory word
// per warp across warps, double-buffered behind one __syncthreads a row.
// Thread 0 builds the seam stitch (state[N-1] << 10) | cin from the last
// warp's word; `perrow` also keeps the TPU kernel's scalar side: the last
// thread writes state[N-1] >> 20 into a two-slot carry queue in shared
// memory (seeded as the TPU kernel finds it: 7 at k = 0, INT32_MIN
// elsewhere) that thread 0 reads as cin in the next rep. WS is capped at 64
// (512 threads, six 16-word arrays in registers); the TPU tool's WS = 336
// buffer (VMEM-sized) would not fit one SM and is not shrunk silently: the
// wrapper refuses it. The narrow kernels have no roll, so their lanes are
// independent and their layout is free: int8 (B = 1) keeps three lanes in
// the 10-bit fields of an int32, as `current` does, so that carries land in
// guard bits and the adds and multiplies run as IMADs on the FMA pipe;
// int16 (B = 2) keeps two lanes packed a word and adds them with Hopper's
// 16x2 add (add.u16x2, SASS VIADD.16x2), exact per halfword (see
// add_chain_kernel and narrow_mix_kernel).
//
// Anti-hoisting (the TPU tool's lesson, which nvcc shares): scores are read
// at strip r % 16 every row, the hit bitmap folds into `acc` at every flush,
// the add chains are nonlinear ((s + i) ^ s), and `reps` and K are read at
// run time. Signed wraparound is done in unsigned arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWords = 16;         // 32-bit words per thread
constexpr int kMaxThreads = 512;   // WS <= 64: 64 * 128 / kWords
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kNS = 16;            // score strips; rep r uses strip r % 16
constexpr int kMaxRows = 128;      // K
constexpr int32_t kFM = 0x00100401;  // bit 0 of each 10-bit field
constexpr int kFlush = 10;         // rows between flushes, int32 variants
constexpr int kNarrowFlush = 8;    // rows between flushes, narrow mix

enum Variant {
  kCurrent, kPerrow, kLeanhit, kNomatch, kNoroll, kAddonly, kMulcost,
  kAndmatch, kNumVariants
};

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t shl(int32_t a, int s) {
  return (int32_t)((uint32_t)a << s);
}

__device__ __forceinline__ void load16(const int32_t* p, int32_t (&v)[kWords]) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int j = 0; j < kWords / 4; ++j) {
    const int4 x = q[j];
    v[4 * j] = x.x; v[4 * j + 1] = x.y; v[4 * j + 2] = x.z; v[4 * j + 3] = x.w;
  }
}

__device__ __forceinline__ void store16(int32_t* p, const int32_t (&v)[kWords]) {
  int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int j = 0; j < kWords / 4; ++j)
    q[j] = make_int4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}

__host__ __device__ constexpr bool rolls(int v) {
  return v != kNoroll && v != kAddonly && v != kMulcost;
}

// The roll of `stripmatch` and `mxumatch*`: the word left of this thread's
// first word in the previous row (the seam stitch (state[N-1] << 10) | 7
// for thread 0), as op_mix_kernel computes it inline. Each call is one row:
// one shared word per warp, double-buffered in `edge` (2 * kMaxWarps
// words) behind one __syncthreads. (op_mix_kernel keeps its own copy:
// sharing these helpers changed its compiled row loop and its measured
// rate, the ceiling the sweep kernel is held against.)
__device__ __forceinline__ int32_t left_word(int32_t last, int32_t* edge,
                                             int& buf) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t* e = edge + buf * kMaxWarps;
  if (lane == 31) e[warp] = last;
  __syncthreads();
  int32_t left = __shfl_up_sync(0xffffffffu, last, 1);
  if (lane == 0)
    left = warp > 0 ? e[warp - 1] : (shl(e[(blockDim.x >> 5) - 1], 10) | 7);
  buf ^= 1;
  return left;
}

// `current`'s row update of 16 words given their match words: shift by one
// word, biased add, bit-9 hit into `bits`, keep mask.
__device__ __forceinline__ void row_update(int32_t (&st)[kWords],
                                           int32_t (&bits)[kWords],
                                           const int32_t (&match)[kWords],
                                           int32_t left) {
#pragma unroll
  for (int j = kWords - 1; j >= 0; --j) {
    const int32_t w = add(j > 0 ? st[j - 1] : left, match[j]);
    const int32_t t9 = w >> 9;
    bits[j] = shl(bits[j], 1) | (t9 & kFM);
    const int32_t kmask = (w >> 8) & ~t9 & kFM;
    st[j] = w & mul(kmask, 255);
  }
}

__device__ __forceinline__ void flush(int32_t (&bits)[kWords],
                                      int32_t (&acc)[kWords]) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    acc[j] ^= bits[j];  // keep the hit ops live
    bits[j] = 0;
  }
}

// One instance per block: blockDim.x = WS * 8 threads, kWords words each.
template <int V>
__global__ void __launch_bounds__(kMaxThreads, 1)
op_mix_kernel(const int32_t* __restrict__ scores,
              const int32_t* __restrict__ i1g, const int32_t* __restrict__ i2g,
              const int32_t* __restrict__ i3g, int K, int reps,
              int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_scores = smem;                    // kNS * K * 4
  int32_t* s_edge = s_scores + kNS * K * 4;    // 2 * kMaxWarps
  int32_t* s_queue = s_edge + 2 * kMaxWarps;   // 2 * (K + 1), perrow
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  for (int x = tid; x < kNS * K * 4; x += nthreads) s_scores[x] = scores[x];
  for (int x = tid; x < 2 * (K + 1); x += nthreads)
    s_queue[x] = (x == 0 || x == K + 1) ? 7 : INT32_MIN;

  const int base = tid * kWords;
  int32_t st[kWords], bits[kWords], acc[kWords];
  int32_t a1[kWords], a2[kWords], a3[kWords];
  load16(i1g + base, a1);
  load16(i2g + base, a2);
  load16(i3g + base, a3);
  int32_t inz8[kWords];  // andmatch: 256 per nonzero field (row-invariant)
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    st[j] = a1[j];
    bits[j] = 0;
    acc[j] = 0;
    inz8[j] = (a1[j] | a2[j] | a3[j]) & (kFM * 256);
  }
  __syncthreads();

  int buf = 0;
  for (int r = 0; r < reps; ++r) {
    const int32_t* srow = s_scores + (r % kNS) * K * 4;
    const int rslot = r & 1;
    int f = 0;
    for (int k = 0; k < K; ++k) {
      const int4 m = *reinterpret_cast<const int4*>(srow + 4 * k);
      // Per-row scalars of the match construction.
      const int32_t c = mul(m.x, kFM);
      int32_t d1 = sub(m.y, m.x), d2 = sub(m.z, m.x), d3 = sub(m.w, m.x);
      if (V == kAndmatch) {
        d1 = mul(add(d1, 256) & 0x3FF, kFM);
        d2 = mul(add(d2, 256) & 0x3FF, kFM);
        d3 = mul(add(d3, 256) & 0x3FF, kFM);
      }
      int32_t left = 0;  // the word left of this thread's first, last row
      if constexpr (rolls(V)) {
        int32_t* edge = s_edge + buf * kMaxWarps;
        if (lane == 31) edge[warp] = st[kWords - 1];
        __syncthreads();
        left = __shfl_up_sync(0xffffffffu, st[kWords - 1], 1);
        if (lane == 0) {
          if (warp > 0) {
            left = edge[warp - 1];
          } else {
            const int32_t cin =
                V == kPerrow ? s_queue[rslot * (K + 1) + k] : 7;
            left = shl(edge[nwarps - 1], 10) | cin;  // the seam stitch
          }
        }
        buf ^= 1;
      }
#pragma unroll
      for (int j = kWords - 1; j >= 0; --j) {
        if (V == kAddonly) {
          st[j] = add(st[j], a1[j]) ^ st[j];
          continue;
        }
        if (V == kMulcost) {
          st[j] = mul(st[j], a1[j]) ^ st[j];
          continue;
        }
        const int32_t shifted = !rolls(V) ? st[j] : (j > 0 ? st[j - 1] : left);
        int32_t match;
        if (V == kNomatch) {
          match = c;
        } else if (V == kAndmatch) {
          match = sub(add(add(c, a1[j] & d1), add(a2[j] & d2, a3[j] & d3)),
                      inz8[j]);
        } else {
          match = add(add(c, mul(a1[j], d1)),
                      add(mul(a2[j], d2), mul(a3[j], d3)));
        }
        const int32_t w = add(shifted, match);
        if (V == kLeanhit) {
          const int32_t b9 = w & (kFM << 9);
          bits[j] = (bits[j] >> 1) | b9;  // hit row r lands at field bit r
          const int32_t keep = (w & (kFM << 8)) & ~(b9 >> 1);
          st[j] = w & sub(keep, keep >> 8);
        } else {
          const int32_t t9 = w >> 9;
          bits[j] = shl(bits[j], 1) | (t9 & kFM);
          const int32_t kmask = (w >> 8) & ~t9 & kFM;
          st[j] = w & mul(kmask, 255);
        }
      }
      if (V == kPerrow && tid == nthreads - 1)  // the per-row scalar side
        s_queue[(rslot ^ 1) * (K + 1) + k + 1] = st[kWords - 1] >> 20;
      if (++f == kFlush) {
        f = 0;
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          acc[j] ^= bits[j];  // keep the hit ops live
          bits[j] = 0;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) st[j] = add(add(st[j], bits[j]), acc[j]);
  store16(out + (long long)blockIdx.x * nthreads * kWords + base, st);
}

// ---- The narrow kernels: add8 / add16 (add_chain_kernel<B>) and int8mix /
// int16mix (narrow_mix_kernel<B>).
//
// What bounds them on the H100: integer issue, and within it the INT32 pipe,
// the only one that runs logic (LOP3), right shifts and byte permutes; adds,
// multiplies and left shifts may issue as IMADs on the FMA pipe. Keeping 4
// int8 or 2 int16 lanes packed a word and emulating each per-lane add with
// masks spends nearly all of a row on the INT32 pipe while the FMA pipe
// idles.
//
// int8 (B = 1): three lanes in the 10-bit fields of an int32 (kFM, the
// layout of `current` and of the sweep kernel), field j of a thread's field
// word w holding its lane 16 j + w. A lane's state and `bits` stay below 256
// and a row's sum below 1024, so carries land in the guard bits and the loop
// needs no lane mask: the add chain is one add and one LOP3 a field word,
// ((s + i) ^ s) & 0xFF. The row update is `current`'s biased update without
// the roll, w = u + m + 256 per field, m the truncated score of the lane's
// symbol, hit iff bit 9, keep iff bit 8 and not bit 9: kernel8's row exactly
// (its state is 0 unless 0 <= u + m <= 255, its hit is u + m >= 256, u the
// state read unsigned). The planes' priority select collapses once a thread
// into one-hot fields e1..e3 of the winning symbol, so the match is
// `current`'s three IMADs c + e1 d1 + e2 d2 + e3 d3 with per-row scalars,
// which a block builds once from the scores into shared memory (one int4
// a row, read at strip r % 16 as the scores were).
// `bits` doubles inside its field (an IMAD): kernel8 keeps it mod 256, so
// at the start of a rep only its low 8 - K bits can still reach the output
// (none when K >= 8: the rep's first flush comes 8 rows later) and the rest
// are dropped there, once a rep. The lanes are independent (no roll), so a
// thread owns 48 of them (16 field words, 12 output words) of the copies'
// flat buffer, read at their offset modulo one instance; they are packed
// into fields before the rep loop and out of them after it.
//
// int16 (B = 2): a lane with its bias and carry would need 18 bits, one lane
// a word, so two lanes stay packed a word, 16 words a thread as op_mix. The
// add is Hopper's 16x2 add (add.u16x2, one VIADD.16x2, wrapping per
// halfword; a card test checks it on every pair); the match is the same
// three IMADs with one-hot LSBs of each lane (exactly one term is non-zero a
// lane, so nothing carries across lanes); the reset is the sign bits of one
// 3-input LOP3 of (state, match, sum), the hit one more LOP3 of that and the
// match. `bits` stays below 2^15 between flushes (at most 15 rows when
// K >= 8) and is masked once a rep otherwise, so it doubles without a lane
// mask (one LEA.HI with the hit's shift).
//
// Anti-hoisting: the rows' scalars are read at strip r % 16 every row, and
// each iteration of the row loop is one row (unroll 1).

constexpr int kFieldLanes = 48;                // int8 lanes a thread (B = 1)
constexpr int kFieldWords = kFieldLanes / 3;   // its field words
constexpr int kFieldThreads = 256;             // block of the B = 1 kernels
constexpr uint32_t kFieldBytes = 0xFFu * kFM;  // the low byte of each field
constexpr uint32_t kH16 = 0x80008000u, kLsb16 = 0x00010001u;

__device__ __forceinline__ uint32_t add16x2(uint32_t a, uint32_t b) {
  uint32_t r;  // per halfword, wrapping (sm_90)
  asm("add.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t sign_mask16(uint32_t x) {
  uint32_t r;  // all ones in every halfword whose sign bit is set
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(x), "r"(0xBB99u));
  return r;
}

__device__ __forceinline__ uint32_t nonzero_mask16(uint32_t x) {
  constexpr uint32_t L = ~kH16;
  return sign_mask16((((x & L) + L) | x) & kH16);
}

// The B = 1 kernels' thread: bytes [g, g + 48) of the (copies x n)-byte
// output, where n = WS * 512 is one instance; the input is one instance,
// read at (g + 16 q) mod n. Threads past the end return at once.
struct FieldSpan {
  long long n, total, g;
  __device__ FieldSpan(int ws, int copies)
      : n(512LL * ws), total(512LL * ws * copies),
        g(kFieldLanes * ((long long)blockIdx.x * blockDim.x + threadIdx.x)) {}
  __device__ bool live() const { return g < total; }
};

__device__ __forceinline__ void load_fields(const int32_t* in,
                                            const FieldSpan& sp,
                                            uint32_t (&f)[kFieldWords]) {
  uint32_t x[12];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    int4 v = make_int4(0, 0, 0, 0);
    if (sp.g + 16 * q < sp.total)
      v = reinterpret_cast<const int4*>(in)[(sp.g + 16 * q) % sp.n / 16];
    x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int w = 0; w < kFieldWords; ++w) {  // lane 16 j + w: byte w % 4 of
    uint32_t v = 0;                        // input word 4 j + w / 4
#pragma unroll
    for (int j = 0; j < 3; ++j)
      v |= ((x[4 * j + w / 4] >> (8 * (w % 4))) & 0xFFu) << (10 * j);
    f[w] = v;
  }
}

__device__ __forceinline__ void store_fields(int32_t* out,
                                             const FieldSpan& sp,
                                             const uint32_t (&f)[kFieldWords]) {
  uint32_t x[12];
#pragma unroll
  for (int w = 0; w < 12; ++w) {  // lane 4 w + b = 16 (w / 4) + 4 (w % 4) + b
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      v |= ((f[4 * (w % 4) + b] >> (10 * (w / 4))) & 0xFFu) << (8 * b);
    x[w] = v;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if (sp.g + 16 * q < sp.total)
      reinterpret_cast<int4*>(out)[(sp.g + 16 * q) / 16] =
          make_int4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// x & ~m & kH16 as one LOP3 (left to itself, nvcc takes the hit from state,
// match and sum, which needs a second LOP3 for the mask).
__device__ __forceinline__ uint32_t hit_bits16(uint32_t x, uint32_t m) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x20;" : "=r"(r) : "r"(x), "r"(m),
      "r"(kH16));
  return r;
}

// A row's scalars from its four int32 scores, as the match takes them:
// {c, d1, d2, d3} with d_s = m_s - m0 and c = (m0 + 256) * kFM (B = 1) or
// m0 * kLsb16 (B = 2), m the scores truncated to int8 / int16 (astype).
template <int B>
__device__ __forceinline__ int4 row_scalars(const int32_t* m) {
  if constexpr (B == 1) {
    const int32_t t0 = (int8_t)m[0];
    return make_int4((t0 + 256) * kFM, (int8_t)m[1] - t0, (int8_t)m[2] - t0,
                     (int8_t)m[3] - t0);
  } else {
    const uint32_t v0 = (uint32_t)m[0] & 0xFFFFu;
    return make_int4((int32_t)(v0 * kLsb16),
                     (int32_t)(((uint32_t)m[1] & 0xFFFFu) - v0),
                     (int32_t)(((uint32_t)m[2] & 0xFFFFu) - v0),
                     (int32_t)(((uint32_t)m[3] & 0xFFFFu) - v0));
  }
}

// Bit 0 of every field whose byte is non-zero.
__device__ __forceinline__ uint32_t nonzero_fields(uint32_t f) {
  return ((f + kFieldBytes) >> 8) & kFM;
}

template <int B>
__global__ void __launch_bounds__(kMaxThreads, 1)
add_chain_kernel(const int32_t* __restrict__ i1g, int ws, int K, int reps,
                 int copies, int32_t* __restrict__ out) {
  if constexpr (B == 1) {
    const FieldSpan sp(ws, copies);
    if (!sp.live()) return;
    uint32_t s[kFieldWords], a[kFieldWords];
    load_fields(i1g, sp, a);
#pragma unroll
    for (int j = 0; j < kFieldWords; ++j) s[j] = a[j];
    for (int r = 0; r < reps; ++r)
#pragma unroll 1
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < kFieldWords; ++j)
          s[j] = ((s[j] + a[j]) ^ s[j]) & kFieldBytes;
    store_fields(out, sp, s);
  } else {
    const int base = threadIdx.x * kWords;
    int32_t s[kWords], a[kWords];
    load16(i1g + base, a);
#pragma unroll
    for (int j = 0; j < kWords; ++j) s[j] = a[j];
    for (int r = 0; r < reps; ++r)
#pragma unroll 1
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < kWords; ++j)
          s[j] = (int32_t)(add16x2((uint32_t)s[j], (uint32_t)a[j]) ^
                           (uint32_t)s[j]);
    store16(out + (long long)blockIdx.x * blockDim.x * kWords + base, s);
  }
}

template <int B>
__global__ void __launch_bounds__(kMaxThreads, 1)
narrow_mix_kernel(const int32_t* __restrict__ scores,
                  const int32_t* __restrict__ i1g,
                  const int32_t* __restrict__ i2g,
                  const int32_t* __restrict__ i3g, int ws, int K, int reps,
                  int copies, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  int4* s_rows = reinterpret_cast<int4*>(smem);  // (kNS, K) row scalars
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int x = tid; x < kNS * K; x += nthreads)
    s_rows[x] = row_scalars<B>(scores + 4 * x);
  __syncthreads();
  if constexpr (B == 1) {
    const FieldSpan sp(ws, copies);
    if (!sp.live()) return;
    uint32_t st[kFieldWords], bits[kFieldWords], acc[kFieldWords];
    uint32_t e1[kFieldWords], e2[kFieldWords], e3[kFieldWords];
    load_fields(i3g, sp, e3);
    load_fields(i2g, sp, e2);
    load_fields(i1g, sp, e1);
#pragma unroll
    for (int j = 0; j < kFieldWords; ++j) {  // one-hot of the winning symbol
      e3[j] = nonzero_fields(e3[j]);
      e2[j] = nonzero_fields(e2[j]) & ~e3[j];
      st[j] = nonzero_fields(e1[j]);  // where(i1, 1, 0)
      e1[j] = st[j] & ~(e2[j] | e3[j]);
      bits[j] = 0;
      acc[j] = 0;
    }
    const uint32_t keep = K < kNarrowFlush ? (0xFFu >> K) * kFM : 0u;
    for (int r = 0; r < reps; ++r) {
      const int4* srow = s_rows + (r % kNS) * K;
#pragma unroll
      for (int j = 0; j < kFieldWords; ++j) bits[j] &= keep;
      int f = 0;
#pragma unroll 1
      for (int k = 0; k < K; ++k) {
        const int4 m = srow[k];
        const uint32_t c = m.x, d1 = m.y, d2 = m.z, d3 = m.w;
#pragma unroll
        for (int j = 0; j < kFieldWords; ++j) {
          const uint32_t w = st[j] + c + e1[j] * d1 + e2[j] * d2 + e3[j] * d3;
          const uint32_t t9 = w >> 9;
          bits[j] = bits[j] * 2 + (t9 & kFM);
          st[j] = w & ((((w >> 8) & ~t9) & kFM) * 255);
        }
        if (++f == kNarrowFlush) {
          f = 0;
#pragma unroll
          for (int j = 0; j < kFieldWords; ++j) {
            acc[j] ^= bits[j];
            bits[j] = 0;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kFieldWords; ++j) st[j] += bits[j] + acc[j];
    store_fields(out, sp, st);
  } else {
    const int base = tid * kWords;
    int32_t in[kWords];
    uint32_t st[kWords], bits[kWords], acc[kWords];
    uint32_t e1[kWords], e2[kWords], e3[kWords];
    load16(i3g + base, in);
#pragma unroll
    for (int j = 0; j < kWords; ++j) e3[j] = nonzero_mask16((uint32_t)in[j]);
    load16(i2g + base, in);
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      e2[j] = nonzero_mask16((uint32_t)in[j]) & ~e3[j];
    load16(i1g + base, in);
#pragma unroll
    for (int j = 0; j < kWords; ++j) {  // one-hot LSBs of the winning symbol
      const uint32_t n1 = nonzero_mask16((uint32_t)in[j]);
      e1[j] = n1 & ~(e2[j] | e3[j]) & kLsb16;
      e2[j] &= kLsb16;
      e3[j] &= kLsb16;
      st[j] = n1 & kLsb16;  // where(i1, 1, 0)
      bits[j] = 0;
      acc[j] = 0;
    }
    const uint32_t keep =
        K < kNarrowFlush ? (0xFFFFu >> K) * kLsb16 : 0xFFFFFFFFu;
    for (int r = 0; r < reps; ++r) {
      const int4* srow = s_rows + (r % kNS) * K;
#pragma unroll
      for (int j = 0; j < kWords; ++j) bits[j] &= keep;
      int f = 0;
#pragma unroll 1
      for (int k = 0; k < K; ++k) {
        const int4 m = srow[k];
        const uint32_t c = m.x, d1 = m.y, d2 = m.z, d3 = m.w;
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          const uint32_t mt = c + e1[j] * d1 + e2[j] * d2 + e3[j] * d3;
          const uint32_t s = add16x2(st[j], mt);
          // Sign bits: carry-out ^ match sign = reset; & !match sign = hit.
          const uint32_t x = ((st[j] & mt) | ((st[j] | mt) & ~s)) ^ mt;
          bits[j] = bits[j] * 2 + (hit_bits16(x, mt) >> 15);
          st[j] = s & ~sign_mask16(x);
        }
        if (++f == kNarrowFlush) {
          f = 0;
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            acc[j] ^= bits[j];
            bits[j] = 0;
          }
        }
      }
    }
    int32_t res[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      res[j] = (int32_t)add16x2(add16x2(st[j], bits[j]), acc[j]);
    store16(out + (long long)blockIdx.x * nthreads * kWords + base, res);
  }
}

// stripmatch: replaces `kernel_strip` (tools/roofline.py:323, launched at
// :373): the strip's match planes (`current`'s match construction) are
// built into scratch, and `current`'s row update reads its match back as
// one load. Bound: issue, plus shared-memory bandwidth (one 16-byte store
// and one load per 4 words and row, 8 B a word and row).
//
// Design: nothing needs all K planes at once (the TPU kernel held them in
// VMEM; in a block's shared memory they would allow WS <= 12 at K = 30, one
// 3-warp block an SM), because a thread stores and loads only its own
// words. So each thread keeps a ring of kStripAhead planes and builds each
// row's plane kStripAhead rows before the row reads it, over the rows of
// all reps in order (ahead of a rep's last row come the next rep's, at its
// strip). The ring is the warp's, [slot][quad][lane] as int4: a warp's
// 16-byte stores and loads are conflict-free and a quad is an immediate
// offset from one address (a [slot][quad][thread] ring spent four address
// registers and spilled). It takes kStripAhead * 64 B a thread at any K,
// so WS 64 runs one 512-thread block an SM (16 warps, the register limit
// `current` runs at) and WS 12 five. A row loads its plane before the
// roll's barrier (`left_word`, one barrier a row, what `current` pays),
// then builds the next plane into the slot it emptied and runs its update
// in one basic block: the build's 3 IMADs a word (FMA pipe) interleave
// with the update's shifts and LOP3s (INT32 pipe), as `current`'s match
// does. (Built a chunk of rows at a time apart from the rows, the IMAD-only
// build and the LOP3-heavy rows each ran on one pipe: 1.47x `current`'s
// time; a 2-slot ring whose row loads the next plane at its end ran 1.09x
// this one's, PERF.md.) The rows' scalars {c,
// d1, d2, d3} are built once a block into shared memory, as the narrow
// kernels' are; the last kStripAhead builds fill slots no row reads.
constexpr int kStripAhead = 1;  // ring slots a thread

__device__ __forceinline__ void build_plane(int4* slot, int4 m,
                                            const int32_t (&a1)[kWords],
                                            const int32_t (&a2)[kWords],
                                            const int32_t (&a3)[kWords]) {
#pragma unroll
  for (int q = 0; q < kWords / 4; ++q) {
    int32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * q + e;
      w[e] = add(add(m.x, mul(a1[j], m.y)),
                 add(mul(a2[j], m.z), mul(a3[j], m.w)));
    }
    slot[q * 32] = make_int4(w[0], w[1], w[2], w[3]);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
strip_mix_kernel(const int32_t* __restrict__ scores,
                 const int32_t* __restrict__ i1g,
                 const int32_t* __restrict__ i2g,
                 const int32_t* __restrict__ i3g, int K, int reps,
                 int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  int4* s_rows = reinterpret_cast<int4*>(smem);  // (kNS, K) scalars
  int32_t* s_edge = smem + kNS * K * 4;          // 2 * kMaxWarps
  int4* s_ring = reinterpret_cast<int4*>(s_edge + 2 * kMaxWarps);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int x = tid; x < kNS * K; x += nthreads) {
    const int32_t* m = scores + 4 * x;
    s_rows[x] = make_int4(mul(m[0], kFM), sub(m[1], m[0]), sub(m[2], m[0]),
                          sub(m[3], m[0]));
  }

  const int base = tid * kWords;
  int32_t st[kWords], bits[kWords], acc[kWords], match[kWords];
  int32_t a1[kWords], a2[kWords], a3[kWords];
  load16(i1g + base, a1);
  load16(i2g + base, a2);
  load16(i3g + base, a3);
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    st[j] = a1[j];
    bits[j] = 0;
    acc[j] = 0;
  }
  __syncthreads();

  // Row k of rep r takes the scalars at (r % kNS) * K + k; `ahead` walks
  // them kStripAhead rows before the run, across reps.
  const int4* const rows_end = s_rows + kNS * K;
  const int4* ahead = s_rows;
  // This warp's ring, [slot][quad][lane]: quad q of slot s at 32 (4 s + q).
  int4* const ring =
      s_ring + (tid >> 5) * (kStripAhead * 4 * 32) + (tid & 31);
  int4* const ring_end = ring + 4 * 32 * kStripAhead;
  for (int4* slot = ring; slot != ring_end; slot += 4 * 32) {
    build_plane(slot, *ahead, a1, a2, a3);
    if (++ahead == rows_end) ahead = s_rows;
  }
  int4* slot = ring;
  int buf = 0;
  for (int r = 0; r < reps; ++r) {
    int f = 0;
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int q = 0; q < kWords / 4; ++q) {
        const int4 v = slot[q * 32];
        match[4 * q] = v.x; match[4 * q + 1] = v.y;
        match[4 * q + 2] = v.z; match[4 * q + 3] = v.w;
      }
      const int32_t left = left_word(st[kWords - 1], s_edge, buf);
      build_plane(slot, *ahead, a1, a2, a3);  // kStripAhead rows on
      if (++ahead == rows_end) ahead = s_rows;
      slot += 4 * 32;
      if (slot == ring_end) slot = ring;
      row_update(st, bits, match, left);
      if (++f == kFlush) {
        f = 0;
        flush(bits, acc);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) st[j] = add(add(st[j], bits[j]), acc[j]);
  store16(out + (long long)blockIdx.x * nthreads * kWords + base, st);
}

// One tensor-core product: D (16 x 8) = A (16 x K) * B (K x 8) + C, A
// row-major, B column-major, fragments as PTX's mma.sync lays them out. Only
// a0 (A row g), a1 (A row g + 8) and b0 (B column g) are non-zero here: the
// K columns 0-3 lie in lanes q = 0-1 (bf16) or q = 0 (s8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b0, float c) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(0u), "r"(b0), "r"(0u), "f"(c),
        "f"(c), "f"(c), "f"(c));
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(0u), "r"(b0), "r"(0u), "r"(0),
        "r"(0), "r"(0), "r"(0));
}

// PTX shl.b32: a shift amount above 31 (a negative one, read unsigned)
// gives 0, which C++'s << leaves undefined.
__device__ __forceinline__ uint32_t shl_clamp(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

constexpr int kGroup = 8;          // rows a product: the mma's N
constexpr int kQuadStride = 132;   // ring words from a row's quad to the next
constexpr int kRowStride = 532;    // ring words from a row to the next
constexpr int kRing = kGroup * kRowStride;  // ring words a warp
// f32 1.5 * 2^23: x + kMagic has the bits kMagicBits + x for every integer
// |x| < 2^22, so the f32 accumulator started at kMagic holds the product's
// integer in its low bits, and kMagicBits << 10 and << 20 vanish mod 2^32.
constexpr float kMagic = 12582912.0f;
constexpr uint32_t kMagicBits = 0x4B400000u;

// mxumatch / mxumatch8: replaces `kernel_mxu` (tools/roofline.py:409,
// launched at :464): per flush of 10 rows, the match words are the product
// (10 x 4 scores) x (4 x 3*WS*128 one-hot), repacked as m0 + (m1 << 10) +
// (m2 << 20) + 256 * FMASK from its three WS-row thirds, then `current`'s
// row update. Bound: issue (the repack and the row); the products are 3/80
// of an mma per word and row.
//
// Design: the product never leaves registers unpacked. Rows are taken 8 at
// a time (a product's rows do not depend on the flush: the flush only
// empties `bits`), and the product is taken transposed, D^T = one-hot^T x
// scores^T, with mma.sync (bf16 m16n8k16 with an f32 accumulator started
// at kMagic, or s8 m16n8k32 with an s32 one): M = one thread's 16 words, N
// = 8 rows, K = the 4 symbols padded with zeros, so every output of the
// mma is used. A warp computes only its own threads' words: for tile t
// (thread t's words) three products, one per third, so the lane that holds
// D(word, row) of one third holds it of the other two and repacks the
// match word in registers (two shifted adds; bf16 needs no conversion, its
// magic offset is folded into the bias, which the row's add takes). Only
// the packed word goes to shared memory, into a ring private to the warp
// ([row][quad][thread] int4 with padded strides, so the lanes' stores and
// the row loop's 16-byte loads are conflict-free), handed over with
// __syncwarp, never a block barrier. The A fragments come from the one-hot
// compressed once a block to one byte a column (the code's shift in a
// fragment: shl(1, 8 code) in lane q = 0 for s8, shl(0x3F80, 16 code - 32 q)
// for bf16), the B fragment is one 32-bit load of the row's scores. The
// ring takes 17,024 B a warp: WS <= 48 at K = 30 (12 warps, one block an
// SM), and 8 warps an SM or more at every WS the tool runs. The input
// one-hot must have one 1 a column, as `make_inputs` builds it.
template <int B>  // bytes per input element: 1 = int8, 2 = bf16
__global__ void __launch_bounds__(kMaxThreads, 1)
mxu_mix_kernel(const uint8_t* __restrict__ scores,
               const uint8_t* __restrict__ onehot, int K, int reps,
               int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int words = nthreads * kWords;       // WS * 128
  const int ncols = 3 * words;
  const int sc_bytes = kNS * K * 4 * B;      // (NS * K / 10, 10, 4)
  int32_t* s_edge = smem;                    // 2 * kMaxWarps
  int32_t* s_ring = s_edge + 2 * kMaxWarps;  // nwarps * kRing
  uint8_t* s_sc = reinterpret_cast<uint8_t*>(s_ring + nwarps * kRing);
  uint8_t* s_code = s_sc + (sc_bytes + 15) / 16 * 16;  // [third][word]
  for (int x = tid; x < sc_bytes; x += nthreads) s_sc[x] = scores[x];
  for (int col = tid; col < ncols; col += nthreads) {
    int code = 0;
#pragma unroll
    for (int a = 1; a < 4; ++a) {
      bool on = false;
#pragma unroll
      for (int b = 0; b < B; ++b)
        on |= onehot[((long long)a * ncols + col) * B + b] != 0;
      if (on) code = a;
    }
    s_code[col] = (uint8_t)(code * 8 * B);
  }
  __syncthreads();

  int32_t st[kWords], bits[kWords], acc[kWords], match[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {  // the TPU kernel starts from zeros
    st[j] = 0;
    bits[j] = 0;
    acc[j] = 0;
  }
  const int g = lane >> 2, q = lane & 3;
  const uint32_t one = B == 1 ? (q == 0 ? 1u : 0u) : 0x3F80u;
  const uint32_t qshift = B == 1 ? 0u : 32u * q;
  const int32_t bias = (int32_t)(256u * kFM - (B == 1 ? 0u : kMagicBits));
  int32_t* ring = s_ring + warp * kRing;
  // This lane's product words: rows 2q and 2q + 1 of words g and g + 8 of
  // every tile (quad g / 4, element g % 4).
  int32_t* put = ring + 2 * q * kRowStride + (g >> 2) * kQuadStride + (g & 3);
  const uint8_t* code = s_code + warp * 32 * kWords + g;
  const int total = reps * K;
  int buf = 0, f = 0;
  for (int r0 = 0; r0 < total; r0 += kGroup) {
    uint32_t b0 = 0;  // row r0 + g's scores at K columns 2q.. / 4q..
    const int row = r0 + g;
    if (row < total && q < (B == 1 ? 1 : 2)) {
      const int rep = row / K, k = row - rep * K;
      b0 = *reinterpret_cast<const uint32_t*>(
          s_sc + ((rep % kNS) * K + k) * 4 * B + 4 * q);
    }
    __syncwarp();  // the ring's previous rows are read
#pragma unroll 2
    for (int t = 0; t < 32; ++t) {  // tile t: thread t's 16 words
      int32_t d[3][4];
#pragma unroll
      for (int th = 0; th < 3; ++th) {
        const uint8_t* c = code + th * words + t * kWords;
        const uint32_t a0 = shl_clamp(one, c[0] - qshift);
        const uint32_t a1 = shl_clamp(one, c[8] - qshift);
        if constexpr (B == 1) {
          mma_s8(d[th], a0, a1, b0);
        } else {
          float x[4];
          mma_bf16(x, a0, a1, b0, kMagic);
#pragma unroll
          for (int e = 0; e < 4; ++e) d[th][e] = __float_as_int(x[e]);
        }
      }
      int32_t m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m[e] = add(add(d[0][e], shl(d[1][e], 10)), shl(d[2][e], 20));
      int32_t* p = put + t * 4;
      p[0] = m[0];                                  // word g, row 2q
      p[kRowStride] = m[1];                         // word g, row 2q + 1
      p[2 * kQuadStride] = m[2];                    // word g + 8, row 2q
      p[2 * kQuadStride + kRowStride] = m[3];       // word g + 8, row 2q + 1
    }
    __syncwarp();
    const int n = total - r0 < kGroup ? total - r0 : kGroup;
    for (int k = 0; k < n; ++k) {
      const int32_t left = left_word(st[kWords - 1], s_edge, buf);
      const int4* row4 = reinterpret_cast<const int4*>(ring + k * kRowStride) +
                         lane;
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const int4 v = row4[i * (kQuadStride / 4)];
        match[4 * i] = add(v.x, bias);
        match[4 * i + 1] = add(v.y, bias);
        match[4 * i + 2] = add(v.z, bias);
        match[4 * i + 3] = add(v.w, bias);
      }
      row_update(st, bits, match, left);
      if (++f == kFlush) {
        f = 0;
        flush(bits, acc);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) st[j] = add(add(st[j], bits[j]), acc[j]);
  store16(out + (long long)blockIdx.x * nthreads * kWords + tid * kWords, st);
}

using OpMixFn = void (*)(const int32_t*, const int32_t*, const int32_t*,
                         const int32_t*, int, int, int32_t*);
using AddFn = void (*)(const int32_t*, int, int, int, int, int32_t*);
using NarrowFn = void (*)(const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, int, int, int, int, int32_t*);

const OpMixFn kOpMix[kNumVariants] = {
    op_mix_kernel<kCurrent>, op_mix_kernel<kPerrow>, op_mix_kernel<kLeanhit>,
    op_mix_kernel<kNomatch>, op_mix_kernel<kNoroll>, op_mix_kernel<kAddonly>,
    op_mix_kernel<kMulcost>, op_mix_kernel<kAndmatch>};
const AddFn kAdd[2] = {add_chain_kernel<1>, add_chain_kernel<2>};
const NarrowFn kNarrow[2] = {narrow_mix_kernel<1>, narrow_mix_kernel<2>};
using MxuFn = void (*)(const uint8_t*, const uint8_t*, int, int, int32_t*);
const MxuFn kMxu[2] = {mxu_mix_kernel<1>, mxu_mix_kernel<2>};

bool bad_shape(int ws, int k, int reps, int copies) {
  return ws < 4 || ws > kMaxThreads * kWords / 128 || ws % 4 != 0 || k < 1 ||
         k > kMaxRows || reps < 0 || copies < 1;
}

size_t op_mix_smem(int k) {
  return sizeof(int32_t) * (kNS * k * 4 + 2 * kMaxWarps + 2 * (k + 1));
}
size_t narrow_smem(int k) { return sizeof(int32_t) * kNS * k * 4; }

// The narrow kernels' block: B = 1 spreads the copies' WS * 512 lanes each
// over kFieldThreads-thread blocks, kFieldLanes lanes a thread; B = 2 runs
// one instance a block, WS * 8 threads.
int narrow_threads(int bytes, int ws) {
  return bytes == 1 ? kFieldThreads : ws * 128 / kWords;
}
int narrow_blocks(int bytes, int ws, int copies) {
  if (bytes != 1) return copies;
  const long long per_block = (long long)kFieldThreads * kFieldLanes;
  return (int)((512LL * ws * copies + per_block - 1) / per_block);
}
size_t strip_smem(int ws, int k) {  // row scalars, edges, rings
  return sizeof(int32_t) * (kNS * k * 4 + 2 * kMaxWarps) +
         sizeof(int4) * (size_t)kStripAhead * 4 * (ws * 128 / kWords);
}
size_t mxu_smem(int ws, int k, int bytes) {  // edges, rings, scores, codes
  const size_t sc = (size_t)kNS * k * 4 * bytes;
  return sizeof(int32_t) * (2 * kMaxWarps + (size_t)(ws / 4) * kRing) +
         (sc + 15) / 16 * 16 + 3 * (size_t)ws * 128;
}

// Lets `fn` take `bytes` of dynamic shared memory (above 48 KB only by
// opting in); cudaErrorInvalidValue above what a block may use.
template <typename F>
cudaError_t allow_smem(F fn, size_t bytes) {
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return e;
  if (bytes > (size_t)limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// Each returns 0 or a cudaError_t; launches on `stream`, does not
// synchronise. The block is WS * 8 threads; `copies` blocks (the int8
// narrow kernels: narrow_blocks of kFieldThreads threads).
extern "C" int hv_roofline_op_mix(int variant, const int32_t* scores,
                                  const int32_t* i1, const int32_t* i2,
                                  const int32_t* i3, int ws, int k, int reps,
                                  int copies, int32_t* out,
                                  cudaStream_t stream) {
  if (variant < 0 || variant >= kNumVariants || bad_shape(ws, k, reps, copies))
    return cudaErrorInvalidValue;
  kOpMix[variant]<<<copies, ws * 128 / kWords, op_mix_smem(k), stream>>>(
      scores, i1, i2, i3, k, reps, out);
  return cudaGetLastError();
}

extern "C" int hv_roofline_add_chain(int bytes, const int32_t* i1, int ws,
                                     int k, int reps, int copies, int32_t* out,
                                     cudaStream_t stream) {
  if ((bytes != 1 && bytes != 2) || bad_shape(ws, k, reps, copies))
    return cudaErrorInvalidValue;
  kAdd[bytes - 1]<<<narrow_blocks(bytes, ws, copies), narrow_threads(bytes, ws),
                    0, stream>>>(i1, ws, k, reps, copies, out);
  return cudaGetLastError();
}

extern "C" int hv_roofline_narrow_mix(int bytes, const int32_t* scores,
                                      const int32_t* i1, const int32_t* i2,
                                      const int32_t* i3, int ws, int k,
                                      int reps, int copies, int32_t* out,
                                      cudaStream_t stream) {
  if ((bytes != 1 && bytes != 2) || bad_shape(ws, k, reps, copies))
    return cudaErrorInvalidValue;
  kNarrow[bytes - 1]<<<narrow_blocks(bytes, ws, copies),
                       narrow_threads(bytes, ws), narrow_smem(k), stream>>>(
      scores, i1, i2, i3, ws, k, reps, copies, out);
  return cudaGetLastError();
}

// stripmatch; the ring (strip_smem) fits WS 4..64 at every K 1..128 on an
// H100; a refused launch returns its error.
extern "C" int hv_roofline_strip(const int32_t* scores, const int32_t* i1,
                                 const int32_t* i2, const int32_t* i3, int ws,
                                 int k, int reps, int copies, int32_t* out,
                                 cudaStream_t stream) {
  if (bad_shape(ws, k, reps, copies)) return cudaErrorInvalidValue;
  const size_t smem = strip_smem(ws, k);
  const cudaError_t e = allow_smem(strip_mix_kernel, smem);
  if (e != cudaSuccess) return e;
  strip_mix_kernel<<<copies, ws * 128 / kWords, smem, stream>>>(
      scores, i1, i2, i3, k, reps, out);
  return cudaGetLastError();
}

// mxumatch (bytes = 2, bf16) / mxumatch8 (bytes = 1, int8): scores
// (16 * K / 10, 10, 4) and the one-hot (4, 3 * WS, 128) of that type; K a
// multiple of 10; WS as shared memory allows (mxu_smem).
extern "C" int hv_roofline_mxu(int bytes, const void* scores,
                               const void* onehot, int ws, int k, int reps,
                               int copies, int32_t* out, cudaStream_t stream) {
  if ((bytes != 1 && bytes != 2) || bad_shape(ws, k, reps, copies) ||
      k % kFlush != 0)
    return cudaErrorInvalidValue;
  const size_t smem = mxu_smem(ws, k, bytes);
  const cudaError_t e = allow_smem(kMxu[bytes - 1], smem);
  if (e != cudaSuccess) return e;
  kMxu[bytes - 1]<<<copies, ws * 128 / kWords, smem, stream>>>(
      static_cast<const uint8_t*>(scores), static_cast<const uint8_t*>(onehot),
      k, reps, out);
  return cudaGetLastError();
}

// add16's halfword add on n word pairs: out = add.u16x2(a, b), for the
// card test that holds it to a wrapping add on every pair of halfwords.
__global__ void add16x2_kernel(const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b, long long n,
                               uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = add16x2(a[i], b[i]);
}

extern "C" int hv_roofline_add16x2(const uint32_t* a, const uint32_t* b,
                                   long long n, uint32_t* out,
                                   cudaStream_t stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  add16x2_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a, b, n,
                                                                  out);
  return cudaGetLastError();
}

// Resident blocks per SM for one kernel (0 op_mix with `which` the variant,
// 1 add_chain / 2 narrow_mix / 4 mxu with `which` the lane or input bytes,
// 3 strip) at (ws, k), at the kernel's own block size (narrow_threads).
extern "C" int hv_roofline_blocks_per_sm(int kernel, int which, int ws, int k,
                                         int* blocks) {
  if (bad_shape(ws, k, 0, 1)) return cudaErrorInvalidValue;
  const int threads = ws * 128 / kWords;
  if (kernel == 3) {
    const cudaError_t e = allow_smem(strip_mix_kernel, strip_smem(ws, k));
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, strip_mix_kernel, threads, strip_smem(ws, k));
  }
  if (kernel == 4 && (which == 1 || which == 2) && k % kFlush == 0) {
    const size_t smem = mxu_smem(ws, k, which);
    const cudaError_t e = allow_smem(kMxu[which - 1], smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kMxu[which - 1], threads, smem);
  }
  if (kernel == 0 && which >= 0 && which < kNumVariants)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kOpMix[which], threads, op_mix_smem(k));
  if ((which == 1 || which == 2) && kernel == 1)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kAdd[which - 1], narrow_threads(which, ws), 0);
  if ((which == 1 || which == 2) && kernel == 2)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kNarrow[which - 1], narrow_threads(which, ws), narrow_smem(k));
  return cudaErrorInvalidValue;
}

extern "C" const char* hv_roofline_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
