// Batched FSE (tANS) stream encode for the LZFSE container encoder, written
// by hand for Hopper (sm_90a). Plain C interface, loaded with ctypes
// (lzfse_rust_tpu_torch/runtime/cuda_lib.py).
//
// Replaces the two Pallas kernels of lzfse_rust_tpu/ops/pallas_encode.py:
//   lzt_encode_literals -> encode_literals_pallas (_literal_encode_kernel)
//   lzt_encode_lmds     -> encode_lmds_pallas     (_lmd_encode_kernel)
// Each computes what the Pallas kernel computes, not how it lays it out: no
// R_ROWS grain, no 128-step superepochs, no roll trees or flips, no combined
// 128-lane L/M/D table tile, no row permutations.
//
// Design: one thread per stream (block slot), 32 threads per CUDA block.
// Thread t takes slot order[t]; the host orders slots longest first, so the
// threads of a warp run similar step counts. A thread walks its row from the
// last input column backwards (the inputs are right-justified, so step i
// reads column n_cols-1-i), keeps its 4 (literal) or 3 (L/M/D) states in
// registers, looks each symbol's packed E entry up in its slot's table row
// (device memory through L1), and writes step i's push group to column i of
// its output rows. The group is built in a uint64: lanes are ORed in from
// bit 0 upward (literal lane 3 first; L/M/D: D, then M, then L), a shift
// of 64 or more drops the lane (never on valid data: a literal group holds
// at most 40 bits, an L/M/D group at most 54).
//
// What bounds it on this card: unlike decode, the E lookup depends on the
// input symbol, not on the state, so the loop-carried chain per step is a
// few integer operations on each state, and every load of a step can be
// issued ahead of it (the step loop is unrolled by 4 for that). What is left
// is the stores -- 8 bytes per step per stream, into rows that neighbouring
// threads do not share -- and low parallelism: a serving batch has ~1,800
// streams, 57 CUDA blocks of 32 threads for the card's 132 SMs. 32 threads
// per CUDA block, because the decode kernels of this port ran 27-37% faster
// at 32 than at 128 on the same batch (PERF.md, PR 1).
//
// Semantics that must hold exactly (they are the Pallas kernels'):
//   * n_b = clip(((e & 0x7FFF) - 2048 + s) >> 10, 0, 25), an arithmetic shift
//     on int32; bits = s & ((1 << n_b) - 1); s' = (e >> 15) + (s >> n_b);
//   * literal steps: (num + 3) >> 2, L/M/D steps: num, both at most n_cols;
//     columns at and past a row's step count are not written;
//   * L/M symbol: v < 16 ? v : 16 + (v >= t1) + (v >= t2) + (v >= t3), with
//     thresholds 20/28/60 (L) and 24/56/312 (M); D symbol: the fine index of
//     d, then D_BASE_FROM_VALUE. Symbol indices are clamped into their
//     tables (no effect on values the format can hold);
//   * a lane's pair is (v - base) | bits << extra, extra + n_b bits long;
//   * glo = group & 0xFFFFFFFF, gmeta = group >> 32 | n << 8 (literals) or
//     << 22 (L/M/D); final states are the raw table states.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int32_t kUStates = 1024, kLStates = 64, kMStates = 64,
                  kDStates = 256;

// D symbol of each fine distance index (base/constants.py D_BASE_FROM_VALUE)
__constant__ uint8_t kDSymbol[256] = {
    0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 8, 8,
    9, 9, 9, 9, 10, 10, 10, 10, 11, 11, 11, 11, 12, 12, 12, 12,
    12, 12, 12, 12, 13, 13, 13, 13, 13, 13, 13, 13, 14, 14, 14, 14,
    14, 14, 14, 14, 15, 15, 15, 15, 15, 15, 15, 15, 0, 0, 0, 0,
    16, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 24, 24, 24,
    25, 25, 25, 25, 26, 26, 26, 26, 27, 27, 27, 27, 28, 28, 28, 28,
    28, 28, 28, 28, 29, 29, 29, 29, 29, 29, 29, 29, 30, 30, 30, 30,
    30, 30, 30, 30, 31, 31, 31, 31, 31, 31, 31, 31, 0, 0, 0, 0,
    32, 33, 34, 35, 36, 36, 37, 37, 38, 38, 39, 39, 40, 40, 40, 40,
    41, 41, 41, 41, 42, 42, 42, 42, 43, 43, 43, 43, 44, 44, 44, 44,
    44, 44, 44, 44, 45, 45, 45, 45, 45, 45, 45, 45, 46, 46, 46, 46,
    46, 46, 46, 46, 47, 47, 47, 47, 47, 47, 47, 47, 0, 0, 0, 0,
    48, 49, 50, 51, 52, 52, 53, 53, 54, 54, 55, 55, 56, 56, 56, 56,
    57, 57, 57, 57, 58, 58, 58, 58, 59, 59, 59, 59, 60, 60, 60, 60,
    60, 60, 60, 60, 61, 61, 61, 61, 61, 61, 61, 61, 62, 62, 62, 62,
    62, 62, 62, 62, 63, 63, 63, 63, 63, 63, 63, 63, 0, 0, 0, 0,
};

// One push: the packed E entry e encodes the state s; returns the state
// bits and sets n_b. Additions wrap on uint32, as int32 does under JAX.
__device__ __forceinline__ uint32_t e_push(int32_t e, int32_t& s, int32_t& n_b) {
  const int32_t t_k = (e & 0x7FFF) - 2048;
  int32_t n = (int32_t)((uint32_t)t_k + (uint32_t)s) >> 10;
  n = n < 0 ? 0 : (n > 25 ? 25 : n);
  const uint32_t bits = (uint32_t)s & ((1u << n) - 1u);
  s = (int32_t)((uint32_t)(e >> 15) + (uint32_t)(s >> n));
  n_b = n;
  return bits;
}

// ORs an n-bit pair into the group above the bits already in it.
__device__ __forceinline__ void group_add(uint64_t& group, int32_t& total,
                                          uint32_t pair, int32_t n) {
  if (total < 64) group |= (uint64_t)pair << total;
  total += n;
}

// L/M symbol, extra bits and base. Below 16 the symbol is the value; the
// bases of symbols 16..19 are 16 and the three thresholds, and the extra
// bits span the gap to the next base (base/constants.py L_/M_EXTRA_BITS,
// L_/M_BASE_VALUE).
__device__ __forceinline__ int32_t lm_symbol(int32_t v, bool is_m,
                                             int32_t& extra, int32_t& base) {
  const int32_t t1 = is_m ? 24 : 20, t2 = is_m ? 56 : 28, t3 = is_m ? 312 : 60;
  int32_t sym = v < 16 ? v : 16 + (v >= t1) + (v >= t2) + (v >= t3);
  sym = sym < 0 ? 0 : (sym > 19 ? 19 : sym);
  if (sym < 16) {
    extra = 0;
    base = sym;
  } else {
    const int32_t j = sym - 16;
    extra = is_m ? (j == 0 ? 3 : j == 1 ? 5 : j == 2 ? 8 : 11)
                 : (j == 0 ? 2 : j == 1 ? 3 : j == 2 ? 5 : 8);
    base = j == 0 ? 16 : j == 1 ? t1 : j == 2 ? t2 : t3;
  }
  return sym;
}

// D symbol j of distance v (fine index, then the table); its extra bits are
// j >> 2 and its base ((4 + (j & 3)) << (j >> 2)) - 4 (base/constants.py
// D_EXTRA_BITS, D_BASE_VALUE).
__device__ __forceinline__ int32_t d_symbol(int32_t v, int32_t& extra,
                                            int32_t& base) {
  int32_t di = v < 60 ? v
             : v < 1020 ? ((v - 60) >> 4) + 64
             : v < 16380 ? ((v - 1020) >> 8) + 128
             : ((v - 16380) >> 12) + 192;
  di = di < 0 ? 0 : (di > 255 ? 255 : di);
  const int32_t j = kDSymbol[di];
  extra = j >> 2;
  base = ((4 + (j & 3)) << (j >> 2)) - 4;
  return j;
}

__global__ void __launch_bounds__(kThreads)
literal_encode_kernel(const int32_t* __restrict__ e_u,
                      const int32_t* __restrict__ words,
                      const int32_t* __restrict__ num,
                      const int32_t* __restrict__ order,
                      int32_t* __restrict__ glo, int32_t* __restrict__ gmeta,
                      int32_t* __restrict__ final_states, int nb, int n_cols) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= nb) return;
  const int slot = order[t];
  if (slot < 0 || slot >= nb) return;
  const int32_t* __restrict__ tab = e_u + (int64_t)slot * 256;
  const int64_t row = (int64_t)slot * n_cols;
  const int32_t* __restrict__ src = words + row + (n_cols - 1);
  int32_t* __restrict__ lo = glo + row;
  int32_t* __restrict__ meta = gmeta + row;
  const int32_t n = num[slot];
  int32_t steps = n > 0 ? (int32_t)(((int64_t)n + 3) >> 2) : 0;
  steps = steps < n_cols ? steps : n_cols;
  int32_t s[4] = {kUStates, kUStates, kUStates, kUStates};

#pragma unroll 4
  for (int32_t i = 0; i < steps; i++) {
    const uint32_t w = (uint32_t)__ldg(src - i);
    int32_t e[4];
#pragma unroll
    for (int lane = 0; lane < 4; lane++)
      e[lane] = __ldg(tab + ((w >> (8 * lane)) & 255u));
    uint64_t group = 0;
    int32_t total = 0;
#pragma unroll
    for (int lane = 3; lane >= 0; lane--) {
      int32_t n_b;
      const uint32_t bits = e_push(e[lane], s[lane], n_b);
      group_add(group, total, bits, n_b);
    }
    lo[i] = (int32_t)(uint32_t)group;
    meta[i] = (int32_t)((uint32_t)(group >> 32) | ((uint32_t)total << 8));
  }
#pragma unroll
  for (int lane = 0; lane < 4; lane++)
    final_states[(int64_t)slot * 4 + lane] = s[lane];
}

__global__ void __launch_bounds__(kThreads)
lmd_encode_kernel(const int32_t* __restrict__ e_l,
                  const int32_t* __restrict__ e_m,
                  const int32_t* __restrict__ e_d,
                  const int32_t* __restrict__ lm,
                  const int32_t* __restrict__ d,
                  const int32_t* __restrict__ num,
                  const int32_t* __restrict__ order,
                  int32_t* __restrict__ glo, int32_t* __restrict__ gmeta,
                  int32_t* __restrict__ final_states, int nb, int n_cols) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= nb) return;
  const int slot = order[t];
  if (slot < 0 || slot >= nb) return;
  const int32_t* __restrict__ tl = e_l + (int64_t)slot * 20;
  const int32_t* __restrict__ tm = e_m + (int64_t)slot * 20;
  const int32_t* __restrict__ td = e_d + (int64_t)slot * 64;
  const int64_t row = (int64_t)slot * n_cols;
  const int32_t* __restrict__ src_lm = lm + row + (n_cols - 1);
  const int32_t* __restrict__ src_d = d + row + (n_cols - 1);
  int32_t* __restrict__ lo = glo + row;
  int32_t* __restrict__ meta = gmeta + row;
  const int32_t n = num[slot];
  int32_t steps = n > 0 ? n : 0;
  steps = steps < n_cols ? steps : n_cols;
  int32_t sl = kLStates, sm = kMStates, sd = kDStates;

#pragma unroll 4
  for (int32_t i = 0; i < steps; i++) {
    const int32_t v_lm = __ldg(src_lm - i);
    const int32_t v_d = __ldg(src_d - i);
    const int32_t v_l = v_lm & 0xFFFF;
    const int32_t v_m = v_lm >> 16;  // arithmetic, as in JAX
    int32_t xl, bl, xm, bm, xd, bd;
    const int32_t jl = lm_symbol(v_l, false, xl, bl);
    const int32_t jm = lm_symbol(v_m, true, xm, bm);
    const int32_t jd = d_symbol(v_d, xd, bd);
    const int32_t el = __ldg(tl + jl), em = __ldg(tm + jm), ed = __ldg(td + jd);
    uint64_t group = 0;
    int32_t total = 0, n_b;
    uint32_t bits = e_push(ed, sd, n_b);
    group_add(group, total,
              ((uint32_t)v_d - (uint32_t)bd) | (bits << (uint32_t)xd), xd + n_b);
    bits = e_push(em, sm, n_b);
    group_add(group, total,
              ((uint32_t)v_m - (uint32_t)bm) | (bits << (uint32_t)xm), xm + n_b);
    bits = e_push(el, sl, n_b);
    group_add(group, total,
              ((uint32_t)v_l - (uint32_t)bl) | (bits << (uint32_t)xl), xl + n_b);
    lo[i] = (int32_t)(uint32_t)group;
    meta[i] = (int32_t)((uint32_t)(group >> 32) | ((uint32_t)total << 22));
  }
  final_states[(int64_t)slot * 3 + 0] = sl;
  final_states[(int64_t)slot * 3 + 1] = sm;
  final_states[(int64_t)slot * 3 + 2] = sd;
}

inline int grid_for(int nb) { return (nb + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Both entry points launch on the given stream, do not synchronise and
// return cudaGetLastError() (0 on success). Every table, row and vector is
// int32 and contiguous: e_u (nb, 256), e_l/e_m (nb, 20), e_d (nb, 64);
// words, lm, d and the outputs glo/gmeta (nb, n_cols); num and order (nb);
// final states (nb, 4) or (nb, 3). order is a permutation of 0..nb-1.

int lzt_encode_literals(const void* e_u, const void* words, const void* num,
                        const void* order, void* glo, void* gmeta,
                        void* final_states, int nb, int n_cols, void* stream) {
  if (nb > 0 && n_cols > 0) {
    literal_encode_kernel<<<grid_for(nb), kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)e_u, (const int32_t*)words, (const int32_t*)num,
        (const int32_t*)order, (int32_t*)glo, (int32_t*)gmeta,
        (int32_t*)final_states, nb, n_cols);
  }
  return (int)cudaGetLastError();
}

int lzt_encode_lmds(const void* e_l, const void* e_m, const void* e_d,
                    const void* lm, const void* d, const void* num,
                    const void* order, void* glo, void* gmeta,
                    void* final_states, int nb, int n_cols, void* stream) {
  if (nb > 0 && n_cols > 0) {
    lmd_encode_kernel<<<grid_for(nb), kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)e_l, (const int32_t*)e_m, (const int32_t*)e_d,
        (const int32_t*)lm, (const int32_t*)d, (const int32_t*)num,
        (const int32_t*)order, (int32_t*)glo, (int32_t*)gmeta,
        (int32_t*)final_states, nb, n_cols);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
