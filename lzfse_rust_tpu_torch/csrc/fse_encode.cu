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
// What bounds them on this card: not bytes (a serving batch moves ~290 MB,
// ~86 us at 3.35 TB/s) but each slot's tANS state chain, up to 10,000 steps
// long. Unlike decode, nothing a step loads depends on the state: the
// symbol, its E entry and its extra bits come from the input alone. What
// truly depends on the previous step is, per lane, a short integer chain:
//   n = clamp((t_k + s) >> 10, 0, 25); s' = t_w + (s >> n)
// (add, shift, clamp, shift, add): 5 dependent instructions in the SASS of
// the loop (IADD3, SHF.R.S32.HI, VIMNMX.RELU, SHF.R.S32.HI, LEA.HI.SX32).
// The floor is the longest slot's steps times that chain. On an H100 the
// longest slot alone runs at about 15 ns a step (literal) and 16 (L/M/D);
// a serving batch takes about 1.2 (literal) and 1.6 (L/M/D) times as long,
// the workers' phases sharing the SMs with the chains (PERF.md).
//
// Design (a CUDA block takes kSlots slots, consecutive in ``order``, which
// the host sorts longest first, so a block's slots end at similar steps):
//   * Tables in shared memory: each slot's E table (literal 1 KiB, L/M/D
//     416 B) and the 256-byte D-symbol table are copied in at the start.
//   * The card is filled: a block holds kSlots slots, so the ~1,900 slots of
//     a serving batch make ~480 CUDA blocks, 3-4 on each of the 132 SMs.
//   * A slot's row is walked in tiles of kTile steps from its right end
//     (step i reads column n_cols-1-i). Worker warps (kWorkers threads)
//     copy tile t+kAhead into shared memory with 16-byte cp.async (a ring
//     of kAhead tiles; scalar copies at a ragged or unaligned edge),
//     assemble and store tile t-1, and compute for tile t+1 everything that
//     does not depend on the state -- each lane's E entry (t_k and t_w
//     packed as the table holds them), and for L/M/D the extra value
//     v - base and the extra bit count -- while the chain warps run tile t.
//   * The chain alone: one thread per slot and lane (kSlots * lanes of
//     them) runs e_push's arithmetic over the tile's entries and writes
//     bits | n << 27 back in place. No load whose address depends on a
//     state, no branch, no device-memory store in that loop; the final
//     state is kept with a select off the chain, so every thread runs the
//     same kTile steps.
//   * Groups assembled wide: a worker takes 4 consecutive steps of one
//     slot, ORs the lanes' pairs into each step's 64-bit group exactly as
//     group_add does, and stores glo and gmeta as 16 bytes each, the
//     threads of a warp on consecutive columns of one row.
//   * The phases meet once a tile at one named barrier (bar.sync 1): loads
//     run kAhead tiles ahead and the chain never waits for one. A worker
//     precomputes exactly the 4 steps it copied, so it waits only for its
//     own cp.async groups (a warp's threads commit and wait together:
//     groups are counted per warp).
//
// Semantics that must hold exactly (they are the Pallas kernels'):
//   * n_b = clip(((e & 0x7FFF) - 2048 + s) >> 10, 0, 25), the add on
//     uint32 and the shift arithmetic on int32; bits = s & ((1 << n_b) - 1);
//     s' = (e >> 15) + (s >> n_b), both shifts arithmetic, the add wrapping;
//   * literal steps: (num + 3) >> 2, L/M/D steps: num, both clamped to
//     [0, n_cols]; columns at and past a row's step count are not written;
//   * L/M symbol: v < 16 ? v : 16 + (v >= t1) + (v >= t2) + (v >= t3), with
//     thresholds 20/28/60 (L) and 24/56/312 (M), v_m = lm >> 16 arithmetic;
//     D symbol: the fine index of d, then D_BASE_FROM_VALUE. Symbol indices
//     are clamped into their tables (no effect on values the format can
//     hold);
//   * a lane's pair is (v - base) | bits << extra (wrapping on uint32),
//     extra + n_b bits long; lanes are ORed into the 64-bit group from bit
//     0 upward (literal lane 3 first; L/M/D: D, then M, then L), and a lane
//     that starts at bit 64 or above is dropped;
//   * glo = group & 0xFFFFFFFF, gmeta = group >> 32 | n << 8 (literals) or
//     << 22 (L/M/D); final states are the raw table states, starting from
//     U_STATES and (L_STATES, M_STATES, D_STATES).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// slots per CUDA block: the one tuning constant
// (lzfse_rust_tpu_torch/tools/block_size_probe.py rewrites this line)
constexpr int kSlots = 4;
constexpr int kTile = 128;           // steps per tile
constexpr int kUnits = kTile / 4;    // 4-step units of a slot in a tile
constexpr int kWorkers = 128;        // worker threads: copy, precompute, store
// Entry tiles (and L/M/D's v - base and extra bit counts): the chain's, and
// the workers'. A worker assembles tile t-1 and then precomputes tile t+1
// in the very words it just read (same units, same thread, in program
// order), so two suffice.
constexpr int kBufs = 2;
constexpr int kAhead = 3;            // tiles copied ahead: a ring of kAhead
constexpr int32_t kUStates = 1024, kLStates = 64, kMStates = 64,
                  kDStates = 256;
constexpr int kLmdTab = 104;         // e_l (20), e_m (20), e_d (64) of a slot
static_assert(kSlots >= 1 && kTile % 4 == 0, "kSlots, kTile");
// tile t + kAhead is copied into the input buffer of tile t (already
// precomputed) while tile t + 1's is read: they differ for kAhead >= 2
static_assert(kAhead >= 2, "kAhead");

// The threads of a kernel whose slots carry kLanes states: the chain warps
// first (one thread per slot and lane), then the workers. A tile of entries
// is [step][kRow]: the chain's threads read a row side by side, and a row
// stride that is odd keeps a worker's 4-step units (rows 4k .. 4k+3, the
// threads of a warp on consecutive k) at 2-way bank conflicts, not 16-way.
template <int kLanes>
struct Shape {
  static constexpr int kQ = kSlots * kLanes;                 // chain threads
  static constexpr int kRow = kQ | 1;
  static constexpr int kChain = (kQ + 31) / 32 * 32;
  static constexpr int kThreads = kChain + kWorkers;
};
constexpr int kXbRow = kSlots | 1;   // row stride of the extra bit counts

// shared memory, in 32-bit words
constexpr int kLitWords = kSlots * 256                       // E tables
                          + kAhead * kSlots * kTile          // input tiles
                          + kBufs * kTile * Shape<4>::kRow;  // entries
constexpr int kLmdWords = kSlots * kLmdTab + 64              // E, D symbols
                          + kAhead * 2 * kSlots * kTile      // lm, d tiles
                          + 2 * kBufs * kTile * Shape<3>::kRow  // entries, v - base
                          + kBufs * kTile * kXbRow;          // extra bit counts
constexpr size_t kLitSmem = (size_t)kLitWords * 4;
constexpr size_t kLmdSmem = (size_t)kLmdWords * 4;
static_assert(kLitSmem <= 232448 && kLmdSmem <= 232448,
              "a CUDA block has at most 227 KB of shared memory");

// D symbol of each fine distance index (base/constants.py D_BASE_FROM_VALUE);
// copied into shared memory by each CUDA block
__device__ const uint8_t kDSymbol[256] = {
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kAhead - 1 of the warp's latest copy groups are in
// flight: the oldest tile copied has landed
__device__ __forceinline__ void cp_async_wait_tile() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the once-a-tile meeting of the chain warps and the workers
template <int kThreads>
__device__ __forceinline__ void tile_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// The 4 input words of columns c .. c + 3 of a row into dst (16-byte
// aligned in shared memory): one 16-byte copy where the source is aligned
// and c >= 0, else a 4-byte copy per column >= 0 and 0 below column 0.
__device__ __forceinline__ void fetch4(uint32_t* dst, const int32_t* row,
                                       int32_t c) {
  if (c >= 0 && ((uintptr_t)(row + c) & 15u) == 0) {
    cp_async16(dst, row + c);
  } else {
#pragma unroll
    for (int m = 0; m < 4; m++) {
      if (c + m >= 0) {
        cp_async4(dst + m, row + c + m);
      } else {
        dst[m] = 0u;
      }
    }
  }
}

// Four steps' outputs at dst[0 .. 4): 16 bytes where all four are defined
// and dst is aligned, else one word for each of the first ``room``.
__device__ __forceinline__ void store4(int32_t* dst, const uint32_t (&v)[4],
                                      int32_t room) {
  if (room >= 4 && ((uintptr_t)dst & 15u) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; r++) {
      if (r < room) dst[r] = (int32_t)v[r];
    }
  }
}

// ORs an n-bit pair into the group above the bits already in it.
__device__ __forceinline__ void group_add(uint64_t& group, int32_t& total,
                                          uint32_t pair, int32_t n) {
  if (total < 64) group |= (uint64_t)pair << total;
  total += n;
}

// One lane's chain over a tile: col[j * kRow] holds step j's packed E entry
// and receives bits | n << 27. Returns the state after step rem - 1 (rem
// >= 1; steps past it run on whatever the tile holds, off the result).
template <int kRow>
__device__ __forceinline__ int32_t chain_tile(uint32_t* col, int32_t s,
                                              int32_t rem) {
  int32_t keep = s;
#pragma unroll
  for (int j = 0; j < kTile; j++) {
    const uint32_t e = col[j * kRow];
    const int32_t t_k = (int32_t)(e & 0x7FFFu) - 2048;
    const int32_t t_w = (int32_t)e >> 15;
    // max(min(x, 25), 0): one instruction on sm_90
    const int32_t n = __vimin_s32_relu(
        (int32_t)((uint32_t)t_k + (uint32_t)s) >> 10, 25);
    const uint32_t bits = (uint32_t)s & ((1u << n) - 1u);
    s = (int32_t)((uint32_t)t_w + (uint32_t)(s >> n));
    col[j * kRow] = bits | ((uint32_t)n << 27);
    keep = j < rem ? s : keep;
  }
  return keep;
}

// The block's slots: s_slot[i] (or -1) and its step count s_steps[i];
// returns the block's tile count. Every thread calls it.
template <bool kLiteral>
__device__ __forceinline__ int block_slots(const int32_t* __restrict__ num,
                                           const int32_t* __restrict__ order,
                                           int nb, int n_cols, int32_t* s_slot,
                                           int32_t* s_steps) {
  const int b0 = blockIdx.x * kSlots;
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
    const int slot = b0 + i < nb ? order[b0 + i] : -1;
    const bool ok = slot >= 0 && slot < nb;
    int64_t steps = 0;
    if (ok) {
      const int32_t n = num[slot];
      steps = n <= 0 ? 0 : kLiteral ? ((int64_t)n + 3) >> 2 : (int64_t)n;
      steps = steps < n_cols ? steps : n_cols;
    }
    s_slot[i] = ok ? slot : -1;
    s_steps[i] = (int32_t)steps;
  }
  __syncthreads();
  int32_t most = 0;
#pragma unroll
  for (int i = 0; i < kSlots; i++) most = max(most, s_steps[i]);
  return (most + kTile - 1) / kTile;
}

// --- literals ------------------------------------------------------------

__global__ void __launch_bounds__(Shape<4>::kThreads)
literal_encode_kernel(const int32_t* __restrict__ e_u,
                      const int32_t* __restrict__ words,
                      const int32_t* __restrict__ num,
                      const int32_t* __restrict__ order,
                      int32_t* __restrict__ glo, int32_t* __restrict__ gmeta,
                      int32_t* __restrict__ final_states, int nb, int n_cols) {
  using S = Shape<4>;
  constexpr int kQ = S::kQ, kRow = S::kRow;
  extern __shared__ __align__(16) uint32_t lzt_smem[];
  __shared__ int32_t s_slot[kSlots], s_steps[kSlots];
  uint32_t* const s_tab = lzt_smem;   // [kSlots][256] E tables
  // [kAhead][kSlots][kTile] input words, column order
  uint32_t* const s_in = s_tab + kSlots * 256;
  // [kBufs][kTile][kRow] entries, then bits | n << 27
  uint32_t* const s_ent = s_in + kAhead * kSlots * kTile;
  const int tid = threadIdx.x;
  const int n_tiles = block_slots<true>(num, order, nb, n_cols, s_slot,
                                        s_steps);
  for (int i = tid; i < kSlots * 256; i += S::kThreads) {
    const int32_t slot = s_slot[i / 256];
    s_tab[i] = slot >= 0 ? (uint32_t)__ldg(e_u + (int64_t)slot * 256 + i % 256)
                         : 0u;
  }
  __syncthreads();

  const int w = tid - S::kChain;   // worker index (< 0: a chain thread)
  // copy tile t's inputs of this worker's units into input buffer
  // t % kAhead
  auto fetch = [&](int t) {
    for (int u = w; u < kSlots * kUnits; u += kWorkers) {
      const int i = u / kUnits, k = u % kUnits;
      const int32_t j0 = t * kTile + 4 * k;
      if (j0 < s_steps[i]) {
        fetch4(s_in + ((t % kAhead) * kSlots + i) * kTile + 4 * k,
               words + (int64_t)s_slot[i] * n_cols, n_cols - 4 - j0);
      }
    }
    cp_async_commit();
  };
  // tile t's E entries from its words, into entry buffer t % kBufs
  auto precompute = [&](int t) {
    uint32_t* ent = s_ent + (t % kBufs) * kTile * kRow;
    for (int u = w; u < kSlots * kUnits; u += kWorkers) {
      const int i = u / kUnits, k = u % kUnits;
      if (t * kTile + 4 * k >= s_steps[i]) continue;
      const uint4 w4 = *reinterpret_cast<const uint4*>(
          s_in + ((t % kAhead) * kSlots + i) * kTile + 4 * k);
      const uint32_t col[4] = {w4.w, w4.z, w4.y, w4.x};   // steps 4k .. 4k+3
      const uint32_t* tab = s_tab + i * 256;
#pragma unroll
      for (int jj = 0; jj < 4; jj++) {
        uint32_t* e = ent + (4 * k + jj) * kRow + i * 4;
#pragma unroll
        for (int lane = 0; lane < 4; lane++)
          e[lane] = tab[(col[jj] >> (8 * lane)) & 255u];
      }
    }
  };
  // tile t's groups from the chain's results, stored
  auto assemble = [&](int t) {
    const uint32_t* ent = s_ent + (t % kBufs) * kTile * kRow;
    for (int u = w; u < kSlots * kUnits; u += kWorkers) {
      const int i = u / kUnits, k = u % kUnits;
      const int32_t j0 = t * kTile + 4 * k;
      if (j0 >= s_steps[i]) continue;
      uint32_t lo[4], meta[4];
#pragma unroll
      for (int jj = 0; jj < 4; jj++) {
        const uint32_t* x = ent + (4 * k + jj) * kRow + i * 4;
        uint64_t group = 0;
        int32_t total = 0;
#pragma unroll
        for (int lane = 3; lane >= 0; lane--)
          group_add(group, total, x[lane] & 0x7FFFFFFu, (int32_t)(x[lane] >> 27));
        lo[jj] = (uint32_t)group;
        meta[jj] = (uint32_t)(group >> 32) | ((uint32_t)total << 8);
      }
      const int64_t at = (int64_t)s_slot[i] * n_cols + j0;
      store4(glo + at, lo, s_steps[i] - j0);
      store4(gmeta + at, meta, s_steps[i] - j0);
    }
  };

  // a tile past the block's end copies nothing but still commits a group,
  // so the wait always leaves exactly the kAhead - 1 newest in flight
  if (w >= 0 && n_tiles > 0) {
    for (int t = 0; t < kAhead; t++) fetch(t);
    cp_async_wait_tile();
    precompute(0);
  }
  tile_barrier<S::kThreads>();
  int32_t s = kUStates;
  for (int t = 0; t <= n_tiles; t++) {
    if (w < 0) {
      const int i = tid / 4;
      if (tid < kQ && t < n_tiles && t * kTile < s_steps[i]) {
        s = chain_tile<kRow>(s_ent + (t % kBufs) * kTile * kRow + tid, s,
                             s_steps[i] - t * kTile);
      }
    } else {
      fetch(t + kAhead);
      if (t >= 1) assemble(t - 1);
      if (t + 1 < n_tiles) {
        cp_async_wait_tile();
        precompute(t + 1);
      }
    }
    tile_barrier<S::kThreads>();
  }
  if (w < 0) {
    if (tid < kQ && s_slot[tid / 4] >= 0)
      final_states[(int64_t)s_slot[tid / 4] * 4 + tid % 4] = s;
  } else {
    cp_async_wait_all();
  }
}

// --- L/M/D -----------------------------------------------------------------

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

// D symbol j of distance v (fine index, then the table in shared memory);
// its extra bits are j >> 2 and its base ((4 + (j & 3)) << (j >> 2)) - 4
// (base/constants.py D_EXTRA_BITS, D_BASE_VALUE).
__device__ __forceinline__ int32_t d_symbol(int32_t v, const uint8_t* dsym,
                                            int32_t& extra, int32_t& base) {
  int32_t di = v < 60 ? v
             : v < 1020 ? ((v - 60) >> 4) + 64
             : v < 16380 ? ((v - 1020) >> 8) + 128
             : ((v - 16380) >> 12) + 192;
  di = di < 0 ? 0 : (di > 255 ? 255 : di);
  const int32_t j = dsym[di];
  extra = j >> 2;
  base = ((4 + (j & 3)) << (j >> 2)) - 4;
  return j;
}

__global__ void __launch_bounds__(Shape<3>::kThreads)
lmd_encode_kernel(const int32_t* __restrict__ e_l,
                  const int32_t* __restrict__ e_m,
                  const int32_t* __restrict__ e_d,
                  const int32_t* __restrict__ lm,
                  const int32_t* __restrict__ d,
                  const int32_t* __restrict__ num,
                  const int32_t* __restrict__ order,
                  int32_t* __restrict__ glo, int32_t* __restrict__ gmeta,
                  int32_t* __restrict__ final_states, int nb, int n_cols) {
  using S = Shape<3>;
  constexpr int kQ = S::kQ, kRow = S::kRow;
  extern __shared__ __align__(16) uint32_t lzt_smem[];
  __shared__ int32_t s_slot[kSlots], s_steps[kSlots];
  uint32_t* const s_tab = lzt_smem;   // [kSlots][kLmdTab] e_l, e_m, e_d
  uint8_t* const s_dsym =             // [256]
      reinterpret_cast<uint8_t*>(s_tab + kSlots * kLmdTab);
  // [kAhead][2][kSlots][kTile] lm, then d; column order
  uint32_t* const s_in = s_tab + kSlots * kLmdTab + 64;
  // [kBufs][kTile][kRow] entries, then bits | n << 27; v - base
  uint32_t* const s_ent = s_in + kAhead * 2 * kSlots * kTile;
  uint32_t* const s_ex = s_ent + kBufs * kTile * kRow;
  // [kBufs][kTile][kXbRow] extra bits: L | M << 8 | D << 16
  uint32_t* const s_xb = s_ex + kBufs * kTile * kRow;
  const int tid = threadIdx.x;
  const int n_tiles = block_slots<false>(num, order, nb, n_cols, s_slot,
                                         s_steps);
  for (int i = tid; i < kSlots * kLmdTab; i += S::kThreads) {
    const int32_t slot = s_slot[i / kLmdTab];
    const int c = i % kLmdTab;
    uint32_t v = 0u;
    if (slot >= 0) {
      v = (uint32_t)(c < 20   ? __ldg(e_l + (int64_t)slot * 20 + c)
                     : c < 40 ? __ldg(e_m + (int64_t)slot * 20 + c - 20)
                              : __ldg(e_d + (int64_t)slot * 64 + c - 40));
    }
    s_tab[i] = v;
  }
  for (int i = tid; i < 256; i += S::kThreads) s_dsym[i] = kDSymbol[i];
  __syncthreads();

  const int w = tid - S::kChain;
  auto in_of = [&](int t, int row, int i) {   // row 0: lm, 1: d
    return s_in + (((t % kAhead) * 2 + row) * kSlots + i) * kTile;
  };
  auto fetch = [&](int t) {
    for (int u = w; u < kSlots * kUnits; u += kWorkers) {
      const int i = u / kUnits, k = u % kUnits;
      const int32_t j0 = t * kTile + 4 * k;
      if (j0 < s_steps[i]) {
        const int64_t row = (int64_t)s_slot[i] * n_cols;
        fetch4(in_of(t, 0, i) + 4 * k, lm + row, n_cols - 4 - j0);
        fetch4(in_of(t, 1, i) + 4 * k, d + row, n_cols - 4 - j0);
      }
    }
    cp_async_commit();
  };
  auto precompute = [&](int t) {
    const int b = (t % kBufs) * kTile;
    for (int u = w; u < kSlots * kUnits; u += kWorkers) {
      const int i = u / kUnits, k = u % kUnits;
      if (t * kTile + 4 * k >= s_steps[i]) continue;
      const uint4 lm4 = *reinterpret_cast<const uint4*>(in_of(t, 0, i) + 4 * k);
      const uint4 d4 = *reinterpret_cast<const uint4*>(in_of(t, 1, i) + 4 * k);
      const uint32_t lmc[4] = {lm4.w, lm4.z, lm4.y, lm4.x};   // steps 4k ..
      const uint32_t dc[4] = {d4.w, d4.z, d4.y, d4.x};
      const uint32_t* tab = s_tab + i * kLmdTab;
#pragma unroll
      for (int jj = 0; jj < 4; jj++) {
        const int32_t v_l = (int32_t)(lmc[jj] & 0xFFFFu);
        const int32_t v_m = (int32_t)lmc[jj] >> 16;   // arithmetic, as in JAX
        const int32_t v_d = (int32_t)dc[jj];
        int32_t xl, bl, xm, bm, xd, bd;
        const int32_t jl = lm_symbol(v_l, false, xl, bl);
        const int32_t jm = lm_symbol(v_m, true, xm, bm);
        const int32_t jd = d_symbol(v_d, s_dsym, xd, bd);
        const int r = (b + 4 * k + jj) * kRow + i * 3;
        s_ent[r + 0] = tab[jl];
        s_ent[r + 1] = tab[20 + jm];
        s_ent[r + 2] = tab[40 + jd];
        s_ex[r + 0] = (uint32_t)v_l - (uint32_t)bl;
        s_ex[r + 1] = (uint32_t)v_m - (uint32_t)bm;
        s_ex[r + 2] = (uint32_t)v_d - (uint32_t)bd;
        s_xb[(b + 4 * k + jj) * kXbRow + i] =
            (uint32_t)xl | ((uint32_t)xm << 8) | ((uint32_t)xd << 16);
      }
    }
  };
  auto assemble = [&](int t) {
    const int b = (t % kBufs) * kTile;
    for (int u = w; u < kSlots * kUnits; u += kWorkers) {
      const int i = u / kUnits, k = u % kUnits;
      const int32_t j0 = t * kTile + 4 * k;
      if (j0 >= s_steps[i]) continue;
      uint32_t lo[4], meta[4];
#pragma unroll
      for (int jj = 0; jj < 4; jj++) {
        const int r = (b + 4 * k + jj) * kRow + i * 3;
        const uint32_t xb = s_xb[(b + 4 * k + jj) * kXbRow + i];
        uint64_t group = 0;
        int32_t total = 0;
#pragma unroll
        for (int lane = 2; lane >= 0; lane--) {   // D, M, L
          const uint32_t x = s_ent[r + lane];
          const uint32_t extra = (xb >> (8 * lane)) & 255u;
          group_add(group, total, s_ex[r + lane] | ((x & 0x7FFFFFFu) << extra),
                    (int32_t)(extra + (x >> 27)));
        }
        lo[jj] = (uint32_t)group;
        meta[jj] = (uint32_t)(group >> 32) | ((uint32_t)total << 22);
      }
      const int64_t at = (int64_t)s_slot[i] * n_cols + j0;
      store4(glo + at, lo, s_steps[i] - j0);
      store4(gmeta + at, meta, s_steps[i] - j0);
    }
  };

  // a tile past the block's end copies nothing but still commits a group,
  // so the wait always leaves exactly the kAhead - 1 newest in flight
  if (w >= 0 && n_tiles > 0) {
    for (int t = 0; t < kAhead; t++) fetch(t);
    cp_async_wait_tile();
    precompute(0);
  }
  tile_barrier<S::kThreads>();
  const int lane = tid % 3;
  int32_t s = lane == 0 ? kLStates : lane == 1 ? kMStates : kDStates;
  for (int t = 0; t <= n_tiles; t++) {
    if (w < 0) {
      const int i = tid / 3;
      if (tid < kQ && t < n_tiles && t * kTile < s_steps[i]) {
        s = chain_tile<kRow>(s_ent + (t % kBufs) * kTile * kRow + tid, s,
                             s_steps[i] - t * kTile);
      }
    } else {
      fetch(t + kAhead);
      if (t >= 1) assemble(t - 1);
      if (t + 1 < n_tiles) {
        cp_async_wait_tile();
        precompute(t + 1);
      }
    }
    tile_barrier<S::kThreads>();
  }
  if (w < 0) {
    if (tid < kQ && s_slot[tid / 3] >= 0)
      final_states[(int64_t)s_slot[tid / 3] * 3 + lane] = s;
  } else {
    cp_async_wait_all();
  }
}

inline int grid_for(int nb) { return (nb + kSlots - 1) / kSlots; }

// Allow the kernel its dynamic shared memory (above 48 KB a block must ask);
// a refusal is returned, and cleared from the last-error slot.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) cudaGetLastError();
  return rc;
}

}  // namespace

extern "C" {

// Both entry points launch on the given stream, do not synchronise and
// return cudaGetLastError() (0 on success), or the error of the shared
// memory request. Every table, row and vector is int32 and contiguous: e_u
// (nb, 256), e_l/e_m (nb, 20), e_d (nb, 64); words, lm, d and the outputs
// glo/gmeta (nb, n_cols); num and order (nb); final states (nb, 4) or
// (nb, 3). order is a permutation of 0..nb-1.

int lzt_encode_literals(const void* e_u, const void* words, const void* num,
                        const void* order, void* glo, void* gmeta,
                        void* final_states, int nb, int n_cols, void* stream) {
  if (nb > 0 && n_cols > 0) {
    const cudaError_t rc = allow_smem(literal_encode_kernel, kLitSmem);
    if (rc != cudaSuccess) return (int)rc;
    literal_encode_kernel<<<grid_for(nb), Shape<4>::kThreads, kLitSmem,
                            (cudaStream_t)stream>>>(
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
    const cudaError_t rc = allow_smem(lmd_encode_kernel, kLmdSmem);
    if (rc != cudaSuccess) return (int)rc;
    lmd_encode_kernel<<<grid_for(nb), Shape<3>::kThreads, kLmdSmem,
                        (cudaStream_t)stream>>>(
        (const int32_t*)e_l, (const int32_t*)e_m, (const int32_t*)e_d,
        (const int32_t*)lm, (const int32_t*)d, (const int32_t*)num,
        (const int32_t*)order, (int32_t*)glo, (int32_t*)gmeta,
        (int32_t*)final_states, nb, n_cols);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
