// Grouped match finding for the LZFSE container encoder's device frontend,
// written by hand for Hopper (sm_90a). Plain C interface, loaded with ctypes
// (lzfse_rust_tpu_torch/runtime/cuda_lib.py).
//
// Replaces lzfse_rust_tpu/ops/match_find_tpu.py:160-217,
// find_matches_grouped_compact (_grouped_compact_one over _grouped_core,
// _windows_fwd and _first_mismatch) followed by take_sat_cols and the
// host's scan of the keys: XLA code under jax.jit on the TPU, no Pallas. It
// computes what they compute together, not how: the TPU version
// materialises a (N, 64) byte window for every position, gathers another
// (N, 64) in grouped order and returns every slot's key, winner and four
// candidates, 47 bytes a slot that the host then scans. Here each thread
// reads the source bytes where they lie, and the kernel writes only what the
// host reads: the matched slots' (slot, best_cand, best_len) and the
// saturated slots' (slot, 4 cands, 4 lcps), each in ascending slot order,
// window after window.
//
// What bounds it on this card: bytes. The inputs are read once (pads 1
// byte a slot, orders 4, oks 1) and the rows written once (9 bytes a
// matched slot, 36 a saturated one, 8 a window for its offsets). The
// operations (a few 8-byte XORs per candidate and a dozen for the
// arbitration) are far below the 32-bit rate. The design:
//   * kBlockSlots = 2,048 slots of window b a CUDA block, 256 threads
//     taking 8 passes of 256 neighbouring slots, each slot's key, winner
//     and length kept in shared memory until the block knows where its
//     rows go; blocks taken in order by a ticket (an atomic counter), so
//     that block t of the flat (window, block) order may wait for block
//     t - 1. Few large blocks keep the look-back's latency (about one
//     device-memory round trip a block) off most of the slots;
//   * a candidate c = orders[b, s - r] is compared with the window at p =
//     orders[b, s] word by word, both loaded as aligned 8-byte words joined
//     by shifts (an unaligned 8-byte load is undefined), loading a word only
//     while every earlier one was equal; the first differing byte of a word
//     is __ffsll(x) - 1 >> 3 on little-endian words. p's words come again
//     from L1 for each candidate, so no 64-byte window is held in
//     registers. The source row (at most 1 MiB) is read in random order,
//     but a window's blocks run together, so its row stays in the 50 MB L2;
//   * a window that would wrap at N (only reachable when a bit is set for
//     an unprobed position: the host grouping never does that) takes a
//     byte-wise path kept out of line;
//   * compaction: warp ballots rank the matched and saturated slots inside
//     each warp and pass, the block adds its 64 groups, and a decoupled
//     look-back over the blocks before it (one 64-bit status word each:
//     flag, matched count, saturated count) gives the block's first output
//     row. The last block of a window writes the window's end offsets. A
//     saturated slot evaluates its four candidates a second time to write
//     them, which keeps them out of registers on the common path.
//
// Semantics that must hold exactly (they are _grouped_compact_one's):
//   * candidate r (1..4) of slot s is orders[b, s - r], the slot axis
//     wrapping at N (jnp.roll), where bit r-1 of oks[b, s] is set; else
//     cand = -1 and lcp = 0;
//   * lcp = min(max(first mismatch, 0), n_real - p), the clip of jnp.clip,
//     in int32 (n_real - p wraps as int32 does);
//   * in r order: mlen = lcp if lcp >= 4, else 3 if vn and lcp == 3, else 0
//     (0 where cand < 0); sat |= cand >= 0 && (lcp == 64 || p + lcp >=
//     n_real); best_len/best_cand take mlen/cand when mlen > best_len
//     (strict: the earlier candidate wins a tie), both starting at 0;
//   * a slot is payload when lo <= p < hi: key 0 (saturated) when payload
//     and sat, 1 (matched) when payload and (best_len > 0 or sat), else 2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 64;    // bytes compared per LCP
constexpr int kWidth = 4;      // candidates per slot (HASH_WIDTH)
constexpr int kBlockSlots = 2048;  // slots a CUDA block
constexpr int kThreads = 256;
constexpr int kPasses = kBlockSlots / kThreads;  // slots a thread
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kPasses * kWarps;  // warp-sized groups a block
static_assert(kGroups == 64, "the block's prefix takes two groups a lane");
constexpr int kSatCols = 1 + 2 * kWidth;  // slot, cands, lcps
constexpr unsigned kFull = 0xffffffffu;
// a block's status word: flag in bits 62-63, matched count in 31-61,
// saturated count in 0-30
constexpr uint64_t kAggregate = 1ull << 62;
constexpr uint64_t kInclusive = 2ull << 62;
constexpr uint64_t kCount = (1ull << 31) - 1;

// bytes [sh/8, sh/8 + 8) of the 16 bytes lo | hi << 64
__device__ __forceinline__ uint64_t join(uint64_t lo, uint64_t hi, int sh) {
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
}

__device__ __forceinline__ int first_byte(uint64_t x) {
  return (__ffsll((long long)x) - 1) >> 3;
}

// First differing byte of the windows at bytes p and c of an 8-byte
// aligned row (p + 72 <= n, c + 72 <= n), loading words only while they
// are equal; kWindow if none differs.
__device__ __forceinline__ int mismatch_fast(const uint64_t* row64,
                                             uint32_t p, uint32_t c) {
  const uint64_t* qa = row64 + (p >> 3);
  const uint64_t* qb = row64 + (c >> 3);
  const int sa = (p & 7) * 8, sb = (c & 7) * 8;
  uint64_t alo = __ldg(qa), blo = __ldg(qb);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const uint64_t ahi = __ldg(qa + k + 1), bhi = __ldg(qb + k + 1);
    const uint64_t x = join(alo, ahi, sa) ^ join(blo, bhi, sb);
    if (x) return 8 * k + first_byte(x);
    alo = ahi;
    blo = bhi;
  }
  return kWindow;
}

// The same for windows that wrap at n, each byte (p + i) mod n: the rolled
// windows of the reference at a row's end.
__device__ __noinline__ int mismatch_wrap(const uint8_t* row, uint32_t p,
                                          uint32_t c, uint32_t n) {
  for (int i = 0; i < kWindow; i++) {
    if (row[(p + i) % n] != row[(c + i) % n]) return i;
  }
  return kWindow;
}

struct Window {
  const uint8_t* row;
  const int32_t* order;
  uint32_t n;
  int s, p, n_real, ok;
};

// Candidate r (1..kWidth) of the slot: its position, or -1, and its lcp.
__device__ __forceinline__ int candidate(const Window& w, int r, int* lcp) {
  *lcp = 0;
  if (!((w.ok >> (r - 1)) & 1)) return -1;
  const int cand = __ldg(w.order + (w.s >= r ? w.s - r : w.s - r + (int)w.n));
  const uint32_t up = (uint32_t)w.p % w.n, uc = (uint32_t)cand % w.n;
  const int m = up + 72u <= w.n && uc + 72u <= w.n
      ? mismatch_fast(reinterpret_cast<const uint64_t*>(w.row), up, uc)
      : mismatch_wrap(w.row, up, uc, w.n);
  *lcp = min(max(m, 0), (int)((uint32_t)w.n_real - (uint32_t)w.p));
  return cand;
}

__device__ __forceinline__ void st_release(uint64_t* a, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(a), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* a) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(a)
               : "memory");
  return v;
}

// The matched and saturated rows before block t (t > 0): the warp's lanes
// read the status words of t - 1 - lane, ..., 32 at a time, waiting for
// each to be published, and add the aggregates back to the nearest
// inclusive prefix. Called by one whole warp.
__device__ void look_back(const uint64_t* status, int t, uint64_t* em,
                          uint64_t* es) {
  const int lane = threadIdx.x & 31;
  uint64_t sm = 0, ss = 0;
  for (int look = t - 1;; look -= 32) {
    const int idx = look - lane;
    uint64_t v = idx >= 0 ? ld_acquire(status + idx) : kInclusive;
    while (__any_sync(kFull, (v >> 62) == 0)) {
      if ((v >> 62) == 0) v = ld_acquire(status + idx);
    }
    const unsigned incl = __ballot_sync(kFull, (v >> 62) == 2);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    uint64_t vm = lane <= stop ? (v >> 31) & kCount : 0;
    uint64_t vs = lane <= stop ? v & kCount : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      vm += __shfl_xor_sync(kFull, vm, o);
      vs += __shfl_xor_sync(kFull, vs, o);
    }
    sm += vm;
    ss += vs;
    if (incl) break;
  }
  *em = sm;
  *es = ss;
}

__global__ void __launch_bounds__(kThreads) match_rows_kernel(
    const uint8_t* __restrict__ pads, const int32_t* __restrict__ n_reals,
    const int32_t* __restrict__ los, const int32_t* __restrict__ his,
    const int32_t* __restrict__ orders, const uint8_t* __restrict__ oks,
    unsigned* ticket, uint64_t* status, int32_t* __restrict__ matched,
    uint8_t* __restrict__ m_len, int32_t* __restrict__ sat,
    int32_t* __restrict__ offsets, int n, int bpw, int vn) {
  __shared__ int s_ticket;
  __shared__ int s_bc[kBlockSlots];
  __shared__ uint8_t s_bl[kBlockSlots], s_key[kBlockSlots];
  // per (pass, warp): its matched and saturated slots, then the rows
  // before it in the block
  __shared__ int cnt_m[kGroups], cnt_s[kGroups];
  __shared__ uint64_t base[2];
  if (threadIdx.x == 0) s_ticket = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int t = s_ticket;
  const int b = t / bpw;
  const int s0 = (t - b * bpw) * kBlockSlots;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  Window w;
  w.row = pads + (size_t)b * n;
  w.order = orders + (size_t)b * n;
  w.n = (uint32_t)n;
  w.n_real = __ldg(n_reals + b);
  const int lo = __ldg(los + b), hi = __ldg(his + b);
  const uint8_t* ok_row = oks + (size_t)b * n;
#pragma unroll 1
  for (int q = 0; q < kPasses; q++) {
    const int j = q * kThreads + threadIdx.x;
    w.s = s0 + j;
    int key = 2, bc = 0, bl = 0;
    if (w.s < n) {
      w.p = __ldg(w.order + w.s);
      w.ok = __ldg(ok_row + w.s) & ((1 << kWidth) - 1);
      bool s_any = false;
#pragma unroll 1
      for (int r = 1; r <= kWidth; r++) {
        int lcp;
        const int cand = candidate(w, r, &lcp);
        if (cand < 0) continue;
        const int mlen = lcp >= 4 ? lcp : (vn && lcp == 3 ? 3 : 0);
        s_any |= lcp == kWindow ||
                 (int)((uint32_t)w.p + (uint32_t)lcp) >= w.n_real;
        if (mlen > bl) {
          bl = mlen;
          bc = cand;
        }
      }
      const bool payload = w.p >= lo && w.p < hi;
      key = payload && s_any ? 0 : (payload && bl > 0 ? 1 : 2);
    }
    s_bc[j] = bc;
    s_bl[j] = (uint8_t)bl;
    s_key[j] = (uint8_t)key;
    const unsigned bm = __ballot_sync(kFull, key == 1);
    const unsigned bs = __ballot_sync(kFull, key == 0);
    if (lane == 0) {
      cnt_m[q * kWarps + warp] = __popc(bm);
      cnt_s[q * kWarps + warp] = __popc(bs);
    }
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive prefix over the groups in slot order, two a lane
    const int m0 = cnt_m[2 * lane], m1 = cnt_m[2 * lane + 1];
    const int z0 = cnt_s[2 * lane], z1 = cnt_s[2 * lane + 1];
    int im = m0 + m1, is = z0 + z1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int xm = __shfl_up_sync(kFull, im, o);
      const int xs = __shfl_up_sync(kFull, is, o);
      if (lane >= o) {
        im += xm;
        is += xs;
      }
    }
    const uint64_t tm = (uint32_t)__shfl_sync(kFull, im, 31);
    const uint64_t ts = (uint32_t)__shfl_sync(kFull, is, 31);
    cnt_m[2 * lane] = im - m0 - m1;
    cnt_m[2 * lane + 1] = im - m1;
    cnt_s[2 * lane] = is - z0 - z1;
    cnt_s[2 * lane + 1] = is - z1;
    uint64_t em = 0, es = 0;
    if (t > 0) {
      if (lane == 0) st_release(status + t, kAggregate | tm << 31 | ts);
      look_back(status, t, &em, &es);
    }
    if (lane == 0) {
      st_release(status + t, kInclusive | ((em + tm) << 31 | (es + ts)));
      base[0] = em;
      base[1] = es;
      if (s0 + kBlockSlots >= n) {
        offsets[2 * (b + 1)] = (int32_t)(em + tm);
        offsets[2 * (b + 1) + 1] = (int32_t)(es + ts);
      }
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int q = 0; q < kPasses; q++) {
    const int j = q * kThreads + threadIdx.x;
    const int key = s_key[j];
    const unsigned bm = __ballot_sync(kFull, key == 1);
    const unsigned bs = __ballot_sync(kFull, key == 0);
    if (key == 1) {
      const size_t at = base[0] + cnt_m[q * kWarps + warp] +
                        __popc(bm & below);
      reinterpret_cast<int2*>(matched)[at] = make_int2(s0 + j, s_bc[j]);
      m_len[at] = s_bl[j];
    } else if (key == 0) {
      int32_t* row = sat + (base[1] + cnt_s[q * kWarps + warp] +
                            __popc(bs & below)) * kSatCols;
      w.s = s0 + j;
      w.p = __ldg(w.order + w.s);
      w.ok = __ldg(ok_row + w.s) & ((1 << kWidth) - 1);
      row[0] = w.s;
#pragma unroll 1
      for (int r = 1; r <= kWidth; r++) {
        int lcp;
        row[r] = candidate(w, r, &lcp);
        row[kWidth + r] = lcp;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success). pads (nb, n) uint8, 8-byte aligned with
// n a multiple of 8; n_reals, los, his (nb) int32; orders (nb, n) int32;
// oks (nb, n) uint8; scratch ticket (1 uint32) and status (nb * ceil(n /
// kBlockSlots) uint64), zeroed; outputs matched (nb * n, 2) int32 (slot,
// best_cand), m_len (nb * n) uint8, sat (nb * n, 9) int32 (slot, 4 cands,
// 4 lcps), each filled from row 0 in (window, slot) order, and offsets
// (nb + 1, 2) int32 (matched, saturated rows before each window), row 0
// zeroed. nb * n < 2**31. vn selects the 3-byte match unit.
int lzt_match_rows(const void* pads, const void* n_reals, const void* los,
                   const void* his, const void* orders, const void* oks,
                   void* ticket, void* status, void* matched, void* m_len,
                   void* sat, void* offsets, int nb, int n, int vn,
                   void* stream) {
  if (nb <= 0 || n <= 0) return (int)cudaGetLastError();
  const int bpw = (n + kBlockSlots - 1) / kBlockSlots;
  match_rows_kernel<<<nb * bpw, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pads, (const int32_t*)n_reals, (const int32_t*)los,
      (const int32_t*)his, (const int32_t*)orders, (const uint8_t*)oks,
      (unsigned*)ticket, (uint64_t*)status, (int32_t*)matched,
      (uint8_t*)m_len, (int32_t*)sat, (int32_t*)offsets, n, bpw, vn);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes per thread and resident blocks per SM of
// the kernel into attrs[0..2]; returns cudaGetLastError().
int lzt_match_rows_attrs(void* attrs) {
  cudaFuncAttributes fa;
  cudaError_t rc = cudaFuncGetAttributes(&fa, (const void*)match_rows_kernel);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, (const void*)match_rows_kernel, kThreads, 0);
  if (rc != cudaSuccess) return (int)rc;
  int* a = (int*)attrs;
  a[0] = fa.numRegs;
  a[1] = (int)fa.localSizeBytes;
  a[2] = blocks;
  return 0;
}

}  // extern "C"
