// Grouped match finding for the LZFSE container encoder's device frontend,
// written by hand for Hopper (sm_90a). Plain C interface, loaded with ctypes
// (lzfse_rust_tpu_torch/runtime/cuda_lib.py).
//
// Replaces lzfse_rust_tpu/ops/match_find_tpu.py:160-205,
// find_matches_grouped_compact (_grouped_compact_one over _grouped_core,
// _windows_fwd and _first_mismatch): XLA code under jax.jit on the TPU, no
// Pallas. It computes what _grouped_compact_one computes, not how: the TPU
// version materialises a (N, 64) byte window for every position and gathers
// another (N, 64) in grouped order, 128 bytes of device memory per position
// before the first compare, where the inputs are 6 bytes per position. Here
// each thread reads the source bytes where they lie.
//
// What bounds it on this card: bytes. Per slot the inputs are read once
// (pads 1 byte, orders 4, oks 1) and the outputs written once (keys 1,
// best_cand 4, best_len 4, cands 16, lcps 16): 47 bytes a slot, about 14 ns
// per 1,000 slots at 3.35 TB/s. The operations (a few 8-byte XORs per
// candidate and a dozen for the arbitration) are far below the 32-bit rate.
// The design keeps device-memory traffic near those 47 bytes:
//   * one thread per slot s of window b (grid: slots x windows, the ragged
//     tail masked), so every input and output is read or written by
//     neighbouring threads at neighbouring addresses;
//   * the 64-byte window at p = orders[b, s] is loaded once, as nine aligned
//     8-byte words joined by shifts (an unaligned 8-byte load is undefined),
//     and kept in registers for all four candidates;
//   * a candidate c = orders[b, s - r] is compared word by word, loading a
//     word only when every earlier one was equal, and the first differing
//     byte of a word is __ffsll(x) - 1 >> 3 on little-endian words. The
//     source row (at most 1 MiB) is read in random order, but a window's
//     CUDA blocks run together (blockIdx.x is the fast grid axis), so its
//     row stays in the 50 MB L2 and device memory sees it about once.
//   * a window is loaded only for a slot with a candidate bit set. The host
//     grouping (tl_match_group) sets bits only for probed positions
//     (p <= n_real - 4) and the encoder keeps n_real + 128 <= N, so every
//     compared window lies inside the row. Any other window wraps at N, as
//     the reference's rolled windows do, through a byte-wise path.
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
//   * a slot is payload when lo <= p < hi: key 0 when payload and sat, 1
//     when payload and (best_len > 0 or sat), else 2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 64;    // bytes compared per LCP
constexpr int kWidth = 4;      // candidates per slot (HASH_WIDTH)
constexpr int kThreads = 256;  // slots per CUDA block
constexpr int kMaxGridY = 65535;

// bytes [sh/8, sh/8 + 8) of the 16 bytes lo | hi << 64
__device__ __forceinline__ uint64_t join(uint64_t lo, uint64_t hi, int sh) {
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
}

// The window at byte p of an 8-byte aligned row, p + 72 <= n: nine aligned
// words, joined by shifts.
__device__ __forceinline__ void window_fast(const uint64_t* row64, uint32_t p,
                                            uint64_t (&w)[8]) {
  const uint64_t* q = row64 + (p >> 3);
  const int sh = (p & 7) * 8;
  uint64_t lo = __ldg(q);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const uint64_t hi = __ldg(q + k + 1);
    w[k] = join(lo, hi, sh);
    lo = hi;
  }
}

// The window at byte p < n, each byte (p + i) mod n: the rolled windows of
// the reference at a row's end.
__device__ void window_wrap(const uint8_t* row, uint32_t p, uint32_t n,
                            uint64_t (&w)[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t x = 0;
    for (int j = 0; j < 8; j++) {
      x |= (uint64_t)row[(p + 8 * k + j) % n] << (8 * j);
    }
    w[k] = x;
  }
}

__device__ __forceinline__ int first_byte(uint64_t x) {
  return (__ffsll((long long)x) - 1) >> 3;
}

// First differing byte of window a and the window at byte c of the row
// (c + 72 <= n), loading c's words only while they are equal; kWindow if
// none differs.
__device__ __forceinline__ int mismatch_fast(const uint64_t (&a)[8],
                                             const uint64_t* row64,
                                             uint32_t c) {
  const uint64_t* q = row64 + (c >> 3);
  const int sh = (c & 7) * 8;
  uint64_t lo = __ldg(q);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const uint64_t hi = __ldg(q + k + 1);
    const uint64_t x = join(lo, hi, sh) ^ a[k];
    if (x) return 8 * k + first_byte(x);
    lo = hi;
  }
  return kWindow;
}

__device__ int mismatch_words(const uint64_t (&a)[8], const uint64_t (&b)[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const uint64_t x = a[k] ^ b[k];
    if (x) return 8 * k + first_byte(x);
  }
  return kWindow;
}

// One thread per slot s of window b0 + blockIdx.y.
__global__ void __launch_bounds__(kThreads) match_grouped_kernel(
    const uint8_t* __restrict__ pads, const int32_t* __restrict__ n_reals,
    const int32_t* __restrict__ los, const int32_t* __restrict__ his,
    const int32_t* __restrict__ orders, const uint8_t* __restrict__ oks,
    uint8_t* __restrict__ keys, int32_t* __restrict__ best_cand,
    int32_t* __restrict__ best_len, int32_t* __restrict__ cands,
    int32_t* __restrict__ lcps, int b0, int n, int vn) {
  const int b = b0 + blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n) return;
  const size_t at = (size_t)b * n + s;
  const uint8_t* row = pads + (size_t)b * n;
  const uint64_t* row64 = reinterpret_cast<const uint64_t*>(row);
  const int32_t* order = orders + (size_t)b * n;
  const uint32_t un = (uint32_t)n;
  const int p = order[s];
  const int ok = oks[at] & ((1 << kWidth) - 1);
  const int n_real = n_reals[b];
  const int cap = (int)((uint32_t)n_real - (uint32_t)p);
  uint64_t a[8];
  if (ok) {
    const uint32_t up = (uint32_t)p % un;
    if (up + 72u <= un) {
      window_fast(row64, up, a);
    } else {
      window_wrap(row, up, un, a);
    }
  }
  int bl = 0, bc = 0;
  bool sat = false;
#pragma unroll
  for (int r = 1; r <= kWidth; r++) {
    int cand = -1, lcp = 0;
    if ((ok >> (r - 1)) & 1) {
      cand = order[s >= r ? s - r : s - r + n];
      const uint32_t uc = (uint32_t)cand % un;
      int m;
      if (uc + 72u <= un) {
        m = mismatch_fast(a, row64, uc);
      } else {
        uint64_t w[8];
        window_wrap(row, uc, un, w);
        m = mismatch_words(a, w);
      }
      lcp = min(max(m, 0), cap);
    }
    const size_t col = ((size_t)b * kWidth + (r - 1)) * n + s;
    cands[col] = cand;
    lcps[col] = lcp;
    const bool okc = cand >= 0;
    int mlen = lcp >= 4 ? lcp : (vn && lcp == 3 ? 3 : 0);
    if (!okc) mlen = 0;
    sat |= okc && (lcp == kWindow ||
                   (int)((uint32_t)p + (uint32_t)lcp) >= n_real);
    if (mlen > bl) {
      bl = mlen;
      bc = cand;
    }
  }
  const bool payload = p >= los[b] && p < his[b];
  sat = sat && payload;
  const bool matched = payload && (bl > 0 || sat);
  keys[at] = sat ? 0 : (matched ? 1 : 2);
  best_cand[at] = bc;
  best_len[at] = bl;
}

}  // namespace

extern "C" {

// Launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success). pads (nb, n) uint8, 8-byte aligned with
// n a multiple of 8; n_reals, los, his (nb) int32; orders (nb, n) int32
// holding positions in [0, n); oks (nb, n) uint8; outputs keys (nb, n)
// uint8, best_cand and best_len (nb, n) int32, cands and lcps (nb, 4, n)
// int32. vn selects the 3-byte match unit.
int lzt_match_grouped(const void* pads, const void* n_reals, const void* los,
                      const void* his, const void* orders, const void* oks,
                      void* keys, void* best_cand, void* best_len,
                      void* cands, void* lcps, int nb, int n, int vn,
                      void* stream) {
  for (int b0 = 0; b0 < nb; b0 += kMaxGridY) {
    const int rows = nb - b0 < kMaxGridY ? nb - b0 : kMaxGridY;
    const dim3 grid((n + kThreads - 1) / kThreads, rows);
    match_grouped_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)pads, (const int32_t*)n_reals, (const int32_t*)los,
        (const int32_t*)his, (const int32_t*)orders, (const uint8_t*)oks,
        (uint8_t*)keys, (int32_t*)best_cand, (int32_t*)best_len,
        (int32_t*)cands, (int32_t*)lcps, b0, n, vn);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
