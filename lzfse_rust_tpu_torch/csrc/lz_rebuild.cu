// LZ77 output reconstruction by pointer doubling for the LZFSE container
// decoder, written by hand for Hopper (sm_90a). Plain C interface, loaded
// with ctypes (lzfse_rust_tpu_torch/runtime/cuda_lib.py).
//
// Replaces lzfse_rust_tpu/ops/lz_rebuild.py:50-107, lz_rebuild_batch: XLA
// code under jax.jit on the TPU, no Pallas. It computes what
// lz_rebuild_batch computes per container, not how: the TPU version pads
// every container to the batch's largest output and keeps about ten (B,
// n_out) int32 maps; at serving size (256 x 4 MiB) each map is 4 GiB. Here
// the containers lie end to end (their rows, literal pools and outputs each
// a segment of one flat array, as ops/lz_rebuild.py lz_rebuild_flat takes
// them) and the only map is one int32 per output byte.
//
// What bounds it on this card: bytes, and the dependent rounds. The inputs
// (12 bytes a row, the literal pool, the offsets) are read and the output
// (1 byte a position) written once: about 0.34 GB for the serving batch,
// 0.1 ms at 3.35 TB/s. The rounds add 12 bytes a still-unresolved position
// each (two reads and a write of the map); a d = 1 run of 4 MiB needs 22.
// The design, simple first:
//   * prefix sums of l + m and of l per container (span_end, lit_end) come
//     from torch (ops/lz_rebuild.py row_prefix), clamped to int32;
//   * lzr_container and lzr_rows compute ok = lit_ok & (total == n_raw) per
//     container, then clear it for any row with m > 0 and d <= 0 or d >
//     match_start (one thread per container, then per row);
//   * lzr_init, one thread per output position: the container by binary
//     search over out_off, the owning row (first with span_end > p, capped
//     at the container's last) by binary search over span_end; a literal
//     position (or position 0 pointing at itself) stores -(literal index +
//     1), any other its parent pos - max(d, 1) (clipped to the segment) as a
//     flat position;
//   * lzr_jump, one launch per round: root[i] = root[root[i]] in place. A
//     value read may already be this round's, but every value is an
//     ancestor, so k rounds resolve every chain of up to 2^k links, as the
//     synchronous composition does. A round that leaves nothing unresolved
//     clears its flag, and the later rounds return at once;
//   * lzr_gather: out = pool[literal index] for p < n_raw, else 0.
// One thread per position (or row), int32 throughout; a container, row or
// literal index that a malformed input would put out of range is clamped
// into the container's own range, so no input reads outside its arrays.
// Not done yet (later work): one warp per row, shared-memory copies of
// short-distance runs.
//
// Semantics that must hold exactly (lz_rebuild_flat's, which are
// lz_rebuild_batch's per container): span_start = span_end - l - m,
// match_start = span_end - m, lit_idx = lit_end - l + (p - span_start)
// clipped to [0, L - 1] (int32 wrap-around), an empty pool gives 0, rows
// absent (R = 0) give a zero row, positions p >= n_raw give 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride: 16 blocks a SM

__host__ __device__ inline int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

// int32 arithmetic that wraps, without signed-overflow UB
__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int add32(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

// The last c in [0, n) with off[c] <= i (off has n + 1 entries, off[0] = 0
// <= i < off[n]); clamped into [0, n) for offsets that break that.
__device__ __forceinline__ int owner(const int* __restrict__ off, int n,
                                     int i) {
  int lo = 0, hi = n + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(off + mid) > i) hi = mid; else lo = mid + 1;
  }
  const int c = lo - 1;
  return c < 0 ? 0 : (c >= n ? n - 1 : c);
}

__global__ void lzr_container(const int* __restrict__ lit_off,
                              const int* __restrict__ row_off,
                              const int* __restrict__ n_raw,
                              const int* __restrict__ span_end,
                              const int* __restrict__ lit_end,
                              bool* __restrict__ ok, int nb) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nb) return;
  const int r1 = row_off[c + 1];
  const bool has = r1 > row_off[c];
  const int total = has ? span_end[r1 - 1] : 0;
  const int lits = has ? lit_end[r1 - 1] : 0;
  ok[c] = lits <= sub32(lit_off[c + 1], lit_off[c]) && total == n_raw[c];
}

__global__ void lzr_rows(const int* __restrict__ rows,
                         const int* __restrict__ row_off,
                         const int* __restrict__ span_end,
                         bool* __restrict__ ok, int nb, int n_rows) {
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n_rows;
       g += gridDim.x * blockDim.x) {
    const int m = rows[3 * (size_t)g + 1];
    const int d = rows[3 * (size_t)g + 2];
    if (m > 0 && (d <= 0 || d > sub32(span_end[g], m))) {
      ok[owner(row_off, nb, g)] = false;
    }
  }
}

__global__ void lzr_init(const int* __restrict__ lit_off,
                         const int* __restrict__ rows,
                         const int* __restrict__ row_off,
                         const int* __restrict__ out_off,
                         const int* __restrict__ span_end,
                         const int* __restrict__ lit_end,
                         int* __restrict__ root, int nb, int n_out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_out;
       i += gridDim.x * blockDim.x) {
    const int c = owner(out_off, nb, i);
    const int seg = __ldg(out_off + c);
    const int p = i - seg;
    const int r0 = __ldg(row_off + c);
    const int n_r = __ldg(row_off + c + 1) - r0;
    int l = 0, m = 0, d = 0, se = 0, le = 0;
    if (n_r > 0) {
      int lo = 0, hi = n_r;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(span_end + r0 + mid) > p) hi = mid; else lo = mid + 1;
      }
      const int g = r0 + (lo < n_r - 1 ? lo : n_r - 1);
      l = rows[3 * (size_t)g];
      m = rows[3 * (size_t)g + 1];
      d = rows[3 * (size_t)g + 2];
      se = span_end[g];
      le = lit_end[g];
    }
    const bool is_lit = p < sub32(se, m);
    const int L = __ldg(lit_off + c + 1) - __ldg(lit_off + c);
    int li = add32(sub32(le, l), sub32(p, sub32(sub32(se, l), m)));
    li = min(li, L - 1);
    li = max(li, 0);
    int parent = p - max(d, 1);
    parent = max(parent, 0);
    parent = min(parent, __ldg(out_off + c + 1) - seg - 1);
    root[i] = (is_lit || parent == p) ? -(li + 1) : seg + parent;
  }
}

__global__ void lzr_jump(int* root, int* flags, int k, int n_out) {
  if (k > 0 && *((volatile int*)(flags + k - 1)) == 0) return;
  bool more = false;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_out;
       i += gridDim.x * blockDim.x) {
    const int v = __ldcg(root + i);
    if (v >= 0) {
      const int w = __ldcg(root + v);
      __stcg(root + i, w);
      more |= w >= 0;
    }
  }
  if (__syncthreads_or(more) && threadIdx.x == 0) flags[k] = 1;
}

__global__ void lzr_gather(const uint8_t* __restrict__ literals,
                           const int* __restrict__ lit_off,
                           const int* __restrict__ n_raw,
                           const int* __restrict__ out_off,
                           const int* __restrict__ root,
                           uint8_t* __restrict__ out, int nb, int n_out,
                           int n_lits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_out;
       i += gridDim.x * blockDim.x) {
    const int c = owner(out_off, nb, i);
    const int p = i - __ldg(out_off + c);
    const int a = __ldg(lit_off + c);
    const int L = __ldg(lit_off + c + 1) - a;
    uint8_t v = 0;
    if (L > 0 && p < __ldg(n_raw + c)) {
      // a resolved entry is -(literal index + 1), the index within [0, L)
      int at = a + (-root[i] - 1);
      at = min(max(at, 0), n_lits - 1);
      v = literals[at];
    }
    out[i] = v;
  }
}

}  // namespace

extern "C" {

// Launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success). literals (n_lits) uint8; lit_off,
// row_off, out_off (nb + 1) and n_raw (nb) int32; rows (n_rows, 3) int32;
// span_end, lit_end (n_rows) int32 from row_prefix; scratch root (n_out)
// int32 and flags (rounds) int32, zeroed; outputs out (n_out) uint8 and ok
// (nb) bool. rounds >= bit_length(longest segment - 1).
int lzt_lz_rebuild(const void* literals, const void* lit_off,
                   const void* rows, const void* row_off, const void* n_raw,
                   const void* out_off, const void* span_end,
                   const void* lit_end, void* root, void* flags, void* out,
                   void* ok, int nb, int n_rows, int n_out, int n_lits,
                   int rounds, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* lo = (const int*)lit_off;
  const int* ro = (const int*)row_off;
  const int* oo = (const int*)out_off;
  const int* se = (const int*)span_end;
  const int* le = (const int*)lit_end;
  const int* rw = (const int*)rows;
  const int* nr = (const int*)n_raw;
  if (nb <= 0) return (int)cudaGetLastError();
  lzr_container<<<(nb + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      lo, ro, nr, se, le, (bool*)ok, nb);
  if (n_rows > 0) {
    lzr_rows<<<blocks_for(n_rows), kThreads, 0, s>>>(rw, ro, se, (bool*)ok,
                                                     nb, n_rows);
  }
  if (n_out > 0) {
    const int grid = blocks_for(n_out);
    lzr_init<<<grid, kThreads, 0, s>>>(lo, rw, ro, oo, se, le, (int*)root, nb,
                                       n_out);
    for (int k = 0; k < rounds; k++) {
      lzr_jump<<<grid, kThreads, 0, s>>>((int*)root, (int*)flags, k, n_out);
    }
    lzr_gather<<<grid, kThreads, 0, s>>>(
        (const uint8_t*)literals, lo, nr, oo, (const int*)root,
        (uint8_t*)out, nb, n_out, n_lits > 0 ? n_lits : 1);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
