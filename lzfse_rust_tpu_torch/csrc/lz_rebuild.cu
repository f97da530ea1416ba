// LZ77 output reconstruction for the LZFSE container decoder, written by
// hand for Hopper (sm_90a). Plain C interface, loaded with ctypes
// (lzfse_rust_tpu_torch/runtime/cuda_lib.py).
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
// What bounds it on this card: the dependent chains, not the bytes. The
// inputs (16 bytes a row, the literal pool, the offsets) are read and the
// output (1 byte a position) written once: about 0.3 GB for the serving
// batch, 0.1 ms at 3.35 TB/s. But a match byte copies a byte that may
// itself be a copy: on the serving batch a byte's chain of copies is up to
// 2,735 rows long (mean 75), and folding the links inside one row shortens
// it by less than 1%, since text copies copies of other rows. So the
// rounds of pointer jumping stay; the design cuts what each costs:
//   * lzr_container and lzr_rows compute ok = lit_ok & (total == n_raw) per
//     container, then clear it for any row with m > 0 and d <= 0 or d >
//     match_start (one thread per container, then per row);
//   * lzr_tile, one CUDA block per tile of kTile output positions, no
//     search per byte: one warp-wide search (32 probes a step) each for the
//     tile's first and last row (over row_start, each row's first position,
//     from torch) and container (over out_off), four warps at once; the
//     rows and containers that start inside the tile scatter their index
//     into shared memory and a block-wide max-scan gives every position its
//     row and container. Each position stores a literal code (-(flat
//     literal index + 1)), a zero code (positions past n_raw or of an empty
//     pool, whose byte is 0), or its parent. A match byte at offset k of a
//     row with d' = max(d, 1) stores its chain's first exit below the match
//     start, match_start - d' + (k mod d'), not p - d' (folded), wherever
//     every position from the match start up to p belongs to the same row,
//     so the root is the same. Links that stay inside the tile are then
//     resolved in shared memory (pointer jumping there); the tile counts
//     the positions still pointing before it (open);
//   * lzr_round, one launch per round: root[i] = root[root[i]] in place for
//     the open positions of the tiles that have any, 16 bytes of the map a
//     thread; each tile counts what stays open, and a round with nothing
//     left returns at once. A value read may already be this round's, but
//     every value is an ancestor, so k rounds resolve every chain of up to
//     2^k links, as the synchronous composition does. A fixed grid walks
//     the tiles (one block per tile cost 0.31 ms a launch, even for a round
//     with nothing left). On the serving batch 80% of positions are still
//     open after the tiles, so a worklist of them was tried first: its
//     reads and writes of the list cost more than sweeping the open tiles
//     (4.8 against about 3.5 ms of rounds);
//   * lzr_out: 16 positions a thread, the byte of each code, one 16-byte
//     store.
// int32 throughout; a container, row or literal index that a malformed
// input would put out of range is clamped into the container's own range,
// so no input reads outside its arrays.
//
// Semantics that must hold exactly (lz_rebuild_flat's, which are
// lz_rebuild_batch's per container): a position's row is the container's
// last row whose row_start is at or before it (with l + m >= 0 on every
// row, the first row with span_end > p, capped at the last row);
// span_start = span_end - l - m, match_start = span_end - m, lit_idx =
// lit_end - l + (p - span_start) clipped to [0, L - 1] (int32 wrap-around),
// parent = p - max(d, 1) clipped to the segment, an empty pool gives 0,
// rows absent (R = 0) give a zero row, positions p >= n_raw give 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride: 16 blocks a SM
constexpr int kTile = 4096;           // output positions per lzr_tile block
constexpr int kTileThreads = 1024;
constexpr int kPer = kTile / kTileThreads;  // 4 positions a thread
static_assert(kPer == 4, "lzr_tile moves a thread's positions as one int4");
constexpr int kRoundBlocks = 132 * 2;  // lzr_round: 2 blocks an SM
constexpr int kZero = INT32_MIN;      // the code of a position whose byte is 0

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

// The last k in [0, n) with a[k] <= x, or -1 (a non-decreasing).
__device__ __forceinline__ int last_le(const int* __restrict__ a, int n,
                                       long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) > x) hi = mid; else lo = mid + 1;
  }
  return lo - 1;
}

// The last c in [0, n) with off[c] <= i (off has n + 1 entries, off[0] = 0
// <= i < off[n]); clamped into [0, n) for offsets that break that.
__device__ __forceinline__ int owner(const int* __restrict__ off, int n,
                                     long long i) {
  const int c = last_le(off, n + 1, i);
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

// Inclusive max-scan of a[kTile] in shared memory, kPer entries a thread;
// every thread of the block calls it. warp_max has kTileThreads / 32 ints.
__device__ __forceinline__ void block_max_scan(int* a, int* warp_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* mine = a + threadIdx.x * kPer;
  int v[kPer];
  int run = INT32_MIN;
#pragma unroll
  for (int k = 0; k < kPer; k++) {
    run = max(run, mine[k]);
    v[k] = run;
  }
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = max(incl, x);
  }
  if (lane == 31) warp_max[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kTileThreads / 32 ? warp_max[lane] : INT32_MIN;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = max(w, x);
    }
    if (lane < kTileThreads / 32) warp_max[lane] = w;
  }
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = INT32_MIN;
  if (warp > 0) before = max(before, warp_max[warp - 1]);
#pragma unroll
  for (int k = 0; k < kPer; k++) mine[k] = max(v[k], before);
  __syncthreads();
}

// Exclusive sum over the block of each thread's n; returns it and sets
// *total. warp_sum has kTileThreads / 32 ints.
__device__ __forceinline__ int block_excl_sum(int n, int* warp_sum,
                                              int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  __syncthreads();
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kTileThreads / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += x;
    }
    if (lane < kTileThreads / 32) warp_sum[lane] = w;
  }
  __syncthreads();
  *total = warp_sum[kTileThreads / 32 - 1];
  return incl - n + (warp > 0 ? warp_sum[warp - 1] : 0);
}

// The last k in [0, n) with a[k] <= x, or -1 (a non-decreasing), found
// by one whole warp: 32 probes a step, so a step cuts the range 33-fold.
__device__ __forceinline__ int warp_last_le(const int* __restrict__ a, int n,
                                            long long x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // a[lo - 1] <= x (or lo = 0), a[hi] > x (or hi = n)
  while (hi - lo > 32) {
    const int at = lo + (int)((long long)(lane + 1) * (hi - lo) / 33);
    const int k = __popc(__ballot_sync(0xffffffffu, __ldg(a + at) <= x));
    const int below = __shfl_sync(0xffffffffu, at, k > 0 ? k - 1 : 0);
    const int above = __shfl_sync(0xffffffffu, at, k < 32 ? k : 31);
    if (k > 0) lo = below + 1;
    if (k < 32) hi = above;
  }
  const bool le = lo + lane < hi && __ldg(a + lo + lane) <= x;
  return lo + __popc(__ballot_sync(0xffffffffu, le)) - 1;
}

__global__ void __launch_bounds__(kTileThreads) lzr_tile(
    const int* __restrict__ lit_off, const int* __restrict__ rows,
    const int* __restrict__ row_off, const int* __restrict__ out_off,
    const int* __restrict__ n_raw, const int* __restrict__ span_end,
    const int* __restrict__ lit_end, const int* __restrict__ row_start,
    int* __restrict__ root, int* __restrict__ tile_open,
    int* __restrict__ counts, int nb, int n_rows, int n_out, int n_lits) {
  __shared__ __align__(16) int own_r[kTile];
  __shared__ __align__(16) int own_c[kTile];
  __shared__ int bounds[4];
  __shared__ int scratch[kTileThreads / 32];
  const long long t0 = (long long)blockIdx.x * kTile;
  const int n_here = (int)min((long long)kTile, n_out - t0);
  const int warp = threadIdx.x >> 5;
  // the tile's first and last row and container, one warp each
  if (warp < 4) {
    const long long x = warp & 1 ? t0 + n_here - 1 : t0;
    int v = warp < 2 ? warp_last_le(row_start, n_rows, x)
                     : warp_last_le(out_off, nb + 1, x);
    if (warp >= 2) v = v < 0 ? 0 : (v >= nb ? nb - 1 : v);
    if ((threadIdx.x & 31) == 0) bounds[warp] = v;
  }
  for (int j = threadIdx.x; j < kTile; j += kTileThreads) {
    own_r[j] = -1;
    own_c[j] = -1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    own_r[0] = bounds[0];
    own_c[0] = bounds[2];
  }
  __syncthreads();
  // rows and containers that start inside the tile mark their first
  // position (empty ones share it: the last wins)
  for (int g = bounds[0] + 1 + threadIdx.x; g <= bounds[1];
       g += kTileThreads) {
    const long long j = __ldg(row_start + g) - t0;
    if (j >= 0 && j < kTile) atomicMax(own_r + j, g);
  }
  for (int c = bounds[2] + 1 + threadIdx.x; c <= bounds[3];
       c += kTileThreads) {
    const long long j = __ldg(out_off + c) - t0;
    if (j >= 0 && j < kTile) atomicMax(own_c + j, c);
  }
  __syncthreads();
  block_max_scan(own_r, scratch);
  block_max_scan(own_c, scratch);

  // each position's code, written over its own entry of own_c (a thread
  // reads and writes only its own positions' entries)
  int* res = own_c;
  const int j0 = threadIdx.x * kPer;
#pragma unroll
  for (int k = 0; k < kPer; k++) {
    const int j = j0 + k;
    if (j >= n_here) {
      res[j] = kZero;
      continue;
    }
    const int c = own_c[j];
    const int g = own_r[j];
    const int seg = __ldg(out_off + c);
    const int p = (int)(t0 + j - seg);
    const int a = __ldg(lit_off + c);
    const int L = __ldg(lit_off + c + 1) - a;
    if (!(L > 0 && p < __ldg(n_raw + c))) {
      res[j] = kZero;
      continue;
    }
    int l = 0, m = 0, d = 0, se = 0, le = 0, os = 0;
    if (g >= __ldg(row_off + c) && g < __ldg(row_off + c + 1)) {
      l = __ldg(rows + 3 * (size_t)g);
      m = __ldg(rows + 3 * (size_t)g + 1);
      d = __ldg(rows + 3 * (size_t)g + 2);
      se = __ldg(span_end + g);
      le = __ldg(lit_end + g);
      os = __ldg(row_start + g) - seg;
    }
    const int ms = sub32(se, m);
    const bool is_lit = p < ms;
    int li = add32(sub32(le, l), sub32(p, sub32(sub32(se, l), m)));
    li = max(min(li, L - 1), 0);
    const int dd = max(d, 1);
    int parent;
    if (!is_lit && ms >= os && ms >= 0) {
      // every position in [ms, p] is a match byte of this row: the chain
      // leaves the row at its first exit below ms
      parent = max(ms - dd + (p - ms) % dd, 0);
    } else {
      parent = min(max(p - dd, 0), __ldg(out_off + c + 1) - seg - 1);
    }
    if (is_lit || parent == p) {
      long long at = (long long)a + li;
      at = at < 0 ? 0 : (at >= n_lits ? n_lits - 1 : at);
      res[j] = -(int)(at + 1);
    } else {
      res[j] = seg + parent;
    }
  }
  __syncthreads();
  // links inside the tile: pointer jumping in shared memory
  const int lo = (int)t0;
  while (true) {
    bool more = false;
#pragma unroll
    for (int k = 0; k < kPer; k++) {
      const int v = res[j0 + k];
      if (v >= lo) {
        const int w = res[v - lo];
        res[j0 + k] = w;
        more |= w >= lo;
      }
    }
    if (!__syncthreads_or(more)) break;
  }
  const int4 q = *reinterpret_cast<const int4*>(res + j0);
  const int code[kPer] = {q.x, q.y, q.z, q.w};
  if (j0 + kPer <= n_here) {
    *reinterpret_cast<int4*>(root + t0 + j0) = q;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; k++) {
      if (j0 + k < n_here) root[t0 + j0 + k] = code[k];
    }
  }
  // the positions still pointing before the tile
  int open = 0;
#pragma unroll
  for (int k = 0; k < kPer; k++) open += code[k] >= 0;
  int total;
  block_excl_sum(open, scratch, &total);
  if (threadIdx.x == 0) {
    tile_open[blockIdx.x] = total;
    if (total) atomicAdd(counts, total);
  }
}

// Round k: every position of a tile with open entries (open_in[tile] > 0)
// that still points at a parent jumps once, root[i] = root[root[i]] in
// place; open_out[tile] counts what stays open and counts[k + 1] adds it
// up. A fixed grid of blocks walks the tiles, so a round with nothing left
// costs one launch of kRoundBlocks blocks, and a resolved tile one read of
// its count.
__global__ void __launch_bounds__(kTileThreads) lzr_round(
    int* root, const int* __restrict__ open_in, int* __restrict__ open_out,
    int* counts, int k, int tiles, int n_out) {
  __shared__ int scratch[kTileThreads / 32];
  if (*((volatile int*)(counts + k)) == 0) return;
  const int j0 = threadIdx.x * kPer;
  int added = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if (open_in[tile] == 0) {
      if (threadIdx.x == 0) open_out[tile] = 0;
      continue;
    }
    const long long i0 = (long long)tile * kTile + j0;
    int v[kPer];
    const bool full = i0 + kPer <= n_out;
    if (full) {
      const int4 q = __ldcg(reinterpret_cast<const int4*>(root + i0));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
#pragma unroll
      for (int q = 0; q < kPer; q++) {
        v[q] = i0 + q < n_out ? __ldcg(root + i0 + q) : -1;
      }
    }
    int open = 0;
    bool moved = false;
#pragma unroll
    for (int q = 0; q < kPer; q++) {
      if (v[q] >= 0) {
        v[q] = __ldcg(root + v[q]);
        moved = true;
        open += v[q] >= 0;
      }
    }
    if (moved) {
      if (full) {
        __stcg(reinterpret_cast<int4*>(root + i0),
               make_int4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int q = 0; q < kPer; q++) {
          if (i0 + q < n_out) __stcg(root + i0 + q, v[q]);
        }
      }
    }
    int total;
    block_excl_sum(open, scratch, &total);
    if (threadIdx.x == 0) open_out[tile] = total;
    added += total;
  }
  if (threadIdx.x == 0 && added) atomicAdd(counts + k + 1, added);
}

__device__ __forceinline__ uint32_t byte_of(const uint8_t* __restrict__ lit,
                                            int v) {
  return v >= 0 || v == kZero ? 0u : (uint32_t)__ldg(lit + (-v - 1));
}

// 16 positions a thread, one 16-byte store (the tail byte by byte).
__global__ void lzr_out(const int* __restrict__ root,
                        const uint8_t* __restrict__ literals,
                        uint8_t* __restrict__ out, int n_out) {
  const long long n16 = n_out / 16;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < n16; q += (long long)gridDim.x * blockDim.x) {
    const int4* src = reinterpret_cast<const int4*>(root) + 4 * q;
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; h++) {
      const int4 v = __ldcs(src + h);
      w[h] = byte_of(literals, v.x) | byte_of(literals, v.y) << 8 |
             byte_of(literals, v.z) << 16 | byte_of(literals, v.w) << 24;
    }
    reinterpret_cast<uint4*>(out)[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  const long long tail = n16 * 16 + (long long)blockIdx.x * blockDim.x +
                         threadIdx.x;
  if (tail < n_out) out[tail] = (uint8_t)byte_of(literals, root[tail]);
}

}  // namespace

extern "C" {

// Launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success). literals (n_lits) uint8; lit_off,
// row_off, out_off (nb + 1) and n_raw (nb) int32; rows (n_rows, 3) int32;
// span_end, lit_end, row_start (n_rows) int32 from row_prefix; scratch
// root (n_out) int32, 16-byte aligned, tile_open (2 * ceil(n_out / kTile))
// int32 and counts (rounds + 1) int32, zeroed; outputs out (n_out) uint8,
// 16-byte aligned, and ok (nb) bool. rounds >= bit_length(longest segment - 1).
// counts[0] is the positions still pointing at a parent after the tiles,
// counts[k + 1] after round k.
int lzt_lz_rebuild(const void* literals, const void* lit_off,
                   const void* rows, const void* row_off, const void* n_raw,
                   const void* out_off, const void* span_end,
                   const void* lit_end, const void* row_start, void* root,
                   void* tile_open, void* counts, void* out, void* ok, int nb, int n_rows, int n_out,
                   int n_lits, int rounds, void* stream) {
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
    const int tiles = (int)(((long long)n_out + kTile - 1) / kTile);
    int* cnt = (int*)counts;
    int* open[2] = {(int*)tile_open, (int*)tile_open + tiles};
    lzr_tile<<<tiles, kTileThreads, 0, s>>>(
        lo, rw, ro, oo, nr, se, le, (const int*)row_start, (int*)root,
        open[0], cnt, nb, n_rows, n_out, n_lits > 0 ? n_lits : 1);
    const int grid = tiles < kRoundBlocks ? tiles : kRoundBlocks;
    for (int k = 0; k < rounds; k++) {
      lzr_round<<<grid, kTileThreads, 0, s>>>(
          (int*)root, open[k & 1], open[(k + 1) & 1], cnt, k, tiles, n_out);
    }
    lzr_out<<<blocks_for((n_out + 15) / 16), kThreads, 0, s>>>(
        (const int*)root, (const uint8_t*)literals, (uint8_t*)out, n_out);
  }
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes per thread and resident blocks per SM of
// kernel k (0 lzr_tile, 1 lzr_round, 2 lzr_out) into attrs[0..2]; returns
// cudaGetLastError().
int lzt_lz_rebuild_attrs(int k, void* attrs) {
  const void* fns[3] = {(const void*)lzr_tile, (const void*)lzr_round,
                        (const void*)lzr_out};
  const int threads[3] = {kTileThreads, kTileThreads, kThreads};
  if (k < 0 || k > 2) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t rc = cudaFuncGetAttributes(&fa, fns[k]);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[k],
                                                     threads[k], 0);
  if (rc != cudaSuccess) return (int)rc;
  int* a = (int*)attrs;
  a[0] = fa.numRegs;
  a[1] = (int)fa.localSizeBytes;
  a[2] = blocks;
  return 0;
}

}  // extern "C"
