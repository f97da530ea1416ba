// Probe kernels: the TPU tools' op-mix microbenchmarks, written by hand for
// Hopper (sm_90a). Plain C interface, loaded with ctypes
// (lzfse_rust_tpu_torch/runtime/cuda_lib.py).
//
// Replaces the three Pallas kernels of the JAX package's tools:
//   lzt_probe_step  -> timed.<locals>.go   (tools/microbench_step.py)
//   lzt_probe_chain -> run.<locals>.go     (tools/microbench_vpu.py)
//   lzt_probe_tput  -> run_tp.<locals>.go  (tools/microbench_vpu.py)
// Each computes the Pallas kernel's final tile bit for bit; the body is a
// template parameter (10 step, 11 chain and 2 throughput instantiations).
//
// Layout. Every op works along the 128 lanes of a row of x, and row rho
// reads only row rho mod 8 of tab and chunk. One warp holds one row, four
// lanes per thread (lane j = 4 * thread + q), so a TPU lane roll is a
// __shfl_sync of one register plus a rotate of the others, and the lanes
// of a 16-lane section are four neighbouring threads. CUDA block r holds
// table row r; its warps are the rows r, r + 8, ... (the TPU's vregs).
//
// Lookups. The TPU emulates a lookup into a wide table with 128-lane
// gathers and select trees (lookup_sec, lookup_chunks, chunk_word,
// chunk_word_128: 8 to 576 gathers a step). Their value is one load:
// tab[r, sec * tw + c * 128 + (idx & 127)] with sec = lane >> 4 and
// c = (idx >> 7) & (n_chunks - 1); chunk_word picks chunk half 0 or 1 by
// widx < 128. Here each is one load from shared memory: the row's table
// (G * tab_words words: 32 KB, 64 KB or 128 KB; dynamic shared memory
// above 48 KB) and its chunk row (8 KB). The pair step's 288 KB table is
// above the 227 KB a block can have and is read from device memory (L1 and
// L2).
//
// What bounds it: each row is one dependent chain of steps; a probe
// measures that chain's latency (chain bodies, lookup-only steps) or the
// issue rate of independent work (gathers_only, the tput bodies). Nothing
// is bound by bytes.
//
// Integer semantics are the TPU's int32: additions wrap (done on uint32),
// >> of an int32 is arithmetic, logical shifts act on uint32, and a left
// shift of a negative value is done on uint32. The funnel shift takes
// 32 bits of whi:wlo from bit sh in [0, 31] (__funnelshift_r), which is
// the TPU tool's guarded (wlo >> sh) | (sh == 0 ? 0 : whi << (32 - sh)).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kG = 8;             // sections per row
constexpr int kChunkWords = kG * 256;
constexpr int kOps = 32;          // chain ops per step
constexpr int kWidth = 8;         // independent ops per throughput step
constexpr int kSmemMax = 232448;  // bytes of shared memory a block may use
constexpr int kSmemDefault = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// lanes 4t .. 4t+3 of one 128-lane row
struct V {
  int32_t v[4];
};

// Keeping the compiler from folding ops that a probe must issue. An empty
// asm that claims to change each register stops the front end (NVVM) from
// folding one op into the next. It emits nothing, so ptxas below it still
// folds constants: 32 dependent x + 1 become x + 32. So the add takes its 1
// from a value known only at run time: every grid is 8 CUDA blocks, so
// gridDim.x >> 3 is 1 and blockIdx.x >> 3 is 0; repeated loads at idx and
// idx + 0 are not merged either. The 32 x ^ 3 of a step still cancel (an
// even count): that body measures the loop's own cost, as the TPU tool
// meant it to ("loop overhead: empty-ish body").
__device__ __forceinline__ void opaque(V& x) {
#pragma unroll
  for (int q = 0; q < 4; q++) asm volatile("" : "+r"(x.v[q]));
}

__device__ __forceinline__ int32_t run_time_one() { return (int32_t)(gridDim.x >> 3); }
__device__ __forceinline__ int32_t run_time_zero() { return (int32_t)(blockIdx.x >> 3); }

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// lane 4t + Q of jnp.roll(x, S) along the 128 lanes: x[(4t + Q - S) mod 128]
template <int S, int Q>
__device__ __forceinline__ int32_t roll_lane(const V& x, int t) {
  constexpr int d = Q - (S & 127);
  constexpr int qs = d & 3;                // source register
  constexpr int off = ((d - qs) / 4) & 31;  // source thread, relative
  if constexpr (off == 0) {
    return x.v[qs];
  } else {
    return __shfl_sync(kFull, x.v[qs], (t + off) & 31);
  }
}

template <int S>
__device__ __forceinline__ V roll(const V& x, int t) {
  return V{{roll_lane<S, 0>(x, t), roll_lane<S, 1>(x, t),
            roll_lane<S, 2>(x, t), roll_lane<S, 3>(x, t)}};
}

// masked_roll: roll by S, zero where lane & 15 < S
template <int S>
__device__ __forceinline__ V mroll(const V& x, int t) {
  V r = roll<S>(x, t);
#pragma unroll
  for (int q = 0; q < 4; q++) {
    if ((((t & 3) << 2) | q) < S) r.v[q] = 0;
  }
  return r;
}

__device__ __forceinline__ int glane(int t, int q) { return ((t & 3) << 2) | q; }

// lookup_sec / lookup_chunks
template <int NCH, int TW>
__device__ __forceinline__ int32_t lookup(const int32_t* T, int32_t idx, int sec) {
  return T[sec * TW + (((idx >> 7) & (NCH - 1)) << 7) + (idx & 127)];
}

// chunk_word: half 0 for widx < 128, else half 1
__device__ __forceinline__ int32_t chunk_word(const int32_t* C, int32_t widx, int sec) {
  return C[sec * 256 + (widx < 128 ? 0 : 128) + (widx & 127)];
}

// chunk_word_128: the section's first 128 words
__device__ __forceinline__ int32_t chunk_word_128(const int32_t* C, int32_t widx, int sec) {
  return C[sec * 256 + (widx & 127)];
}

__device__ __forceinline__ uint32_t funnel(int32_t wlo, int32_t whi, int32_t ksum) {
  return __funnelshift_r((uint32_t)wlo, (uint32_t)whi, (uint32_t)(ksum & 31));
}

// ---- step bodies (tools/microbench_step.py) --------------------------------

enum StepBody {
  kCurrent, kIndepRoll, kGathersOnly, kLookupOnly, kFast, kFastNosplit,
  kLookup8, kLookup16, kLookup32, kPair64, kStepBodies
};

__host__ __device__ constexpr int step_tab_words(int body) {
  return body == kLookup16 ? 2048 : body == kLookup32 ? 4096
       : body == kPair64 ? 9216 : 1024;
}

__host__ __device__ constexpr bool step_shared(int body) {
  return 4 * (kG * step_tab_words(body) + kChunkWords) <= kSmemMax;
}

// independent-roll prefix and fused bidirectional total
__device__ __forceinline__ void indep_prefix(const V& k, int t, V& ksum, V& tot) {
  const V f1 = mroll<1>(k, t), f2 = mroll<2>(k, t), f3 = mroll<3>(k, t);
  const V r1 = roll<127>(k, t), r2 = roll<126>(k, t), r3 = roll<125>(k, t);
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const int g = glane(t, q);
    ksum.v[q] = add(add(k.v[q], f1.v[q]), add(f2.v[q], f3.v[q]));
    tot.v[q] = add(add(ksum.v[q], g < 3 ? r1.v[q] : 0),
                   add(g < 2 ? r2.v[q] : 0, g < 1 ? r3.v[q] : 0));
  }
}

template <int BODY>
__device__ __forceinline__ V step_body(const V& s, int32_t i, const int32_t* T,
                                       const int32_t* C, int t) {
  const int sec = t >> 2;
  V out;
  if constexpr (BODY == kCurrent || BODY == kIndepRoll || BODY == kFastNosplit) {
    V ent, k, ksum, tot;
#pragma unroll
    for (int q = 0; q < 4; q++) {
      ent.v[q] = lookup<8, 1024>(T, s.v[q] & 1023, sec);
      k.v[q] = glane(t, q) < 4 ? (ent.v[q] & 15) : 0;
    }
    if constexpr (BODY == kCurrent) {
      const V r1 = mroll<1>(k, t);
#pragma unroll
      for (int q = 0; q < 4; q++) ksum.v[q] = add(k.v[q], r1.v[q]);
      const V r2 = mroll<2>(ksum, t);
#pragma unroll
      for (int q = 0; q < 4; q++) {
        ksum.v[q] = add(ksum.v[q], r2.v[q]);
        tot.v[q] = glane(t, q) == 3 ? ksum.v[q] : 0;
      }
      const V t1 = roll<127>(tot, t);
#pragma unroll
      for (int q = 0; q < 4; q++) tot.v[q] = add(tot.v[q], t1.v[q]);
      const V t2 = roll<126>(tot, t);
#pragma unroll
      for (int q = 0; q < 4; q++) tot.v[q] = add(tot.v[q], t2.v[q]);
    } else {
      indep_prefix(k, t, ksum, tot);
    }
#pragma unroll
    for (int q = 0; q < 4; q++) {
      uint32_t val;
      if constexpr (BODY == kFastNosplit) {
        const int32_t widx = add(ksum.v[q], i) & 126;
        val = funnel(chunk_word_128(C, widx, sec),
                     chunk_word_128(C, widx + 1, sec), ksum.v[q]);
      } else {
        const int32_t widx = add(ksum.v[q], i) & 254;
        val = funnel(chunk_word(C, widx, sec), chunk_word(C, widx + 1, sec),
                     ksum.v[q]);
      }
      const uint32_t bits = val & 1023u;
      out.v[q] = (int32_t)((bits + (uint32_t)(ent.v[q] >> 12)
                            + (uint32_t)tot.v[q]) & 1023u);
    }
  } else if constexpr (BODY == kGathersOnly) {
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const int32_t lo = s.v[q] & 127;
      const int32_t lo_again = lo + run_time_zero();
      uint32_t acc = (uint32_t)s.v[q];
#pragma unroll
      for (int g = 0; g < kG; g++) {
#pragma unroll
        for (int c = 0; c < 8; c++) acc += (uint32_t)T[g * 1024 + c * 128 + lo];
      }
#pragma unroll
      for (int g = 0; g < kG; g++) {
#pragma unroll
        for (int c = 0; c < 4; c++)  // chunks 0, 1, 0, 1: 4 loads, not 2
          acc += (uint32_t)C[g * 256 + (c % 2) * 128 + (c < 2 ? lo : lo_again)];
      }
      out.v[q] = (int32_t)(acc & 1023u);
    }
  } else if constexpr (BODY == kLookupOnly || BODY == kLookup8 ||
                       BODY == kLookup16 || BODY == kLookup32) {
    constexpr int TW = step_tab_words(BODY);
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const int32_t e = lookup<TW / 128, TW>(T, s.v[q] & (TW - 1), sec);
      out.v[q] = add(s.v[q], e) & 1023;
    }
  } else if constexpr (BODY == kFast) {
    V k, delta, sym, ksum, tot;
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const int32_t state = s.v[q] & 1023;
      // split_lookup: kd halfword-packed in 4 chunks, sym byte-packed in 2
      const int32_t kd_i = state >> 1;
      const uint32_t kd = (uint32_t)T[sec * 1024 + kd_i];
      const int32_t sy_i = state >> 2;
      const uint32_t sy = (uint32_t)T[sec * 1024 + ((sy_i >> 7) == 0 ? 512 : 640)
                                      + (sy_i & 127)];
      const int32_t kdv = (int32_t)(kd >> ((state & 1) << 4));
      k.v[q] = glane(t, q) < 4 ? (kdv & 15) : 0;
      delta.v[q] = (kdv >> 4) & 1023;
      sym.v[q] = (int32_t)(sy >> ((state & 3) << 3)) & 255;
    }
    indep_prefix(k, t, ksum, tot);
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const int32_t widx = add(ksum.v[q], i) & 126;
      const uint32_t bits = funnel(chunk_word_128(C, widx, sec),
                                   chunk_word_128(C, widx + 1, sec),
                                   ksum.v[q]) & 1023u;
      out.v[q] = (int32_t)((bits + (uint32_t)delta.v[q] + (uint32_t)tot.v[q]
                            + (uint32_t)sym.v[q]) & 1023u);
    }
  } else {  // kPair64
    constexpr int TW = 9216;
    V ent, k1, ksum;
#pragma unroll
    for (int q = 0; q < 4; q++) {
      ent.v[q] = lookup<8, TW>(T, s.v[q] & 1023, sec);
      k1.v[q] = ent.v[q] & 15;
    }
    const V r1 = mroll<1>(k1, t);
#pragma unroll
    for (int q = 0; q < 4; q++) ksum.v[q] = add(k1.v[q], r1.v[q]);
    const V r2 = mroll<2>(ksum, t);
#pragma unroll
    for (int q = 0; q < 4; q++) {
      ksum.v[q] = add(ksum.v[q], r2.v[q]);
      const int32_t widx = add(ksum.v[q], i) & 126;
      const uint32_t val = funnel(chunk_word_128(C, widx, sec),
                                  chunk_word_128(C, widx + 1, sec), ksum.v[q]);
      const int32_t b1 = (int32_t)(val & ((1u << (uint32_t)k1.v[q]) - 1u));
      const int32_t base = (ent.v[q] >> 4) & 8191;
      const int32_t pair = lookup<64, TW>(T, add(add(1024, base), b1) & (TW - 1), sec);
      const int32_t sym2 = (pair >> 8) & 255;
      const int32_t k2 = (pair >> 16) & 15;
      const int32_t delta2 = (pair >> 20) & 1023;
      const int32_t widx2 = add(add(ksum.v[q], k2), i) & 126;
      const uint32_t w2 = (uint32_t)chunk_word_128(C, widx2, sec);
      const uint32_t b2 = w2 & ((1u << (uint32_t)k2) - 1u);
      out.v[q] = (int32_t)((b2 + (uint32_t)delta2 + (uint32_t)sym2
                            + (uint32_t)(pair & 255)) & 1023u);
    }
  }
  return out;
}

template <int BODY>
__global__ void step_kernel(const int32_t* __restrict__ tab,
                            const int32_t* __restrict__ chunk,
                            const int32_t* __restrict__ x,
                            int32_t* __restrict__ out, int n_steps) {
  constexpr int TW = step_tab_words(BODY);
  extern __shared__ __align__(16) int32_t smem[];
  const int r = blockIdx.x;  // table row
  const int t = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5) * 8 + r;
  const int32_t* T;
  int32_t* C;
  if constexpr (step_shared(BODY)) {
    for (int w = threadIdx.x; w < kG * TW; w += blockDim.x)
      smem[w] = tab[(int64_t)r * kG * TW + w];
    T = smem;
    C = smem + kG * TW;
  } else {
    T = tab + (int64_t)r * kG * TW;
    C = smem;
  }
  for (int w = threadIdx.x; w < kChunkWords; w += blockDim.x)
    C[w] = chunk[r * kChunkWords + w];
  __syncthreads();
  const int4 in = reinterpret_cast<const int4*>(x + row * 128)[t];
  V s{{in.x, in.y, in.z, in.w}};
  for (int32_t i = 0; i < n_steps; i++) s = step_body<BODY>(s, i, T, C, t);
  reinterpret_cast<int4*>(out + row * 128)[t] =
      make_int4(s.v[0], s.v[1], s.v[2], s.v[3]);
}

template <int BODY>
cudaError_t launch_step(const int32_t* tab, const int32_t* chunk,
                        const int32_t* x, int32_t* out, int n_rows,
                        int n_steps, cudaStream_t stream) {
  constexpr int bytes = 4 * ((step_shared(BODY) ? kG * step_tab_words(BODY) : 0)
                             + kChunkWords);
  if constexpr (bytes > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        step_kernel<BODY>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  step_kernel<BODY><<<8, 32 * (n_rows / 8), bytes, stream>>>(tab, chunk, x,
                                                             out, n_steps);
  return cudaGetLastError();
}

// ---- chain and throughput bodies (tools/microbench_vpu.py) ------------------

enum ChainBody {
  kAdd, kGather128, kRoll, kSelect, kGatherIndep, kShiftPair, kGather16,
  kXor, kPrefixChain, kPrefixTree, kLitStep, kChainBodies
};
enum TputBody { kGatherX8, kRollX8, kTputBodies };

template <int BODY, int J>
__device__ __forceinline__ V chain_op(const V& x, const int32_t* T, int t) {
  V y;
  if constexpr (BODY == kRoll) {
    y = roll<1>(x, t);
#pragma unroll
    for (int q = 0; q < 4; q++) y.v[q] = add(y.v[q], 1);
  } else if constexpr (BODY == kPrefixChain) {
    V k;
#pragma unroll
    for (int q = 0; q < 4; q++) k.v[q] = x.v[q] & 15;
    const V r1 = roll<1>(k, t);
#pragma unroll
    for (int q = 0; q < 4; q++) k.v[q] = add(k.v[q], r1.v[q]);
    const V r2 = roll<2>(k, t);
#pragma unroll
    for (int q = 0; q < 4; q++) y.v[q] = add(k.v[q], r2.v[q]);
  } else if constexpr (BODY == kPrefixTree || BODY == kLitStep) {
    V k, e;
#pragma unroll
    for (int q = 0; q < 4; q++) {
      e.v[q] = BODY == kLitStep ? T[x.v[q] & 127] : x.v[q];
      k.v[q] = e.v[q] & 15;
    }
    const V r1 = roll<1>(k, t), r2 = roll<2>(k, t), r3 = roll<3>(k, t);
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const int32_t ksum = add(add(k.v[q], r1.v[q]), add(r2.v[q], r3.v[q]));
      if constexpr (BODY == kLitStep) {
        const int32_t w = T[128 + (ksum & 127)];
        y.v[q] = (w >> (k.v[q] & 7)) & 127;
      } else {
        y.v[q] = ksum;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const int32_t v = x.v[q];
      if constexpr (BODY == kAdd) y.v[q] = add(v, run_time_one());
      else if constexpr (BODY == kGather128) y.v[q] = T[v & 127];
      else if constexpr (BODY == kSelect) y.v[q] = v > 64 ? add(v, -1) : add(v, 1);
      else if constexpr (BODY == kGatherIndep)
        y.v[q] = add(v, T[(J % 8) * 128 + (add(v, J) & 127)]);
      else if constexpr (BODY == kShiftPair)
        y.v[q] = (v >> 1) ^ (int32_t)((uint32_t)v << 2);
      else if constexpr (BODY == kGather16) y.v[q] = add(v, T[v & 15]);
      else y.v[q] = v ^ 3;  // kXor
    }
  }
  return y;
}

// ops J .. N-1 of one step, in order
template <int BODY, int J, int N>
struct Chain {
  __device__ static __forceinline__ void run(V& x, const int32_t* T, int t) {
    x = chain_op<BODY, J>(x, T, t);
    opaque(x);
    Chain<BODY, J + 1, N>::run(x, T, t);
  }
};
template <int BODY, int N>
struct Chain<BODY, N, N> {
  __device__ static __forceinline__ void run(V&, const int32_t*, int) {}
};

template <int BODY, int J>
__device__ __forceinline__ V tput_op(const V& x, const int32_t* T, int t) {
  if constexpr (BODY == kGatherX8) {
    V y;
#pragma unroll
    for (int q = 0; q < 4; q++) y.v[q] = T[x.v[q] & 127];
    return y;
  } else {
    return roll<(J % 7) + 1>(x, t);
  }
}

// acc += op(x + J) for J .. N-1: independent of each other
template <int BODY, int J, int N>
struct Tput {
  __device__ static __forceinline__ void run(const V& x, V& acc,
                                             const int32_t* T, int t) {
    V xj;
#pragma unroll
    for (int q = 0; q < 4; q++) xj.v[q] = add(x.v[q], J);
    V y = tput_op<BODY, J>(xj, T, t);
    opaque(y);
#pragma unroll
    for (int q = 0; q < 4; q++) acc.v[q] = add(acc.v[q], y.v[q]);
    Tput<BODY, J + 1, N>::run(x, acc, T, t);
  }
};
template <int BODY, int N>
struct Tput<BODY, N, N> {
  __device__ static __forceinline__ void run(const V&, V&, const int32_t*, int) {}
};

// TPUT selects the throughput kernel (8 independent ops a step) or the
// chain kernel (32 dependent ops a step); one warp per row, 8 rows.
template <bool TPUT, int BODY>
__global__ void vpu_kernel(const int32_t* __restrict__ tab,
                           const int32_t* __restrict__ x,
                           int32_t* __restrict__ out, int n_steps) {
  __shared__ __align__(16) int32_t T[1024];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  for (int w = t; w < 1024; w += 32) T[w] = tab[r * 1024 + w];
  __syncwarp();
  const int4 in = reinterpret_cast<const int4*>(x + r * 128)[t];
  V s{{in.x, in.y, in.z, in.w}};
  for (int i = 0; i < n_steps; i++) {
    if constexpr (TPUT) {
      V acc{{0, 0, 0, 0}};
      Tput<BODY, 0, kWidth>::run(s, acc, T, t);
#pragma unroll
      for (int q = 0; q < 4; q++) s.v[q] = acc.v[q] & 127;
    } else {
      Chain<BODY, 0, kOps>::run(s, T, t);
    }
  }
  reinterpret_cast<int4*>(out + r * 128)[t] =
      make_int4(s.v[0], s.v[1], s.v[2], s.v[3]);
}

template <bool TPUT, int BODY>
cudaError_t launch_vpu(const int32_t* tab, const int32_t* x, int32_t* out,
                       int n_steps, cudaStream_t stream) {
  vpu_kernel<TPUT, BODY><<<8, 32, 0, stream>>>(tab, x, out, n_steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point launches on the given stream, does not synchronise and
// returns cudaGetLastError() (0 on success); an unknown body or a bad row
// count returns cudaErrorInvalidValue and launches nothing.

int lzt_probe_step(int body, const void* tab, const void* chunk, const void* x,
                   void* out, int n_rows, int n_steps, void* stream) {
  if (n_rows < 8 || n_rows % 8 != 0 || n_rows > 256 || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  const auto* tb = (const int32_t*)tab;
  const auto* ck = (const int32_t*)chunk;
  const auto* xs = (const int32_t*)x;
  auto* o = (int32_t*)out;
  const auto st = (cudaStream_t)stream;
  switch (body) {
#define LZT_STEP(B) \
  case B: return (int)launch_step<B>(tb, ck, xs, o, n_rows, n_steps, st);
    LZT_STEP(kCurrent) LZT_STEP(kIndepRoll) LZT_STEP(kGathersOnly)
    LZT_STEP(kLookupOnly) LZT_STEP(kFast) LZT_STEP(kFastNosplit)
    LZT_STEP(kLookup8) LZT_STEP(kLookup16) LZT_STEP(kLookup32)
    LZT_STEP(kPair64)
#undef LZT_STEP
    default: return (int)cudaErrorInvalidValue;
  }
}

// Where lzt_probe_step keeps the row's table: 1 in shared memory, 0 in
// device memory (read through L1 and L2); -1 for an unknown body.
int lzt_probe_step_shared(int body) {
  if (body < 0 || body >= kStepBodies) return -1;
  return step_shared(body) ? 1 : 0;
}

int lzt_probe_chain(int body, const void* tab, const void* x, void* out,
                    int n_steps, void* stream) {
  if (n_steps < 0) return (int)cudaErrorInvalidValue;
  const auto* tb = (const int32_t*)tab;
  const auto* xs = (const int32_t*)x;
  auto* o = (int32_t*)out;
  const auto st = (cudaStream_t)stream;
  switch (body) {
#define LZT_CHAIN(B) \
  case B: return (int)launch_vpu<false, B>(tb, xs, o, n_steps, st);
    LZT_CHAIN(kAdd) LZT_CHAIN(kGather128) LZT_CHAIN(kRoll) LZT_CHAIN(kSelect)
    LZT_CHAIN(kGatherIndep) LZT_CHAIN(kShiftPair) LZT_CHAIN(kGather16)
    LZT_CHAIN(kXor) LZT_CHAIN(kPrefixChain) LZT_CHAIN(kPrefixTree)
    LZT_CHAIN(kLitStep)
#undef LZT_CHAIN
    default: return (int)cudaErrorInvalidValue;
  }
}

int lzt_probe_tput(int body, const void* tab, const void* x, void* out,
                   int n_steps, void* stream) {
  if (n_steps < 0) return (int)cudaErrorInvalidValue;
  const auto* tb = (const int32_t*)tab;
  const auto* xs = (const int32_t*)x;
  auto* o = (int32_t*)out;
  const auto st = (cudaStream_t)stream;
  switch (body) {
    case kGatherX8: return (int)launch_vpu<true, kGatherX8>(tb, xs, o, n_steps, st);
    case kRollX8: return (int)launch_vpu<true, kRollX8>(tb, xs, o, n_steps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
