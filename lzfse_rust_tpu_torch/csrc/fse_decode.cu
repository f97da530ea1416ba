// Batched FSE (tANS) stream decode for the LZFSE container decoder, written
// by hand for Hopper (sm_90a). Plain C interface, loaded with ctypes
// (lzfse_rust_tpu_torch/runtime/cuda_lib.py).
//
// Replaces the two Pallas kernels of lzfse_rust_tpu/ops/pallas_decode.py:
//   lzt_decode_literals -> decode_literals_pallas (_literal_kernel)
//   lzt_decode_lmds     -> decode_lmds_pallas     (_lmd_kernel)
// Each computes what the Pallas kernel computes, not how it lays it out:
// no sectioned vreg layout, no compacted refresh windows, no superepochs.
//
// What bounds them on this card: not bytes (a serving batch moves ~190 MB,
// ~57 us at 3.35 TB/s) but each stream's serial chain -- table lookup, bit
// read at a position that depends on the lookup, next state -- up to 10,000
// steps long. The floor is the longest stream's steps times one dependent
// shared-memory lookup plus the step's integer work, and the issue rate of
// the warp that carries the stream.
//
// Design (one thread per stream; kStreams streams per CUDA block):
//   * The card is filled: a block holds only kStreams streams, so the ~1,800
//     streams of a serving batch spread over all 132 SMs, a few partial
//     warps per SM, none waiting for another's issue slot. Streams
//     arrive longest first from the host, so a warp's streams run similar
//     step counts.
//   * Tables live in shared memory, laid out [entry][stream] so the threads
//     of a warp always hit distinct banks. The block's 128 threads fill them
//     in one coalesced pass before the loop:
//       - literal: the u3 table is expanded into one flat entry per state
//         0..1023 (sym | k << 8 | slow << 12 | delta << 13), so a step does
//         one dependent shared lookup per lane instead of the two dependent
//         device-memory reads (symbol word, then aux word) of the u3 layout;
//       - L/M/D: the v table is expanded to 512 entries indexed by
//         state & 511, which folds the chunk select into the lookup.
//     A literal state outside [0, 1024), or one whose delta does not fit
//     the entry (the slow bit), takes today's arithmetic on the u3 table in
//     device memory on a rare branch, so every int32 state decodes as before.
//   * The payload is off the chain. A step reads its bits from the three
//     (literal: 4 x 15 bits) or four (L/M/D: 3 x 30 bits) words below pos,
//     loaded from shared memory while the step's table lookups are in
//     flight; each lane's field is one funnel shift at an offset that is a
//     prefix sum of the lanes' bit counts, with no branch. The words come
//     from a ring of 128 words a stream, kept 80 words deep by cp.async,
//     which the threads of a warp commit and wait for together every four
//     steps, four rounds behind, so no device-memory load sits between a
//     lookup and the next state.
//   * A step's chain is then: table lookup, bit counts, prefix sums, funnel
//     shift, add: about ten dependent instructions after the lookup. One
//     branch a step remains, for the rare slow literal entries.
//
// Semantics that must hold exactly (they are the Pallas kernels'):
//   * a field whose start position is below bit 0 reads as zero as a whole
//     (no partial funnel), and for L/M/D the state bits read as zero too
//     whenever the extra-bits field starts below 0;
//   * words past a stream's len read as zero;
//   * a literal state >= tot latches: k = 0, delta = state, sym = 0;
//   * literal steps are active while 4*step < num, L/M/D steps while
//     step < num; inactive steps are not written and freeze the state
//     (outputs are dense: block b's step j lands at out[out_off[b] + j]);
//   * every shift is on an unsigned type, and none is by 32 or more.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// streams per CUDA block: the one tuning constant
// (lzfse_rust_tpu_torch/tools/block_size_probe.py rewrites this line)
constexpr int kStreams = 8;
constexpr int kThreads = 128;      // threads of a block; threads < kStreams decode
constexpr int kTab = 384;          // u3 / v table words per stream
constexpr int kLitStates = 1024;   // flat literal entries per stream
constexpr int kLmdStates = 512;    // flat L/M/D entries per stream
// The payload ring. A warp tracks cp.async groups for all its threads at
// once, so its threads commit and wait together: once a round of kRound
// steps, each thread whose ring holds fewer than kAhead words below its
// reader copies kChunk more, and the warp waits for the groups of kLag
// rounds ago. A step takes at most 3 words (90 bits), so a round takes at
// most 3 * kRound, less than a chunk; a word copied in round r is first
// read more than kLag rounds later, after its wait.
constexpr int kRing = 256;         // ring words per stream
constexpr int kChunk = 32;         // words copied per refill
constexpr int kRound = 8;          // steps per refill round
constexpr int kLag = 4;            // rounds between a refill and its wait
constexpr int kAhead = 128;        // words kept copied below the reader
static_assert(kStreams >= 1 && kStreams <= kThreads, "kStreams");
static_assert((kRound & (kRound - 1)) == 0 && 3 * kRound < kChunk,
              "a round's words fit one refill");
static_assert(kAhead - 3 * kRound - 1 > 3 * kRound * kLag,
              "a refill is waited for before it is read");
static_assert(kAhead + 4 <= kRing - kChunk && kRing <= kTab,
              "a refill overwrites only words already read");
static_assert(kAhead + 3 + 2 * kChunk <= kRing, "the first fill fits the ring");

constexpr size_t kLitSmem = (size_t)(kLitStates + kTab) * kStreams * 4;
constexpr size_t kLmdSmem = (size_t)(kLmdStates + kRing) * kStreams * 4;

// flat literal entry: k | slow << 4 | sym << 5 | delta << 13
constexpr uint32_t kSlow = 1u << 4;
constexpr uint32_t kDeltaLim = 1u << 19;

// A block's readable words: its own length, cut at the end of the buffer.
__device__ __forceinline__ uint32_t clamp_len(int64_t base, int32_t len,
                                              int64_t n_words) {
  if (base < 0 || len <= 0 || base >= n_words) return 0u;
  const int64_t room = n_words - base;
  return (uint32_t)(len < room ? (int64_t)len : room);
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kLag of the warp's latest copy groups are in flight
__device__ __forceinline__ void cp_async_wait_lag() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kLag) : "memory");
}

// wait for all copies (before the first read, and before a thread exits)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A 32-bit load from shared memory at a 32-bit shared address. Volatile:
// it stays after the cp.async wait that precedes it.
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// all ones when ok, else zero: selects without a branch
__device__ __forceinline__ uint32_t mask_if(bool ok) {
  return 0u - (uint32_t)ok;
}

// The word holding bit pos - 1: floor((pos - 1) / 32), on unsigned types.
__device__ __forceinline__ int32_t top_word(int32_t pos) {
  return (int32_t)(((uint32_t)pos - 1u + 0x80000000u) >> 5) - (1 << 26);
}

// n <= 30 bits at offset o of the little-endian words w[0..3] (o + n <= 128)
__device__ __forceinline__ uint32_t bits_at(uint32_t w0, uint32_t w1,
                                            uint32_t w2, uint32_t w3,
                                            uint32_t o, uint32_t n) {
  const uint32_t j = o >> 5;
  const uint32_t lo = (j & 2u) ? ((j & 1u) ? w3 : w2) : ((j & 1u) ? w1 : w0);
  const uint32_t hi = (j & 2u) ? ((j & 1u) ? 0u : w3) : ((j & 1u) ? w2 : w1);
  return __funnelshift_r(lo, hi, o & 31u) & ((1u << n) - 1u);
}

// One stream's payload ring in shared memory: word w at
// col[(w & (kRing - 1)) * kStreams], copied ahead of the reader.
struct Ring {
  const int32_t* words;                // the stream's word 0
  uint32_t len;                        // readable words
  uint32_t* col;
  uint32_t col_s;                      // col as a shared-memory address
  int32_t fetched;                     // lowest word copied

  __device__ __forceinline__ uint32_t at(int32_t w) const {
    return lds(col_s + (uint32_t)(w & (kRing - 1)) * (kStreams * 4u));
  }

  // copy the kChunk words from cs up (zero outside [0, len)); no commit.
  // Chunks start at multiples of kChunk, so a chunk's slots are adjacent.
  __device__ __forceinline__ void fetch(int32_t cs) {
    uint32_t* dst = col + (cs & (kRing - 1)) * kStreams;
    if (cs >= 0 && (uint32_t)cs + kChunk <= len) {
      const int32_t* src = words + cs;
#pragma unroll
      for (int q = 0; q < kChunk; q++) cp_async4(dst + q * kStreams, src + q);
    } else {
#pragma unroll
      for (int q = 0; q < kChunk; q++) {
        const int32_t w = cs + q;
        if ((uint32_t)w < len) {
          cp_async4(dst + q * kStreams, words + w);
        } else {
          dst[q * kStreams] = 0u;
        }
      }
    }
  }

  // Words from top - 3 - kAhead up to top, waited for once, by all threads
  // together (the first chunk starts at a multiple of kChunk above top)
  __device__ __forceinline__ void init(int32_t top) {
    fetched = (top + kChunk) & ~(kChunk - 1);
    while (top - 3 - fetched < kAhead) {
      fetched -= kChunk;
      fetch(fetched);
    }
    cp_async_commit();
    cp_async_wait_all();
  }

  // The end of a round, by every thread of the warp at the same step:
  // one more chunk when fewer than kAhead words wait below ``low``.
  __device__ __forceinline__ void round(int32_t low) {
    if (low - fetched < kAhead) {
      fetched -= kChunk;
      fetch(fetched);
    }
    cp_async_commit();
    cp_async_wait_lag();
  }
};

// The u3 lookup of one literal state, as the Pallas kernel computes it:
// byte-packed symbols (state i in byte i & 3 of word i >> 2) and per-symbol
// halfword aux B | k0 << 11, two per word; a state >= tot latches.
__device__ __forceinline__ void literal_lookup(const int32_t* tab, int32_t st,
                                               int32_t t, int32_t& k,
                                               int32_t& delta, uint32_t& sym) {
  const uint32_t us = (uint32_t)st;
  const uint32_t col = ((us >> 2) & 127u) | (((us >> 9) & 1u) << 7);
  const uint32_t sy = (uint32_t)tab[col];
  uint32_t y = (sy >> ((us & 3u) << 3)) & 255u;
  const uint32_t aw = (uint32_t)tab[256 + (y >> 1)];
  const uint32_t aux = (aw >> ((y & 1u) << 4)) & 0x7FFFu;
  const int32_t bv = (int32_t)(aux & 2047u);
  const int32_t k0 = (int32_t)(aux >> 11);
  const int32_t a = (int32_t)(2048u >> (uint32_t)k0) - bv;  // A + B == 2048 >> k0
  const bool head = st < bv;
  int32_t kk = head ? k0 : k0 - 1;
  kk = kk > 0 ? kk : 0;
  const uint32_t sh = (uint32_t)(k0 - 1 > 0 ? k0 - 1 : 0);
  int32_t dd = head
      ? (int32_t)((((uint32_t)st + (uint32_t)a) << (uint32_t)k0) - 1024u)
      : (int32_t)(((uint32_t)st - (uint32_t)bv) << sh);
  if (st >= t) {  // latch
    kk = 0;
    dd = st;
    y = 0;
  }
  k = kk;
  delta = dd;
  sym = y;
}

__device__ __forceinline__ uint32_t flat_literal(const int32_t* tab, int32_t st,
                                                 int32_t t) {
  int32_t k, delta;
  uint32_t sym;
  literal_lookup(tab, st, t, k, delta, sym);
  const uint32_t head = (uint32_t)k | (sym << 5);
  return (uint32_t)delta < kDeltaLim ? head | ((uint32_t)delta << 13)
                                     : head | kSlow;
}

// The 64 stream bits below pos, as x2 (bits pos - 32 .. pos) and x1 (the 32
// below), from the three ring words top - 2 .. top: depends on pos only.
__device__ __forceinline__ void window64(const Ring& ring, int32_t pos,
                                         int32_t top, uint32_t& x1,
                                         uint32_t& x2, uint32_t w[3]) {
  w[0] = ring.at(top - 2);
  w[1] = ring.at(top - 1);
  w[2] = ring.at(top);
  const uint32_t sh = (uint32_t)pos - 32u * (uint32_t)(top - 2) - 64u;  // 1..32
  x2 = __funnelshift_rc(w[1], w[2], sh);
  x1 = __funnelshift_rc(w[0], w[1], sh);
}

// The 32 bits that start c bits below the top of x2:x1 (c <= 64): a lane's
// field is their top k bits.
__device__ __forceinline__ uint32_t below_top(uint32_t x0, uint32_t x1,
                                              uint32_t x2, uint32_t c) {
  // a shift above 32 clamps, so the branch not taken stays defined
  return c <= 32u ? __funnelshift_lc(x1, x2, c)
                  : __funnelshift_lc(x0, x1, c - 32u);
}

// the top n <= 32 bits of x
__device__ __forceinline__ uint32_t top_bits(uint32_t x, uint32_t n) {
  return __funnelshift_rc(x, 0u, 32u - n);
}

// A round's outputs at dst[0 .. kRound): 16 bytes at a time where dst is
// aligned, else one word at a time; only the first ``room`` when not whole.
__device__ __forceinline__ void store_round(int32_t* dst,
                                            const uint32_t (&v)[kRound],
                                            bool whole, int64_t room) {
  if (whole && ((uintptr_t)dst & 15u) == 0) {
#pragma unroll
    for (int r = 0; r < kRound; r += 4) {
      *reinterpret_cast<uint4*>(dst + r) = make_uint4(v[r], v[r + 1], v[r + 2],
                                                      v[r + 3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRound; r++) {
      if (whole || r < room) dst[r] = (int32_t)v[r];
    }
  }
}

// One literal stream's decoder state and its step.
struct LiteralStream {
  Ring ring;
  uint32_t flat;                 // the stream's flat table, shared address
  const int32_t* tab;            // its u3 table in device memory (slow path)
  int32_t t;                     // latch threshold
  int32_t s[4];
  int32_t pos;
  int32_t top;
  // the plain version's int64 position has gone below bit 0: every later
  // read is zero (pos itself wraps on int32 as that position does)
  bool below;

  // one step: returns the four symbols packed
  __device__ __forceinline__ uint32_t step() {
    uint32_t us[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; i++) {
      us[i] = (uint32_t)s[i];
      e[i] = lds(flat + (us[i] & (uint32_t)(kLitStates - 1)) * (kStreams * 4u));
    }
    uint32_t w[3], x1, x2;
    window64(ring, pos, top, x1, x2, w);
    // lane i's field: k[i] bits, c[i] bits below pos
    uint32_t k[4], c[5];
#pragma unroll
    for (int i = 0; i < 4; i++) k[i] = e[i] & 15u;
    c[0] = 0u;
#pragma unroll
    for (int i = 0; i < 4; i++) c[i + 1] = c[i] + k[i];
    int32_t ns[4];
#pragma unroll
    for (int i = 0; i < 4; i++) {
      // c[i] <= 45 < 64, and the field lies in x2:x1
      const uint32_t bits = top_bits(below_top(0u, x1, x2, c[i]), k[i])
                            & mask_if(!below && pos >= (int32_t)c[i + 1]);
      ns[i] = (int32_t)(bits + (e[i] >> 13));
    }
    uint32_t sym[4];
#pragma unroll
    for (int i = 0; i < 4; i++) sym[i] = (e[i] >> 5) & 255u;
    const uint32_t umax = max(max(us[0], us[1]), max(us[2], us[3]));
    if (((e[0] | e[1] | e[2] | e[3]) & kSlow) || umax >= (uint32_t)kLitStates) {
      // rare: a state outside the flat table or an entry that did not fit;
      // today's arithmetic on the u3 table, then the same reads
      const uint32_t a = (uint32_t)pos - 32u * (uint32_t)(top - 2);
#pragma unroll
      for (int i = 0; i < 4; i++) {
        int32_t kk, dd;
        literal_lookup(tab, s[i], t, kk, dd, sym[i]);
        k[i] = (uint32_t)kk;
        e[i] = (uint32_t)dd;  // the delta
      }
#pragma unroll
      for (int i = 0; i < 4; i++) c[i + 1] = c[i] + k[i];
#pragma unroll
      for (int i = 0; i < 4; i++) {
        const uint32_t bits = bits_at(w[0], w[1], w[2], 0u, a - c[i + 1], k[i])
                              & mask_if(!below && pos >= (int32_t)c[i + 1]);
        ns[i] = (int32_t)(bits + e[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; i++) s[i] = ns[i];
    below = below || pos < (int32_t)c[4];
    pos = (int32_t)((uint32_t)pos - c[4]);
    top = top_word(pos);
    return sym[0] | (sym[1] << 8) | (sym[2] << 16) | (sym[3] << 24);
  }
};

// One L/M/D stream's decoder state and its step.
struct LmdStream {
  Ring ring;
  uint32_t flat;                 // the stream's flat table, shared address
  int32_t s[3];
  int32_t pos;
  int32_t top;
  bool below;                    // as in LiteralStream

  // one step: lm = l | m << 16 and the raw d
  __device__ __forceinline__ void step(uint32_t& lm, uint32_t& d) {
    uint32_t e[3];
#pragma unroll
    for (int i = 0; i < 3; i++) {
      e[i] = lds(flat + ((uint32_t)s[i] & (uint32_t)(kLmdStates - 1))
                            * (kStreams * 4u));
    }
    // the 96 stream bits below pos, x2 on top, from words top - 3 .. top
    const uint32_t w0 = ring.at(top - 3), w1 = ring.at(top - 2),
                   w2 = ring.at(top - 1), w3 = ring.at(top);
    const uint32_t sh = (uint32_t)pos - 32u * (uint32_t)(top - 3) - 96u;
    const uint32_t x2 = __funnelshift_rc(w2, w3, sh);
    const uint32_t x1 = __funnelshift_rc(w1, w2, sh);
    const uint32_t x0 = __funnelshift_rc(w0, w1, sh);
    // lane i's field [extra bits][state bits]: knb[i] bits, c[i] below pos
    uint32_t nbits[3], knb[3], c[4];
#pragma unroll
    for (int i = 0; i < 3; i++) {
      nbits[i] = (e[i] >> 4) & 15u;
      knb[i] = (e[i] & 15u) + nbits[i];
    }
    c[0] = 0u;
#pragma unroll
    for (int i = 0; i < 3; i++) c[i + 1] = c[i] + knb[i];
    uint32_t val[3];
#pragma unroll
    for (int i = 0; i < 3; i++) {
      // a field that starts below bit 0 reads zero as a whole, state bits
      // included; state bits that start below 0 lie in such a field
      const uint32_t both = top_bits(below_top(x0, x1, x2, c[i]), knb[i])
                            & mask_if(!below && pos >= (int32_t)c[i + 1]);
      const uint32_t hi = (e[i] >> 17) & 0x7FFFu;
      // L and M carry the value base inline; D packs the symbol j with
      // base ((4 + (j & 3)) << min(j >> 2, 15)) - 4
      const uint32_t dsh = (hi >> 2) < 15u ? (hi >> 2) : 15u;
      const uint32_t vbase = i == 2 ? ((4u + (hi & 3u)) << dsh) - 4u : hi;
      val[i] = vbase + (both & ((1u << nbits[i]) - 1u));
      s[i] = (int32_t)((both >> nbits[i]) + ((e[i] >> 8) & 0x1FFu));
    }
    below = below || pos < (int32_t)c[3];
    pos = (int32_t)((uint32_t)pos - c[3]);
    top = top_word(pos);
    lm = val[0] + (val[1] << 16);
    d = val[2];
  }
};

__global__ void __launch_bounds__(kThreads)
literal_kernel(const int32_t* __restrict__ u3, const int32_t* __restrict__ words,
               const int32_t* __restrict__ word_off,
               const int32_t* __restrict__ word_len,
               const int32_t* __restrict__ init_states,
               const int32_t* __restrict__ init_pos,
               const int32_t* __restrict__ num, const int32_t* __restrict__ tot,
               const int32_t* __restrict__ out_off, int32_t* __restrict__ out,
               int32_t* __restrict__ final_states,
               int32_t* __restrict__ final_pos, int nb, int64_t n_words,
               int64_t n_out) {
  extern __shared__ __align__(16) uint32_t lzt_smem[];
  __shared__ int32_t s_tot[kStreams];
  uint32_t* flat = lzt_smem;                        // [1024][kStreams]
  uint32_t* scratch = lzt_smem + kLitStates * kStreams;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kStreams;
  const int ns = nb - b0 < kStreams ? nb - b0 : kStreams;

  // the block's u3 rows, [stream][384], in one coalesced pass
  const int32_t* __restrict__ rows = u3 + (int64_t)b0 * kTab;
  for (int i = tid; i < ns * kTab; i += kThreads) {
    scratch[i] = (uint32_t)__ldg(rows + i);
  }
  if (tid < ns) s_tot[tid] = tot[b0 + tid];
  __syncthreads();
  for (int i = tid; i < kLitStates * kStreams; i += kThreads) {
    const int j = i % kStreams;
    if (j < ns) {
      flat[i] = flat_literal((const int32_t*)scratch + j * kTab, i / kStreams,
                             s_tot[j]);
    }
  }
  __syncthreads();  // from here on scratch is the payload ring
  if (tid >= ns) return;

  const int b = b0 + tid;
  const int64_t wb = word_off[b];
  LiteralStream st;
  st.ring.len = clamp_len(wb, word_len[b], n_words);
  st.ring.words = words + (st.ring.len ? wb : 0);
  st.ring.col = scratch + tid;
  st.ring.col_s = (uint32_t)__cvta_generic_to_shared(st.ring.col);
  st.flat = (uint32_t)__cvta_generic_to_shared(flat + tid);
  st.tab = u3 + (int64_t)b * kTab;
  st.t = s_tot[tid];
  const int32_t n = num[b];
  const int64_t n_steps = n > 0 ? ((int64_t)n + 3) / 4 : 0;
  const int64_t o = out_off[b];
  const int64_t o_lim = (o >= 0 && o <= n_out) ? n_out - o : 0;
  int32_t* __restrict__ dst = out + o;
#pragma unroll
  for (int i = 0; i < 4; i++) st.s[i] = init_states[b * 4 + i];
  st.pos = init_pos[b];
  st.below = st.pos < 0;
  st.top = top_word(st.pos);
  st.ring.init(st.top);

  // whole rounds, each ending in the warp's refill; then the last steps
  // (fewer than a round: the ring holds them)
  int64_t step = 0;
  const int64_t n_whole = n_steps - n_steps % kRound;
  for (; step < n_whole; step += kRound) {
    uint32_t packed[kRound];
#pragma unroll
    for (int r = 0; r < kRound; r++) packed[r] = st.step();
    store_round(dst + step, packed, step + kRound <= o_lim, o_lim - step);
    st.ring.round(st.top - 3);
  }
  for (; step < n_steps; step++) {
    const uint32_t packed = st.step();
    if (step < o_lim) dst[step] = (int32_t)packed;
  }
#pragma unroll
  for (int i = 0; i < 4; i++) final_states[b * 4 + i] = st.s[i];
  final_pos[b] = st.pos;
  cp_async_wait_all();
}

__global__ void __launch_bounds__(kThreads)
lmd_kernel(const int32_t* __restrict__ v, const int32_t* __restrict__ words,
           const int32_t* __restrict__ word_off,
           const int32_t* __restrict__ word_len,
           const int32_t* __restrict__ init_states,
           const int32_t* __restrict__ init_pos,
           const int32_t* __restrict__ num, const int32_t* __restrict__ out_off,
           int32_t* __restrict__ out_lm, int32_t* __restrict__ out_d,
           int32_t* __restrict__ final_states, int32_t* __restrict__ final_pos,
           int nb, int64_t n_words, int64_t n_out) {
  extern __shared__ __align__(16) uint32_t lzt_smem[];
  uint32_t* flat = lzt_smem;                         // [512][kStreams]
  uint32_t* rings = lzt_smem + kLmdStates * kStreams;  // [kRing][kStreams]
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kStreams;
  const int ns = nb - b0 < kStreams ? nb - b0 : kStreams;

  // entry u of a stream is the v word the Pallas lookup picks for any state
  // with state & 511 == u: bit 1 of u >> 7 picks chunk 2, else bit 0
  // picks chunk 1 or 0. Read in row order (coalesced).
  const int32_t* __restrict__ rows = v + (int64_t)b0 * kTab;
  for (int i = tid; i < ns * kLmdStates; i += kThreads) {
    const uint32_t j = (uint32_t)i / kLmdStates;
    const uint32_t u = (uint32_t)i % kLmdStates;
    const uint32_t hi7 = u >> 7;
    const uint32_t chunk = (hi7 & 2u) ? 2u : (hi7 & 1u);
    flat[u * kStreams + j] =
        (uint32_t)__ldg(rows + j * kTab + chunk * 128u + (u & 127u));
  }
  __syncthreads();
  if (tid >= ns) return;

  const int b = b0 + tid;
  const int64_t wb = word_off[b];
  LmdStream st;
  st.ring.len = clamp_len(wb, word_len[b], n_words);
  st.ring.words = words + (st.ring.len ? wb : 0);
  st.ring.col = rings + tid;
  st.ring.col_s = (uint32_t)__cvta_generic_to_shared(st.ring.col);
  st.flat = (uint32_t)__cvta_generic_to_shared(flat + tid);
  const int32_t n = num[b];
  const int64_t o = out_off[b];
  const int64_t o_lim = (o >= 0 && o <= n_out) ? n_out - o : 0;
  int32_t* __restrict__ dlm = out_lm + o;
  int32_t* __restrict__ dd = out_d + o;
#pragma unroll
  for (int i = 0; i < 3; i++) st.s[i] = init_states[b * 3 + i];
  st.pos = init_pos[b];
  st.below = st.pos < 0;
  st.top = top_word(st.pos);
  st.ring.init(st.top);

  // whole rounds, each ending in the warp's refill; then the last steps
  int32_t step = 0;
  const int32_t n_whole = n > 0 ? n - n % kRound : 0;
  for (; step < n_whole; step += kRound) {
    uint32_t lm[kRound], d[kRound];
#pragma unroll
    for (int r = 0; r < kRound; r++) st.step(lm[r], d[r]);
    const bool whole = step + kRound <= o_lim;
    store_round(dlm + step, lm, whole, o_lim - step);
    store_round(dd + step, d, whole, o_lim - step);
    st.ring.round(st.top - 3);
  }
  for (; step < n; step++) {
    uint32_t lm, d;
    st.step(lm, d);
    if (step < o_lim) {
      dlm[step] = (int32_t)lm;
      dd[step] = (int32_t)d;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; i++) final_states[b * 3 + i] = st.s[i];
  final_pos[b] = st.pos;
  cp_async_wait_all();
}

inline int grid_for(int nb) { return (nb + kStreams - 1) / kStreams; }

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

// Every entry point launches on the given stream, does not synchronise and
// returns cudaGetLastError() (0 on success), or the error of the shared
// memory request. n_words and n_out are the element counts of the payload
// and output buffers: reads past a block's words or the buffer read zero,
// writes past n_out are dropped.

int lzt_decode_literals(const void* u3, const void* words, const void* word_off,
                        const void* word_len, const void* init_states,
                        const void* init_pos, const void* num, const void* tot,
                        const void* out_off, void* out, void* final_states,
                        void* final_pos, int nb, long long n_words,
                        long long n_out, void* stream) {
  if (nb > 0) {
    const cudaError_t rc = allow_smem(literal_kernel, kLitSmem);
    if (rc != cudaSuccess) return (int)rc;
    literal_kernel<<<grid_for(nb), kThreads, kLitSmem, (cudaStream_t)stream>>>(
        (const int32_t*)u3, (const int32_t*)words, (const int32_t*)word_off,
        (const int32_t*)word_len, (const int32_t*)init_states,
        (const int32_t*)init_pos, (const int32_t*)num, (const int32_t*)tot,
        (const int32_t*)out_off, (int32_t*)out, (int32_t*)final_states,
        (int32_t*)final_pos, nb, n_words, n_out);
  }
  return (int)cudaGetLastError();
}

int lzt_decode_lmds(const void* v, const void* words, const void* word_off,
                    const void* word_len, const void* init_states,
                    const void* init_pos, const void* num, const void* out_off,
                    void* out_lm, void* out_d, void* final_states,
                    void* final_pos, int nb, long long n_words,
                    long long n_out, void* stream) {
  if (nb > 0) {
    const cudaError_t rc = allow_smem(lmd_kernel, kLmdSmem);
    if (rc != cudaSuccess) return (int)rc;
    lmd_kernel<<<grid_for(nb), kThreads, kLmdSmem, (cudaStream_t)stream>>>(
        (const int32_t*)v, (const int32_t*)words, (const int32_t*)word_off,
        (const int32_t*)word_len, (const int32_t*)init_states,
        (const int32_t*)init_pos, (const int32_t*)num, (const int32_t*)out_off,
        (int32_t*)out_lm, (int32_t*)out_d, (int32_t*)final_states,
        (int32_t*)final_pos, nb, n_words, n_out);
  }
  return (int)cudaGetLastError();
}

const char* lzt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
