// tpulzfse — native host runtime for the TPU-native LZFSE framework.
//
// Role: the sequential host data path (container assembly, scalar codec,
// streaming IO) that complements the TPU batch kernels — the moral
// equivalent of the reference crate's native core. The format semantics
// mirror the Python spec layer (lzfse_rust_tpu/spec/*), which is validated
// bit-exact against the reference fixtures; format constants follow
// the reference's src/fse/constants.rs and src/vn/constants.rs.
//
// C ABI:
//   tl_decode_bound(src, n)          -> decoded size (probe) or -errcode
//   tl_decode(src, n, dst, cap)      -> decoded size or -errcode
//   tl_encode_bound(n)               -> worst-case container size
//   tl_encode(src, n, dst, cap)      -> encoded size or -errcode

#include <algorithm>
#include <cstdint>
#if defined(__AVX2__)
#include <immintrin.h>
#endif
#include <cstring>
#include <atomic>
#include <condition_variable>
#include <cstdlib>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include <malloc.h>

namespace {

// ---------------------------------------------------------------- constants
constexpr uint32_t MAGIC_EOS = 0x24787662, MAGIC_RAW = 0x2D787662,
                   MAGIC_VX1 = 0x31787662, MAGIC_VX2 = 0x32787662,
                   MAGIC_VXN = 0x6E787662;

constexpr int LMDS_PER_BLOCK = 10000, LITERALS_PER_BLOCK = 40000;
constexpr int L_SYMS = 20, M_SYMS = 20, D_SYMS = 64, U_SYMS = 256;
constexpr int L_STATES = 64, M_STATES = 64, D_STATES = 256, U_STATES = 1024;
constexpr int MAX_L = 315, MAX_M = 2359;
constexpr uint32_t MAX_D = 262139;
constexpr int N_WEIGHTS = 360;
constexpr int V1_HEADER = 0x32, V2_HEADER = 0x20;
constexpr int V1_WEIGHTS = N_WEIGHTS * 2 + 2;
constexpr int V2_WEIGHTS_MAX = (N_WEIGHTS * 14 + 7) / 8;

static const uint8_t L_EXTRA[L_SYMS] = {0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,2,3,5,8};
static const int32_t L_BASE[L_SYMS]  = {0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,20,28,60};
static const uint8_t M_EXTRA[M_SYMS] = {0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,3,5,8,11};
static const int32_t M_BASE[M_SYMS]  = {0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,24,56,312};
static const uint8_t D_EXTRA[D_SYMS] = {
    0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,4,4,4,4,5,5,5,5,6,6,6,6,7,7,7,7,
    8,8,8,8,9,9,9,9,10,10,10,10,11,11,11,11,12,12,12,12,13,13,13,13,
    14,14,14,14,15,15,15,15};
static const int32_t D_BASE[D_SYMS] = {
    0,1,2,3,4,6,8,10,12,16,20,24,28,36,44,52,60,76,92,108,124,156,188,220,
    252,316,380,444,508,636,764,892,1020,1276,1532,1788,2044,2556,3068,3580,
    4092,5116,6140,7164,8188,10236,12284,14332,16380,20476,24572,28668,32764,
    40956,49148,57340,65532,81916,98300,114684,131068,163836,196604,229372};

// derived value->symbol tables
struct Derived {
  uint8_t l_sym[MAX_L + 1];
  uint8_t m_sym[MAX_M + 1];
  uint8_t d_sym[256];
  Derived() {
    for (int s = 0; s < L_SYMS; s++)
      for (int v = L_BASE[s]; v < L_BASE[s] + (1 << L_EXTRA[s]); v++) l_sym[v] = s;
    for (int s = 0; s < M_SYMS; s++)
      for (int v = M_BASE[s]; v < M_BASE[s] + (1 << M_EXTRA[s]); v++) m_sym[v] = s;
    for (int s = 0; s < D_SYMS; s++)
      for (int v = D_BASE[s]; v < D_BASE[s] + (1 << D_EXTRA[s]); v++) {
        int idx = v < 60 ? v : v < 1020 ? ((v - 60) >> 4) + 64
                  : v < 16380 ? ((v - 1020) >> 8) + 128 : ((v - 16380) >> 12) + 192;
        d_sym[idx] = s;
      }
  }
};
static const Derived DV;

static inline int d_index(uint32_t v) {
  return v < 60 ? (int)v : v < 1020 ? (int)((v - 60) >> 4) + 64
         : v < 16380 ? (int)((v - 1020) >> 8) + 128 : (int)((v - 16380) >> 12) + 192;
}

// errors (negative return codes)
enum Err {
  E_OK = 0, E_UNDERFLOW = 1, E_OVERFLOW = 2, E_BADBLOCK = 3, E_BADBITS = 4,
  E_FSE = 5, E_VN = 6, E_BADD = 7, E_CAP = 8, E_INTERNAL = 9,
};

static inline uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
static inline uint64_t rd64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
static inline void wr32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
static inline void wr64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }

// ------------------------------------------------------------ bit streams
// Backwards reader over a payload copied into a padded scratch, with the
// reference's accumulator discipline (src/bits/bit_reader.rs): hold 64 bits
// in a register, pull from the top, refill whole bytes on flush(). Callers
// flush once per symbol group (<=54 bits between flushes).
struct BitRd {
  const uint8_t* buf;  // padded: 8 zero bytes precede logical payload
  uint64_t accum;
  int accum_bits;      // valid top bits in accum
  int64_t idx;         // byte index of accum's low end (scratch coords)
  bool init(const uint8_t* padded, size_t payload_len, int off) {
    if (off > 7) return false;
    if (payload_len < 8) return false;
    if (off && (rd64(padded + 8 + payload_len - 8) >> (64 - off)) != 0) return false;
    buf = padded;  // buf[8..] is the payload (which has its own 8-byte pad)
    idx = (int64_t)payload_len + 8 - 8;  // last 8 payload bytes (+ scratch pad)
    accum = rd64(buf + idx);
    accum_bits = 64 - off;
    return true;
  }
  inline void flush() {
    int nb = (64 - accum_bits) >> 3;
    idx -= nb;
    int64_t p = idx < 0 ? 0 : idx;  // below-scratch reads yield pad zeros
    accum = idx < 0 ? 0 : rd64(buf + p);
    accum_bits += nb << 3;
  }
  inline uint32_t pull(int n) {
    accum_bits -= n;
    // malformed streams may drive accum_bits negative between flushes; the
    // shift mask mirrors the reference's wrap and finalize() rejects
    return (uint32_t)((accum >> (accum_bits & 63)) & ((1u << n) - 1));
  }
  bool finalize() {
    flush();
    // remaining bits must cover both the scratch pad and the stream pad
    return accum_bits >= 0 && (int64_t)accum_bits + idx * 8 >= 64 + 64;
  }
};

// Forward writer: little-endian accumulator append.
struct BitWr {
  std::vector<uint8_t>* out;
  uint64_t accum = 0;
  int bits = 0;
  inline void push(uint32_t v, int n) {
    accum |= (uint64_t)v << bits;
    bits += n;
    while (bits >= 8) { out->push_back((uint8_t)accum); accum >>= 8; bits -= 8; }
  }
  int finalize() {  // returns off
    if (!bits) return 0;
    out->push_back((uint8_t)accum);
    int off = 8 - bits;
    accum = 0; bits = 0;
    return off;
  }
};

// ------------------------------------------------------------ weights codec
static int decode_weight(uint32_t u, int* w) {
  static const uint8_t BITS[32] = {2,3,2,5,2,3,2,8,2,3,2,5,2,3,2,14,
                                   2,3,2,5,2,3,2,8,2,3,2,5,2,3,2,14};
  static const int8_t VAL[32] = {0,2,1,4,0,3,1,-1,0,2,1,5,0,3,1,-1,
                                 0,2,1,6,0,3,1,-1,0,2,1,7,0,3,1,-1};
  int i = u & 0x1F, nb = BITS[i];
  *w = nb == 8 ? 8 + ((u >> 4) & 0xF) : nb == 14 ? 24 + ((u >> 4) & 0x3FF) : VAL[i];
  return nb;
}

static void encode_weight(int w, uint32_t* u, int* nb) {
  switch (w) {
    case 0: *u = 0; *nb = 2; return;   case 1: *u = 2; *nb = 2; return;
    case 2: *u = 1; *nb = 3; return;   case 3: *u = 5; *nb = 3; return;
    case 4: *u = 3; *nb = 5; return;   case 5: *u = 11; *nb = 5; return;
    case 6: *u = 19; *nb = 5; return;  case 7: *u = 27; *nb = 5; return;
    default:
      if (w < 24) { *u = ((w - 8) << 4) + 7; *nb = 8; }
      else { *u = ((w - 24) << 4) + 15; *nb = 14; }
  }
}

// Weights::load_v2 (weights.rs:83-105)
static int load_weights_v2(const uint8_t* src, size_t n, uint16_t* w) {
  uint64_t accum = 0;
  int accum_bits = 0;
  size_t i = 0;
  for (int k = 0; k < N_WEIGHTS; k++) {
    while (i != n && accum_bits <= 24) { accum |= (uint64_t)src[i++] << accum_bits; accum_bits += 8; }
    int wv; int nb = decode_weight((uint32_t)accum, &wv);
    w[k] = (uint16_t)wv;
    accum >>= nb;
    accum_bits -= nb;
  }
  if (accum_bits < 0) return -E_FSE;
  if (accum_bits >= 8 || i != n) return -E_FSE;
  return 0;
}

static size_t store_weights_v2(const uint16_t* w, uint8_t* dst) {
  uint64_t accum = 0; int bits = 0; size_t i = 0;
  for (int k = 0; k < N_WEIGHTS; k++) {
    uint32_t u; int nb; encode_weight(w[k], &u, &nb);
    accum |= (uint64_t)u << bits; bits += nb;
    while (bits >= 8) { dst[i++] = (uint8_t)accum; accum >>= 8; bits -= 8; }
  }
  if (bits > 0) dst[i++] = (uint8_t)accum;
  return i;
}

static bool check_totals(const uint16_t* w) {
  int64_t tl = 0, tm = 0, td = 0, tu = 0;
  for (int i = 0; i < 20; i++) tl += w[i];
  for (int i = 20; i < 40; i++) tm += w[i];
  for (int i = 40; i < 104; i++) td += w[i];
  for (int i = 104; i < 360; i++) tu += w[i];
  return tl <= L_STATES && tm <= M_STATES && td <= D_STATES && tu <= U_STATES;
}

// normalize_m1 (weights.rs:218-278), exact integer model
static void normalize_m1(uint16_t* w, int n, int64_t in_total, int out_total) {
  if (in_total == 0) return;
  int shift = __builtin_clz((uint32_t)out_total);
  uint32_t multiply = (uint32_t)((1u << 31) / in_total);
  uint32_t round = 1u << (shift - 1);
  int32_t remaining = out_total;
  uint32_t max_w = 0; int max_i = 0;
  for (int i = 0; i < n; i++) {
    if (!w[i]) continue;
    uint32_t f = ((uint32_t)w[i] * multiply + round) >> shift;
    if (!f) f = 1;
    w[i] = (uint16_t)f;
    remaining -= (int32_t)f;
    if (f > max_w) { max_w = f; max_i = i; }
  }
  if (-remaining < (int32_t)w[max_i] / 4) {
    w[max_i] = (uint16_t)((int32_t)w[max_i] + remaining);
  } else {
    uint32_t overflow = (uint32_t)(-remaining);
    for (int shift2 = 3; shift2 >= 0 && overflow; shift2--)
      for (int i = 0; i < n && overflow; i++) {
        if (!w[i]) continue;
        uint32_t d = ((uint32_t)(w[i] - 1)) >> shift2;
        if (d > overflow) d = overflow;
        w[i] = (uint16_t)(w[i] - d);
        overflow -= d;
      }
  }
}

// ------------------------------------------------------------ decode tables
struct VEntry { uint8_t k, vbits; int16_t delta; int32_t vbase; };
struct UEntry { uint8_t k, sym; int16_t delta; };

// decoder.rs:244-292 table build
static void build_v_block(const uint16_t* w, int n_syms, const uint8_t* vbits,
                          const int32_t* vbase, VEntry* tab, int n_states, int offset) {
  int n_clz = __builtin_clz((uint32_t)n_states);
  int total = 0;
  for (int i = 0; i < n_syms; i++) {
    int wv = w[i];
    if (!wv) continue;
    int k = __builtin_clz((uint32_t)wv) - n_clz;
    int x = ((n_states << 1) >> k) - wv;
    for (int j = 0; j < x; j++)
      tab[total + j] = {(uint8_t)k, vbits[i], (int16_t)(((wv + j) << k) - n_states + offset), vbase[i]};
    for (int j = x; j < wv; j++)
      tab[total + j] = {(uint8_t)(k - 1), vbits[i], (int16_t)(((j - x) << (k - 1)) + offset), vbase[i]};
    total += wv;
  }
  for (int s = total; s < n_states; s++) tab[s] = {0, 0, (int16_t)(offset + s), 0};
}

static void build_u_table(const uint16_t* w, UEntry* tab) {
  int n_clz = __builtin_clz((uint32_t)U_STATES);
  int total = 0;
  for (int i = 0; i < U_SYMS; i++) {
    int wv = w[i];
    if (!wv) continue;
    int k = __builtin_clz((uint32_t)wv) - n_clz;
    int x = ((U_STATES << 1) >> k) - wv;
    for (int j = 0; j < x; j++)
      tab[total + j] = {(uint8_t)k, (uint8_t)i, (int16_t)(((wv + j) << k) - U_STATES)};
    for (int j = x; j < wv; j++)
      tab[total + j] = {(uint8_t)(k - 1), (uint8_t)i, (int16_t)((j - x) << (k - 1))};
    total += wv;
  }
  for (int s = total; s < U_STATES; s++) tab[s] = {0, 0, (int16_t)s};
}

// ------------------------------------------------------------ encode tables
struct EEntry { int16_t t_k, t_w; };
static void build_e_table(const uint16_t* w, int n, int n_states, EEntry* tab) {
  int n_clz = __builtin_clz((uint32_t)n_states);
  int total = 0;
  for (int i = 0; i < n; i++) {
    int wv = w[i];
    if (!wv) { tab[i] = {(int16_t)-n_states, 0}; }
    else {
      int k = __builtin_clz((uint32_t)wv) - n_clz;
      tab[i] = {(int16_t)(1024 * k - (wv << k)), (int16_t)(n_states + total - wv)};
    }
    total += wv;
  }
}

static inline void e_encode(BitWr& bw, uint32_t* state, const EEntry& e) {
  uint32_t s = *state;
  uint32_t nb = (uint32_t)((int32_t)(e.t_k + (int32_t)s)) >> 10;
  *state = (uint32_t)(e.t_w + (int32_t)(s >> nb));
  bw.push(s & ((1u << nb) - 1), (int)nb);
}

// ============================================================== DECODE SIDE

// 16-byte unaligned block move; constant size lets the compiler emit two
// vector mov instructions instead of a libc memcpy call (the per-row call
// overhead dominated the LZ rebuild at ~9-byte average match lengths).
static inline void cpy16(uint8_t* d, const uint8_t* s) {
  __builtin_memcpy(d, s, 16);
}

struct Sink {
  uint8_t* dst;
  size_t cap, len = 0;
  int write(const uint8_t* p, size_t n) {
    if (len + n > cap) return -E_CAP;
    memcpy(dst + len, p, n); len += n; return 0;
  }
  // Wide-stride variant: requires the SOURCE to have >= 15 readable bytes
  // past p + n (callers pass padded scratch rows, never borrowed buffer
  // tails). May scribble up to 15 bytes of slack past n in dst; the slack
  // stays below cap and is overwritten by later emission.
  int write_slack(const uint8_t* p, size_t n) {
    if (len + n + 16 > cap) return write(p, n);
    uint8_t* o = dst + len;
    cpy16(o, p);
    for (size_t i = 16; i < n; i += 16) cpy16(o + i, p + i);
    len += n;
    return 0;
  }
  int write_match(uint32_t m, uint32_t d) {
    if (d == 0 || d > len) return -E_BADD;
    if (len + m > cap) return -E_CAP;
    uint8_t* out = dst + len;
    const uint8_t* src = out - d;
    if (len + m + 16 <= cap) {
      if (d >= 16) {
        // 16-byte strides are overlap-safe for d >= 16: byte j of chunk n
        // reads position j - d <= j - 16, already written by chunk n-1
        cpy16(out, src);
        for (size_t i = 16; i < m; i += 16) cpy16(out + i, src + i);
      } else if (m <= d) {
        // short non-overlapping copy; bytes m..15 of the wide store are
        // slack (and the read past src + m stays inside the output
        // buffer: src + 16 = out + 16 - d <= out + 15 < cap slack)
        cpy16(out, src);
      } else {
        // 1 <= d < 16 < m: replicate the d-byte period into a 16-byte
        // pattern once, then branch-light 16B stores advancing by the
        // largest multiple of d <= 16 (store phase stays period-aligned)
        uint8_t pat[16];
        for (int i = 0; i < 16; i++) pat[i] = src[i % d];
        size_t step = (16 / d) * d;
        for (size_t done = 0; done < m; done += step)
          cpy16(out + done, pat);
      }
    } else if (d >= m) {
      memcpy(out, src, m);
    } else {
      // overlap-safe exponential widening: the copied prefix repeats with
      // period d, so doubling the stride (a multiple of d) keeps every
      // memcpy non-overlapping — O(log(m/d)) calls instead of a byte loop
      size_t done = 0, dd = d;
      while (done < m) {
        size_t c = dd < m - done ? dd : m - done;
        memcpy(out + done, out + done - dd, c);
        done += c;
        dd <<= 1;
      }
    }
    len += m;
    return 0;
  }
};

struct FseTables {
  VEntry v[L_STATES + M_STATES + D_STATES];
  UEntry u[U_STATES];
  void init(const uint16_t* w) {
    build_v_block(w, L_SYMS, L_EXTRA, L_BASE, v, L_STATES, 0);
    build_v_block(w + 20, M_SYMS, M_EXTRA, M_BASE, v + L_STATES, M_STATES, L_STATES);
    build_v_block(w + 40, D_SYMS, D_EXTRA, D_BASE, v + L_STATES + M_STATES, D_STATES, L_STATES + M_STATES);
    build_u_table(w + 104, u);
  }
};

struct FseHeader {
  uint32_t n_raw_bytes;
  uint32_t lit_num, lit_pay, lit_bits; uint16_t lit_state[4];
  uint32_t lmd_num, lmd_pay, lmd_bits; uint16_t lmd_state[3];
};

static int parse_v2_header(const uint8_t* p, FseHeader* h, uint32_t* n_weights) {
  h->n_raw_bytes = rd32(p + 4);
  uint64_t a = rd64(p + 8), b = rd64(p + 16), c = rd64(p + 24);
  h->lit_num = a & 0xFFFFF;
  h->lit_pay = (a >> 20) & 0xFFFFF;
  h->lmd_num = (a >> 40) & 0xFFFFF;
  h->lit_bits = 7 - (uint32_t)(a >> 60);
  h->lit_state[0] = b & 0x3FF; h->lit_state[1] = (b >> 10) & 0x3FF;
  h->lit_state[2] = (b >> 20) & 0x3FF; h->lit_state[3] = (b >> 30) & 0x3FF;
  h->lmd_pay = (b >> 40) & 0xFFFFF;
  h->lmd_bits = 7 - (uint32_t)((b >> 60) & 7);
  uint32_t header_size = (uint32_t)c;
  h->lmd_state[0] = (c >> 32) & 0x3FF; h->lmd_state[1] = (c >> 42) & 0x3FF;
  h->lmd_state[2] = (c >> 52) & 0x3FF;
  *n_weights = header_size - V2_HEADER;
  return 0;
}

static inline uint16_t rd16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }

static int parse_v1_header(const uint8_t* p, FseHeader* h) {
  h->n_raw_bytes = rd32(p + 4);
  uint32_t n_pay = rd32(p + 8);
  h->lit_num = rd32(p + 12);
  h->lmd_num = rd32(p + 16);
  h->lit_pay = rd32(p + 20);
  h->lmd_pay = rd32(p + 24);
  h->lit_bits = (uint32_t)(-(int32_t)rd32(p + 28));
  for (int i = 0; i < 4; i++) h->lit_state[i] = rd16(p + 32 + 2 * i);
  h->lmd_bits = (uint32_t)(-(int32_t)rd32(p + 40));
  for (int i = 0; i < 3; i++) h->lmd_state[i] = rd16(p + 44 + 2 * i);
  if (n_pay < h->lit_pay + h->lmd_pay) return -E_FSE;
  return 0;
}

static bool validate_header(const FseHeader& h) {
  uint64_t lmd_cap = 1024 + 8 + ((uint64_t)h.lmd_num * 54 + 7) / 8;
  uint64_t lit_cap = 1024 + ((uint64_t)h.lit_num * 10 + 7) / 8;
  if (h.lit_num % 4 || h.lit_num > LITERALS_PER_BLOCK || h.lit_pay > lit_cap) return false;
  if (h.lmd_num > LMDS_PER_BLOCK || h.lmd_pay < 8 || h.lmd_pay > lmd_cap) return false;
  if (h.lit_bits > 7 || h.lmd_bits > 7) return false;
  for (int i = 0; i < 4; i++) if (h.lit_state[i] >= U_STATES) return false;
  if (h.lmd_state[0] >= L_STATES || h.lmd_state[1] >= M_STATES || h.lmd_state[2] >= D_STATES) return false;
  if ((uint64_t)h.n_raw_bytes > (uint64_t)h.lit_num + (uint64_t)h.lmd_num * MAX_M) return false;
  return true;
}

struct FseDecoder {
  FseTables tabs;
  uint16_t weights[N_WEIGHTS];
  uint8_t literals[LITERALS_PER_BLOCK + 64];
  std::vector<uint8_t> scratch;

  // payload: raw pointer/len from the container (includes leading 8-byte
  // borrow/pad). Copies into a zero-padded scratch for safe 64-bit loads.
  bool make_reader(BitRd* br, const uint8_t* payload, size_t n, int off) {
    scratch.assign(n + 16, 0);
    memcpy(scratch.data() + 8, payload, n);
    return br->init(scratch.data(), n, off);
  }

  int decode_literals(const uint8_t* payload, size_t n, const FseHeader& h) {
    BitRd br;
    if (!make_reader(&br, payload, n, (int)h.lit_bits)) return -E_BADBITS;
    int s0 = h.lit_state[0], s1 = h.lit_state[1], s2 = h.lit_state[2], s3 = h.lit_state[3];
    for (uint32_t i = 0; i < h.lit_num; i += 4) {
      const UEntry& e0 = tabs.u[s0]; literals[i] = e0.sym; s0 = (int)br.pull(e0.k) + e0.delta;
      const UEntry& e1 = tabs.u[s1]; literals[i + 1] = e1.sym; s1 = (int)br.pull(e1.k) + e1.delta;
      const UEntry& e2 = tabs.u[s2]; literals[i + 2] = e2.sym; s2 = (int)br.pull(e2.k) + e2.delta;
      const UEntry& e3 = tabs.u[s3]; literals[i + 3] = e3.sym; s3 = (int)br.pull(e3.k) + e3.delta;
      br.flush();  // <=40 bits per group (literals.rs:65-77 discipline)
    }
    if (!br.finalize()) return -E_UNDERFLOW;
    if (s0 | s1 | s2 | s3) return -E_FSE;
    return 0;
  }

  int decode_lmds_to(Sink& sink, const uint8_t* payload, size_t n, const FseHeader& h) {
    BitRd br;
    if (!make_reader(&br, payload, n, (int)h.lmd_bits)) return -E_BADBITS;
    int sl = h.lmd_state[0], sm = h.lmd_state[1] + L_STATES,
        sd = h.lmd_state[2] + L_STATES + M_STATES;
    uint32_t lit_idx = 0, n_match = 0, dist = 0;
    for (uint32_t i = 0; i < h.lmd_num; i++) {
      br.flush();  // <=54 bits per LMD group (lmds.rs:41-51 discipline)
      const VEntry& el = tabs.v[sl];
      sl = (int)br.pull(el.k) + el.delta;
      uint32_t l = el.vbase + br.pull(el.vbits);
      const VEntry& em = tabs.v[sm];
      sm = (int)br.pull(em.k) + em.delta;
      uint32_t m = em.vbase + br.pull(em.vbits);
      const VEntry& ed = tabs.v[sd];
      sd = (int)br.pull(ed.k) + ed.delta;
      uint32_t d = ed.vbase + br.pull(ed.vbits);
      if (d) dist = d;
      if (lit_idx + l > h.lit_num || lit_idx + l > LITERALS_PER_BLOCK) return -E_FSE;
      int rc = sink.write_slack(literals + lit_idx, l);  // scratch has +64 pad
      if (rc) return rc;
      lit_idx += l;
      if (m) {
        n_match += m;
        rc = sink.write_match(m, dist);
        if (rc) return rc;
      }
    }
    if (!br.finalize()) return -E_UNDERFLOW;
    if (sl != 0 || sm != L_STATES || sd != L_STATES + M_STATES) return -E_FSE;
    if (lit_idx > h.lit_num || n_match + lit_idx != h.n_raw_bytes) return -E_FSE;
    return 0;
  }

  // Rows-producing LMD decode for the parallel one-shot path: identical
  // stream semantics and validity checks to decode_lmds_to, but (l, m,
  // raw-d) land in `rows` instead of the sink — repeat-D resolution and
  // the distance-vs-produced check happen at ordered replay time (the
  // sink's write_match validates d exactly as the sequential path).
  struct Row { uint16_t l, m; uint32_t d; };
  int decode_lmds_rows(Row* rows, const uint8_t* payload, size_t n,
                       const FseHeader& h) {
    BitRd br;
    if (!make_reader(&br, payload, n, (int)h.lmd_bits)) return -E_BADBITS;
    int sl = h.lmd_state[0], sm = h.lmd_state[1] + L_STATES,
        sd = h.lmd_state[2] + L_STATES + M_STATES;
    uint32_t lit_idx = 0, n_match = 0;
    for (uint32_t i = 0; i < h.lmd_num; i++) {
      br.flush();
      const VEntry& el = tabs.v[sl];
      sl = (int)br.pull(el.k) + el.delta;
      uint32_t l = el.vbase + br.pull(el.vbits);
      const VEntry& em = tabs.v[sm];
      sm = (int)br.pull(em.k) + em.delta;
      uint32_t m = em.vbase + br.pull(em.vbits);
      const VEntry& ed = tabs.v[sd];
      sd = (int)br.pull(ed.k) + ed.delta;
      uint32_t d = ed.vbase + br.pull(ed.vbits);
      if (lit_idx + l > h.lit_num || lit_idx + l > LITERALS_PER_BLOCK)
        return -E_FSE;
      lit_idx += l;
      n_match += m;
      rows[i] = Row{(uint16_t)l, (uint16_t)m, d};
    }
    if (!br.finalize()) return -E_UNDERFLOW;
    if (sl != 0 || sm != L_STATES || sd != L_STATES + M_STATES) return -E_FSE;
    if (lit_idx > h.lit_num || n_match + lit_idx != h.n_raw_bytes) return -E_FSE;
    return 0;
  }
};

// LZVN op decode (src/vn/constants.rs:38-72 grammar)
static int decode_vn(Sink& sink, const uint8_t* p, size_t n_pay, uint32_t n_raw) {
  size_t i = 0;
  size_t raw0 = sink.len;
  uint32_t dist = 0;
  for (;;) {
    if (i + 8 > n_pay) return -E_UNDERFLOW;
    uint8_t op = p[i];
    uint32_t l, m, d;
    size_t c;
    if (op >= 0xF0) {          // SmlM / LrgM
      if (op == 0xF0) { m = p[i + 1] + 0x10u; c = 2; } else { m = op & 0xF; c = 1; }
      int rc = sink.write_match(m, dist);
      if (rc) return rc;
      i += c;
      continue;
    }
    if (op >= 0xE0) {          // SmlL / LrgL
      if (op == 0xE0) { l = p[i + 1] + 0x10u; c = 2; } else { l = op & 0xF; c = 1; }
      if (i + c + l + 8 > n_pay) return -E_UNDERFLOW;
      int rc = sink.write(p + i + c, l);
      if (rc) return rc;
      i += c + l;
      continue;
    }
    if ((op & 0xE0) == 0xA0) { // MedD
      uint32_t opu = (uint32_t)p[i] | ((uint32_t)p[i + 1] << 8) | ((uint32_t)p[i + 2] << 16);
      m = (((opu & 7) << 2) | ((opu >> 8) & 3)) + 3;
      l = (opu >> 3) & 3;
      d = (opu >> 10) & 0x3FFF;
      c = 3;
    } else if ((op >= 0x70 && op <= 0x7F) || (op >= 0xD0 && op <= 0xDF)) {
      return -E_VN;              // Udef rows (constants.rs:54-55, 66-67)
    } else if ((op & 7) == 7) {  // LrgD
      m = ((op >> 3) & 7) + 3;
      l = (op >> 6) & 3;
      d = (uint32_t)p[i + 1] | ((uint32_t)p[i + 2] << 8);
      c = 3;
    } else if ((op & 7) == 6) {  // specials + PreD
      if (op == 0x06) {          // EOS
        if (memcmp(p + i, "\x06\x00\x00\x00\x00\x00\x00\x00", 8)) return -E_VN;
        i += 8;
        break;
      }
      if (op == 0x0E || op == 0x16) { i += 1; continue; }        // Nop
      if (op == 0x1E || op == 0x26 || op == 0x2E || op == 0x36 || op == 0x3E)
        return -E_VN;            // Udef
      m = ((op >> 3) & 7) + 3;   // PreD
      l = (op >> 6) & 3;
      d = dist;
      c = 1;
    } else {                     // SmlD
      m = ((op >> 3) & 7) + 3;
      l = (op >> 6) & 3;
      d = (((uint32_t)op & 7) << 8) | p[i + 1];
      c = 2;
    }
    if (i + c + l + 8 > n_pay) return -E_UNDERFLOW;
    int rc = sink.write(p + i + c, l);
    if (rc) return rc;
    rc = sink.write_match(m, d);
    if (rc) return rc;
    dist = d;
    i += c + l;
  }
  if (i != n_pay) return i < n_pay ? -E_OVERFLOW : -E_UNDERFLOW;
  if (sink.len - raw0 != n_raw) return -E_VN;
  return 0;
}

static int64_t decode_container(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  Sink sink{dst, cap};
  FseDecoder* fd = new FseDecoder();
  size_t pos = 0;
  int rc = 0;
  for (;;) {
    if (n - pos < 4) { rc = -E_UNDERFLOW; break; }
    uint32_t magic = rd32(src + pos);
    if (magic == MAGIC_EOS) {
      pos += 4;
      if (pos != n) rc = -E_OVERFLOW;
      break;
    }
    if (magic == MAGIC_VX2 || magic == MAGIC_VX1) {
      FseHeader h;
      uint32_t n_weights;
      size_t header;
      if (magic == MAGIC_VX2) {
        if (n - pos < (size_t)V2_HEADER) { rc = -E_UNDERFLOW; break; }
        parse_v2_header(src + pos, &h, &n_weights);
        if (n_weights > (uint32_t)V2_WEIGHTS_MAX) { rc = -E_FSE; break; }
        header = V2_HEADER;
      } else {
        if (n - pos < (size_t)V1_HEADER) { rc = -E_UNDERFLOW; break; }
        rc = parse_v1_header(src + pos, &h);
        if (rc) break;
        n_weights = V1_WEIGHTS;
        header = V1_HEADER;
      }
      if (!validate_header(h)) { rc = -E_FSE; break; }
      if (n - pos < header + n_weights + h.lit_pay + h.lmd_pay) { rc = -E_UNDERFLOW; break; }
      if (magic == MAGIC_VX2) {
        rc = load_weights_v2(src + pos + header, n_weights, fd->weights);
        if (rc) break;
      } else {
        for (int i = 0; i < N_WEIGHTS; i++) fd->weights[i] = rd16(src + pos + header + 2 * i);
      }
      if (!check_totals(fd->weights)) { rc = -E_FSE; break; }
      fd->tabs.init(fd->weights);
      const uint8_t* lit_payload = src + pos + header + n_weights - 8;  // borrow 8
      rc = fd->decode_literals(lit_payload, h.lit_pay + 8, h);
      if (rc) break;
      const uint8_t* lmd_payload = src + pos + header + n_weights + h.lit_pay;
      rc = fd->decode_lmds_to(sink, lmd_payload, h.lmd_pay, h);
      if (rc) break;
      pos += header + n_weights + h.lit_pay + h.lmd_pay;
    } else if (magic == MAGIC_VXN) {
      if (n - pos < 12) { rc = -E_UNDERFLOW; break; }
      uint32_t n_raw = rd32(src + pos + 4), n_pay = rd32(src + pos + 8);
      if (n - pos < 12 + (size_t)n_pay) { rc = -E_UNDERFLOW; break; }
      rc = decode_vn(sink, src + pos + 12, n_pay, n_raw);
      if (rc) break;
      pos += 12 + n_pay;
    } else if (magic == MAGIC_RAW) {
      if (n - pos < 8) { rc = -E_UNDERFLOW; break; }
      uint32_t n_raw = rd32(src + pos + 4);
      if (n - pos < 8 + (size_t)n_raw) { rc = -E_UNDERFLOW; break; }
      rc = sink.write(src + pos + 8, n_raw);
      if (rc) break;
      pos += 8 + n_raw;
    } else {
      rc = -E_BADBLOCK;
      break;
    }
  }
  size_t out = sink.len;
  delete fd;
  return rc ? rc : (int64_t)out;
}

// ========================================================== PARALLEL DECODE
// Multi-threaded one-shot decode. FSE blocks are entropy-independent (each
// header carries its own weights and initial states), so their tANS decode
// parallelizes across a persistent worker pool; only the LZ replay is
// sequential (matches reference earlier output, so block replay must run
// in container order). Workers decode blocks into a bounded window of
// slots; the calling thread replays finished slots in order into the sink.
// Output is byte-identical to decode_container by construction, and ANY
// error (structure, entropy, or replay) re-runs the whole container
// through decode_container so error semantics are exactly the sequential
// engine's. The reference decoder is one sequential state machine
// (src/decode/decoder.rs:72-99); this parallel plane has no counterpart.

struct WorkerPool {
  std::mutex mu;
  std::condition_variable cv_go, cv_fin;
  uint64_t gen = 0;
  int n_threads = 0, n_done = 0;
  std::function<void()> job;
  std::mutex serial;  // one parallel decode at a time (try_lock by callers)

  void ensure_locked() {
    if (n_threads) return;
    unsigned hc = std::thread::hardware_concurrency();
    if (hc > 8) hc = 8;
    n_threads = hc > 2 ? (int)hc - 1 : 1;  // leave the replay thread a core
    for (int t = 0; t < n_threads; t++) {
      std::thread([this] {
        uint64_t seen = 0;
        std::unique_lock<std::mutex> lk(mu);
        for (;;) {
          cv_go.wait(lk, [&] { return gen != seen; });
          seen = gen;
          std::function<void()> f = job;
          lk.unlock();
          f();
          lk.lock();
          if (++n_done == n_threads) cv_fin.notify_all();
        }
      }).detach();
    }
  }
  void launch(std::function<void()> f) {
    std::lock_guard<std::mutex> lk(mu);
    ensure_locked();
    job = std::move(f);
    n_done = 0;
    gen++;
    cv_go.notify_all();
  }
  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv_fin.wait(lk, [&] { return n_done == n_threads; });
  }
};

static WorkerPool& mt_pool() {
  // intentionally leaked: destroying a condvar with detached waiters at
  // process exit is UB (observed as an exit hang)
  static WorkerPool* p = new WorkerPool();
  return *p;
}

struct MtSlot {
  FseDecoder fd;
  std::vector<FseDecoder::Row> rows;
  int rc = 0;
};

constexpr size_t MT_SLOTS = 24;

// persistent slot arena (leaked; ~3.5MB): per-call allocation + first-touch
// page faults of the 130KB/slot buffers cost more than the decode of a
// typical block. pool.serial guarantees exclusive use.
static std::vector<MtSlot>& mt_slots() {
  static std::vector<MtSlot>* s = [] {
    auto* v = new std::vector<MtSlot>(MT_SLOTS);
    for (auto& x : *v) x.rows.resize(LMDS_PER_BLOCK);
    return v;
  }();
  return *s;
}

static int64_t decode_container_mt(const uint8_t* src, size_t n, uint8_t* dst,
                                   size_t cap) {
  // walk: structure + header validation mirroring decode_container; any
  // rejection (or a dirty tail) defers to the sequential engine so the
  // reported error is exactly its code
  struct BD {
    uint8_t kind;  // 0 fse, 1 vn, 2 raw
    uint8_t v2;
    FseHeader h;
    uint32_t n_weights;
    size_t wts_off, lit_off, lmd_off;
    size_t pay_off;
    uint32_t n_raw, n_pay;
  };
  std::vector<BD> blocks;
  size_t n_fse = 0, pos = 0;
  bool clean = false;
  for (;;) {
    if (n - pos < 4 || pos > n) break;
    uint32_t magic = rd32(src + pos);
    if (magic == MAGIC_EOS) {
      pos += 4;
      clean = pos == n;
      break;
    }
    if (magic == MAGIC_VX2 || magic == MAGIC_VX1) {
      BD b;
      b.kind = 0;
      b.v2 = magic == MAGIC_VX2;
      size_t header;
      if (b.v2) {
        if (n - pos < (size_t)V2_HEADER) break;
        parse_v2_header(src + pos, &b.h, &b.n_weights);
        if (b.n_weights > (uint32_t)V2_WEIGHTS_MAX) break;
        header = V2_HEADER;
      } else {
        if (n - pos < (size_t)V1_HEADER) break;
        if (parse_v1_header(src + pos, &b.h)) break;
        b.n_weights = V1_WEIGHTS;
        header = V1_HEADER;
      }
      if (!validate_header(b.h)) break;
      if (n - pos < header + b.n_weights + b.h.lit_pay + b.h.lmd_pay) break;
      b.wts_off = pos + header;
      b.lit_off = pos + header + b.n_weights - 8;  // 8-byte borrow
      b.lmd_off = pos + header + b.n_weights + b.h.lit_pay;
      blocks.push_back(b);
      n_fse++;
      pos += header + b.n_weights + b.h.lit_pay + b.h.lmd_pay;
    } else if (magic == MAGIC_VXN) {
      if (n - pos < 12) break;
      BD b;
      b.kind = 1;
      b.n_raw = rd32(src + pos + 4);
      b.n_pay = rd32(src + pos + 8);
      if (n - pos < 12 + (size_t)b.n_pay) break;
      b.pay_off = pos + 12;
      blocks.push_back(b);
      pos += 12 + b.n_pay;
    } else if (magic == MAGIC_RAW) {
      if (n - pos < 8) break;
      BD b;
      b.kind = 2;
      b.n_raw = rd32(src + pos + 4);
      if (n - pos < 8 + (size_t)b.n_raw) break;
      b.pay_off = pos + 8;
      blocks.push_back(b);
      pos += 8 + b.n_raw;
    } else {
      break;
    }
  }
  // threads pay off only once the pipeline reaches steady state: below
  // ~16 FSE blocks (~1.5MB raw) the wake latency + the rows pass's extra
  // memory traffic outweigh the overlap (measured on the corpus: per-file
  // mt was 5-10% SLOWER; a 300-block container is 1.25x faster)
  WorkerPool& pool = mt_pool();
  if (!clean || n_fse < 16 || std::thread::hardware_concurrency() < 2
      || !pool.serial.try_lock())
    return decode_container(src, n, dst, cap);
  std::lock_guard<std::mutex> sl(pool.serial, std::adopt_lock);

  size_t n_slots = n_fse < MT_SLOTS ? n_fse : MT_SLOTS;
  std::vector<MtSlot>& slots = mt_slots();
  std::vector<uint32_t> fse_blk;
  fse_blk.reserve(n_fse);
  for (size_t i = 0; i < blocks.size(); i++)
    if (blocks[i].kind == 0) fse_blk.push_back((uint32_t)i);

  std::mutex mu;
  std::condition_variable cv_free, cv_done;
  std::vector<uint8_t> state(n_slots, 0);  // 0 free, 1 decoded
  size_t next_claim = 0;
  std::atomic<bool> abort{false};

  pool.launch([&]() {
    for (;;) {
      size_t j;
      {
        std::unique_lock<std::mutex> lk(mu);
        for (;;) {
          if (next_claim >= n_fse || abort.load(std::memory_order_relaxed))
            return;
          if (state[next_claim % n_slots] == 0) break;
          cv_free.wait(lk);
        }
        j = next_claim++;
      }
      MtSlot& s = slots[j % n_slots];
      const BD& b = blocks[fse_blk[j]];
      int rc = 0;
      if (b.v2) {
        rc = load_weights_v2(src + b.wts_off, b.n_weights, s.fd.weights);
      } else {
        for (int i = 0; i < N_WEIGHTS; i++)
          s.fd.weights[i] = rd16(src + b.wts_off + 2 * i);
      }
      if (!rc && !check_totals(s.fd.weights)) rc = -E_FSE;
      if (!rc) {
        s.fd.tabs.init(s.fd.weights);
        rc = s.fd.decode_literals(src + b.lit_off, b.h.lit_pay + 8, b.h);
      }
      if (!rc)
        rc = s.fd.decode_lmds_rows(s.rows.data(), src + b.lmd_off,
                                   b.h.lmd_pay, b.h);
      s.rc = rc;
      {
        std::lock_guard<std::mutex> lk(mu);
        state[j % n_slots] = 1;
      }
      cv_done.notify_all();
      if (rc) {
        abort.store(true, std::memory_order_relaxed);
        cv_free.notify_all();
        return;
      }
    }
  });

  Sink sink{dst, cap};
  int err = 0;
  size_t fse_seq = 0;
  for (size_t bi = 0; bi < blocks.size() && !err; bi++) {
    const BD& b = blocks[bi];
    if (b.kind == 1) {
      err = decode_vn(sink, src + b.pay_off, b.n_pay, b.n_raw);
      continue;
    }
    if (b.kind == 2) {
      err = sink.write(src + b.pay_off, b.n_raw);
      continue;
    }
    size_t j = fse_seq++;
    MtSlot& s = slots[j % n_slots];
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_done.wait(lk, [&] { return state[j % n_slots] == 1; });
    }
    if (s.rc) {
      err = s.rc;
      break;
    }
    const uint8_t* lits = s.fd.literals;
    uint32_t li = 0, dist = 0;
    for (uint32_t i = 0; i < b.h.lmd_num && !err; i++) {
      FseDecoder::Row r = s.rows[i];
      if (r.d) dist = r.d;
      if (r.l) {
        err = sink.write_slack(lits + li, r.l);  // literals has +64 pad
        li += r.l;
      }
      if (!err && r.m) err = sink.write_match(r.m, dist);
    }
    if (err) break;
    {
      std::lock_guard<std::mutex> lk(mu);
      state[j % n_slots] = 0;
    }
    cv_free.notify_all();
  }
  abort.store(true, std::memory_order_relaxed);
  cv_free.notify_all();
  pool.wait();
  if (err) return decode_container(src, n, dst, cap);
  return (int64_t)sink.len;
}

// ========================================================= STREAMING DECODE
// Constant-memory decode of unbounded containers (the role of the
// reference's ReaderCore::fill + ring output, src/decode/reader_core.rs:
// 56-99,171-188 and src/ring/ring_lz_writer.rs:31-57). Redesigned for the
// hybrid host/TPU runtime: instead of an input ring + retro-patched output
// ring, we buffer at most one bounded FSE block (~121 KB by header
// validation), decode its LMD rows up front (the sub-block suspend point —
// the counterpart of FseCore::decode_n, src/fse/fse_core.rs:143-198 — is a
// row-granular emission cursor), and emit through a 1 MiB power-of-two
// output ring that always retains more history than the format's maximum
// match distance (262139 < 2^18). LZVN opcodes and RAW bodies stream
// through with O(1) carry, so total memory is O(1) for any input.

constexpr size_t RING_LOG = 20, RING_SZ = (size_t)1 << RING_LOG;

struct RingSink {
  std::vector<uint8_t> buf;
  uint64_t wpos = 0, rpos = 0;  // total produced / total drained
  RingSink() : buf(RING_SZ) {}
  size_t free_space() const { return RING_SZ - (size_t)(wpos - rpos); }
  size_t pending() const { return (size_t)(wpos - rpos); }
  // caller guarantees free_space() >= n. Writing at wpos only clobbers the
  // byte RING_SZ back, which is always older than the max match distance.
  void write(const uint8_t* p, size_t n) {
    size_t o = (size_t)(wpos & (RING_SZ - 1));
    size_t first = n < RING_SZ - o ? n : RING_SZ - o;
    memcpy(&buf[o], p, first);
    memcpy(&buf[0], p + first, n - first);
    wpos += n;
  }
  void write_match(uint32_t m, uint32_t d) {  // d pre-validated by caller
    while (m) {
      size_t o = (size_t)(wpos & (RING_SZ - 1));
      size_t s = (size_t)((wpos - d) & (RING_SZ - 1));
      size_t run = m;
      if (run > d) run = d;                       // overlap period
      if (run > RING_SZ - o) run = RING_SZ - o;   // dst wrap
      if (run > RING_SZ - s) run = RING_SZ - s;   // src wrap
      memcpy(&buf[o], &buf[s], run);  // run <= d < RING/2: never aliases
      wpos += run;
      m -= (uint32_t)run;
    }
  }
  size_t drain(uint8_t* dst, size_t cap) {
    size_t n = pending() < cap ? pending() : cap;
    size_t o = (size_t)(rpos & (RING_SZ - 1));
    size_t first = n < RING_SZ - o ? n : RING_SZ - o;
    memcpy(dst, &buf[o], first);
    memcpy(dst + first, &buf[0], n - first);
    rpos += n;
    return n;
  }
};

enum StreamState { S_MAGIC, S_FSE_EMIT, S_VN, S_RAW, S_DONE, S_ERR };

struct StreamDec {
  RingSink ring;
  FseDecoder* fd = new FseDecoder();
  // decoded LMD rows of the current FSE block (bounded by format caps)
  std::vector<uint32_t> rl, rm, rdist;
  uint32_t n_rows = 0, row = 0, lit_idx = 0, l_left = 0, m_left = 0,
           cur_d = 0;
  uint64_t blk_left = 0;                    // RAW bytes remaining
  uint64_t vn_i = 0, vn_pay = 0, blk0 = 0;  // VN cursor / payload / start pos
  uint32_t vn_raw = 0, vn_dist = 0;
  std::vector<uint8_t> carry;
  size_t carry_off = 0;
  StreamState st = S_MAGIC;
  int err = 0;
  ~StreamDec() { delete fd; }

  size_t carry_avail() const { return carry.size() - carry_off; }
  void carry_compact() {
    if (carry_off == carry.size()) { carry.clear(); carry_off = 0; }
    else if (carry_off > (64 << 10)) {
      carry.erase(carry.begin(), carry.begin() + carry_off);
      carry_off = 0;
    }
  }
  // move up to `want` total bytes of lookahead into the carry
  void fill(size_t want, const uint8_t* p, size_t n, size_t* used) {
    if (carry_avail() >= want) return;
    size_t take = want - carry_avail();
    if (take > n - *used) take = n - *used;
    carry.insert(carry.end(), p + *used, p + *used + take);
    *used += take;
  }

  // decode the LMD stream into rows with the exact check order of the
  // one-shot path (decode_lmds_to), using a virtual produced-bytes counter
  // so emission itself cannot fail later
  int decode_rows(const uint8_t* payload, size_t n, const FseHeader& h) {
    BitRd br;
    if (!fd->make_reader(&br, payload, n, (int)h.lmd_bits)) return -E_BADBITS;
    int sl = h.lmd_state[0], sm = h.lmd_state[1] + L_STATES,
        sd = h.lmd_state[2] + L_STATES + M_STATES;
    rl.resize(h.lmd_num); rm.resize(h.lmd_num); rdist.resize(h.lmd_num);
    uint32_t li = 0, n_match = 0, dist = 0;
    uint64_t produced = ring.wpos;
    for (uint32_t i = 0; i < h.lmd_num; i++) {
      br.flush();
      const VEntry& el = fd->tabs.v[sl];
      sl = (int)br.pull(el.k) + el.delta;
      uint32_t l = el.vbase + br.pull(el.vbits);
      const VEntry& em = fd->tabs.v[sm];
      sm = (int)br.pull(em.k) + em.delta;
      uint32_t m = em.vbase + br.pull(em.vbits);
      const VEntry& ed = fd->tabs.v[sd];
      sd = (int)br.pull(ed.k) + ed.delta;
      uint32_t d = ed.vbase + br.pull(ed.vbits);
      if (d) dist = d;
      if (li + l > h.lit_num || li + l > LITERALS_PER_BLOCK) return -E_FSE;
      produced += l;
      li += l;
      if (m) {
        if (dist == 0 || (uint64_t)dist > produced) return -E_BADD;
        n_match += m;
        produced += m;
      }
      rl[i] = l; rm[i] = m; rdist[i] = dist;
    }
    if (!br.finalize()) return -E_UNDERFLOW;
    if (sl != 0 || sm != L_STATES || sd != L_STATES + M_STATES) return -E_FSE;
    if (li > h.lit_num || n_match + li != h.n_raw_bytes) return -E_FSE;
    n_rows = h.lmd_num; row = 0; lit_idx = 0; l_left = 0; m_left = 0;
    return 0;
  }

  // emit decoded rows into the ring as far as space allows; true = block done
  bool emit_fse() {
    for (;;) {
      if (l_left == 0 && m_left == 0) {
        if (row == n_rows) return true;
        l_left = rl[row]; m_left = rm[row]; cur_d = rdist[row];
        row++;
      }
      if (l_left) {
        size_t c = ring.free_space();
        if (c == 0) return false;
        if (c > l_left) c = l_left;
        ring.write(fd->literals + lit_idx, c);
        lit_idx += (uint32_t)c;
        l_left -= (uint32_t)c;
        if (l_left) return false;
      }
      if (m_left) {
        size_t c = ring.free_space();
        if (c == 0) return false;
        if (c > m_left) c = m_left;
        ring.write_match((uint32_t)c, cur_d);
        m_left -= (uint32_t)c;
        if (m_left) return false;
      }
    }
  }

  // one LZVN opcode from the carry; 0 = emitted, 1 = need input,
  // 2 = ring full, 3 = payload done, <0 error. Bounds follow decode_vn
  // exactly, using the virtual payload cursor vn_i against vn_pay.
  int vn_step() {
    if (vn_pay - vn_i < 8) return -E_UNDERFLOW;  // decode_vn's i+8 bound
    size_t need = vn_pay - vn_i;
    if (need > 512) need = 512;
    if (carry_avail() < need) return 1;
    if (ring.free_space() < 600) return 2;
    const uint8_t* p = carry.data() + carry_off;
    size_t rem = vn_pay - vn_i;  // bytes of payload from vn_i to end
    uint8_t op = p[0];
    uint32_t l, m, d;
    size_t c;
    if (op >= 0xF0) {
      if (op == 0xF0) { m = p[1] + 0x10u; c = 2; } else { m = op & 0xF; c = 1; }
      if (vn_dist == 0 || (uint64_t)vn_dist > ring.wpos) return -E_BADD;
      ring.write_match(m, vn_dist);
      vn_i += c; carry_off += c;
      return 0;
    }
    if (op >= 0xE0) {
      if (op == 0xE0) { l = p[1] + 0x10u; c = 2; } else { l = op & 0xF; c = 1; }
      if (c + l + 8 > rem) return -E_UNDERFLOW;
      ring.write(p + c, l);
      vn_i += c + l; carry_off += c + l;
      return 0;
    }
    if ((op & 0xE0) == 0xA0) {
      uint32_t opu = (uint32_t)p[0] | ((uint32_t)p[1] << 8)
                     | ((uint32_t)p[2] << 16);
      m = (((opu & 7) << 2) | ((opu >> 8) & 3)) + 3;
      l = (opu >> 3) & 3;
      d = (opu >> 10) & 0x3FFF;
      c = 3;
    } else if ((op >= 0x70 && op <= 0x7F) || (op >= 0xD0 && op <= 0xDF)) {
      return -E_VN;
    } else if ((op & 7) == 7) {
      m = ((op >> 3) & 7) + 3;
      l = (op >> 6) & 3;
      d = (uint32_t)p[1] | ((uint32_t)p[2] << 8);
      c = 3;
    } else if ((op & 7) == 6) {
      if (op == 0x06) {
        if (memcmp(p, "\x06\x00\x00\x00\x00\x00\x00\x00", 8)) return -E_VN;
        vn_i += 8; carry_off += 8;
        if (vn_i != vn_pay) return vn_i < vn_pay ? -E_OVERFLOW : -E_UNDERFLOW;
        if (ring.wpos - blk0 != vn_raw) return -E_VN;
        return 3;
      }
      if (op == 0x0E || op == 0x16) { vn_i += 1; carry_off += 1; return 0; }
      if (op == 0x1E || op == 0x26 || op == 0x2E || op == 0x36 || op == 0x3E)
        return -E_VN;
      m = ((op >> 3) & 7) + 3;
      l = (op >> 6) & 3;
      d = vn_dist;
      c = 1;
    } else {
      m = ((op >> 3) & 7) + 3;
      l = (op >> 6) & 3;
      d = (((uint32_t)op & 7) << 8) | p[1];
      c = 2;
    }
    if (c + l + 8 > rem) return -E_UNDERFLOW;
    ring.write(p + c, l);
    if (d == 0 || (uint64_t)d > ring.wpos) return -E_BADD;
    ring.write_match(m, d);
    vn_dist = d;
    vn_i += c + l; carry_off += c + l;
    return 0;
  }

  // Consume input / make progress. Returns bytes consumed; sets err on
  // failure. Stops early only when blocked on output-ring space.
  size_t push(const uint8_t* p, size_t n) {
    size_t used = 0;
    for (;;) {
      if (st == S_ERR) return used;
      if (st == S_DONE) {
        if (used < n || carry_avail()) { err = -E_OVERFLOW; st = S_ERR; }
        return used;
      }
      if (st == S_RAW) {
        // drain any carry first, then stream directly from the input
        while (blk_left) {
          size_t space = ring.free_space();
          if (space == 0) return used;
          size_t c = carry_avail();
          const uint8_t* src = carry.data() + carry_off;
          bool from_carry = c > 0;
          if (!from_carry) { c = n - used; src = p + used; }
          if (c == 0) return used;
          if (c > blk_left) c = (size_t)blk_left;
          if (c > space) c = space;
          ring.write(src, c);
          blk_left -= c;
          if (from_carry) carry_off += c; else used += c;
        }
        carry_compact();
        st = S_MAGIC;
        continue;
      }
      if (st == S_VN) {
        int rc = vn_step();
        if (rc == 0) continue;
        if (rc == 1) {
          size_t want = vn_pay - vn_i;
          if (want > 512) want = 512;
          size_t before = carry_avail();
          fill(want, p, n, &used);
          if (carry_avail() == before) return used;  // out of input
          continue;
        }
        if (rc == 2) return used;  // ring full
        if (rc == 3) { carry_compact(); st = S_MAGIC; continue; }
        err = rc; st = S_ERR;
        return used;
      }
      if (st == S_FSE_EMIT) {
        if (!emit_fse()) return used;  // ring full
        st = S_MAGIC;
        continue;
      }
      // S_MAGIC: need a block header (bounded lookahead via carry)
      fill(4, p, n, &used);
      if (carry_avail() < 4) return used;
      const uint8_t* hp = carry.data() + carry_off;
      uint32_t magic = rd32(hp);
      if (magic == MAGIC_EOS) {
        carry_off += 4;
        carry_compact();
        st = S_DONE;
        continue;
      }
      if (magic == MAGIC_RAW) {
        fill(8, p, n, &used);
        if (carry_avail() < 8) return used;
        blk_left = rd32(carry.data() + carry_off + 4);
        carry_off += 8;
        st = S_RAW;
        continue;
      }
      if (magic == MAGIC_VXN) {
        fill(12, p, n, &used);
        if (carry_avail() < 12) return used;
        vn_raw = rd32(carry.data() + carry_off + 4);
        vn_pay = rd32(carry.data() + carry_off + 8);
        carry_off += 12;
        vn_i = 0; blk0 = ring.wpos;
        st = S_VN;
        continue;
      }
      if (magic == MAGIC_VX2 || magic == MAGIC_VX1) {
        size_t header = magic == MAGIC_VX2 ? (size_t)V2_HEADER
                                           : (size_t)V1_HEADER;
        fill(header, p, n, &used);
        if (carry_avail() < header) return used;
        FseHeader h;
        uint32_t n_weights;
        hp = carry.data() + carry_off;
        if (magic == MAGIC_VX2) {
          parse_v2_header(hp, &h, &n_weights);
          if (n_weights > (uint32_t)V2_WEIGHTS_MAX) {
            err = -E_FSE; st = S_ERR; return used;
          }
        } else {
          int rc = parse_v1_header(hp, &h);
          if (rc) { err = rc; st = S_ERR; return used; }
          n_weights = V1_WEIGHTS;
        }
        if (!validate_header(h)) { err = -E_FSE; st = S_ERR; return used; }
        size_t total = header + n_weights + h.lit_pay + h.lmd_pay;
        fill(total, p, n, &used);
        if (carry_avail() < total) return used;
        hp = carry.data() + carry_off;
        int rc;
        if (magic == MAGIC_VX2) {
          rc = load_weights_v2(hp + header, n_weights, fd->weights);
          if (rc) { err = rc; st = S_ERR; return used; }
        } else {
          for (int i = 0; i < N_WEIGHTS; i++)
            fd->weights[i] = rd16(hp + header + 2 * i);
        }
        if (!check_totals(fd->weights)) { err = -E_FSE; st = S_ERR; return used; }
        fd->tabs.init(fd->weights);
        rc = fd->decode_literals(hp + header + n_weights - 8, h.lit_pay + 8, h);
        if (rc) { err = rc; st = S_ERR; return used; }
        rc = decode_rows(hp + header + n_weights + h.lit_pay, h.lmd_pay, h);
        if (rc) { err = rc; st = S_ERR; return used; }
        carry_off += total;
        carry_compact();
        st = S_FSE_EMIT;
        continue;
      }
      err = -E_BADBLOCK;
      st = S_ERR;
      return used;
    }
  }

  int64_t pull(uint8_t* dst, size_t cap) {
    size_t out = 0;
    for (;;) {
      out += ring.drain(dst + out, cap - out);
      if (out == cap) break;
      // input-free progress: resume a suspended emission
      if (st == S_FSE_EMIT || st == S_RAW || st == S_VN) {
        uint64_t before = ring.wpos;
        push(nullptr, 0);
        if (ring.wpos != before) continue;
      }
      break;
    }
    if (out == 0 && st == S_ERR) return err;
    return (int64_t)out;
  }

  int finish() const {
    if (st == S_ERR) return err;
    if (st != S_DONE || carry_avail()) return -E_UNDERFLOW;
    return 0;
  }
};

// probe: decode size without decompressing (src/decode/probe.rs)
static int64_t probe_container(const uint8_t* src, size_t n) {
  size_t pos = 0;
  uint64_t raw = 0;
  for (;;) {
    if (n - pos < 4) return -E_UNDERFLOW;
    uint32_t magic = rd32(src + pos);
    if (magic == MAGIC_EOS) { pos += 4; return pos == n ? (int64_t)raw : -E_OVERFLOW; }
    if (magic == MAGIC_VX2) {
      if (n - pos < (size_t)V2_HEADER) return -E_UNDERFLOW;
      FseHeader h; uint32_t nw;
      parse_v2_header(src + pos, &h, &nw);
      if (nw > (uint32_t)V2_WEIGHTS_MAX || !validate_header(h)) return -E_FSE;
      raw += h.n_raw_bytes;
      pos += V2_HEADER + nw + h.lit_pay + h.lmd_pay;
    } else if (magic == MAGIC_VX1) {
      if (n - pos < (size_t)V1_HEADER) return -E_UNDERFLOW;
      FseHeader h;
      if (parse_v1_header(src + pos, &h) || !validate_header(h)) return -E_FSE;
      raw += h.n_raw_bytes;
      pos += V1_HEADER + V1_WEIGHTS + h.lit_pay + h.lmd_pay;
    } else if (magic == MAGIC_VXN) {
      if (n - pos < 12) return -E_UNDERFLOW;
      raw += rd32(src + pos + 4);
      pos += 12 + rd32(src + pos + 8);
    } else if (magic == MAGIC_RAW) {
      if (n - pos < 8) return -E_UNDERFLOW;
      uint32_t r = rd32(src + pos + 4);
      raw += r;
      pos += 8 + r;
    } else return -E_BADBLOCK;
    if (pos > n) return -E_UNDERFLOW;
  }
}

// ============================================================== ENCODE SIDE

// History table: 2^14 buckets x 4-way FIFO (src/encode/history.rs)
constexpr int HASH_BITS = 14, HASH_WIDTH = 4;
constexpr uint32_t GOOD_MATCH = 0x28;

struct HistItem { uint32_t val; int32_t pos; };
struct History { HistItem q[HASH_WIDTH]; };

static inline uint32_t hash_fse(uint32_t v) { return (v * 0x9E3779B1u) >> (32 - HASH_BITS); }
static inline uint32_t hash_vn(uint32_t v) { return ((v & 0xFFFFFF) * 0x9E3779B1u) >> (32 - HASH_BITS); }

static inline size_t lcp_fwd(const uint8_t* s, size_t i, size_t j, size_t len, size_t max) {
  while (len + 8 <= max) {
    uint64_t x = rd64(s + i + len) ^ rd64(s + j + len);
    if (x) return len + (__builtin_ctzll(x) >> 3);
    len += 8;
  }
  while (len < max && s[i + len] == s[j + len]) len++;
  return len;
}

static inline size_t lcp_bwd(const uint8_t* s, size_t i, size_t j, size_t max) {
  size_t len = 0;
  // word-at-a-time backwards: compare the 8 bytes ENDING at i-len/j-len
  // (reads stay inside the buffer: i-len-8 >= i-max-8 >= 0 is guaranteed
  // by max <= min(i, j) - 0 only when both have 8 bytes of headroom)
  while (len + 8 <= max) {
    uint64_t x = rd64(s + i - len - 8) ^ rd64(s + j - len - 8);
    if (x) return len + (__builtin_clzll(x) >> 3);
    len += 8;
  }
  while (len < max && s[i - len - 1] == s[j - len - 1]) len++;
  return len;
}

// FSE encode backend (fse/backend.rs + buffer.rs semantics)
struct FseBackend {
  struct Lmd { uint16_t l, m; uint32_t d; };
  // vector-backed so the parallel-emission encoder can hand a closed
  // block to a worker with two O(1) swaps instead of a ~120KB copy on
  // the frontend's critical path; `lits`/`lmds` alias .data() and all
  // hot-loop accesses go through them (re-aimed after a swap)
  std::vector<uint8_t> lits_v = std::vector<uint8_t>(LITERALS_PER_BLOCK + 8);
  std::vector<Lmd> lmds_v = std::vector<Lmd>(LMDS_PER_BLOCK);
  uint8_t* lits = lits_v.data();
  Lmd* lmds = lmds_v.data();
  int n_lit = 0, n_lmd = 0;
  uint32_t n_match_bytes = 0, match_distance = 0;
  std::vector<uint8_t>* out;

  void reset() { n_lit = 0; n_lmd = 0; n_match_bytes = 0; match_distance = 0; }

  void push_l(uint16_t l) {
    match_distance = 1;
    lmds[n_lmd++] = {l, 0, 1};
  }
  void push_lmd(uint16_t l, uint16_t m, uint32_t d) {
    lmds[n_lmd++] = {l, m, match_distance == d ? 0u : d};
    match_distance = d;
    n_match_bytes += m;
  }

  // Buffer::push (fse/buffer.rs:44-97). Returns true when fully consumed.
  bool push(const uint8_t** lit, size_t* lit_len, uint32_t* m, uint32_t d) {
    while (*lit_len > MAX_L) {
      if (n_lmd == LMDS_PER_BLOCK) return false;
      uint32_t limit = LITERALS_PER_BLOCK - n_lit;
      if (MAX_L <= limit) {
        memcpy(lits + n_lit, *lit, MAX_L); n_lit += MAX_L; *lit += MAX_L; *lit_len -= MAX_L;
        push_l(MAX_L);
      } else if (limit) {
        memcpy(lits + n_lit, *lit, limit); n_lit += limit; *lit += limit; *lit_len -= limit;
        push_l((uint16_t)limit);
        return false;
      } else return false;
    }
    if (n_lmd == LMDS_PER_BLOCK) return false;
    uint32_t literal_len = (uint32_t)*lit_len;
    uint32_t limit = LITERALS_PER_BLOCK - n_lit;
    if (literal_len <= limit) {
      memcpy(lits + n_lit, *lit, literal_len); n_lit += literal_len; *lit += literal_len; *lit_len = 0;
    } else if (limit) {
      memcpy(lits + n_lit, *lit, limit); n_lit += limit; *lit += limit; *lit_len -= limit;
      push_l((uint16_t)limit);
      return false;
    } else return false;
    while (*m > MAX_M) {
      push_lmd((uint16_t)literal_len, MAX_M, d);
      *m -= MAX_M;
      literal_len = 0;
      if (n_lmd == LMDS_PER_BLOCK) return false;
    }
    push_lmd((uint16_t)literal_len, (uint16_t)*m, d);
    *m = 0;
    return true;
  }

  void push_match(const uint8_t* lit, size_t lit_len, uint32_t m, uint32_t d) {
    for (;;) {
      if (push(&lit, &lit_len, &m, d)) return;
      emit_block();
    }
  }
  void push_literals(const uint8_t* lit, size_t lit_len) { push_match(lit, lit_len, 0, 1); }
  void finalize() { emit_block(); }

  // dump mode: serialize raw block contents (for the device emission
  // plane — the TPU runs the tANS state scans, the host packs) instead of
  // encoding. Format per block: u32 n_lit, u32 n_lmd, u32 n_match_bytes,
  // lits[n_lit], then n_lmd x (u16 l, u16 m, u32 d packed).
  std::vector<uint8_t>* dump = nullptr;
  // parallel-emission mode: hand each closed block to the caller (who
  // queues it for pool emission via emit_into) instead of encoding inline
  std::function<void(FseBackend&)> on_block;

  void emit_block() {
    if (on_block) {
      on_block(*this);
      reset();
      return;
    }
    if (dump) {
      uint32_t hdr[3] = {(uint32_t)n_lit, (uint32_t)n_lmd, n_match_bytes};
      dump->insert(dump->end(), (uint8_t*)hdr, (uint8_t*)hdr + 12);
      dump->insert(dump->end(), lits, lits + n_lit);
      dump->insert(dump->end(), (uint8_t*)lmds, (uint8_t*)(lmds + n_lmd));
      reset();
      return;
    }
    emit_block_encoded();
  }

  void emit_block_encoded() { emit_best(lits, n_lit, lmds, n_lmd,
                                        n_match_bytes, out); reset(); }

  // Period-split candidate (the "reps" rule): a match with running
  // distance d in [4, 15] and m > d can equivalently emit as m/d pieces
  // of length d (+ remainder) — each piece a zero-extra-bit direct M
  // symbol and a repeat-D, so on strongly periodic data the whole stream
  // entropy-codes to ~0 bits/row and beats the big-match chunking that
  // pays the top-M-symbol extra bits per row (Apple's encoder emits this
  // shape on reps13..15; the lzfse_rust reference never does and loses
  // there). d >= 4 keeps the candidate inside the encoder's normal match
  // vocabulary (the finder's minimum match length) — in particular d < 4
  // runs (e.g. zeros) are never rewritten, preserving the reference
  // golden outputs. Returns false when no row qualifies or the expansion
  // would overflow the block's LMD cap.
  // Rows are scanned as LOGICAL matches: a row plus its continuation rows
  // (l == 0, stored d == 0 — the MAX_M chunking the buffer already
  // applied), so one long periodic match re-splits with a single
  // remainder piece instead of one per 2359-chunk.
  static bool period_split(const Lmd* lmds, int n_lmd, std::vector<Lmd>& b) {
    uint32_t dist = 0;
    long long total = 0;
    bool any = false;
    for (int i = 0; i < n_lmd;) {
      uint32_t de = lmds[i].d ? lmds[i].d : dist;
      if (lmds[i].d) dist = lmds[i].d;
      long long m = lmds[i].m;
      int j = i + 1;
      while (j < n_lmd && lmds[j].l == 0 && lmds[j].d == 0) {
        m += lmds[j].m;
        j++;
      }
      if (de >= 4 && de <= 15 && m > (long long)de) {
        any = true;
        total += m / de + (m % de ? 1 : 0);
      } else {
        total += j - i;
      }
      i = j;
    }
    if (!any || total > LMDS_PER_BLOCK) return false;
    b.clear();
    b.reserve((size_t)total);
    dist = 0;
    for (int i = 0; i < n_lmd;) {
      Lmd t = lmds[i];
      uint32_t de = t.d ? t.d : dist;
      if (t.d) dist = t.d;
      long long m = t.m;
      int j = i + 1;
      while (j < n_lmd && lmds[j].l == 0 && lmds[j].d == 0) {
        m += lmds[j].m;
        j++;
      }
      if (!(de >= 4 && de <= 15 && m > (long long)de)) {
        for (int k = i; k < j; k++) b.push_back(lmds[k]);
      } else {
        b.push_back({t.l, (uint16_t)de, t.d});
        m -= de;
        while (m >= (long long)de) {
          b.push_back({0, (uint16_t)de, 0});
          m -= de;
        }
        if (m) b.push_back({0, (uint16_t)m, 0});
      }
      i = j;
    }
    return true;
  }

  // Emit the smaller of the as-is block and its period-split candidate
  // (tie keeps the as-is form, so outputs only ever change when the
  // candidate is strictly smaller). Every encoding engine routes block
  // emission through this single decision point.
  static void emit_best(uint8_t* lits, int n_lit, const Lmd* lmds, int n_lmd,
                        uint32_t n_match_bytes, std::vector<uint8_t>* out) {
    std::vector<Lmd> alt;
    if (!period_split(lmds, n_lmd, alt)) {
      emit_into(lits, n_lit, lmds, n_lmd, n_match_bytes, out);
      return;
    }
    std::vector<uint8_t> a, b;
    emit_into(lits, n_lit, lmds, n_lmd, n_match_bytes, &a);
    emit_into(lits, n_lit, alt.data(), (int)alt.size(), n_match_bytes, &b);
    const std::vector<uint8_t>& best = b.size() < a.size() ? b : a;
    out->insert(out->end(), best.begin(), best.end());
  }

  // Whole-block tANS emission as a pure function of the block contents —
  // shared by the sequential backend and the parallel-emission encoder
  // (blocks are independent, so emission parallelizes with no effect on
  // bytes). `lits` must have 3 writable slack bytes (pad-to-4).
  static void emit_into(uint8_t* lits, int n_lit, const Lmd* lmds, int n_lmd,
                        uint32_t n_match_bytes, std::vector<uint8_t>* out) {
    // weights from unpadded content (emit_block_v2, fse/backend.rs:39-54)
    uint16_t w[N_WEIGHTS];
    memset(w, 0, sizeof w);
    for (int i = 0; i < n_lmd; i++) {
      w[DV.l_sym[lmds[i].l]]++;
      w[20 + DV.m_sym[lmds[i].m]]++;
      w[40 + DV.d_sym[d_index(lmds[i].d)]]++;
    }
    for (int i = 0; i < n_lit; i++) w[104 + lits[i]]++;
    if (n_lmd) {
      normalize_m1(w, 20, n_lmd, L_STATES);
      normalize_m1(w + 20, 20, n_lmd, M_STATES);
      normalize_m1(w + 40, 64, n_lmd, D_STATES);
    }
    if (n_lit) normalize_m1(w + 104, 256, n_lit, U_STATES);

    EEntry el[L_SYMS], em[M_SYMS], ed[D_SYMS], eu[U_SYMS];
    build_e_table(w, L_SYMS, L_STATES, el);
    build_e_table(w + 20, M_SYMS, M_STATES, em);
    build_e_table(w + 40, D_SYMS, D_STATES, ed);
    build_e_table(w + 104, U_SYMS, U_STATES, eu);

    size_t mark = out->size();
    out->resize(mark + V2_HEADER);  // placeholder header
    uint8_t wbuf[V2_WEIGHTS_MAX];
    size_t n_weights = store_weights_v2(w, wbuf);
    out->insert(out->end(), wbuf, wbuf + n_weights);

    // literals: pad to 4 with lits[0], reverse 4-state encode
    int padded = (n_lit + 3) & ~3;
    uint8_t pad_byte = n_lit ? lits[0] : 0;
    for (int i = n_lit; i < padded; i++) lits[i] = pad_byte;
    size_t lit_mark = out->size();
    BitWr bw{out};
    uint32_t u0 = U_STATES, u1 = U_STATES, u2 = U_STATES, u3 = U_STATES;
    for (int i = padded; i > 0; i -= 4) {
      e_encode(bw, &u3, eu[lits[i - 1]]);
      e_encode(bw, &u2, eu[lits[i - 2]]);
      e_encode(bw, &u1, eu[lits[i - 3]]);
      e_encode(bw, &u0, eu[lits[i - 4]]);
    }
    int lit_off = bw.finalize();
    uint32_t lit_pay = (uint32_t)(out->size() - lit_mark);

    // lmds: 8-byte pad then reverse D,M,L encode
    size_t lmd_mark = out->size();
    out->insert(out->end(), 8, 0);
    BitWr bw2{out};
    uint32_t sl = L_STATES, sm = M_STATES, sd = D_STATES;
    for (int i = n_lmd - 1; i >= 0; i--) {
      const Lmd& t = lmds[i];
      int dsym = DV.d_sym[d_index(t.d)];
      bw2.push(t.d - D_BASE[dsym], D_EXTRA[dsym]);
      e_encode(bw2, &sd, ed[dsym]);
      int msym = DV.m_sym[t.m];
      bw2.push(t.m - M_BASE[msym], M_EXTRA[msym]);
      e_encode(bw2, &sm, em[msym]);
      int lsym = DV.l_sym[t.l];
      bw2.push(t.l - L_BASE[lsym], L_EXTRA[lsym]);
      e_encode(bw2, &sl, el[lsym]);
    }
    int lmd_off = bw2.finalize();
    uint32_t lmd_pay = (uint32_t)(out->size() - lmd_mark);

    // patch the v2 header (block.rs:168-196)
    uint8_t* hp = out->data() + mark;
    wr32(hp, MAGIC_VX2);
    wr32(hp + 4, (uint32_t)n_lit + n_match_bytes);
    uint64_t a = (uint64_t)padded | ((uint64_t)lit_pay << 20) | ((uint64_t)n_lmd << 40)
                 | ((uint64_t)(7 - lit_off) << 60);
    wr64(hp + 8, a);
    uint64_t b = (uint64_t)(u0 - U_STATES) | ((uint64_t)(u1 - U_STATES) << 10)
                 | ((uint64_t)(u2 - U_STATES) << 20) | ((uint64_t)(u3 - U_STATES) << 30)
                 | ((uint64_t)lmd_pay << 40) | ((uint64_t)(7 - lmd_off) << 60);
    wr64(hp + 16, b);
    uint64_t c = (uint64_t)(V2_HEADER + n_weights) | ((uint64_t)(sl - L_STATES) << 32)
                 | ((uint64_t)(sm - M_STATES) << 42) | ((uint64_t)(sd - D_STATES) << 52);
    wr64(hp + 24, c);
  }
};

// LZVN backend (vn/backend.rs semantics)
struct VnBackend {
  std::vector<uint8_t>* out;
  uint32_t match_distance = 0, n_literals = 0, n_match_bytes = 0;
  size_t mark;

  void init() {
    mark = out->size();
    out->insert(out->end(), 12, 0);  // header placeholder
  }
  void lits_ops(const uint8_t* lit, size_t n, bool allow_small_tail) {
    size_t p = 0;
    while (n - p >= 0x10) {
      size_t take = n - p < 0x10F ? n - p : 0x10F;
      out->push_back(0xE0);
      out->push_back((uint8_t)(take - 0x10));
      out->insert(out->end(), lit + p, lit + p + take);
      p += take;
    }
    size_t rem = n - p;
    if (rem > 0 && (allow_small_tail || rem >= 4)) {
      out->push_back((uint8_t)(0xE0 | rem));
      out->insert(out->end(), lit + p, lit + p + rem);
      p += rem;
    }
    rem_start = p;
  }
  size_t rem_start = 0;

  void push_literals(const uint8_t* lit, size_t n) {
    n_literals += (uint32_t)n;
    lits_ops(lit, n, true);
  }

  void push_match(const uint8_t* lit, size_t n, uint32_t m, uint32_t d) {
    n_literals += (uint32_t)n;
    n_match_bytes += m;
    lits_ops(lit, n, false);
    size_t l = n - rem_start;
    const uint8_t* tail = lit + rem_start;
    uint32_t mx = 0x0A - 2 * (uint32_t)l;
    uint32_t mm = m < mx ? m : mx;
    m -= mm;
    if (d == match_distance) {
      if (l == 0) {
        out->push_back((uint8_t)(0xF0 | mm));
      } else {  // PreD
        out->push_back((uint8_t)((l << 6) | ((mm - 3) << 3) | 0x6));
        out->insert(out->end(), tail, tail + l);
      }
    } else if (d < 0x600) {  // SmlD
      out->push_back((uint8_t)((l << 6) | ((mm - 3) << 3) | ((d >> 8) & 7)));
      out->push_back((uint8_t)(d & 0xFF));
      out->insert(out->end(), tail, tail + l);
    } else if (d >= 0x4000 || m == 0 || mm + m > 0x22) {  // LrgD
      out->push_back((uint8_t)((l << 6) | ((mm - 3) << 3) | 0x7));
      out->push_back((uint8_t)(d & 0xFF));
      out->push_back((uint8_t)(d >> 8));
      out->insert(out->end(), tail, tail + l);
    } else {  // MedD
      uint32_t md = mm - 3;
      out->push_back((uint8_t)(0xA0 | (l << 3) | ((md >> 2) & 7)));
      uint16_t rest = (uint16_t)((md & 3) | (d << 2));
      out->push_back((uint8_t)(rest & 0xFF));
      out->push_back((uint8_t)(rest >> 8));
      out->insert(out->end(), tail, tail + l);
    }
    match_distance = d;
    while (m > 0x0F) {
      uint32_t take = m < 0x10F ? m : 0x10F;
      out->push_back(0xF0);
      out->push_back((uint8_t)(take - 0x10));
      m -= take;
    }
    if (m) out->push_back((uint8_t)(0xF0 | m));
  }

  void finalize() {
    static const uint8_t eos[8] = {0x06, 0, 0, 0, 0, 0, 0, 0};
    out->insert(out->end(), eos, eos + 8);
    uint8_t* hp = out->data() + mark;
    wr32(hp, MAGIC_VXN);
    wr32(hp + 4, n_literals + n_match_bytes);
    wr32(hp + 8, (uint32_t)(out->size() - mark - 12));
  }
};

// Frontend: sequential hot loop with the reference's exact selection
// semantics (frontend_bytes.rs:160-268, match_object.rs:12-33).
template <typename Backend, bool VN>
static void run_frontend(const uint8_t* src, size_t n, Backend& backend) {
  if (n < 4) {
    if (n) backend.push_literals(src, n);
    backend.finalize();
    return;
  }
  // thread_local arena: a fresh 512KB vector per call costs ~128 page
  // faults (5-10% of a 100KB-input encode); the re-init writes are cheap
  // on warm pages. Bounded (one table per thread), so the streaming
  // engines' constant-RSS contracts are unaffected.
  static thread_local std::vector<History> table;
  table.resize((size_t)1 << HASH_BITS);
  for (auto& h : table)
    for (auto& item : h.q) item = {0, (int32_t)0 - 0x40000000};
  const uint32_t max_d = VN ? 0xFFFF : MAX_D;
  const uint32_t unit_mask = VN ? 0x00FFFFFF : 0xFFFFFFFF;

  size_t limit = n - 3;
  size_t literal_index = 0;
  size_t index = 0;
  struct M { size_t idx, midx; uint32_t len; } pending{0, 0, 0};

  // Prefetch distance: the per-position bucket load is a dependent random
  // access into the 512KB table — on incompressible data (no matches, one
  // position per iteration) it is THE bottleneck. The probe value at
  // index+PF is already in sequential source bytes, so its bucket address
  // is computable early; prefetching it hides the miss behind PF
  // iterations of work. Semantics-free: decisions never change.
  constexpr size_t PF = 24;
  // int32 distance math is exact below 1 GiB (table init pos -2^30);
  // larger windows take the scalar int64 probe path
  const bool narrow = n < ((size_t)1 << 30);
  (void)narrow;

  while (index < limit) {
    uint32_t val = rd32(src + index);
    if (index + PF < limit) {
      uint32_t vp = rd32(src + index + PF);
      __builtin_prefetch(&table[VN ? hash_vn(vp) : hash_fse(vp)], 1);
    }
    History& bucket = table[VN ? hash_vn(val) : hash_fse(val)];
    // Dead-bucket fast path: q[0] is the newest entry, so if IT is out of
    // range the whole bucket is (ordering invariant) — store the new head
    // and leave the stale tail unshifted. Stale entries are older than a
    // known out-of-range one, so every future probe (larger index) breaks
    // at or before them: exact same decisions, 8B traffic instead of 64B
    // on the incompressible-data common case. In-range buckets take the
    // reference's copy+shift+probe (vectorizes better than a fused
    // load-store-compare chain — measured 16-19% on match-dense corpus).
    M inc{0, 0, 0};
    if ((int64_t)index - bucket.q[0].pos > (int64_t)max_d) {
      bucket.q[0] = {val, (int32_t)index};
    } else {
#if defined(__AVX2__)
      // Branchless probe (FSE unit only; positions must fit int32 math —
      // index < 2^30 with the -2^30 table init keeps dist < 2^31).
      // Probing ALL in-range equal entries instead of breaking at the
      // first out-of-range one is exact: bucket positions are newest-
      // first monotonic, so everything past an out-of-range entry is
      // also out of range (the dead-bucket invariant above). Lane order
      // q0..q3 with strict `>` keeps the reference's tie-break.
      if (!VN && narrow) {
        __m256i B = _mm256_loadu_si256((const __m256i*)&bucket);
        const __m256i SH = _mm256_setr_epi32(0, 0, 0, 1, 2, 3, 4, 5);
        __m256i shifted = _mm256_permutevar8x32_epi32(B, SH);
        __m256i ni = _mm256_castsi128_si256(
            _mm_set_epi32(0, 0, (int)index, (int)val));
        _mm256_storeu_si256((__m256i*)&bucket,
                            _mm256_blend_epi32(shifted, ni, 0x3));
        __m256i eq = _mm256_cmpeq_epi32(B, _mm256_set1_epi32((int)val));
        __m256i pos = _mm256_srli_epi64(B, 32);
        __m256i dist =
            _mm256_sub_epi32(_mm256_set1_epi32((int)index), pos);
        __m256i out =
            _mm256_cmpgt_epi32(dist, _mm256_set1_epi32((int)max_d));
        uint32_t mm = (uint32_t)_mm256_movemask_ps(_mm256_castsi256_ps(
                          _mm256_andnot_si256(out, eq))) &
                      0x55u;
        if (mm) {
          alignas(32) int32_t tmp[8];
          _mm256_store_si256((__m256i*)tmp, B);
          do {
            int lane = __builtin_ctz(mm);
            mm &= mm - 1;
            size_t cpos = (size_t)(uint32_t)tmp[lane + 1];
            uint32_t len =
                (uint32_t)lcp_fwd(src, index, cpos, 4, n - index);
            if (len > inc.len) { inc.len = len; inc.midx = cpos; }
          } while (mm);
        }
      } else {
#else
      {
#endif
        History copy = bucket;
        for (int i = HASH_WIDTH - 1; i > 0; i--)
          bucket.q[i] = bucket.q[i - 1];
        bucket.q[0] = {val, (int32_t)index};
        for (int i = 0; i < HASH_WIDTH; i++) {
          int64_t dist = (int64_t)index - copy.q[i].pos;
          if (dist > (int64_t)max_d) break;
          uint32_t x = val ^ copy.q[i].val;
          uint32_t len;
          if (x == 0) {
            len = (uint32_t)lcp_fwd(src, index, (size_t)copy.q[i].pos, 4,
                                    n - index);
          } else if (VN && (x & unit_mask) == 0) {
            len = 3;
          } else continue;
          if (len > inc.len) { inc.len = len; inc.midx = (size_t)copy.q[i].pos; }
        }
      }
    }
    if (inc.len) {
      inc.idx = index;
      size_t ext = lcp_bwd(src, inc.idx, inc.midx,
                           std::min(inc.idx - literal_index, inc.midx));
      inc.idx -= ext;
      inc.midx -= ext;
      inc.len += (uint32_t)ext;

      // Match::select
      M sel{0, 0, 0};
      bool emit = false;
      if (inc.len >= GOOD_MATCH) { sel = inc; pending.len = 0; emit = true; }
      else if (pending.len == 0) { pending = inc; }
      else if (pending.idx + pending.len <= inc.idx) { sel = pending; pending = inc; emit = true; }
      else if (inc.len > pending.len) { sel = inc; pending.len = 0; emit = true; }
      else { sel = pending; pending.len = 0; emit = true; }

      if (emit) {
        backend.push_match(src + literal_index, sel.idx - literal_index,
                           sel.len, (uint32_t)(sel.idx - sel.midx));
        literal_index = sel.idx + sel.len;
        if (literal_index >= limit) break;
        size_t next = index + 1;
        // sync_history: push skipped positions (same dead-bucket fast path)
        while (next < literal_index) {
          uint32_t v2 = rd32(src + next);
          if (next + PF < literal_index) {
            uint32_t vp = rd32(src + next + PF);
            __builtin_prefetch(&table[VN ? hash_vn(vp) : hash_fse(vp)], 1);
          }
          History& b2 = table[VN ? hash_vn(v2) : hash_fse(v2)];
          if ((int64_t)next - b2.q[0].pos > (int64_t)max_d) {
            b2.q[0] = {v2, (int32_t)next};
          } else {
#if defined(__AVX2__)
            __m256i B2v = _mm256_loadu_si256((const __m256i*)&b2);
            const __m256i SH2 = _mm256_setr_epi32(0, 0, 0, 1, 2, 3, 4, 5);
            __m256i ni2 = _mm256_castsi128_si256(
                _mm_set_epi32(0, 0, (int)next, (int)v2));
            _mm256_storeu_si256(
                (__m256i*)&b2,
                _mm256_blend_epi32(_mm256_permutevar8x32_epi32(B2v, SH2),
                                   ni2, 0x3));
#else
            for (int i = HASH_WIDTH - 1; i > 0; i--) b2.q[i] = b2.q[i - 1];
            b2.q[0] = {v2, (int32_t)next};
#endif
          }
          next++;
        }
        index = next;
        if (index >= limit) break;
        continue;
      }
    }
    index++;
  }
  if (pending.len && literal_index < limit) {
    backend.push_match(src + literal_index, pending.idx - literal_index,
                       pending.len, (uint32_t)(pending.idx - pending.midx));
    literal_index = pending.idx + pending.len;
  }
  if (literal_index < n) backend.push_literals(src + literal_index, n - literal_index);
  backend.finalize();
}

// ======================================================= STREAMING ENCODE
// Sliding-window ring encode (the reference's frontend_ring Goldilocks
// semantics, src/encode/frontend_ring.rs:44-106,359-397): matches may reach
// up to the format's maximum distance (262139) back across chunk
// boundaries. Redesign: instead of a literal input ring with split-probe
// logic, each processing step re-runs the one-shot frontend over
// [history | new chunk] and a clipping backend drops everything below the
// emission base — straddling literal runs keep their suffix, straddling
// matches keep their tail (same distance; remnants under 4 bytes are
// literalized). The FseBackend persists across chunks, so blocks fill and
// span chunk boundaries exactly as a continuous encode would. The history
// re-scan costs ~1.5x frontend work for 512 KB chunks; probes are exact
// because a history-table FIFO walk breaks at the first out-of-reach entry,
// so candidates only ever depend on the last max_d+3 bytes.

constexpr size_t ENC_HIST = (size_t)MAX_D + 5;     // > max distance + probe
constexpr size_t ENC_CHUNK = (size_t)512 << 10;    // processing granule

struct ClipFseBackend {
  FseBackend* inner;
  const uint8_t* src = nullptr;
  uint64_t base = 0, cursor = 0;

  void unit(const uint8_t* lit, size_t lit_len, uint32_t m, uint32_t d) {
    uint64_t end = cursor + lit_len + m;
    if (end <= base) { cursor = end; return; }
    if (cursor >= base) {
      if (m) inner->push_match(lit, lit_len, m, d);
      else inner->push_literals(lit, lit_len);
    } else {
      uint64_t skip = base - cursor;
      if (skip < lit_len) {  // literals straddle: keep suffix
        if (m) inner->push_match(lit + skip, lit_len - skip, m, d);
        else inner->push_literals(lit + skip, lit_len - skip);
      } else {               // match straddles: keep the tail
        uint32_t mk = (uint32_t)(end - base);
        if (mk >= 4) inner->push_match(lit, 0, mk, d);
        else inner->push_literals(src + base, mk);
      }
    }
    cursor = end;
  }
  void push_match(const uint8_t* lit, size_t n, uint32_t m, uint32_t d) {
    unit(lit, n, m, d);
  }
  void push_literals(const uint8_t* lit, size_t n) { unit(lit, n, 0, 1); }
  void finalize() {}  // block flush is the stream's finish decision
};

struct StreamEnc {
  FseBackend* fb = new FseBackend();
  std::vector<uint8_t> out;     // emitted container bytes awaiting drain
  size_t out_off = 0;
  std::vector<uint8_t> window;  // history + pending input
  size_t processed = 0;         // prefix of `window` already emitted
  uint64_t n_raw = 0;
  bool finished = false;

  StreamEnc() { fb->out = &out; }
  ~StreamEnc() { delete fb; }

  void step() {
    ClipFseBackend cb{fb, window.data(), processed, 0};
    run_frontend<ClipFseBackend, false>(window.data(), window.size(), cb);
    processed = window.size();
    if (processed > ENC_HIST) {  // slide: keep max-distance reach of history
      size_t cut = processed - ENC_HIST;
      window.erase(window.begin(), window.begin() + cut);
      processed -= cut;
    }
  }

  // Granule boundaries are fixed at ENC_CHUNK multiples of the raw stream,
  // independent of push sizes, so the emitted bytes do not depend on how
  // the caller chunks its writes (the reference ring encoder's fixed-fill
  // property, ring_encoder.rs).
  void push(const uint8_t* p, size_t n) {
    n_raw += n;
    while (n) {
      size_t room = ENC_CHUNK - (window.size() - processed);
      size_t take = n < room ? n : room;
      window.insert(window.end(), p, p + take);
      p += take; n -= take;
      if (window.size() - processed == ENC_CHUNK) step();
    }
  }

  void finish() {
    if (finished) return;
    if (window.size() > processed) step();
    fb->finalize();  // flush the final (possibly empty) block
    uint32_t eos = MAGIC_EOS;
    out.insert(out.end(), (uint8_t*)&eos, (uint8_t*)&eos + 4);
    finished = true;
  }

  size_t drain(uint8_t* dst, size_t cap) {
    size_t n = out.size() - out_off;
    if (n > cap) n = cap;
    if (n) memcpy(dst, out.data() + out_off, n);  // data() may be null at n=0
    out_off += n;
    if (out_off == out.size()) { out.clear(); out_off = 0; }
    return n;
  }
};

static int64_t encode_container(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  std::vector<uint8_t> out;
  out.reserve(n + n / 2 + 256);
  if (n > 0x1000) {
    FseBackend* fb = new FseBackend();
    fb->out = &out;
    run_frontend<FseBackend, false>(src, n, *fb);
    delete fb;
  } else if (n > 0x14) {
    VnBackend vb;
    vb.out = &out;
    vb.init();
    run_frontend<VnBackend, true>(src, n, vb);
    // VN-not-smaller-than-raw rework (frontend_bytes.rs:92-99)
    if (n < 0x4000 && n + 8 <= out.size()) {
      out.clear();
      out.resize(8 + n);
      wr32(out.data(), MAGIC_RAW);
      wr32(out.data() + 4, (uint32_t)n);
      memcpy(out.data() + 8, src, n);
    }
  } else {
    out.resize(8 + n);
    wr32(out.data(), MAGIC_RAW);
    wr32(out.data() + 4, (uint32_t)n);
    memcpy(out.data() + 8, src, n);
  }
  uint32_t eos = MAGIC_EOS;
  out.insert(out.end(), (uint8_t*)&eos, (uint8_t*)&eos + 4);
  if (out.size() > cap) return -E_CAP;
  memcpy(dst, out.data(), out.size());
  return (int64_t)out.size();
}

// ========================================================== PARALLEL ENCODE
// Emission-parallel one-shot encode: the exact sequential frontend
// (selection semantics untouched — it decides identical block contents)
// streams each closed block to the worker pool, which runs the per-block
// tANS emission (FseBackend::emit_into) concurrently; bodies concatenate
// in block order, so output is byte-identical to encode_container. Wall
// time ~ max(frontend, emission / workers) instead of their sum.

struct EmitJob {
  std::vector<uint8_t> lits;            // swapped in from the backend
  std::vector<FseBackend::Lmd> lmds;    // swapped in from the backend
  int n_lit = 0, n_lmd = 0;
  uint32_t n_match_bytes = 0;
  std::vector<uint8_t> body;
};

constexpr size_t ENC_JOBS = 48;

// persistent job ring (leaked): full-size swap buffers + body capacity
// survive across calls so handoff costs two O(1) swaps, no allocation
static std::vector<EmitJob>& enc_jobs() {
  static std::vector<EmitJob>* j = [] {
    auto* v = new std::vector<EmitJob>(ENC_JOBS);
    for (auto& x : *v) {
      x.lits.resize(LITERALS_PER_BLOCK + 8);
      x.lmds.resize(LMDS_PER_BLOCK);
      x.body.reserve(LITERALS_PER_BLOCK + LMDS_PER_BLOCK * 8 + 4096);
    }
    return v;
  }();
  return *j;
}

static int64_t encode_container_mt(const uint8_t* src, size_t n, uint8_t* dst,
                                   size_t cap) {
  WorkerPool& pool = mt_pool();
  if (n < 0x10000 || std::thread::hardware_concurrency() < 2
      || !pool.serial.try_lock())
    return encode_container(src, n, dst, cap);
  std::lock_guard<std::mutex> sl(pool.serial, std::adopt_lock);

  std::vector<EmitJob>& jobs = enc_jobs();
  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  // ring slot states: 0 free, 1 queued (awaiting a worker), 2 emitted
  uint8_t state[ENC_JOBS] = {0};
  size_t n_blocks = 0;      // blocks produced so far (frontend)
  size_t next_claim = 0;    // next block a worker may take
  size_t next_drain = 0;    // next block to copy into dst (in order)
  uint8_t* wp = dst;
  size_t room = cap;
  bool produced_all = false, overflow = false, launched = false;

  // engaged lazily at the SECOND block: single-block containers (common
  // for match-dense data — 400KB can fit one block) emit inline and pay
  // only two O(1) swaps for the whole mt detour
  auto worker = [&]() {
    for (;;) {
      size_t j;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [&] {
          return next_claim < n_blocks || produced_all;
        });
        if (next_claim >= n_blocks) return;
        j = next_claim++;
      }
      EmitJob& e = jobs[j % ENC_JOBS];
      e.body.clear();
      FseBackend::emit_best(e.lits.data(), e.n_lit, e.lmds.data(), e.n_lmd,
                            e.n_match_bytes, &e.body);
      {
        std::lock_guard<std::mutex> lk(mu);
        state[j % ENC_JOBS] = 2;
      }
      cv_done.notify_one();  // at most one waiter (the frontend thread)
    }
  };

  // drain finished blocks in order into dst; frees ring slots
  auto drain_ready = [&](std::unique_lock<std::mutex>& lk) {
    while (next_drain < n_blocks && state[next_drain % ENC_JOBS] == 2) {
      EmitJob& e = jobs[next_drain % ENC_JOBS];
      lk.unlock();
      if (e.body.size() > room) {
        overflow = true;
        lk.lock();
        return;
      }
      memcpy(wp, e.body.data(), e.body.size());
      wp += e.body.size();
      room -= e.body.size();
      lk.lock();
      state[next_drain % ENC_JOBS] = 0;
      next_drain++;
      cv_job.notify_all();  // slot freed; frontend may be waiting
    }
  };

  {
    FseBackend* fb = new FseBackend();
    std::vector<uint8_t> unused;
    fb->out = &unused;
    fb->on_block = [&](FseBackend& b) {
      std::unique_lock<std::mutex> lk(mu);
      // wait for the ring slot, draining finished blocks while here
      for (;;) {
        drain_ready(lk);
        if (overflow) return;  // frontend keeps running; result discarded
        if (state[n_blocks % ENC_JOBS] == 0) break;
        cv_done.wait(lk);
      }
      EmitJob& e = jobs[n_blocks % ENC_JOBS];
      std::swap(e.lits, b.lits_v);
      std::swap(e.lmds, b.lmds_v);
      b.lits = b.lits_v.data();
      b.lmds = b.lmds_v.data();
      e.n_lit = b.n_lit;
      e.n_lmd = b.n_lmd;
      e.n_match_bytes = b.n_match_bytes;
      state[n_blocks % ENC_JOBS] = 1;
      n_blocks++;
      lk.unlock();
      if (!launched && n_blocks >= 2) {
        launched = true;
        pool.launch(worker);
      } else if (launched) {
        cv_job.notify_one();
      }
    };
    run_frontend<FseBackend, false>(src, n, *fb);
    delete fb;
  }
  if (!launched) {
    // 0 or 1 blocks: emit inline (the sequential engine's exact cost)
    for (size_t j = 0; j < n_blocks && !overflow; j++) {
      EmitJob& e = jobs[j];
      e.body.clear();
      FseBackend::emit_best(e.lits.data(), e.n_lit, e.lmds.data(), e.n_lmd,
                            e.n_match_bytes, &e.body);
      if (e.body.size() > room) {
        overflow = true;
        break;
      }
      memcpy(wp, e.body.data(), e.body.size());
      wp += e.body.size();
      room -= e.body.size();
    }
    if (overflow || room < 4) return -E_CAP;
    wr32(wp, MAGIC_EOS);
    return (int64_t)(wp + 4 - dst);
  }
  {
    std::lock_guard<std::mutex> lk(mu);
    produced_all = true;
  }
  cv_job.notify_all();
  {
    std::unique_lock<std::mutex> lk(mu);
    while (!overflow && next_drain < n_blocks) {
      drain_ready(lk);
      if (next_drain < n_blocks && !overflow)
        cv_done.wait(lk);
    }
  }
  pool.wait();
  if (overflow || room < 4) return -E_CAP;
  wr32(wp, MAGIC_EOS);
  return (int64_t)(wp + 4 - dst);
}

}  // namespace

extern "C" {

// Serving-process allocator tuning: keep freed large blocks in the arena
// (no mmap/munmap churn) so each decode batch's fresh output `bytes`
// objects land on already-faulted pages. Opt-in (TpuDecoder init) — the
// constant-memory streaming paths never call it, so their RSS contracts
// are unaffected. Raises steady-state RSS by about one batch of outputs.
long long tl_alloc_reuse(void) {
  mallopt(M_MMAP_THRESHOLD, 256 << 20);
  mallopt(M_TRIM_THRESHOLD, 256 << 20);
  return 0;
}


long long tl_decode_bound(const char* src, size_t n) {
  return probe_container((const uint8_t*)src, n);
}

long long tl_decode(const char* src, size_t n, char* dst, size_t cap) {
  return decode_container((const uint8_t*)src, n, (uint8_t*)dst, cap);
}

// Parallel one-shot decode: byte-identical output, identical error codes
// (falls back to the sequential engine on any error or small input).
long long tl_decode_mt(const char* src, size_t n, char* dst, size_t cap) {
  return decode_container_mt((const uint8_t*)src, n, (uint8_t*)dst, cap);
}

long long tl_encode_bound(size_t n) {
  // worst case: raw-ish expansion + per-block headers
  return (long long)(n + n / 8 + 4096);
}

long long tl_encode(const char* src, size_t n, char* dst, size_t cap) {
  return encode_container((const uint8_t*)src, n, (uint8_t*)dst, cap);
}

// Emission-parallel encode: byte-identical output (sequential exact
// frontend, pooled per-block emission); small inputs route sequentially.
long long tl_encode_mt(const char* src, size_t n, char* dst, size_t cap) {
  return encode_container_mt((const uint8_t*)src, n, (uint8_t*)dst, cap);
}

// Greedy/lazy selection + FSE block emission from a precomputed match
// stream (the TPU encoder's host epilogue). `stream` is n_matches rows of
// int64 (pos, match_pos, fwd_len, back_max) sorted by pos; emits the Vx2
// block body for this window (no container EOS).
static long long select_into_backend(const uint8_t* src, size_t n,
                                     const long long* stream,
                                     size_t n_matches, FseBackend* fb) {
  // Match::select scan (match_object.rs:12-33 + the hot-loop skip logic)
  size_t literal_index = 0;
  size_t limit = n >= 3 ? n - 3 : 0;
  size_t min_index = 0;
  struct M { size_t idx, midx; uint32_t len; } pending{0, 0, 0};
  struct Sel { size_t idx, midx; uint32_t len; };
  std::vector<Sel> sel;
  sel.reserve(n_matches / 2 + 1);
  bool done = false;
  for (size_t i = 0; i < n_matches && !done; i++) {
    size_t p = (size_t)stream[i * 4];
    if (p < min_index) continue;
    long long back_max = stream[i * 4 + 3];
    long long lit_cap = (long long)(p - literal_index);
    long long ext = back_max < lit_cap ? back_max : lit_cap;
    size_t idx = p - (size_t)ext;
    size_t midx = (size_t)stream[i * 4 + 1] - (size_t)ext;
    uint32_t len = (uint32_t)(stream[i * 4 + 2] + ext);

    M inc{idx, midx, len};
    M emit{0, 0, 0};
    if (inc.len >= GOOD_MATCH) { emit = inc; pending.len = 0; }
    else if (pending.len == 0) { pending = inc; continue; }
    else if (pending.idx + pending.len <= inc.idx) { emit = pending; pending = inc; }
    else if (inc.len > pending.len) { emit = inc; pending.len = 0; }
    else { emit = pending; pending.len = 0; }

    sel.push_back({emit.idx, emit.midx, emit.len});
    literal_index = emit.idx + emit.len;
    if (literal_index >= limit) { pending.len = 0; done = true; break; }
    min_index = p + 1 > literal_index ? p + 1 : literal_index;
  }
  if (pending.len) sel.push_back({pending.idx, pending.midx, pending.len});

  size_t li = 0;
  for (const Sel& s2 : sel) {
    fb->push_match(src + li, s2.idx - li, s2.len, (uint32_t)(s2.idx - s2.midx));
    li = s2.idx + s2.len;
  }
  if (li < n) fb->push_literals(src + li, n - li);
  fb->finalize();
  return 0;
}

long long tl_select_emit_fse(const char* src_c, size_t n,
                             const long long* stream, size_t n_matches,
                             char* dst, size_t cap) {
  std::vector<uint8_t> out;
  out.reserve(n / 2 + 4096);
  FseBackend* fb = new FseBackend();
  fb->out = &out;
  select_into_backend((const uint8_t*)src_c, n, stream, n_matches, fb);
  delete fb;
  if (out.size() > cap) return -E_CAP;
  memcpy(dst, out.data(), out.size());
  return (long long)out.size();
}

// Selection + block splitting only: serialized raw block contents for the
// device emission plane (see FseBackend::emit_block dump mode).
long long tl_select_blocks(const char* src_c, size_t n,
                           const long long* stream, size_t n_matches,
                           char* dst, size_t cap) {
  std::vector<uint8_t> out;
  out.reserve(n + n / 4 + 4096);
  FseBackend* fb = new FseBackend();
  fb->dump = &out;
  select_into_backend((const uint8_t*)src_c, n, stream, n_matches, fb);
  delete fb;
  if (out.size() > cap) return -E_CAP;
  memcpy(dst, out.data(), out.size());
  return (long long)out.size();
}

// Normalized weights + V2 weight payload for one block's raw contents —
// the device emission plane's per-block host prep (histogram +
// normalize_m1 + store_weights_v2 exactly as emit_into). rows are int32
// (l, m, d-with-repeat-zeros) triples. Writes N_WEIGHTS u16 into w_out
// and the payload into dst; returns payload bytes or -errcode.
long long tl_block_weights(const int* rows, size_t n_lmd,
                           const char* lits_c, size_t n_lit,
                           unsigned short* w_out, char* dst, size_t cap) {
  const uint8_t* lits = (const uint8_t*)lits_c;
  uint16_t w[N_WEIGHTS];
  memset(w, 0, sizeof w);
  for (size_t i = 0; i < n_lmd; i++) {
    w[DV.l_sym[(uint32_t)rows[i * 3]]]++;
    w[20 + DV.m_sym[(uint32_t)rows[i * 3 + 1]]]++;
    w[40 + DV.d_sym[d_index((uint32_t)rows[i * 3 + 2])]]++;
  }
  for (size_t i = 0; i < n_lit; i++) w[104 + lits[i]]++;
  if (n_lmd) {
    normalize_m1(w, 20, (int64_t)n_lmd, L_STATES);
    normalize_m1(w + 20, 20, (int64_t)n_lmd, M_STATES);
    normalize_m1(w + 40, 64, (int64_t)n_lmd, D_STATES);
  }
  if (n_lit) normalize_m1(w + 104, 256, (int64_t)n_lit, U_STATES);
  memcpy(w_out, w, sizeof w);
  uint8_t wbuf[V2_WEIGHTS_MAX];
  size_t n_weights = store_weights_v2(w, wbuf);
  if (n_weights > cap) return -E_CAP;
  memcpy(dst, wbuf, n_weights);
  return (long long)n_weights;
}

// Pack a device-emitted tANS group stream into payload bytes: per group,
// value = lo (u32) | hi << 32 with n = meta >> shift total bits (n <= 54,
// hi = meta & ((1<<shift)-1)). Sequential 64-bit accumulator bit writer
// (the numpy bitwise_or.at scatter this replaces ran ~20M ops/s and
// dominated the encode pack stage). Returns total BITS or -errcode.
static long long pack_groups_into(const int* lo, const int* meta, size_t n,
                                  int shift, char* dst, size_t cap) {
  uint64_t acc = 0;
  int bits = 0;  // < 8 after each flush; nb <= 54 so acc use <= 61 bits
  size_t w = 0;
  const uint32_t hi_mask = (1u << shift) - 1;
  long long total_bits = 0;
  // word-at-a-time flush: one unaligned 8-byte store per group (covers the
  // <= 61 live bits), then advance by the whole bytes committed — ~5x the
  // byte-loop this replaces (the per-byte branch + cap check dominated)
  for (size_t i = 0; i < n; i++) {
    uint64_t v = (uint32_t)lo[i]
                 | ((uint64_t)((uint32_t)meta[i] & hi_mask) << 32);
    int nb = (int)((uint32_t)meta[i] >> shift);
    acc |= v << bits;
    bits += nb;
    total_bits += nb;
    if (w + 8 > cap) {
      while (bits >= 8) {
        if (w >= cap) return -E_CAP;
        dst[w++] = (char)(acc & 0xFF);
        acc >>= 8;
        bits -= 8;
      }
      continue;
    }
    wr64((uint8_t*)dst + w, acc);
    int adv = bits >> 3;
    w += adv;
    acc >>= adv * 8;
    bits &= 7;
  }
  if (bits) {
    if (w >= cap) return -E_CAP;
    dst[w++] = (char)(acc & 0xFF);
  }
  return total_bits;
}

long long tl_pack_groups(const int* lo, const int* meta, size_t n,
                         int shift, char* dst, size_t cap) {
  return pack_groups_into(lo, meta, n, shift, dst, cap);
}

// Batched pack + block assembly for the staged serving path: for every
// slot, pack the device kernels' literal and LMD group streams into
// payload bits and assemble the COMPLETE Vx2 block body (header, weight
// payload, literal payload, 8-byte pad + LMD payload) into a fixed-stride
// arena — one native call for the whole batch, parallel across slots on
// the worker pool, in place of per-block ctypes pack calls + Python
// header assembly. lens[slot] = body bytes (or negative errcode);
// returns 0, or the first slot's error code if any slot failed.
// Header layout mirrors FseBackend::emit_into / spec store_v2_header
// (block.rs:168-196); byte-identical output is test-enforced.
long long tl_pack_stage(const int* glo, const int* gmeta, const int* mlo,
                        const int* mmeta, const int* lfs, const int* mfs,
                        const int* lit_num, const int* lmd_num,
                        const int* meta4, const char* wpay,
                        const int* wpay_len, long long n_slots,
                        long long n_cols, long long wpay_cap,
                        long long lfs_stride, long long mfs_stride,
                        char* arena, long long slot_cap, long long* lens) {
  std::atomic<long long> next{0};
  auto work = [&]() {
    for (;;) {
      long long s = next.fetch_add(1, std::memory_order_relaxed);
      if (s >= n_slots) return;
      uint8_t* p = (uint8_t*)arena + s * slot_cap;
      long long cap = slot_cap;
      int nw = wpay_len[s];
      if (32 + nw > cap) { lens[s] = -E_CAP; continue; }
      memcpy(p + 32, wpay + s * wpay_cap, (size_t)nw);
      long long used = 32 + nw;
      long long lit_bits = pack_groups_into(
          glo + s * n_cols, gmeta + s * n_cols, (size_t)lit_num[s] / 4, 8,
          (char*)p + used, (size_t)(cap - used));
      if (lit_bits < 0) { lens[s] = lit_bits; continue; }
      uint32_t lit_pay = (uint32_t)((lit_bits + 7) / 8);
      int lit_off = (int)((8 - lit_bits % 8) % 8);
      used += lit_pay;
      if (used + 8 > cap) { lens[s] = -E_CAP; continue; }
      memset(p + used, 0, 8);
      long long lmd_bits = pack_groups_into(
          mlo + s * n_cols, mmeta + s * n_cols, (size_t)lmd_num[s], 22,
          (char*)p + used + 8, (size_t)(cap - used - 8));
      if (lmd_bits < 0) { lens[s] = lmd_bits; continue; }
      uint32_t lmd_pay = 8 + (uint32_t)((lmd_bits + 7) / 8);
      int lmd_off = (int)((8 - lmd_bits % 8) % 8);
      used += lmd_pay;
      // Vx2 header (emit_into / block.rs:168-196); kernel final states
      // arrive as raw table states, the header stores state - N_STATES
      wr32(p, MAGIC_VX2);
      wr32(p + 4, (uint32_t)meta4[s * 4] + (uint32_t)meta4[s * 4 + 1]);
      const int* uf = lfs + s * lfs_stride;
      const int* vf = mfs + s * mfs_stride;
      uint64_t a = (uint64_t)(uint32_t)lit_num[s]
                   | ((uint64_t)lit_pay << 20)
                   | ((uint64_t)(uint32_t)lmd_num[s] << 40)
                   | ((uint64_t)(7 - lit_off) << 60);
      wr64(p + 8, a);
      uint64_t b = (uint64_t)(uint32_t)(uf[0] - U_STATES)
                   | ((uint64_t)(uint32_t)(uf[1] - U_STATES) << 10)
                   | ((uint64_t)(uint32_t)(uf[2] - U_STATES) << 20)
                   | ((uint64_t)(uint32_t)(uf[3] - U_STATES) << 30)
                   | ((uint64_t)lmd_pay << 40)
                   | ((uint64_t)(7 - lmd_off) << 60);
      wr64(p + 16, b);
      uint64_t c = (uint64_t)(uint32_t)(V2_HEADER + nw)
                   | ((uint64_t)(uint32_t)(vf[0] - L_STATES) << 32)
                   | ((uint64_t)(uint32_t)(vf[1] - M_STATES) << 42)
                   | ((uint64_t)(uint32_t)(vf[2] - D_STATES) << 52);
      wr64(p + 24, c);
      lens[s] = used;
    }
  };
  WorkerPool& pool = mt_pool();
  std::lock_guard<std::mutex> serial(pool.serial);
  pool.launch(work);
  work();
  pool.wait();
  for (long long s = 0; s < n_slots; s++)
    if (lens[s] < 0) return lens[s];
  return 0;
}

// Native frontend (history-table match finding + selection + block
// splitting) straight to raw block contents for the device emission
// plane: run_frontend with the dump backend. This is the serving-path
// front half when device match finding is not profitable (XLA sorts
// dominate it — see ops/match_find_tpu.py); emission still pools on
// device. Byte-compatible with tl_select_blocks' blob format.
long long tl_frontend_blocks(const char* src_c, size_t n, char* dst,
                             size_t cap) {
  std::vector<uint8_t> out;
  out.reserve(n + n / 4 + 4096);
  FseBackend* fb = new FseBackend();
  fb->dump = &out;
  run_frontend<FseBackend, false>((const uint8_t*)src_c, n, *fb);
  delete fb;
  if (out.size() > cap) return -E_CAP;
  memcpy(dst, out.data(), out.size());
  return (long long)out.size();
}

// Fused frontend + emission staging: one pass per source that runs the
// history-table frontend AND writes each closed block straight into the
// pooled device-emission staging arrays (normalized int64 weights row, V2
// weight payload, right-justified literal words, packed l|m<<16 / d rows,
// counts, and the period-split alt variant when eligible — the emit_best
// decision's second candidate). Replaces the dump-blob serialize ->
// Python parse -> numpy stage round trip of the previous serving path;
// everything runs GIL-free inside the per-source host pool, so staging
// fully overlaps other sources' frontends. Slots are reserved from a
// shared atomic counter (completion order — the emission kernels are
// order-independent; Python tracks each source's base-slot list).
// Returns the number of BASE blocks (alt slots are referenced from
// meta[slot].alt_idx) or -E_CAP when the pool or out_idx would overflow.
struct StagePool {
  long long* weights;  // [B][N_WEIGHTS] int64
  uint8_t* litw;       // [B][n_cols*4] right-justified literal bytes
  int* lit_num;        // [B] padded literal counts
  int* lmv;            // [B][n_cols] l | m<<16, right-justified
  int* dv;             // [B][n_cols] stored d (repeat-zeroed)
  int* lmd_num;        // [B]
  int* meta;           // [B][4]: n_lit_raw, n_match_bytes, alt_idx, 0
  char* wpay;          // [B][wpay_cap] V2 weight payload
  int* wpay_len;       // [B]
  long long n_cols, B, wpay_cap;
  long long* counter;  // shared atomic slot counter
  bool overflow = false;
};

static void stage_block(StagePool& P, long long slot, const uint8_t* lits,
                        int n_lit, const FseBackend::Lmd* lmds, int n_lmd,
                        uint32_t n_match_bytes, int alt_idx) {
  uint16_t w[N_WEIGHTS];
  memset(w, 0, sizeof w);
  const long long nc = P.n_cols;
  int* lmv = P.lmv + slot * nc;
  int* dvp = P.dv + slot * nc;
  const long long base = nc - n_lmd;
  for (int i = 0; i < n_lmd; i++) {
    uint32_t l = lmds[i].l, m = lmds[i].m, d = lmds[i].d;
    w[DV.l_sym[l]]++;
    w[20 + DV.m_sym[m]]++;
    w[40 + DV.d_sym[d_index(d)]]++;
    lmv[base + i] = (int)(l | (m << 16));
    dvp[base + i] = (int)d;
  }
  for (int i = 0; i < n_lit; i++) w[104 + lits[i]]++;
  if (n_lmd) {
    normalize_m1(w, 20, n_lmd, L_STATES);
    normalize_m1(w + 20, 20, n_lmd, M_STATES);
    normalize_m1(w + 40, 64, n_lmd, D_STATES);
  }
  if (n_lit) normalize_m1(w + 104, 256, n_lit, U_STATES);
  long long* wrow = P.weights + slot * N_WEIGHTS;
  for (int k = 0; k < N_WEIGHTS; k++) wrow[k] = w[k];
  uint8_t wbuf[V2_WEIGHTS_MAX];
  size_t nw = store_weights_v2(w, wbuf);
  memcpy(P.wpay + slot * P.wpay_cap, wbuf, nw);
  P.wpay_len[slot] = (int)nw;
  const int pad = (4 - (n_lit & 3)) & 3;
  const int g = (n_lit + pad) / 4;
  uint8_t* lrow = P.litw + slot * (nc * 4);
  const long long start = nc * 4 - (long long)g * 4;
  memcpy(lrow + start, lits, (size_t)n_lit);
  for (int i = 0; i < pad; i++)
    lrow[start + n_lit + i] = n_lit ? lits[0] : 0;
  P.lit_num[slot] = n_lit + pad;
  P.lmd_num[slot] = n_lmd;
  int* mrow = P.meta + slot * 4;
  mrow[0] = n_lit;
  mrow[1] = (int)n_match_bytes;
  mrow[2] = alt_idx;
  mrow[3] = 0;
}

long long tl_frontend_stage(const char* src_c, size_t n, long long* weights,
                            unsigned char* litw, int* lit_num, int* lmv,
                            int* dv, int* lmd_num, int* meta, char* wpay,
                            int* wpay_len, long long n_cols, long long B,
                            long long wpay_cap, long long* counter,
                            int* out_idx, long long out_cap) {
  StagePool P{weights,  litw, lit_num, lmv,      dv,      lmd_num, meta,
              wpay,     wpay_len, n_cols, B, wpay_cap, counter};
  long long n_base = 0;
  std::vector<FseBackend::Lmd> altv;
  FseBackend fb;
  fb.on_block = [&](FseBackend& b) {
    if (P.overflow) return;
    bool has_alt = FseBackend::period_split(b.lmds, b.n_lmd, altv);
    long long slots = has_alt ? 2 : 1;
    long long s = __atomic_fetch_add(counter, slots, __ATOMIC_RELAXED);
    if (s + slots > B || n_base >= out_cap) {
      P.overflow = true;
      return;
    }
    stage_block(P, s, b.lits, b.n_lit, b.lmds, b.n_lmd, b.n_match_bytes,
                has_alt ? (int)(s + 1) : -1);
    if (has_alt)
      stage_block(P, s + 1, b.lits, b.n_lit, altv.data(), (int)altv.size(),
                  b.n_match_bytes, -1);
    out_idx[n_base++] = (int)s;
  };
  run_frontend<FseBackend, false>((const uint8_t*)src_c, n, fb);
  if (P.overflow) return -E_CAP;
  return n_base;
}

// LZ77 reconstruction from a flattened (l, m, d) row stream + literal pool
// (the host half of the hybrid TPU decode: entropy on device, copy-back
// here). Rows are int32 triples; returns bytes written or -errcode.
long long tl_rebuild(const int* rows, size_t n_rows, const char* lits_c,
                     size_t n_lits, char* dst, size_t cap) {
  Sink sink{(uint8_t*)dst, cap};
  const uint8_t* lits = (const uint8_t*)lits_c;
  size_t li = 0;
  for (size_t i = 0; i < n_rows; i++) {
    uint32_t l = (uint32_t)rows[i * 3];
    uint32_t m = (uint32_t)rows[i * 3 + 1];
    uint32_t d = (uint32_t)rows[i * 3 + 2];
    if (l) {
      if (li + l > n_lits) return -E_FSE;
      // wide copies only while 16B of the literal pool remain readable
      int rc = li + l + 16 <= n_lits ? sink.write_slack(lits + li, l)
                                     : sink.write(lits + li, l);
      if (rc) return rc;
      li += l;
    }
    if (m) {
      int rc = sink.write_match(m, d);
      if (rc) return rc;
    }
  }
  return (long long)sink.len;
}

// Fused flatten + LZ rebuild for a batch of containers (the host half of
// the hybrid TPU decode; replaces a Python flatten loop + per-container
// rebuild calls). Each container is a sequence of 6-int parts
// [kind, a, b, c, d, src_idx]: kind 0 parts read the device kernels'
// decoded (l,m,d) rows and literal rows in place (a = block row index,
// b = n_rows, c = literal cap); kind 1 parts read host-parsed LZVN/raw
// rows from the concatenated side arrays (a = row offset, b = n_rows,
// c = literal offset, d = literal length); kind 2 parts decode an LZVN
// payload from source container src_idx at rebuild time (a = payload
// offset, b = n_pay, c = n_raw); kind 3 parts copy a RAW body from the
// source (a = data offset, b = n_raw). Containers
// rebuild in parallel (work-stealing). status[ci] = bytes written or
// -err; callers compare against the expected n_raw and fall back to the
// spec layer on mismatch. Reference hot loop: fse_core.rs:80-141.
// Shared row-replay loop for the rebuild kinds. The fast path handles the
// dominant small-row shape (l <= 16, m <= 16, non-pattern copy, ample
// space) with two unconditional 16B moves and ONE rarely-taken branch;
// everything else — long rows, short-distance patterns, buffer tails,
// validity violations — falls through to the exact original per-row code
// so error semantics are unchanged. PACKED selects the device-row layout
// (lm = l|m<<16 + raw d with repeat-zero carry) vs host (l,m,d) triplets.
static inline int replay_rows(Sink& sink, const int* a, const int* b,
                              const uint8_t* lits, size_t n_rows,
                              size_t lit_cap, size_t lit_avail,
                              const bool PACKED) {
  size_t li = 0;
  uint32_t dist = 0;
  size_t len = sink.len;
  const size_t cap = sink.cap;
  uint8_t* dst = sink.dst;
  for (size_t i = 0; i < n_rows; i++) {
    uint32_t l, m, d;
    if (PACKED) {
      uint32_t lmv = (uint32_t)a[i];
      l = lmv & 0xFFFF;
      m = lmv >> 16;
      d = (uint32_t)b[i];
      if (d) dist = d;
    } else {
      l = (uint32_t)a[i * 3];
      m = (uint32_t)a[i * 3 + 1];
      dist = d = (uint32_t)a[i * 3 + 2];
    }
    if (__builtin_expect((l | m) > 16 || (dist < 16 && m > dist)
                             || len + 48 > cap || li + 16 > lit_avail
                             || li + l > lit_cap,
                         0)) {
      // exact slow path (bounds, pattern stores, long rows)
      sink.len = len;
      if (l) {
        if (li + l > lit_cap) return -E_FSE;
        int rc = li + l + 16 <= lit_avail ? sink.write_slack(lits + li, l)
                                          : sink.write(lits + li, l);
        if (rc) return rc;
        li += l;
      }
      if (m) {
        int rc = sink.write_match(m, dist);
        if (rc) return rc;
      }
      len = sink.len;
      continue;
    }
    uint8_t* o = dst + len;
    cpy16(o, lits + li);  // l <= 16; slack overwritten by later rows
    li += l;
    o += l;
    len += l;
    if (m) {
      if (dist == 0 || dist > len) { sink.len = len; return -E_BADD; }
      // dist >= 16 (overlap-safe 16B stride for m <= 16) or m <= dist
      // (non-overlapping; trailing slack reads stay inside dst)
      cpy16(o, o - dist);
      len += m;
    }
  }
  sink.len = len;
  return 0;
}

long long tl_flatten_rebuild(
    const int* lm_rows, const int* d_rows, const unsigned char* lit_rows,
    size_t lmd_stride, size_t lit_stride, const int* parts,
    const int* cont_part_off, const long long* out_offs,
    const int* host_rows, const unsigned char* host_lits, char* out,
    long long* status, size_t n_conts, size_t lit_rows_total,
    size_t host_lits_total, const char* const* srcs,
    char* const* out_ptrs) {
  // out_ptrs, when non-null, gives each container its own output base
  // (the caller's final PyBytes buffers — rebuild writes the results in
  // place, no per-container copy-out pass); otherwise segments of `out`.
  auto run_one = [&](size_t ci) {
    Sink sink{out_ptrs ? (uint8_t*)out_ptrs[ci]
                       : (uint8_t*)out + out_offs[ci],
              (size_t)(out_offs[ci + 1] - out_offs[ci])};
    for (int pi = cont_part_off[ci]; pi < cont_part_off[ci + 1]; pi++) {
      const int* P = parts + (size_t)pi * 6;
      if (P[0] == 2) {  // LZVN payload decoded straight from the source
        int rc = decode_vn(sink, (const uint8_t*)srcs[P[5]] + P[1],
                           (size_t)P[2], (uint32_t)P[3]);
        if (rc) { status[ci] = rc; return; }
        continue;
      }
      if (P[0] == 3) {  // RAW body copied straight from the source
        int rc = sink.write((const uint8_t*)srcs[P[5]] + P[1],
                            (size_t)P[2]);
        if (rc) { status[ci] = rc; return; }
        continue;
      }
      if (P[0] == 0) {
        // packed device rows: lm = l | m << 16, d raw (0 = repeat the
        // running distance, reset per block — lmd.rs repeat-D rule).
        // P[1] is the block's row in the lm/d arrays and P[4] its row in
        // the literal array — the caller passes the kernels' SORTED
        // outputs directly (no device-side unsort copies) and remaps the
        // part indices through the two sort permutations host-side.
        int rc = replay_rows(
            sink, lm_rows + (size_t)P[1] * lmd_stride,
            d_rows + (size_t)P[1] * lmd_stride,
            lit_rows + (size_t)P[4] * lit_stride, (size_t)P[2],
            (size_t)P[3], lit_rows_total - (size_t)P[4] * lit_stride,
            true);
        if (rc) { status[ci] = rc; return; }
        continue;
      }
      // kind 1: host-parsed (l, m, d) triplet rows
      int rc = replay_rows(
          sink, host_rows + (size_t)P[1] * 3, nullptr,
          host_lits + (size_t)P[3], (size_t)P[2], (size_t)P[4],
          host_lits_total - (size_t)P[3], false);
      if (rc) { status[ci] = rc; return; }
    }
    status[ci] = (long long)sink.len;
  };
  unsigned nt = std::thread::hardware_concurrency();
  if (nt == 0) nt = 1;
  if (nt > 8) nt = 8;
  if (n_conts < 2) nt = 1;
  std::atomic<size_t> next{0};
  auto work = [&]() {
    size_t ci;
    while ((ci = next.fetch_add(1)) < n_conts) run_one(ci);
  };
  if (nt == 1) {
    work();
  } else {
    std::vector<std::thread> th;
    for (unsigned t = 1; t < nt; t++) th.emplace_back(work);
    work();
    for (auto& x : th) x.join();
  }
  return 0;
}

// Packed decode-table build mirroring ops/table_build.py EXACTLY (packed
// int32 entry formats consumed by the Pallas kernels, including the
// self-latching entries for states beyond an invalid total). Tables are
// tiny (~5.6KB/block) — building them host-side at native speed and
// uploading packed beats spending device time on the batched build.
static void build_packed_block(const uint16_t* w, int S, int n_states,
                               int offset, const uint8_t* extra,
                               const int32_t* basev, bool is_u, bool is_d,
                               int32_t* out) {
  int n_bits = 0;
  while ((1 << n_bits) < n_states) n_bits++;
  int total = 0;
  int cum_exc[256];
  for (int i = 0; i < S; i++) { cum_exc[i] = total; total += w[i]; }
  int sym = 0;
  for (int s = 0; s < n_states; s++) {
    if (s < total) {
      while (sym < S - 1 && cum_exc[sym] + w[sym] <= s) sym++;
      int ws = w[sym];
      int j = s - cum_exc[sym];
      int bl = 0, t = ws > 0 ? ws : 1;
      while (t) { bl++; t >>= 1; }
      int k = (n_bits + 1) - bl;
      int x = ((n_states << 1) >> k) - ws;
      bool head = j < x;
      int k_e = head ? k : k - 1;
      int km1 = k - 1 > 0 ? k - 1 : 0;
      int delta = (head ? ((ws + j) << k) - n_states : (j - x) << km1)
                  + offset;
      if (is_u) out[s] = k_e | (sym << 4) | (delta << 12);
      else {
        int hi = is_d ? sym : basev[sym];
        out[s] = k_e | ((int)extra[sym] << 4) | (delta << 8) | (hi << 17);
      }
    } else {  // latch entry: k=0, sym/bits 0, delta = state + offset
      int delta = s + offset;
      out[s] = is_u ? (delta << 12) : (delta << 8);
    }
  }
}

// Batch payload scatter: copy concatenated payloads into staging-buffer
// rows (the decode batch prep hot path). offs has n_rows+1 entries; each
// row gets an 8-byte zero tail after its payload.
long long tl_scatter_rows(const char* cat, const long long* offs,
                          const int* slots, size_t n_rows, char* dst,
                          size_t row_stride) {
  for (size_t i = 0; i < n_rows; i++) {
    size_t len = (size_t)(offs[i + 1] - offs[i]);
    char* row = dst + (size_t)slots[i] * row_stride;
    memcpy(row, cat + offs[i], len);
    memset(row + len, 0, 8);
  }
  return 0;
}

// v3 decode tables (ops/table_build.py build_decode_tables_v3, consumed
// by the Pallas kernels): v_packed (384 words/block) keeps the per-state
// packed V entries (build_packed_block — the sym+aux arithmetic variant
// was A/B'd slower on the LMD kernel); u3 (384 words/block) is the
// literal kernel's compact layout with HALFWORD-packed per-symbol aux:
// byte-packed symbols [0,256) + aux halfwords B | (k0 << 11) [256,384).
// tot = the normalized U-weight total (literal latch threshold).
static void build_u3_block(const uint16_t* w, int32_t* u3, int32_t* tot_out) {
  int total = 0;
  unsigned char syms[U_STATES];
  uint16_t aux[256];
  for (int i = 0; i < 256; i++) {
    int f = w[i];
    int base = total;
    if (f) {
      int bl = 0, t = f;
      while (t) { bl++; t >>= 1; }
      int k0 = 11 - bl;
      int x = ((U_STATES << 1) >> k0) - f;
      int B = base + x;
      aux[i] = (uint16_t)(B | (k0 << 11));
      for (int j = 0; j < f && base + j < U_STATES; j++)
        syms[base + j] = (unsigned char)i;
      total += f;
    } else {
      aux[i] = 0;
    }
  }
  if (total > U_STATES) total = U_STATES;
  for (int s = total; s < U_STATES; s++) syms[s] = 0;
  memcpy(u3, syms, U_STATES);
  memcpy((char*)u3 + 256 * 4, aux, 256 * 2);
  *tot_out = total;
}

long long tl_build_tables3(const unsigned short* w, int* v_packed, int* u3,
                           int* tot) {
  build_packed_block((const uint16_t*)w, 20, L_STATES, 0, L_EXTRA, L_BASE,
                     false, false, v_packed);
  build_packed_block((const uint16_t*)w + 20, 20, M_STATES, L_STATES,
                     M_EXTRA, M_BASE, false, false, v_packed + L_STATES);
  build_packed_block((const uint16_t*)w + 40, 64, D_STATES,
                     L_STATES + M_STATES, D_EXTRA, D_BASE, false, true,
                     v_packed + L_STATES + M_STATES);
  build_u3_block((const uint16_t*)w + 104, u3, tot);
  return 0;
}

long long tl_build_tables3_batch(const unsigned short* w, const int* slots_v,
                                 const int* slots_u, size_t nb, int* v_all,
                                 int* u_all, int* totu_all) {
  unsigned nt = std::thread::hardware_concurrency();
  if (nt == 0) nt = 1;
  if (nt > 8) nt = 8;
  if (nb < 32) nt = 1;
  auto work = [&](size_t t0) {
    for (size_t i = t0; i < nb; i += nt)
      tl_build_tables3(w + i * 360, v_all + (size_t)slots_v[i] * 384,
                       u_all + (size_t)slots_u[i] * 384,
                       totu_all + slots_u[i]);
  };
  if (nt == 1) {
    work(0);
  } else {
    std::vector<std::thread> th;
    for (unsigned t = 1; t < nt; t++) th.emplace_back(work, t);
    work(0);
    for (auto& x : th) x.join();
  }
  return 0;
}

long long tl_build_tables(const unsigned short* w, int* v_packed,
                          int* u_packed) {
  build_packed_block((const uint16_t*)w, 20, L_STATES, 0, L_EXTRA, L_BASE,
                     false, false, v_packed);
  build_packed_block((const uint16_t*)w + 20, 20, M_STATES, L_STATES,
                     M_EXTRA, M_BASE, false, false, v_packed + L_STATES);
  build_packed_block((const uint16_t*)w + 40, 64, D_STATES,
                     L_STATES + M_STATES, D_EXTRA, D_BASE, false, true,
                     v_packed + L_STATES + M_STATES);
  build_packed_block((const uint16_t*)w + 104, 256, U_STATES, 0, nullptr,
                     nullptr, true, false, u_packed);
  return 0;
}

// Batched variant: all blocks' tables in one call, threaded (the per-call
// ctypes overhead at a few hundred blocks/batch was ~6ms of prep time).
// w is nb rows of 360 u16 weights; slots_v/slots_u give each block's
// destination row in the size-sorted staging arrays.
long long tl_build_tables_batch(const unsigned short* w, const int* slots_v,
                                const int* slots_u, size_t nb, int* v_all,
                                int* u_all) {
  unsigned nt = std::thread::hardware_concurrency();
  if (nt == 0) nt = 1;
  if (nt > 8) nt = 8;
  if (nb < 32) nt = 1;
  auto work = [&](size_t t0) {
    for (size_t i = t0; i < nb; i += nt)
      tl_build_tables(w + i * 360, v_all + (size_t)slots_v[i] * 384,
                      u_all + (size_t)slots_u[i] * 1024);
  };
  if (nt == 1) {
    work(0);
  } else {
    std::vector<std::thread> th;
    for (unsigned t = 1; t < nt; t++) th.emplace_back(work, t);
    work(0);
    for (auto& x : th) x.join();
  }
  return 0;
}

// V2 weight-payload Huffman decode into 360 u16 weights (the host parse
// hot spot: the Python nibble loop costs ~0.3ms/block). Returns 0 or -err.
long long tl_load_weights_v2(const char* src, size_t n, unsigned short* w) {
  return load_weights_v2((const uint8_t*)src, n, (uint16_t*)w);
}

// Native batch container walk (the TpuDecoder parse stage; replaces the
// per-block Python loop, ~33us/block). Walks every container, validating
// exactly like the Python parse (header load, weight Huffman decode,
// BitReader init-pad check, payload bounds), and emits flat descriptor
// arrays the batch prep consumes directly:
//   desc   (cap_fse, 20) i32: [0]=container [1]=lit_num [2]=lmd_num
//     [3]=lit_bits [4]=lmd_bits [5]=lit_off (src offset, incl. 8 lead
//     bytes) [6]=lit_len (=lit_pay+8) [7]=lmd_off [8]=lmd_len
//     [9..12]=lit_state [13..15]=lmd_state [16]=n_raw_bytes
//   weights (cap_fse, 360) u16
//   parts  (cap_parts, 6) i32: [kind, a, b, c, d, container] with
//     kind 0 = FSE (a = global fse index), kind 2 = LZVN payload in src
//     (a = payload off, b = n_pay, c = n_raw), kind 3 = RAW body in src
//     (a = data off, b = n_raw). VN/RAW bodies are NOT parsed here — the
//     fused rebuild decodes them straight from src (zero copies).
//   cont_part_off (n_srcs+1) i32, cont_nraw (n_srcs) i64,
//   cont_ok (n_srcs) i32 (1 = parsed clean; 0 = caller re-parses that
//     container in Python for exact error semantics).
// counts_out[0]=n_fse, [1]=n_parts. Returns 0, or -E_CAP when a capacity
// is exhausted (caller doubles and retries).
long long tl_walk_batch(const char* const* srcs, const long long* lens,
                        size_t n_srcs, int* desc, unsigned short* weights,
                        size_t cap_fse, int* parts, size_t cap_parts,
                        int* cont_part_off, long long* cont_nraw,
                        int* cont_ok, long long* counts_out) {
  size_t n_fse = 0, n_parts = 0;
  for (size_t ci = 0; ci < n_srcs; ci++) {
    const uint8_t* src = (const uint8_t*)srcs[ci];
    size_t n = (size_t)lens[ci];
    cont_part_off[ci] = (int)n_parts;
    cont_nraw[ci] = 0;
    cont_ok[ci] = 0;
    if (n > 0x7FFFFFFFull) continue;  // i32 offsets; Python path handles
    size_t pos = 0;
    size_t fse_mark = n_fse, part_mark = n_parts;
    int64_t nraw_acc = 0;
    bool ok = false;
    for (;;) {
      if (n - pos < 4) break;
      uint32_t magic = rd32(src + pos);
      if (magic == MAGIC_EOS) {
        pos += 4;
        ok = pos == n;
        break;
      }
      if (magic == MAGIC_VX2 || magic == MAGIC_VX1) {
        FseHeader h;
        uint32_t n_weights;
        size_t header;
        if (magic == MAGIC_VX2) {
          if (n - pos < (size_t)V2_HEADER) break;
          parse_v2_header(src + pos, &h, &n_weights);
          if (n_weights > (uint32_t)V2_WEIGHTS_MAX) break;
          header = V2_HEADER;
        } else {
          if (n - pos < (size_t)V1_HEADER) break;
          if (parse_v1_header(src + pos, &h)) break;
          n_weights = V1_WEIGHTS;
          header = V1_HEADER;
        }
        if (!validate_header(h)) break;
        if (n - pos < header + n_weights + h.lit_pay + h.lmd_pay) break;
        if (n_fse >= cap_fse || n_parts >= cap_parts) return -E_CAP;
        uint16_t* w = weights + n_fse * N_WEIGHTS;
        if (magic == MAGIC_VX2) {
          if (load_weights_v2(src + pos + header, n_weights, w)) break;
        } else {
          for (int i = 0; i < N_WEIGHTS; i++)
            w[i] = rd16(src + pos + header + 2 * i);
        }
        size_t pay = pos + header + n_weights;
        // BitReader init-pad checks (bit_reader.rs:25-27): bits above the
        // declared head of each backwards stream must be zero
        const uint8_t* lit_end = src + pay + h.lit_pay;
        const uint8_t* lmd_end = lit_end + h.lmd_pay;
        if (h.lit_bits && (rd64(lit_end - 8) >> (64 - h.lit_bits))) break;
        if (h.lmd_bits && (rd64(lmd_end - 8) >> (64 - h.lmd_bits))) break;
        int* D = desc + n_fse * 20;
        D[0] = (int)ci;
        D[1] = (int)h.lit_num; D[2] = (int)h.lmd_num;
        D[3] = (int)h.lit_bits; D[4] = (int)h.lmd_bits;
        D[5] = (int)(pay - 8); D[6] = (int)(h.lit_pay + 8);
        D[7] = (int)(pay + h.lit_pay); D[8] = (int)h.lmd_pay;
        for (int i = 0; i < 4; i++) D[9 + i] = h.lit_state[i];
        for (int i = 0; i < 3; i++) D[13 + i] = h.lmd_state[i];
        D[16] = (int)h.n_raw_bytes; D[17] = D[18] = D[19] = 0;
        int* P = parts + n_parts * 6;
        // pre-shaped as a flatten part: [0, block row, n_rows, lit cap]
        P[0] = 0; P[1] = (int)n_fse; P[2] = (int)h.lmd_num;
        P[3] = (int)h.lit_num; P[4] = 0; P[5] = (int)ci;
        n_fse++; n_parts++;
        nraw_acc += h.n_raw_bytes;
        pos += header + n_weights + h.lit_pay + h.lmd_pay;
      } else if (magic == MAGIC_VXN) {
        if (n - pos < 12) break;
        uint32_t n_raw = rd32(src + pos + 4), n_pay = rd32(src + pos + 8);
        if (n - pos < 12 + (size_t)n_pay) break;
        if (n_parts >= cap_parts) return -E_CAP;
        int* P = parts + n_parts * 6;
        P[0] = 2; P[1] = (int)(pos + 12); P[2] = (int)n_pay;
        P[3] = (int)n_raw; P[4] = 0; P[5] = (int)ci;
        n_parts++;
        nraw_acc += n_raw;
        pos += 12 + n_pay;
      } else if (magic == MAGIC_RAW) {
        if (n - pos < 8) break;
        uint32_t n_raw = rd32(src + pos + 4);
        if (n - pos < 8 + (size_t)n_raw) break;
        if (n_parts >= cap_parts) return -E_CAP;
        int* P = parts + n_parts * 6;
        P[0] = 3; P[1] = (int)(pos + 8); P[2] = (int)n_raw;
        P[3] = 0; P[4] = 0; P[5] = (int)ci;
        n_parts++;
        nraw_acc += n_raw;
        pos += 8 + n_raw;
      } else {
        break;
      }
    }
    if (ok) {
      cont_nraw[ci] = nraw_acc;
      cont_ok[ci] = 1;
    } else {
      // rewind this container's contributions; Python re-parses it
      n_fse = fse_mark;
      n_parts = part_mark;
    }
  }
  cont_part_off[n_srcs] = (int)n_parts;
  counts_out[0] = (long long)n_fse;
  counts_out[1] = (long long)n_parts;
  return 0;
}

// Batch payload gather: copy every FSE block's literal and LMD payloads
// from the source containers straight into the compact 512B-chunk staging
// buffer (replaces the Python bytes join + copy — one memcpy instead of
// three). dst_l/dst_m are byte offsets into stage; pads each payload's
// final chunk with zeros. Threaded over blocks.
long long tl_gather_payloads(const char* const* srcs, const int* desc,
                             size_t nb, const long long* dst_l,
                             const long long* dst_m, char* stage) {
  auto fill = [&](size_t i) {
    const int* D = desc + i * 20;
    const char* s = srcs[D[0]];
    size_t ll = (size_t)D[6], lm = (size_t)D[8];
    memcpy(stage + dst_l[i], s + D[5], ll);
    memset(stage + dst_l[i] + ll, 0, (size_t)(-(long long)ll & 511));
    memcpy(stage + dst_m[i], s + D[7], lm);
    memset(stage + dst_m[i] + lm, 0, (size_t)(-(long long)lm & 511));
  };
  unsigned nt = std::thread::hardware_concurrency();
  if (nt == 0) nt = 1;
  if (nt > 4) nt = 4;
  if (nb < 16) nt = 1;
  if (nt == 1) {
    for (size_t i = 0; i < nb; i++) fill(i);
  } else {
    std::atomic<size_t> next{0};
    auto work = [&]() {
      size_t i;
      while ((i = next.fetch_add(1)) < nb) fill(i);
    };
    std::vector<std::thread> th;
    for (unsigned t = 1; t < nt; t++) th.emplace_back(work);
    work();
    for (auto& x : th) x.join();
  }
  return 0;
}

// Sort-free device-frontend support: stable counting sort of one padded
// match window's positions by hash bucket, plus per-slot candidate masks.
// Replaces the device path's two ~100ms 1M-element XLA argsorts with one
// linear GIL-free host pass (~4ms/MiB). Semantics mirror
// ops/match_find_tpu.find_matches_device exactly (which mirrors the
// reference history table, src/encode/history.rs:24-31): positions
// 0..n_real-4 are probed (Knuth hash of the LE u32 at the position);
// unprobed positions group after every real bucket; inside a bucket
// positions ascend (stable counting sort == stable argsort by bucket).
// ok_out[slot] bit r-1 set <=> order_out[slot-r] is a valid candidate of
// order_out[slot] (same bucket, distance <= max_d). Returns 0.
long long tl_match_group(const char* src_c, long long n_pad,
                         long long n_real, int vn,
                         int32_t* order_out, uint8_t* ok_out) {
  const uint8_t* src = (const uint8_t*)src_c;
  const int64_t N = n_pad;
  const int64_t probe_hi = n_real - 4;  // last probed position (inclusive)
  const uint32_t max_d = vn ? 0xFFFF : MAX_D;
  constexpr int NB = 1 << HASH_BITS;
  std::vector<uint16_t> bucket(N);
  std::vector<int32_t> counts(NB + 2, 0);
  for (int64_t i = 0; i < N; i++) {
    uint16_t b;
    if (i <= probe_hi) {
      uint32_t v;
      memcpy(&v, src + i, 4);
      b = (uint16_t)(vn ? hash_vn(v) : hash_fse(v));
    } else {
      b = NB;  // reserved bucket: never matches
    }
    bucket[i] = b;
    counts[b + 1]++;
  }
  for (int b = 0; b <= NB; b++) counts[b + 1] += counts[b];
  std::vector<int32_t> off(counts.begin(), counts.end() - 1);
  for (int64_t i = 0; i < N; i++) order_out[off[bucket[i]]++] = (int32_t)i;
  for (int64_t s = 0; s < N; s++) {
    int32_t p = order_out[s];
    uint16_t b = bucket[p];
    uint8_t m = 0;
    if (b != NB) {
      for (int64_t r = 1; r <= HASH_WIDTH && r <= s; r++) {
        int32_t c = order_out[s - r];
        // grouped order: a bucket mismatch or an out-of-range distance
        // (positions ascend inside a bucket) is monotone in r — stop
        if (bucket[c] != b || (int64_t)p - c > (int64_t)max_d) break;
        m |= (uint8_t)(1 << (r - 1));
      }
    }
    ok_out[s] = m;
  }
  return 0;
}

// Streaming decode handles (reference pull/push streaming object roles:
// LzfseRingDecoder / LzfseReader, src/decode/reader.rs + reader_core.rs).
// push returns bytes consumed (may be < n only under output backpressure);
// pull returns bytes produced; finish returns 0 once EOS was consumed with
// no trailing garbage. Memory per stream is O(1) in the input size.
void* tl_stream_new() { return new StreamDec(); }

void tl_stream_free(void* h) { delete (StreamDec*)h; }

long long tl_stream_push(void* h, const char* p, size_t n) {
  StreamDec* s = (StreamDec*)h;
  size_t used = s->push((const uint8_t*)p, n);
  if (s->st == S_ERR && used == 0) return s->err;
  return (long long)used;
}

long long tl_stream_pull(void* h, char* dst, size_t cap) {
  return ((StreamDec*)h)->pull((uint8_t*)dst, cap);
}

long long tl_stream_finish(void* h) { return ((StreamDec*)h)->finish(); }

// Streaming encode handles (reference LzfseRingEncoder / frontend_ring
// roles). push consumes everything; drain between pushes to keep memory
// O(window + one block). finish() flushes the final block + EOS.
void* tl_enc_new() { return new StreamEnc(); }

void tl_enc_free(void* h) { delete (StreamEnc*)h; }

long long tl_enc_push(void* h, const char* p, size_t n) {
  StreamEnc* s = (StreamEnc*)h;
  if (s->finished) return -E_INTERNAL;
  s->push((const uint8_t*)p, n);
  return (long long)n;
}

long long tl_enc_finish(void* h) {
  ((StreamEnc*)h)->finish();
  return 0;
}

long long tl_enc_drain(void* h, char* dst, size_t cap) {
  return (long long)((StreamEnc*)h)->drain((uint8_t*)dst, cap);
}

}  // extern "C"
