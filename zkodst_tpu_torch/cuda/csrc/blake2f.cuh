// BLAKE2f (EIP-152 / RFC 7693 compression F) on 64-bit words, and the cell
// writer of the BLAKE2f circuit's witness, shared by the card's kernels
// (blake2f.cu) and a host build (tests/test_torch_blake2f_kernels.py
// compiles this header with g++ and holds it to the plain versions and to
// the JAX package). It replaces no Pallas kernel: it is the arithmetic of
// the two `lax.scan` round loops the JAX package compiles with XLA
// (zkodst_tpu/circuit/blake2f.py:_numeric_stream, zkodst_tpu/ops/blake2.py:
// blake2f).
//
// The witness stream is the sequence of cell values that
// zkodst_tpu_torch/circuit/blake2f.py's `_schedule` pushes, cell for cell:
// the init phase (143 cells), then per round and half-round the four G
// calls G-major (131 cells each), then the final phase (8 words of 33
// cells). A cell is a (lo, hi) pair of int64 holding the two 32-bit halves
// of its value; a 32-bit cell has hi = 0. The per-op push orders are those
// of the plain `_Numeric` backend:
//
//   add   the carry out of the top limb, then dense and spread of each
//         16-bit limb interleaved, then the 64-bit sum
//   xor   per limb: a & b, its spread, a ^ b, its spread
//   rcp   the 64-bit recomposed word (here a rotation of the xor)
//   s88   limb 1's low byte, its spread, its high byte, its spread
//   s115  limb 3's low 15 bits, their spread, its top bit
//   dec   dense and spread of each limb interleaved
//
// The spread of a 16-bit value puts bit i at bit 2i (circuit/spread.py).
// Every function writes through a sink (`Cells`) that advances one cell a
// push, so a G call's 131 cells can go to their place in the stream from
// whichever thread runs that call.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define ZKB_HD __host__ __device__ __forceinline__
#else
#define ZKB_HD inline
#endif
#if defined(__CUDA_ARCH__)
#define ZKB_UNROLL _Pragma("unroll")
#else
#define ZKB_UNROLL
#endif

namespace zkb {

constexpr int kInitCells = 143;
constexpr int kGCells = 131;
constexpr int kFinalWordCells = 33;

// the stream's length and the offsets of its parts, in cells
ZKB_HD constexpr int64_t g_offset(int64_t round, int half, int g) {
  return kInitCells + ((round * 2 + half) * 4 + g) * kGCells;
}
ZKB_HD constexpr int64_t final_offset(int64_t rounds) {
  return kInitCells + rounds * 8 * kGCells;
}
ZKB_HD constexpr int64_t n_cells(int64_t rounds) {
  return final_offset(rounds) + 8 * kFinalWordCells;
}

// RFC 7693 §2.6 IV[i]
ZKB_HD constexpr uint64_t iv(int i) {
  return i == 0 ? 0x6a09e667f3bcc908ull : i == 1 ? 0xbb67ae8584caa73bull
       : i == 2 ? 0x3c6ef372fe94f82bull : i == 3 ? 0xa54ff53a5f1d36f1ull
       : i == 4 ? 0x510e527fade682d1ull : i == 5 ? 0x9b05688c2b3e6c1full
       : i == 6 ? 0x1f83d9abfb41bd6bull : 0x5be0cd19137e2179ull;
}

// RFC 7693 §2.7 SIGMA[r][i] for r < 10, each row packed a nibble an entry
ZKB_HD constexpr int sigma(int r, int i) {
  return (int)(((r == 0 ? 0xfedcba9876543210ull : r == 1 ? 0x357b20c16df984aeull
               : r == 2 ? 0x491763eadf250c8bull : r == 3 ? 0x8f04a562ebcd1397ull
               : r == 4 ? 0xd386cb1efa427509ull : r == 5 ? 0x91ef57d438b0a6c2ull
               : r == 6 ? 0xb8293670a4def15cull : r == 7 ? 0xa2684f05931ce7bdull
               : r == 8 ? 0x5a417d2c803b9ef6ull : 0x0dc3e9bf5167482aull)
               >> (4 * i)) & 15);
}

// (a, b, c, d) of G call gi of a round (0–3 the columns, 4–7 the
// diagonals), role 0–3, packed a nibble a role
ZKB_HD constexpr int g_index(int gi, int role) {
  return ((gi == 0 ? 0xc840 : gi == 1 ? 0xd951 : gi == 2 ? 0xea62
           : gi == 3 ? 0xfb73 : gi == 4 ? 0xfa50 : gi == 5 ? 0xcb61
           : gi == 6 ? 0xd872 : 0xe943) >> (4 * role)) & 15;
}

ZKB_HD uint64_t rotr(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

ZKB_HD uint32_t limb(uint64_t w, int i) {
  return (uint32_t)(w >> (16 * i)) & 0xffffu;
}

ZKB_HD uint32_t spread16(uint32_t x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// a word from its (lo, hi) int64 pair
ZKB_HD uint64_t load_word(const int64_t* p) {
  return (uint64_t)(uint32_t)p[0] | ((uint64_t)(uint32_t)p[1] << 32);
}

ZKB_HD void store_word(int64_t* p, uint64_t w) {
  p[0] = (int64_t)(w & 0xffffffffu);
  p[1] = (int64_t)(w >> 32);
}

// the sink: (lo, hi) int64 cells written one after another
struct Cells {
  int64_t* p;
  ZKB_HD void put(uint64_t lo, uint64_t hi) {
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<longlong2*>(p) = make_longlong2((long long)lo,
                                                      (long long)hi);
#else
    p[0] = (int64_t)lo;
    p[1] = (int64_t)hi;
#endif
    p += 2;
  }
  ZKB_HD void push32(uint32_t v) { put(v, 0); }
  ZKB_HD void push64(uint64_t w) { put(w & 0xffffffffu, w >> 32); }
};

// -- the ops of `_Numeric` ---------------------------------------------------

template <class S>
ZKB_HD void dec(S& s, uint64_t w) {
  for (int i = 0; i < 4; ++i) {
    s.push32(limb(w, i));
    s.push32(spread16(limb(w, i)));
  }
}

// u + v + x mod 2^64; the carry out of the top limb is 0, 1 or 2
template <class S>
ZKB_HD uint64_t add(S& s, uint64_t u, uint64_t v, uint64_t x) {
  const uint64_t s1 = u + v;
  const uint64_t w = s1 + x;
  s.push32((uint32_t)(s1 < u) + (uint32_t)(w < s1));
  dec(s, w);
  s.push64(w);
  return w;
}

template <class S>
ZKB_HD uint64_t xor_(S& s, uint64_t u, uint64_t v) {
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = limb(u, i), b = limb(v, i);
    s.push32(a & b);
    s.push32(spread16(a & b));
    s.push32(a ^ b);
    s.push32(spread16(a ^ b));
  }
  return u ^ v;
}

template <class S>
ZKB_HD void s88(S& s, uint64_t e) {
  const uint32_t lo = limb(e, 1) & 0xffu, hi = limb(e, 1) >> 8;
  s.push32(lo);
  s.push32(spread16(lo));
  s.push32(hi);
  s.push32(spread16(hi));
}

template <class S>
ZKB_HD void s115(S& s, uint64_t e) {
  const uint32_t lo = limb(e, 3) & 0x7fffu;
  s.push32(lo);
  s.push32(spread16(lo));
  s.push32(limb(e, 3) >> 15);
}

// -- the schedule: `_init_phase`, `_g_sequence`, `_final_phase` --------------

// the 143 init cells; v gets the initial work vector. f is 0 or 1.
template <class S>
ZKB_HD void init_cells(S& s, const uint64_t* h, const uint64_t* m,
                       uint64_t t0, uint64_t t1, uint32_t f, uint64_t* v) {
  s.push64(t0);
  s.push64(t1);
  s.push32(f);
  for (int i = 0; i < 8; ++i) s.push64(h[i]);
  for (int j = 0; j < 16; ++j) s.push64(m[j]);
  for (int i = 0; i < 8; ++i) dec(s, h[i]);
  dec(s, t0);
  dec(s, t1);
  for (int i = 0; i < 8; ++i) v[i] = h[i];
  for (int i = 0; i < 4; ++i) v[8 + i] = iv(i);
  v[12] = xor_(s, t0, iv(4));
  v[13] = xor_(s, t1, iv(5));
  v[14] = iv(6) ^ (f ? ~0ull : 0ull);
  for (int i = 0; i < 4; ++i) s.push32(spread16(limb(v[14], i)));
  v[15] = iv(7);
}

// one G call's 131 cells; (a, b, c, d) updated in place
template <class S>
ZKB_HD void g_cells(S& s, uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d,
                    uint64_t x, uint64_t y) {
  const uint64_t a1 = add(s, a, b, x);
  const uint64_t d1 = rotr(xor_(s, d, a1), 32);
  s.push64(d1);
  const uint64_t c1 = add(s, c, d1, 0);
  const uint64_t e2 = xor_(s, b, c1);
  s88(s, e2);
  const uint64_t b1 = rotr(e2, 24);
  s.push64(b1);
  dec(s, b1);
  const uint64_t a2 = add(s, a1, b1, y);
  const uint64_t d2 = rotr(xor_(s, d1, a2), 16);
  s.push64(d2);
  const uint64_t c2 = add(s, c1, d2, 0);
  const uint64_t e4 = xor_(s, b1, c2);
  s115(s, e4);
  const uint64_t b2 = rotr(e4, 63);
  s.push64(b2);
  dec(s, b2);
  a = a2;
  b = b2;
  c = c2;
  d = d2;
}

// one output word's 33 cells; returns h'[i]
template <class S>
ZKB_HD uint64_t final_cells(S& s, uint64_t vi, uint64_t vi8, uint64_t hi) {
  const uint64_t out = xor_(s, xor_(s, vi, vi8), hi);
  s.push64(out);
  return out;
}

// One instance's whole stream (n_cells(rounds) cells at `out`) and h', in
// order, each part written at its offset: the host's form of the witness
// kernel, which spreads the same calls over a warp.
ZKB_HD void witness_one(const int64_t* h, const int64_t* m, const int64_t* t,
                        int64_t f, int64_t rounds, int64_t* out,
                        int64_t* hout) {
  uint64_t hw[8], mw[16], v[16];
  for (int i = 0; i < 8; ++i) hw[i] = load_word(h + 2 * i);
  for (int j = 0; j < 16; ++j) mw[j] = load_word(m + 2 * j);
  Cells s{out};
  init_cells(s, hw, mw, load_word(t), load_word(t + 2), f != 0, v);
  for (int64_t rd = 0; rd < rounds; ++rd) {
    const int r10 = (int)(rd % 10);
    for (int half = 0; half < 2; ++half)
      for (int g = 0; g < 4; ++g) {
        const int gi = 4 * half + g;
        Cells sg{out + 2 * g_offset(rd, half, g)};
        g_cells(sg, v[g_index(gi, 0)], v[g_index(gi, 1)], v[g_index(gi, 2)],
                v[g_index(gi, 3)], mw[sigma(r10, 2 * gi)],
                mw[sigma(r10, 2 * gi + 1)]);
      }
  }
  for (int i = 0; i < 8; ++i) {
    Cells sf{out + 2 * (final_offset(rounds) + kFinalWordCells * i)};
    store_word(hout + 2 * i, final_cells(sf, v[i], v[i + 8], hw[i]));
  }
}

// -- the compression alone (kernel 14) ---------------------------------------

ZKB_HD void g(uint64_t* v, int a, int b, int c, int d, uint64_t x,
              uint64_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 63);
}

// round R mod 10: every index a compile-time constant, so v and m stay in
// registers on the card
template <int R>
ZKB_HD void round_(uint64_t* v, const uint64_t* m) {
  ZKB_UNROLL
  for (int gi = 0; gi < 8; ++gi)
    g(v, g_index(gi, 0), g_index(gi, 1), g_index(gi, 2), g_index(gi, 3),
      m[sigma(R, 2 * gi)], m[sigma(R, 2 * gi + 1)]);
}

// h' of one compression (h, m, t as int64 pairs; f nonzero: the final
// block), `rounds` rounds (any count below 2^32)
ZKB_HD void compress_one(const int64_t* h, const int64_t* m,
                         const int64_t* t, bool f, uint64_t rounds,
                         int64_t* hout) {
  uint64_t hw[8], mw[16], v[16];
  ZKB_UNROLL
  for (int i = 0; i < 8; ++i) hw[i] = v[i] = load_word(h + 2 * i);
  ZKB_UNROLL
  for (int j = 0; j < 16; ++j) mw[j] = load_word(m + 2 * j);
  ZKB_UNROLL
  for (int i = 0; i < 8; ++i) v[8 + i] = iv(i);
  v[12] ^= load_word(t);
  v[13] ^= load_word(t + 2);
  if (f) v[14] = ~v[14];
  for (uint64_t base = 0; base < rounds; base += 10) {
    round_<0>(v, mw);
    if (base + 1 < rounds) round_<1>(v, mw); else break;
    if (base + 2 < rounds) round_<2>(v, mw); else break;
    if (base + 3 < rounds) round_<3>(v, mw); else break;
    if (base + 4 < rounds) round_<4>(v, mw); else break;
    if (base + 5 < rounds) round_<5>(v, mw); else break;
    if (base + 6 < rounds) round_<6>(v, mw); else break;
    if (base + 7 < rounds) round_<7>(v, mw); else break;
    if (base + 8 < rounds) round_<8>(v, mw); else break;
    if (base + 9 < rounds) round_<9>(v, mw); else break;
  }
  ZKB_UNROLL
  for (int i = 0; i < 8; ++i) store_word(hout + 2 * i, hw[i] ^ v[i] ^ v[i + 8]);
}

}  // namespace zkb
