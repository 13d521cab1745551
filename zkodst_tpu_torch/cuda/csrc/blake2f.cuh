// BLAKE2f (EIP-152 / RFC 7693 compression F) on 64-bit words, and the cell
// writer of the BLAKE2f circuit's witness, shared by the card's kernels
// (blake2f.cu) and a host build (tests/test_torch_blake2f_kernels.py
// compiles this header with g++ and holds it to the plain versions and to
// the JAX package). It replaces no Pallas kernel: it is the arithmetic of
// the two `lax.scan` round loops the JAX package compiles with XLA
// (zkodst_tpu/circuit/blake2f.py:_numeric_stream and the scatter of
// Blake2fCircuit._witness_impl, zkodst_tpu/ops/blake2.py:blake2f).
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
// Every function writes through a sink (`Cells`) that takes one cell a
// push, in stream order. `place_cell` then writes a cell to its rows in
// the circuit's advice columns, through a table of each stream index's
// placements; with an identity table it writes the stream itself.
//
// The cells are a pure function of each segment's inputs: the init phase's
// of the instance's words, a G call's of its (a, b, c, d, x, y), an output
// word's of v[i], v[i + 8] and h[i]. Those inputs come from the chain, the
// plain BLAKE2f rounds, run on a quad: lane i holds column i of the 4×4
// work matrix (v[i], v[4 + i], v[8 + i], v[12 + i]), the four column G
// calls run side by side, and rows b, c and d turn by 1, 2 and 3 lanes for
// the diagonal calls and back. The lanes are a policy: on the card four
// neighbouring threads that trade words by warp shuffles (`WarpLanes`), on
// the host one object holding all four (`QuadLanes`), so the host build
// runs the card's round code.
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
constexpr int kRoundCells = 8 * kGCells;
// the instance column's block of an instance (circuit/blake2f.py ROW_*):
// t0, t1, f, h[0..7], m[0..15], then h'[0..7] from row kRowOut
constexpr int kPubRows = 35;
constexpr int kRowOut = 27;

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

// one (lo, hi) cell: a 16-byte store on the card
ZKB_HD void put_cell(int64_t* p, uint64_t lo, uint64_t hi) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<longlong2*>(p) = make_longlong2((long long)lo,
                                                    (long long)hi);
#else
  p[0] = (int64_t)lo;
  p[1] = (int64_t)hi;
#endif
}

ZKB_HD void store_word(int64_t* p, uint64_t w) {
  put_cell(p, w & 0xffffffffu, w >> 32);
}

// -- the sinks: the stream, then each cell to its placements ----------------

// (lo, hi) cells one after another: a group's stream, staged
struct Cells {
  int64_t* p;
  ZKB_HD void put(uint64_t lo, uint64_t hi) {
    put_cell(p, lo, hi);
    p += 2;
  }
  ZKB_HD void push32(uint32_t v) { put(v, 0); }
  ZKB_HD void push64(uint64_t w) { put(w & 0xffffffffu, w >> 32); }
};

// A cell's placements are four int32 (`slot`): up to four rows of the
// advice columns, each col·n + row within its instance's rows, −1 for
// none. A fourth entry of −2 − s or below says the cell has more than four:
// the first three, then the list at more[s], ended by −1 (a message word
// has one a round). Writes the cell (lo, hi) to each, from row0 on.
ZKB_HD void place_cell(const int32_t* slot, const int32_t* more,
                       int64_t* out, int64_t row0, int64_t lo, int64_t hi) {
#if defined(__CUDA_ARCH__)
  const int4 q = __ldg(reinterpret_cast<const int4*>(slot));
  const int32_t d[4] = {q.x, q.y, q.z, q.w};
#else
  const int32_t d[4] = {slot[0], slot[1], slot[2], slot[3]};
#endif
  for (int j = 0; j < 4; ++j)
    if (d[j] >= 0) put_cell(out + 2 * (row0 + d[j]), lo, hi);
  if (d[3] <= -2)
    for (const int32_t* p = more + (-2 - d[3]); *p >= 0; ++p)
      put_cell(out + 2 * (row0 + *p), lo, hi);
}

// one G call's inputs
struct GIn {
  uint64_t a, b, c, d, x, y;
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

// A G call's 131 cells come in four parts, one per line pair of G: the
// add, the xor and the rotation that make a1 and d1 (27 cells), c1 and b1
// (39, with the split of limb 1 and b1's decomposition), a2 and d2 (27),
// c2 and b2 (38). Each part is a function of the call's inputs alone.
ZKB_HD constexpr int g_part_offset(int part) {
  return part == 0 ? 0 : part == 1 ? 27 : part == 2 ? 66 : 93;
}

// part `part` of the G call on (a, b, c, d, x, y), at the sink
template <class S>
ZKB_HD void g_part(S& s, int part, const GIn& g) {
  const uint64_t a1 = g.a + g.b + g.x, d1 = rotr(g.d ^ a1, 32);
  const uint64_t c1 = g.c + d1, e2 = g.b ^ c1, b1 = rotr(e2, 24);
  const uint64_t a2 = a1 + b1 + g.y, d2 = rotr(d1 ^ a2, 16);
  const uint64_t c2 = c1 + d2, e4 = b1 ^ c2, b2 = rotr(e4, 63);
  if (part == 0) {
    add(s, g.a, g.b, g.x);
    xor_(s, g.d, a1);
    s.push64(d1);
  } else if (part == 1) {
    add(s, g.c, d1, 0);
    xor_(s, g.b, c1);
    s88(s, e2);
    s.push64(b1);
    dec(s, b1);
  } else if (part == 2) {
    add(s, a1, b1, g.y);
    xor_(s, d1, a2);
    s.push64(d2);
  } else {
    add(s, c1, d2, 0);
    xor_(s, b1, c2);
    s115(s, e4);
    s.push64(b2);
    dec(s, b2);
  }
}

// one output word's 33 cells; returns h'[i]
template <class S>
ZKB_HD uint64_t final_cells(S& s, uint64_t vi, uint64_t vi8, uint64_t hi) {
  const uint64_t out = xor_(s, xor_(s, vi, vi8), hi);
  s.push64(out);
  return out;
}

// -- the chain: the BLAKE2f rounds on a quad ---------------------------------

// one instance's (or compression's) input words
struct Words {
  uint64_t h[8], m[16], t0, t1;
  uint32_t f;  // 0 or 1
};

// The host's quad: one object holds the four lanes' words.
struct QuadLanes {
  struct Word {
    uint64_t w[4];
  };
  template <class F>
  ZKB_HD Word make(F f) const { return Word{{f(0), f(1), f(2), f(3)}}; }
  ZKB_HD uint64_t at(const Word& x, int i) const { return x.w[i]; }
  template <class F>
  ZKB_HD void lanes(F f) const {
    for (int i = 0; i < 4; ++i) f(i);
  }
  // lane i gets lane (i + k) mod 4's word
  ZKB_HD Word rot(const Word& x, int k) const {
    return make([&](int i) { return x.w[(i + k) & 3]; });
  }
};

ZKB_HD QuadLanes::Word operator+(const QuadLanes::Word& u,
                                 const QuadLanes::Word& v) {
  return QuadLanes().make([&](int i) { return u.w[i] + v.w[i]; });
}
ZKB_HD QuadLanes::Word operator^(const QuadLanes::Word& u,
                                 const QuadLanes::Word& v) {
  return QuadLanes().make([&](int i) { return u.w[i] ^ v.w[i]; });
}
ZKB_HD QuadLanes::Word rotr(const QuadLanes::Word& u, int n) {
  return QuadLanes().make([&](int i) { return rotr(u.w[i], n); });
}

// The card's quad: this thread is lane (lane mod 4) of four neighbouring
// lanes of a warp, and `mask` names every lane that takes part in the
// shuffles.
struct WarpLanes {
  int lane;
  unsigned mask;
  using Word = uint64_t;
  template <class F>
  ZKB_HD Word make(F f) const { return f(lane & 3); }
  ZKB_HD uint64_t at(Word x, int) const { return x; }
  template <class F>
  ZKB_HD void lanes(F f) const { f(lane & 3); }
  ZKB_HD Word rot(Word x, int k) const {
#if defined(__CUDA_ARCH__)
    return __shfl_sync(mask, (unsigned long long)x,
                       (lane & ~3) | ((lane + k) & 3));
#else
    return x;  // no host form: the host's quad is QuadLanes
#endif
  }
};

// G on each lane's column of (a, b, c, d)
template <class W>
ZKB_HD void quad_g(W& a, W& b, W& c, W& d, const W& x, const W& y) {
  a = a + b + x;
  d = rotr(d ^ a, 32);
  c = c + d;
  b = rotr(b ^ c, 24);
  a = a + b + y;
  d = rotr(d ^ a, 16);
  c = c + d;
  b = rotr(b ^ c, 63);
}

// the initial work vector by columns
template <class L, class W = typename L::Word>
ZKB_HD void quad_init(const L& l, const Words& w, W& a, W& b, W& c, W& d) {
  a = l.make([&](int i) { return w.h[i]; });
  b = l.make([&](int i) { return w.h[4 + i]; });
  c = l.make([&](int i) { return iv(i); });
  d = l.make([&](int i) {
    return iv(4 + i) ^ (i == 0 ? w.t0 : i == 1 ? w.t1
                        : i == 2 && w.f ? ~0ull : 0ull);
  });
}

// One round (r10 = round mod 10): the column G calls, b, c, d turned onto
// the diagonals, the diagonal calls, turned back. With `cap`, G call
// 4·half + i's inputs go to cap[4·half + i] for each lane i held here.
template <class L, class W = typename L::Word>
ZKB_HD void quad_round(const L& l, W& a, W& b, W& c, W& d,
                       const uint64_t* m, int r10, GIn* cap) {
  ZKB_UNROLL
  for (int half = 0; half < 2; ++half) {
    const W x = l.make([&](int i) { return m[sigma(r10, 8 * half + 2 * i)]; });
    const W y = l.make([&](int i) {
      return m[sigma(r10, 8 * half + 2 * i + 1)];
    });
    if (cap)
      l.lanes([&](int i) {
        cap[4 * half + i] = GIn{l.at(a, i), l.at(b, i), l.at(c, i),
                                l.at(d, i), l.at(x, i), l.at(y, i)};
      });
    quad_g(a, b, c, d, x, y);
    b = l.rot(b, half ? 3 : 1);
    c = l.rot(c, 2);
    d = l.rot(d, half ? 1 : 3);
  }
}

// `rounds` rounds (any count below 2^32), in unrolled blocks of ten so that
// each round's message indices are constants but for the lane
template <class L, class W = typename L::Word>
ZKB_HD void quad_rounds(const L& l, W& a, W& b, W& c, W& d,
                        const uint64_t* m, uint64_t rounds) {
  for (uint64_t base = 0; base < rounds; base += 10) {
    const uint64_t left = rounds - base;
    ZKB_UNROLL
    for (int r10 = 0; r10 < 10; ++r10)
      if ((uint64_t)r10 < left)
        quad_round(l, a, b, c, d, m, r10, (GIn*)nullptr);
  }
}

// -- the witness by groups ----------------------------------------------------
//
// An instance's stream in groups: 0 the init phase, 1..rounds round
// grp − 1's eight G calls, rounds + 1 the eight output words. A group's
// items (its G calls, its words) and a G call's four parts are
// independent once the chain has given their inputs.

ZKB_HD int64_t group_begin(int grp, int rounds) {
  return grp == 0 ? 0 : grp <= rounds ? g_offset(grp - 1, 0, 0)
                                      : final_offset(rounds);
}
ZKB_HD int group_cells(int grp, int rounds) {
  return grp == 0 ? kInitCells : grp <= rounds ? kRoundCells
                                               : 8 * kFinalWordCells;
}
// the items of a group (init: 1, G calls or words: 8) and the parts of
// each (G calls: 4)
ZKB_HD int group_items(int grp) { return grp == 0 ? 1 : 8; }
ZKB_HD int item_parts(int grp, int rounds) {
  return grp == 0 || grp > rounds ? 1 : 4;
}

// The chain up to group grp ≥ 1: round grp − 1's G inputs into gin, or,
// for the final group, the work vector after every round into v.
template <class L>
ZKB_HD void group_chain(const L& l, const Words& w, int grp, int rounds,
                        GIn* gin, uint64_t* v) {
  typename L::Word a, b, c, d;
  quad_init(l, w, a, b, c, d);
  quad_rounds(l, a, b, c, d, w.m, (uint64_t)(grp <= rounds ? grp - 1
                                                           : rounds));
  if (grp <= rounds) {
    quad_round(l, a, b, c, d, w.m, (grp - 1) % 10, gin);
  } else {
    l.lanes([&](int i) {
      v[i] = l.at(a, i);
      v[4 + i] = l.at(b, i);
      v[8 + i] = l.at(c, i);
      v[12 + i] = l.at(d, i);
    });
  }
}

// Part `part` of item k of group grp into `s` (at the group's first cell,
// in stream order): the init cells (k = 0, part 0), part `part` of G call
// k, or output word k (part 0); returns h'[k] for the final group.
ZKB_HD uint64_t group_part(Cells s, const Words& w, int grp, int rounds,
                           int k, int part, const GIn* gin,
                           const uint64_t* v) {
  if (grp == 0) {
    uint64_t v0[16];
    init_cells(s, w.h, w.m, w.t0, w.t1, w.f, v0);
    return 0;
  }
  if (grp <= rounds) {
    s.p += 2 * (kGCells * k + g_part_offset(part));
    g_part(s, part, gin[k]);
    return 0;
  }
  s.p += 2 * kFinalWordCells * k;
  return final_cells(s, v[k], v[k + 8], w.h[k]);
}

// the word of pub row i < kRowOut of an instance: t0, t1, f, h, m
ZKB_HD uint64_t pub_input(const Words& w, int i) {
  return i == 0 ? w.t0 : i == 1 ? w.t1 : i == 2 ? (uint64_t)w.f
       : i < 11 ? w.h[i - 3] : w.m[i - 11];
}

ZKB_HD Words load_words(const int64_t* h, const int64_t* m, const int64_t* t,
                        int64_t f) {
  Words w;
  for (int i = 0; i < 8; ++i) w.h[i] = load_word(h + 2 * i);
  for (int j = 0; j < 16; ++j) w.m[j] = load_word(m + 2 * j);
  w.t0 = load_word(t);
  w.t1 = load_word(t + 2);
  w.f = f != 0;
  return w;
}

// One instance on the host, group by group: what the card's kernel
// spreads over a block a group (blake2f.cu). Each group's cells are
// staged in stream order, then placed through `slots` / `more` into `out`
// from row row0; the `cdst` / `cval` constant cells too; pub (the
// instance's kPubRows rows) and hout (8 words) when not null.
inline void place_one(const Words& w, int rounds, const int32_t* slots,
                      const int32_t* more, int n_const, const int32_t* cdst,
                      const int64_t* cval, int64_t* out, int64_t row0,
                      int64_t* pub, int64_t* hout) {
  GIn gin[8];
  uint64_t v[16];
  int64_t cell[2 * kRoundCells];  // the group's stream
  for (int grp = 0; grp < rounds + 2; ++grp) {
    if (grp > 0) group_chain(QuadLanes(), w, grp, rounds, gin, v);
    for (int k = 0; k < group_items(grp); ++k)
      for (int part = 0; part < item_parts(grp, rounds); ++part) {
        const uint64_t o = group_part(Cells{cell}, w, grp, rounds, k, part,
                                      gin, v);
        if (grp != rounds + 1) continue;
        if (pub) store_word(pub + 2 * (kRowOut + k), o);
        if (hout) store_word(hout + 2 * k, o);
      }
    const int64_t begin = group_begin(grp, rounds);
    for (int i = 0; i < group_cells(grp, rounds); ++i)
      place_cell(slots + 4 * (begin + i), more, out, row0, cell[2 * i],
                 cell[2 * i + 1]);
  }
  for (int i = 0; i < n_const; ++i)
    put_cell(out + 2 * (row0 + cdst[i]), cval[2 * i], cval[2 * i + 1]);
  if (pub)
    for (int i = 0; i < kRowOut; ++i) store_word(pub + 2 * i, pub_input(w, i));
}

// -- the compression alone (kernel 14) ---------------------------------------

// h' of one compression on a quad: lane i's o0 is h'[i], its o1 h'[4 + i]
template <class L, class W = typename L::Word>
ZKB_HD void quad_compress(const L& l, const Words& w, uint64_t rounds,
                          W& o0, W& o1) {
  W a, b, c, d;
  quad_init(l, w, a, b, c, d);
  quad_rounds(l, a, b, c, d, w.m, rounds);
  o0 = l.make([&](int i) { return w.h[i]; }) ^ a ^ c;
  o1 = l.make([&](int i) { return w.h[4 + i]; }) ^ b ^ d;
}

// the host's form: h' of one compression (h, m, t as int64 pairs; f
// nonzero: the final block) as 8 pairs at hout
inline void compress_one(const int64_t* h, const int64_t* m, const int64_t* t,
                         bool f, uint64_t rounds, int64_t* hout) {
  const QuadLanes l;
  QuadLanes::Word o0, o1;
  quad_compress(l, load_words(h, m, t, f), rounds, o0, o1);
  for (int i = 0; i < 4; ++i) {
    store_word(hout + 2 * i, o0.w[i]);
    store_word(hout + 2 * (4 + i), o1.w[i]);
  }
}

}  // namespace zkb
