// Field and curve arithmetic shared by every kernel of the port: BN254's
// two fields and G1, and the Pasta fields and the pallas curve of the IPA
// backend.
//
// A field element is 8 little-endian 32-bit limbs holding the canonical
// Montgomery value a·2^256 mod p (the same value the JAX reference keeps in
// 16×16-bit limbs). Every function is __host__ __device__ so the header can
// also be compiled by a host C++ compiler and checked against Python ints
// without a card (tests/test_torch_cuda_header.py).
//
// The multiply is CIOS, one row per word of b: t += a·b_i, then
// t += m·p with m = t0·(−p^-1), then t moves down a word. On the card each
// row is PTX carry chains over two accumulators, E (words 0..7) and O
// (words 1..8), so that the low and high halves of every 32×32 product
// fall in one aligned register pair and ptxas makes each pair one 64-bit
// multiply-add with carry in and out (IMAD.WIDE.U32.X). One chain over
// all words instead costs a multiply and a carry add for each half, and
// the 64-bit C form below more still. E and O swap roles every row, which
// makes the word shift an aligned move folded into the next row's first
// chain. Each whole chain is one asm block: the carry flag does not
// survive between asm statements. The host (g++, in the tests) compiles
// the portable 64-bit form; both return the same canonical value. Sums,
// differences and the final conditional subtraction are add.cc / sub.cc
// chains on the card too: with the 64-bit C form there instead, the EC
// kernels took 16–55% longer on an H100 and the multiply-bound chain and
// NTT kernels 13–28% (PERF.md §6). Every modulus here is below 2^255
// (BN254's below 2^254, the two Pasta moduli just above it), and that is
// all the bounds need: with a, b < p a row adds less than 2p·2^32 to a
// sum below 2p, so the running sum stays below 2p·2^32 < 2^288 (nine
// words), the sum after the row's shift is again below 2p, every result
// before the final conditional subtraction is < 2p < 2^256, and a sum
// a + b of two canonical values never carries out of the top word.
//
// Everything is inlined, so the complete addition and doubling keep their
// points in registers: a call out of line would pass them through a stack
// frame in local memory, which competes with L1 in the scan kernels.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define ZK_HD __host__ __device__ __forceinline__
#else
#define ZK_HD inline
#endif

namespace zk {

// Fr: the scalar field (witness columns, MSM scalars).
struct Fr {
  static constexpr uint32_t INV = 0xEFFFFFFFu;  // -p^-1 mod 2^32
  ZK_HD static void load(uint32_t p[8]) {
    p[0] = 0xF0000001u; p[1] = 0x43E1F593u; p[2] = 0x79B97091u;
    p[3] = 0x2833E848u; p[4] = 0x8181585Du; p[5] = 0xB85045B6u;
    p[6] = 0xE131A029u; p[7] = 0x30644E72u;
  }
  // 1 in Montgomery form (2^256 mod p)
  ZK_HD static void one(uint32_t r[8]) {
    r[0] = 0x4FFFFFFBu; r[1] = 0xAC96341Cu; r[2] = 0x9F60CD29u;
    r[3] = 0x36FC7695u; r[4] = 0x7879462Eu; r[5] = 0x666EA36Fu;
    r[6] = 0x9A07DF2Fu; r[7] = 0x0E0A77C1u;
  }
};

// Fq: the base field (point coordinates).
struct Fq {
  static constexpr uint32_t INV = 0xE4866389u;  // -p^-1 mod 2^32
  ZK_HD static void load(uint32_t p[8]) {
    p[0] = 0xD87CFD47u; p[1] = 0x3C208C16u; p[2] = 0x6871CA8Du;
    p[3] = 0x97816A91u; p[4] = 0x8181585Du; p[5] = 0xB85045B6u;
    p[6] = 0xE131A029u; p[7] = 0x30644E72u;
  }
  // 1 in Montgomery form (2^256 mod p)
  ZK_HD static void one(uint32_t r[8]) {
    r[0] = 0xC58F0D9Du; r[1] = 0xD35D438Du; r[2] = 0xF5C70B3Du;
    r[3] = 0x0A78EB28u; r[4] = 0x7879462Cu; r[5] = 0x666EA36Fu;
    r[6] = 0x9A07DF2Fu; r[7] = 0x0E0A77C1u;
  }
};

// PallasFp: the base field of the Pasta "pallas" curve (PALLAS_BASE).
struct PallasFp {
  static constexpr uint32_t INV = 0xFFFFFFFFu;  // p ≡ 1 mod 2^32
  ZK_HD static void load(uint32_t p[8]) {
    p[0] = 0x00000001u; p[1] = 0x992D30EDu; p[2] = 0x094CF91Bu;
    p[3] = 0x224698FCu; p[4] = 0x00000000u; p[5] = 0x00000000u;
    p[6] = 0x00000000u; p[7] = 0x40000000u;
  }
  ZK_HD static void one(uint32_t r[8]) {
    r[0] = 0xFFFFFFFDu; r[1] = 0x34786D38u; r[2] = 0xE41914ADu;
    r[3] = 0x992C350Bu; r[4] = 0xFFFFFFFFu; r[5] = 0xFFFFFFFFu;
    r[6] = 0xFFFFFFFFu; r[7] = 0x3FFFFFFFu;
  }
};

// PallasFr: the scalar field of pallas, the base field of vesta
// (VESTA_BASE).
struct PallasFr {
  static constexpr uint32_t INV = 0xFFFFFFFFu;  // p ≡ 1 mod 2^32
  ZK_HD static void load(uint32_t p[8]) {
    p[0] = 0x00000001u; p[1] = 0x8C46EB21u; p[2] = 0x0994A8DDu;
    p[3] = 0x224698FCu; p[4] = 0x00000000u; p[5] = 0x00000000u;
    p[6] = 0x00000000u; p[7] = 0x40000000u;
  }
  ZK_HD static void one(uint32_t r[8]) {
    r[0] = 0xFFFFFFFDu; r[1] = 0x5B2B3E9Cu; r[2] = 0xE3420567u;
    r[3] = 0x992C350Bu; r[4] = 0xFFFFFFFFu; r[5] = 0xFFFFFFFFu;
    r[6] = 0xFFFFFFFFu; r[7] = 0x3FFFFFFFu;
  }
};

#if defined(__CUDA_ARCH__)
// The rows of the card's multiply (see the top of the file): E holds the
// running sum's words 0..7 and O its words 1..8.

// E += x_even·y: x0, x2, x4, x6 at words 0, 2, 4, 6; the carry out of
// word 7 goes to o8, the word at position 8.
__device__ __forceinline__ void mad_even(uint32_t E[8], const uint32_t x[8],
                                         uint32_t y, uint32_t& o8) {
  asm volatile(
      "mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(E[0]), "+r"(E[1]), "+r"(E[2]), "+r"(E[3]), "+r"(E[4]),
        "+r"(E[5]), "+r"(E[6]), "+r"(E[7]), "+r"(o8)
      : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]), "r"(y));
}

// O += x_odd·y: x1, x3, x5, x7 at words 1, 3, 5, 7 (O's pairs).
__device__ __forceinline__ void mad_odd(uint32_t O[8], const uint32_t x[8],
                                        uint32_t y) {
  asm volatile(
      "mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
      "madc.hi.u32 %7, %11, %12, %7;"
      : "+r"(O[0]), "+r"(O[1]), "+r"(O[2]), "+r"(O[3]), "+r"(O[4]),
        "+r"(O[5]), "+r"(O[6]), "+r"(O[7])
      : "r"(x[1]), "r"(x[3]), "r"(x[5]), "r"(x[7]), "r"(y));
}

// The start of a row, after the last one's reduction cleared word 0 and
// the sum moved down a word: E (the last row's O) takes word 1 of P (the
// last row's E), and P becomes the new O, its words 2..7 moved down two
// places (an aligned move) and added to x_odd·y, in one carry chain.
__device__ __forceinline__ void shift_mad_odd(uint32_t E[8], uint32_t P[8],
                                              const uint32_t x[8],
                                              uint32_t y) {
  uint32_t o[8];
  asm volatile(
      "add.cc.u32 %0, %0, %9;\n\t"
      "madc.lo.cc.u32 %1, %16, %20, %10;\n\t"
      "madc.hi.cc.u32 %2, %16, %20, %11;\n\t"
      "madc.lo.cc.u32 %3, %17, %20, %12;\n\t"
      "madc.hi.cc.u32 %4, %17, %20, %13;\n\t"
      "madc.lo.cc.u32 %5, %18, %20, %14;\n\t"
      "madc.hi.cc.u32 %6, %18, %20, %15;\n\t"
      "madc.lo.cc.u32 %7, %19, %20, %21;\n\t"
      "madc.hi.u32 %8, %19, %20, %21;"
      : "+r"(E[0]), "=r"(o[0]), "=r"(o[1]), "=r"(o[2]), "=r"(o[3]),
        "=r"(o[4]), "=r"(o[5]), "=r"(o[6]), "=r"(o[7])
      : "r"(P[1]), "r"(P[2]), "r"(P[3]), "r"(P[4]), "r"(P[5]), "r"(P[6]),
        "r"(P[7]), "r"(x[1]), "r"(x[3]), "r"(x[5]), "r"(x[7]), "r"(y),
        "r"(0u));
#pragma unroll
  for (int j = 0; j < 8; ++j) P[j] = o[j];
}

// Reduction step of a row: m = E0·(−p^-1), then E and O take m·p, which
// clears word 0.
template <class M>
__device__ __forceinline__ void redc(uint32_t E[8], uint32_t O[8],
                                     const uint32_t p[8]) {
  const uint32_t m = E[0] * M::INV;
  mad_odd(O, p, m);
  mad_even(E, p, m, O[7]);
}

// Row i ≥ 1 of the product: E, P as above; P holds the new O after it.
template <class M>
__device__ __forceinline__ void mul_row(uint32_t E[8], uint32_t P[8],
                                        const uint32_t a[8], uint32_t b,
                                        const uint32_t p[8]) {
  shift_mad_odd(E, P, a, b);
  mad_even(E, a, b, P[7]);
  redc<M>(E, P, p);
}
#endif

#if defined(__CUDA_ARCH__)
// d = a − b over 8 words; returns 0xFFFFFFFF if it borrowed, else 0.
__device__ __forceinline__ uint32_t sub8(const uint32_t a[8],
                                         const uint32_t b[8], uint32_t d[8]) {
  uint32_t borrow = 0;              // x − x − borrow-in = the borrow mask
  asm volatile(
      "sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %8, %8;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "+r"(borrow)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return borrow;
}

// s = a + b over 8 words, the carry out of the top word dropped.
__device__ __forceinline__ void add8(const uint32_t a[8], const uint32_t b[8],
                                     uint32_t s[8]) {
  asm volatile(
      "add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
        "=r"(s[5]), "=r"(s[6]), "=r"(s[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
}
#endif

// r = t - p if t >= p else t (t < 2p).
template <class M>
ZK_HD void reduce_once(const uint32_t t[8], uint32_t r[8]) {
  uint32_t p[8];
  M::load(p);
  uint32_t d[8];
#if defined(__CUDA_ARCH__)
  const uint32_t borrow = sub8(t, p, d);
#else
  uint64_t borrow = 0;
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)t[i] - p[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (s >> 32) & 1u;
  }
#endif
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = borrow ? t[i] : d[i];
}

// r = a·b·2^-256 mod p; a, b canonical (< p).
template <class M>
ZK_HD void mont_mul(const uint32_t a[8], const uint32_t b[8], uint32_t r[8]) {
  uint32_t p[8];
  M::load(p);
#if defined(__CUDA_ARCH__)
  uint32_t x[8], y[8];              // row 0: E = x, O = y
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    uint64_t w = (uint64_t)a[j] * b[0];
    x[j] = (uint32_t)w;
    x[j + 1] = (uint32_t)(w >> 32);
    w = (uint64_t)a[j + 1] * b[0];
    y[j] = (uint32_t)w;
    y[j + 1] = (uint32_t)(w >> 32);
  }
  redc<M>(x, y, p);
#pragma unroll
  for (int i = 1; i < 8; i += 2) {  // the arrays swap roles every row
    mul_row<M>(y, x, a, b[i], p);
    if (i + 1 < 8) mul_row<M>(x, y, a, b[i + 1], p);
  }
  // E = y, O = x, word 0 clear: t = (E + O·2^32) / 2^32
  uint32_t t[8];
  asm volatile(
      "add.cc.u32 %0, %8, %17;\n\t"
      "addc.cc.u32 %1, %9, %18;\n\t"
      "addc.cc.u32 %2, %10, %19;\n\t"
      "addc.cc.u32 %3, %11, %20;\n\t"
      "addc.cc.u32 %4, %12, %21;\n\t"
      "addc.cc.u32 %5, %13, %22;\n\t"
      "addc.cc.u32 %6, %14, %23;\n\t"
      "addc.u32 %7, %15, %16;"
      : "=r"(t[0]), "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]),
        "=r"(t[5]), "=r"(t[6]), "=r"(t[7])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(x[6]), "r"(x[7]), "r"(0u), "r"(y[1]), "r"(y[2]), "r"(y[3]),
        "r"(y[4]), "r"(y[5]), "r"(y[6]), "r"(y[7]));
#else
  uint32_t t[10];
  for (int i = 0; i < 10; ++i) t[i] = 0;
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * M::INV;
    s = (uint64_t)m * p[0] + t[0];
    c = s >> 32;
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
#endif
  reduce_once<M>(t, r);
}

// r = a + b mod p (a + b < 2p < 2^256: no carry out of the top limb).
template <class M>
ZK_HD void add_mod(const uint32_t a[8], const uint32_t b[8], uint32_t r[8]) {
  uint32_t s[8];
#if defined(__CUDA_ARCH__)
  add8(a, b, s);
#else
  uint64_t c = 0;
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)a[i] + b[i] + c;
    s[i] = (uint32_t)v;
    c = v >> 32;
  }
#endif
  reduce_once<M>(s, r);
}

// r = a - b mod p.
template <class M>
ZK_HD void sub_mod(const uint32_t a[8], const uint32_t b[8], uint32_t r[8]) {
  uint32_t p[8];
  M::load(p);
  uint32_t d[8];
#if defined(__CUDA_ARCH__)
  const uint32_t mask = sub8(a, b, d);
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] &= mask;
  add8(d, p, r);
#else
  uint64_t borrow = 0;
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (v >> 32) & 1u;
  }
  uint64_t c = 0;
  uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)d[i] + (p[i] & mask) + c;
    r[i] = (uint32_t)v;
    c = v >> 32;
  }
#endif
}

// Radix-2 DIT butterfly in place: (u, v) <- (u + w·v, u − w·v).
template <class M>
ZK_HD void butterfly(uint32_t u[8], uint32_t v[8], const uint32_t w[8]) {
  uint32_t t[8], s[8];
  mont_mul<M>(v, w, t);
  add_mod<M>(u, t, s);
  sub_mod<M>(u, t, v);
#pragma unroll
  for (int i = 0; i < 8; ++i) u[i] = s[i];
}

// A projective point (X : Y : Z); the identity is (0 : 1 : 0).
struct Pt {
  uint32_t x[8], y[8], z[8];
};

// The curves y² = x³ + b, a = 0: the field of the coordinates and
// b3 = 3·b, the one constant of the complete formulas, as a chain of
// additions.
struct Bn254 {                      // BN254 G1: b = 3
  using F = Fq;
  ZK_HD static void mul_b3(const uint32_t a[8], uint32_t r[8]) {
    uint32_t a2[8], a4[8], a8[8];   // 9a = 8a + a
    add_mod<Fq>(a, a, a2);
    add_mod<Fq>(a2, a2, a4);
    add_mod<Fq>(a4, a4, a8);
    add_mod<Fq>(a8, a, r);
  }
};

struct Pallas {                     // Pasta pallas: b = 5
  using F = PallasFp;
  ZK_HD static void mul_b3(const uint32_t a[8], uint32_t r[8]) {
    uint32_t a2[8], a3[8], a6[8], a12[8];   // 15a = 12a + 3a
    add_mod<F>(a, a, a2);
    add_mod<F>(a2, a, a3);
    add_mod<F>(a3, a3, a6);
    add_mod<F>(a6, a6, a12);
    add_mod<F>(a12, a3, r);
  }
};

template <class C = Bn254>
ZK_HD void set_identity(Pt& p) {
  C::F::one(p.y);                   // Y = 1 in Montgomery form
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p.x[i] = 0;
    p.z[i] = 0;
  }
}

// The complete addition and doubling are written once, over a `Layer`
// that computes one layer of independent products r[k] = a[k]·b[k] in the
// curve's field. SerialLayer runs them one after another in one thread
// (ptxas overlaps their carry chains); ec.cu's warp layer gives each
// product its own lane.
template <class M = Fq>
struct SerialLayer {
  template <int N>
  ZK_HD void operator()(const uint32_t* const (&a)[N],
                        const uint32_t* const (&b)[N],
                        uint32_t* const (&r)[N]) const {
#pragma unroll
    for (int k = 0; k < N; ++k) mont_mul<M>(a[k], b[k], r[k]);
  }
};

// Complete addition, RCB16 Alg. 7 for a = 0 (b3 = 9 on BN254, 15 on
// pallas), in the operation sequence of
// zkodst_tpu/pallas/ec.py:_ec_add_vecs: 12 products in two layers of 6.
// Valid for every input pair, including identity and P + P; symmetric in
// (p, q). o may alias p or q.
template <class Layer, class C = Bn254>
ZK_HD void ec_add_by(const Layer& mul, const Pt& p, const Pt& q, Pt& o) {
  using F = typename C::F;
  uint32_t sp[3][8], sq[3][8];
  add_mod<F>(p.x, p.y, sp[0]);
  add_mod<F>(p.y, p.z, sp[1]);
  add_mod<F>(p.x, p.z, sp[2]);
  add_mod<F>(q.x, q.y, sq[0]);
  add_mod<F>(q.y, q.z, sq[1]);
  add_mod<F>(q.x, q.z, sq[2]);
  uint32_t t0[8], t1[8], t2[8], u1[8], u2[8], u3[8];
  const uint32_t* const a1[6] = {p.x, p.y, p.z, sp[0], sp[1], sp[2]};
  const uint32_t* const b1[6] = {q.x, q.y, q.z, sq[0], sq[1], sq[2]};
  uint32_t* const r1[6] = {t0, t1, t2, u1, u2, u3};
  mul(a1, b1, r1);
  uint32_t s[8], t3[8], t4[8], w3[8];
  add_mod<F>(t0, t1, s);
  sub_mod<F>(u1, s, t3);            // x1y2 + x2y1
  add_mod<F>(t1, t2, s);
  sub_mod<F>(u2, s, t4);            // y1z2 + y2z1
  add_mod<F>(t0, t2, s);
  sub_mod<F>(u3, s, w3);            // x1z2 + x2z1
  uint32_t t0_3[8], t2_9[8], z3p[8], t1m[8], y3p[8];
  add_mod<F>(t0, t0, s);
  add_mod<F>(s, t0, t0_3);         // 3·x1x2
  C::mul_b3(t2, t2_9);             // b3·z1z2
  add_mod<F>(t1, t2_9, z3p);
  sub_mod<F>(t1, t2_9, t1m);
  C::mul_b3(w3, y3p);             // b3·(x1z2 + x2z1)
  uint32_t m[6][8];
  const uint32_t* const a2[6] = {t3, t4, y3p, t1m, z3p, t0_3};
  const uint32_t* const b2[6] = {t1m, y3p, t0_3, z3p, t4, t3};
  uint32_t* const r2[6] = {m[0], m[1], m[2], m[3], m[4], m[5]};
  mul(a2, b2, r2);
  sub_mod<F>(m[0], m[1], o.x);
  add_mod<F>(m[2], m[3], o.y);
  add_mod<F>(m[4], m[5], o.z);
}

// Complete doubling, RCB16 Alg. 9 for a = 0 (b3 = 9 on BN254, 15 on
// pallas), in the operation sequence of zkodst_tpu/ops/curve.py:
// _double_impl: 6 multiplies and 2 squarings in three layers of
// independent products (4, 2, 2), where ec_add(p, p) takes 12 in two
// layers of 6. Valid for every input; the identity (0 : 1 : 0) maps to
// itself. o may alias p.
template <class Layer, class C = Bn254>
ZK_HD void ec_dbl_by(const Layer& mul, const Pt& p, Pt& o) {
  using F = typename C::F;
  uint32_t t0[8], t1[8], xy[8], t2[8];
  const uint32_t* const a1[4] = {p.y, p.y, p.x, p.z};
  const uint32_t* const b1[4] = {p.y, p.z, p.y, p.z};
  uint32_t* const r1[4] = {t0, t1, xy, t2};
  mul(a1, b1, r1);                  // y², yz, xy, z²
  uint32_t u[8], v[8], z3[8], b3z2[8];
  add_mod<F>(t0, t0, u);
  add_mod<F>(u, u, v);
  add_mod<F>(v, v, z3);             // 8·y²
  C::mul_b3(t2, b3z2);              // b3·z²
  uint32_t x3[8];
  const uint32_t* const a2[2] = {b3z2, t1};
  const uint32_t* const b2[2] = {z3, z3};
  uint32_t* const r2[2] = {x3, o.z};  // p is not read after the first layer
  mul(a2, b2, r2);
  uint32_t y3[8], w[8];
  add_mod<F>(t0, b3z2, y3);
  add_mod<F>(b3z2, b3z2, u);
  add_mod<F>(u, b3z2, v);           // 3·b3·z²
  sub_mod<F>(t0, v, w);
  uint32_t ya[8], xa[8];
  const uint32_t* const a3[2] = {w, w};
  const uint32_t* const b3[2] = {y3, xy};
  uint32_t* const r3[2] = {ya, xa};
  mul(a3, b3, r3);
  add_mod<F>(ya, x3, o.y);
  add_mod<F>(xa, xa, o.x);
}

template <class C = Bn254>
ZK_HD void ec_add(const Pt& p, const Pt& q, Pt& o) {
  ec_add_by<SerialLayer<typename C::F>, C>(SerialLayer<typename C::F>(), p,
                                           q, o);
}

template <class C = Bn254>
ZK_HD void ec_dbl(const Pt& p, Pt& o) {
  ec_dbl_by<SerialLayer<typename C::F>, C>(SerialLayer<typename C::F>(), p,
                                           o);
}

// Packed point tensors are (batch, 24, n) 32-bit words: row c·8 + i holds
// limb i of coordinate c, so neighbouring threads read neighbouring words.
ZK_HD void load_pt(const uint32_t* base, int64_t n, int64_t e, Pt& p) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p.x[i] = base[i * n + e];
    p.y[i] = base[(8 + i) * n + e];
    p.z[i] = base[(16 + i) * n + e];
  }
}

ZK_HD void store_pt(uint32_t* base, int64_t n, int64_t e, const Pt& p) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    base[i * n + e] = p.x[i];
    base[(8 + i) * n + e] = p.y[i];
    base[(16 + i) * n + e] = p.z[i];
  }
}

}  // namespace zk
