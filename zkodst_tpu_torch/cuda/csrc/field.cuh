// BN254 field and G1 arithmetic shared by every kernel of the port.
//
// A field element is 8 little-endian 32-bit limbs holding the canonical
// Montgomery value a·2^256 mod p (the same value the JAX reference keeps in
// 16×16-bit limbs). Every function is __host__ __device__ so the header can
// also be compiled by a host C++ compiler and checked against Python ints
// without a card (tests/test_torch_cuda_header.py).
//
// The multiply is CIOS with 64-bit intermediates: (2^32-1)^2 + 2(2^32-1)
// fits in 64 bits, and nvcc lowers each step to a 32×32→64 multiply-add.
// p < 2^254 for both moduli, so every result before the final conditional
// subtraction is < 2p < 2^255 and the top word never carries.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define ZK_HD __host__ __device__ __forceinline__
// nvcc 12.9's front end (cicc) crashes when the complete addition is
// inlined into the scan kernels; out of line it costs a 288-byte stack
// frame per call and no spills.
#define ZK_HD_OUTLINE __host__ __device__ __noinline__
#else
#define ZK_HD inline
#define ZK_HD_OUTLINE inline
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

// r = t - p if t >= p else t (t < 2p).
template <class M>
ZK_HD void reduce_once(const uint32_t t[8], uint32_t r[8]) {
  uint32_t p[8];
  M::load(p);
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)t[i] - p[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (s >> 32) & 1u;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = borrow ? t[i] : d[i];
}

// r = a·b·2^-256 mod p; a, b canonical (< p).
template <class M>
ZK_HD void mont_mul(const uint32_t a[8], const uint32_t b[8], uint32_t r[8]) {
  uint32_t p[8];
  M::load(p);
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
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
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  reduce_once<M>(t, r);
}

// r = a + b mod p (a + b < 2p < 2^256: no carry out of the top limb).
template <class M>
ZK_HD void add_mod(const uint32_t a[8], const uint32_t b[8], uint32_t r[8]) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)a[i] + b[i] + c;
    s[i] = (uint32_t)v;
    c = v >> 32;
  }
  reduce_once<M>(s, r);
}

// r = a - b mod p.
template <class M>
ZK_HD void sub_mod(const uint32_t a[8], const uint32_t b[8], uint32_t r[8]) {
  uint32_t p[8];
  M::load(p);
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (v >> 32) & 1u;
  }
  uint64_t c = 0;
  uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)d[i] + (p[i] & mask) + c;
    r[i] = (uint32_t)v;
    c = v >> 32;
  }
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

// A projective G1 point (X : Y : Z); the identity is (0 : 1 : 0).
struct Pt {
  uint32_t x[8], y[8], z[8];
};

ZK_HD void set_identity(Pt& p) {
  Fq::one(p.y);                     // Y = 1 in Montgomery form
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p.x[i] = 0;
    p.z[i] = 0;
  }
}

ZK_HD void mul9(const uint32_t a[8], uint32_t r[8]) {
  uint32_t a2[8], a4[8], a8[8];
  add_mod<Fq>(a, a, a2);
  add_mod<Fq>(a2, a2, a4);
  add_mod<Fq>(a4, a4, a8);
  add_mod<Fq>(a8, a, r);
}

// Complete addition, RCB16 Alg. 7 for a = 0 with b3 = 3·3 = 9, in the
// operation sequence of zkodst_tpu/pallas/ec.py:_ec_add_vecs. Valid for
// every input pair, including identity and P + P; symmetric in (p, q).
ZK_HD_OUTLINE void ec_add(const Pt& p, const Pt& q, Pt& o) {
  uint32_t t0[8], t1[8], t2[8], u[8], v[8], w[8];
  uint32_t t3[8], t4[8], w3[8], s[8];
  mont_mul<Fq>(p.x, q.x, t0);
  mont_mul<Fq>(p.y, q.y, t1);
  mont_mul<Fq>(p.z, q.z, t2);
  add_mod<Fq>(p.x, p.y, u);
  add_mod<Fq>(q.x, q.y, v);
  mont_mul<Fq>(u, v, w);            // u1
  add_mod<Fq>(t0, t1, s);
  sub_mod<Fq>(w, s, t3);            // x1y2 + x2y1
  add_mod<Fq>(p.y, p.z, u);
  add_mod<Fq>(q.y, q.z, v);
  mont_mul<Fq>(u, v, w);            // u2
  add_mod<Fq>(t1, t2, s);
  sub_mod<Fq>(w, s, t4);            // y1z2 + y2z1
  add_mod<Fq>(p.x, p.z, u);
  add_mod<Fq>(q.x, q.z, v);
  mont_mul<Fq>(u, v, w);            // u3
  add_mod<Fq>(t0, t2, s);
  sub_mod<Fq>(w, s, w3);            // x1z2 + x2z1
  uint32_t t0_3[8], t2_9[8], z3p[8], t1m[8], y3p[8];
  add_mod<Fq>(t0, t0, s);
  add_mod<Fq>(s, t0, t0_3);         // 3·x1x2
  mul9(t2, t2_9);                   // b3·z1z2
  add_mod<Fq>(t1, t2_9, z3p);
  sub_mod<Fq>(t1, t2_9, t1m);
  mul9(w3, y3p);                    // b3·(x1z2 + x2z1)
  uint32_t a[8], b[8];
  mont_mul<Fq>(t3, t1m, a);
  mont_mul<Fq>(t4, y3p, b);
  sub_mod<Fq>(a, b, o.x);
  mont_mul<Fq>(y3p, t0_3, a);
  mont_mul<Fq>(t1m, z3p, b);
  add_mod<Fq>(a, b, o.y);
  mont_mul<Fq>(z3p, t4, a);
  mont_mul<Fq>(t0_3, t3, b);
  add_mod<Fq>(a, b, o.z);
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
