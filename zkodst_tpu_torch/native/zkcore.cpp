// BN254 host-side crypto core: Montgomery field tower, G1 Jacobian ops,
// optimal-ate pairing. The native (C++) leg of the framework's verifier —
// the role the reference delegates to Rust `halo2curves`/`pairing`
// (SURVEY.md §2.3 N4/N6). Mirrors zkodst_tpu/proof/pairing.py operation
// for operation (same tower, same Miller loop, same naive final
// exponentiation driven by exponent bytes passed from Python), so the two
// implementations cross-check each other in tests.
//
// No external dependencies; all magic constants (Montgomery n', R² mod p)
// are derived at startup (Newton iteration / doubling ladder). Build:
//   g++ -O3 -shared -fPIC -o libzkcore.so zkcore.cpp
//
// Boundary convention: field elements cross as 32-byte little-endian
// canonical (non-Montgomery) integers; G1 points as (inf, x, y); G2 points
// as (x.c0, x.c1, y.c0, y.c1).

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

struct U256 {
    u64 v[4];
};

static inline bool geq(const U256 &a, const U256 &b) {
    for (int i = 3; i >= 0; --i) {
        if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
    }
    return true;
}

static inline bool is_zero(const U256 &a) {
    return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline u64 add_raw(U256 &o, const U256 &a, const U256 &b) {
    u128 c = 0;
    for (int i = 0; i < 4; ++i) {
        c += (u128)a.v[i] + b.v[i];
        o.v[i] = (u64)c;
        c >>= 64;
    }
    return (u64)c;
}

static inline u64 sub_raw(U256 &o, const U256 &a, const U256 &b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        o.v[i] = (u64)d;
        borrow = (d >> 64) & 1;  // two's-complement borrow bit
    }
    return (u64)borrow;
}

// A prime field with Montgomery arithmetic (R = 2^256).
struct Fp {
    U256 p;
    u64 ninv;   // -p^{-1} mod 2^64
    U256 r2;    // R^2 mod p
    U256 one;   // R mod p (1 in Montgomery form)

    void init(const U256 &prime) {
        p = prime;
        // ninv by Newton: x <- x(2 - p x) mod 2^64
        u64 x = 1;
        for (int i = 0; i < 6; ++i) x *= 2 - p.v[0] * x;
        ninv = ~x + 1;  // -x
        // R mod p via 256 doublings of 1; R^2 via 512 doublings
        U256 acc = {{1, 0, 0, 0}};
        for (int i = 0; i < 256; ++i) dbl_mod(acc);
        one = acc;
        for (int i = 0; i < 256; ++i) dbl_mod(acc);
        r2 = acc;
    }

    void dbl_mod(U256 &a) const {
        U256 t;
        u64 carry = add_raw(t, a, a);
        if (carry || geq(t, p)) sub_raw(t, t, p);
        a = t;
    }

    void add(U256 &o, const U256 &a, const U256 &b) const {
        u64 carry = add_raw(o, a, b);
        if (carry || geq(o, p)) sub_raw(o, o, p);
    }

    void sub(U256 &o, const U256 &a, const U256 &b) const {
        if (sub_raw(o, a, b)) add_raw(o, o, p);
    }

    void neg(U256 &o, const U256 &a) const {
        if (is_zero(a)) { o = a; return; }
        sub_raw(o, p, a);
    }

    // CIOS Montgomery multiplication: o = a*b*R^{-1} mod p
    void mul(U256 &o, const U256 &a, const U256 &b) const {
        u64 t[6] = {0, 0, 0, 0, 0, 0};
        for (int i = 0; i < 4; ++i) {
            u128 c = 0;
            for (int j = 0; j < 4; ++j) {
                c += (u128)t[j] + (u128)a.v[i] * b.v[j];
                t[j] = (u64)c;
                c >>= 64;
            }
            c += t[4];
            t[4] = (u64)c;
            t[5] = (u64)(c >> 64);
            u64 m = t[0] * ninv;
            c = (u128)t[0] + (u128)m * p.v[0];
            c >>= 64;
            for (int j = 1; j < 4; ++j) {
                c += (u128)t[j] + (u128)m * p.v[j];
                t[j - 1] = (u64)c;
                c >>= 64;
            }
            c += t[4];
            t[3] = (u64)c;
            t[4] = t[5] + (u64)(c >> 64);
            t[5] = 0;
        }
        U256 r = {{t[0], t[1], t[2], t[3]}};
        if (t[4] || geq(r, p)) sub_raw(r, r, p);
        o = r;
    }

    void sqr(U256 &o, const U256 &a) const { mul(o, a, a); }

    void to_mont(U256 &o, const U256 &a) const { mul(o, a, r2); }

    void from_mont(U256 &o, const U256 &a) const {
        U256 u = {{1, 0, 0, 0}};
        mul(o, a, u);
    }

    // o = a^{-1} (Montgomery in/out) by Fermat via bits of p-2
    void inv(U256 &o, const U256 &a) const {
        U256 e;
        U256 two = {{2, 0, 0, 0}};
        sub_raw(e, p, two);
        U256 acc = one, base = a;
        for (int w = 0; w < 4; ++w) {
            u64 bits = e.v[w];
            for (int i = 0; i < 64; ++i) {
                if (bits & 1) mul(acc, acc, base);
                mul(base, base, base);
                bits >>= 1;
            }
        }
        o = acc;
    }
};

static const U256 FQ_P = {{0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                           0xb85045b68181585dULL, 0x30644e72e131a029ULL}};
static const U256 FR_P = {{0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                           0xb85045b68181585dULL, 0x30644e72e131a029ULL}};

static Fp FQ, FR;
static bool g_init = false;

static void ensure_init() {
    if (!g_init) {
        FQ.init(FQ_P);
        FR.init(FR_P);
        g_init = true;
    }
}

// ---------------------------------------------------------------------------
// Fq2 / Fq6 / Fq12 tower (mirrors proof/pairing.py; Montgomery throughout)
// ---------------------------------------------------------------------------

struct F2 { U256 c0, c1; };

static F2 f2_zero() { F2 z; memset(&z, 0, sizeof z); return z; }
static F2 f2_one() { F2 z = f2_zero(); z.c0 = FQ.one; return z; }

static void f2_add(F2 &o, const F2 &a, const F2 &b) {
    FQ.add(o.c0, a.c0, b.c0);
    FQ.add(o.c1, a.c1, b.c1);
}
static void f2_sub(F2 &o, const F2 &a, const F2 &b) {
    FQ.sub(o.c0, a.c0, b.c0);
    FQ.sub(o.c1, a.c1, b.c1);
}
static void f2_neg(F2 &o, const F2 &a) {
    FQ.neg(o.c0, a.c0);
    FQ.neg(o.c1, a.c1);
}
static void f2_mul(F2 &o, const F2 &a, const F2 &b) {
    U256 t0, t1, s;
    FQ.mul(t0, a.c0, b.c0);
    FQ.mul(t1, a.c1, b.c1);
    U256 x, y;
    FQ.mul(x, a.c0, b.c1);
    FQ.mul(y, a.c1, b.c0);
    FQ.sub(s, t0, t1);      // a0b0 - a1b1
    o.c1 = x;
    FQ.add(o.c1, x, y);
    o.c0 = s;
}
static void f2_inv(F2 &o, const F2 &a) {
    U256 d, t;
    FQ.mul(d, a.c0, a.c0);
    FQ.mul(t, a.c1, a.c1);
    FQ.add(d, d, t);
    FQ.inv(d, d);
    FQ.mul(o.c0, a.c0, d);
    U256 n;
    FQ.neg(n, a.c1);
    FQ.mul(o.c1, n, d);
}
// xi = 9 + u
static void f2_mul_xi(F2 &o, const F2 &a) {
    U256 t0 = a.c0, t1 = a.c1, x, y;
    // (9a0 - a1) + (a0 + 9a1) u
    U256 nine_a0 = t0;
    for (int i = 0; i < 3; ++i) FQ.add(nine_a0, nine_a0, nine_a0);  // 8a0
    FQ.add(nine_a0, nine_a0, t0);
    U256 nine_a1 = t1;
    for (int i = 0; i < 3; ++i) FQ.add(nine_a1, nine_a1, nine_a1);
    FQ.add(nine_a1, nine_a1, t1);
    FQ.sub(x, nine_a0, t1);
    FQ.add(y, t0, nine_a1);
    o.c0 = x;
    o.c1 = y;
}

struct F6 { F2 c0, c1, c2; };

static F6 f6_zero() { F6 z; memset(&z, 0, sizeof z); return z; }
static F6 f6_one() { F6 z = f6_zero(); z.c0 = f2_one(); return z; }

static void f6_add(F6 &o, const F6 &a, const F6 &b) {
    f2_add(o.c0, a.c0, b.c0);
    f2_add(o.c1, a.c1, b.c1);
    f2_add(o.c2, a.c2, b.c2);
}
static void f6_sub(F6 &o, const F6 &a, const F6 &b) {
    f2_sub(o.c0, a.c0, b.c0);
    f2_sub(o.c1, a.c1, b.c1);
    f2_sub(o.c2, a.c2, b.c2);
}
static void f6_neg(F6 &o, const F6 &a) {
    f2_neg(o.c0, a.c0);
    f2_neg(o.c1, a.c1);
    f2_neg(o.c2, a.c2);
}
static void f6_mul(F6 &o, const F6 &a, const F6 &b) {
    F2 t0, t1, t2, tmp, u, v;
    f2_mul(t0, a.c0, b.c0);
    f2_mul(t1, a.c1, b.c1);
    f2_mul(t2, a.c2, b.c2);
    // c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
    f2_add(u, a.c1, a.c2);
    f2_add(v, b.c1, b.c2);
    f2_mul(tmp, u, v);
    f2_sub(tmp, tmp, t1);
    f2_sub(tmp, tmp, t2);
    f2_mul_xi(tmp, tmp);
    F2 c0, c1, c2;
    f2_add(c0, t0, tmp);
    // c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
    f2_add(u, a.c0, a.c1);
    f2_add(v, b.c0, b.c1);
    f2_mul(tmp, u, v);
    f2_sub(tmp, tmp, t0);
    f2_sub(tmp, tmp, t1);
    F2 xt2;
    f2_mul_xi(xt2, t2);
    f2_add(c1, tmp, xt2);
    // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    f2_add(u, a.c0, a.c2);
    f2_add(v, b.c0, b.c2);
    f2_mul(tmp, u, v);
    f2_sub(tmp, tmp, t0);
    f2_sub(tmp, tmp, t2);
    f2_add(c2, tmp, t1);
    o.c0 = c0; o.c1 = c1; o.c2 = c2;
}
static void f6_mul_v(F6 &o, const F6 &a) {
    F2 t;
    f2_mul_xi(t, a.c2);
    F2 a0 = a.c0, a1 = a.c1;
    o.c0 = t;
    o.c1 = a0;
    o.c2 = a1;
}
static void f6_inv(F6 &o, const F6 &a) {
    F2 c0, c1, c2, t, u;
    f2_mul(c0, a.c0, a.c0);
    f2_mul(t, a.c1, a.c2);
    f2_mul_xi(t, t);
    f2_sub(c0, c0, t);
    f2_mul(c1, a.c2, a.c2);
    f2_mul_xi(c1, c1);
    f2_mul(t, a.c0, a.c1);
    f2_sub(c1, c1, t);
    f2_mul(c2, a.c1, a.c1);
    f2_mul(t, a.c0, a.c2);
    f2_sub(c2, c2, t);
    // t = xi*(a2*c1 + a1*c2) + a0*c0
    f2_mul(t, a.c2, c1);
    f2_mul(u, a.c1, c2);
    f2_add(t, t, u);
    f2_mul_xi(t, t);
    f2_mul(u, a.c0, c0);
    f2_add(t, t, u);
    f2_inv(t, t);
    f2_mul(o.c0, c0, t);
    f2_mul(o.c1, c1, t);
    f2_mul(o.c2, c2, t);
}

struct F12 { F6 c0, c1; };

static F12 f12_zero() { F12 z; memset(&z, 0, sizeof z); return z; }
static F12 f12_one() { F12 z = f12_zero(); z.c0 = f6_one(); return z; }

static void f12_add(F12 &o, const F12 &a, const F12 &b) {
    f6_add(o.c0, a.c0, b.c0);
    f6_add(o.c1, a.c1, b.c1);
}
static void f12_sub(F12 &o, const F12 &a, const F12 &b) {
    f6_sub(o.c0, a.c0, b.c0);
    f6_sub(o.c1, a.c1, b.c1);
}
static void f12_neg(F12 &o, const F12 &a) {
    f6_neg(o.c0, a.c0);
    f6_neg(o.c1, a.c1);
}
static void f12_mul(F12 &o, const F12 &a, const F12 &b) {
    F6 t0, t1, u, v, tmp;
    f6_mul(t0, a.c0, b.c0);
    f6_mul(t1, a.c1, b.c1);
    F6 c0, c1;
    f6_mul_v(tmp, t1);
    f6_add(c0, t0, tmp);
    f6_add(u, a.c0, a.c1);
    f6_add(v, b.c0, b.c1);
    f6_mul(tmp, u, v);
    f6_sub(tmp, tmp, t0);
    f6_sub(c1, tmp, t1);
    o.c0 = c0; o.c1 = c1;
}
static void f12_inv(F12 &o, const F12 &a) {
    F6 t, u;
    f6_mul(t, a.c0, a.c0);
    f6_mul(u, a.c1, a.c1);
    f6_mul_v(u, u);
    f6_sub(t, t, u);
    f6_inv(t, t);
    f6_mul(o.c0, a.c0, t);
    f6_mul(u, a.c1, t);
    f6_neg(o.c1, u);
}
static bool f12_eq(const F12 &a, const F12 &b) {
    return memcmp(&a, &b, sizeof(F12)) == 0;
}
static void f12_scalar(F12 &o, const U256 &mont_fq) {
    o = f12_zero();
    o.c0.c0.c0 = mont_fq;
}
static void f12_pow_bytes(F12 &o, const F12 &a, const uint8_t *exp,
                          int len) {
    // exponent little-endian bytes, square-and-multiply
    F12 acc = f12_one(), base = a;
    for (int i = 0; i < len; ++i) {
        uint8_t byte = exp[i];
        for (int b = 0; b < 8; ++b) {
            if (byte & 1) f12_mul(acc, acc, base);
            f12_mul(base, base, base);
            byte >>= 1;
        }
    }
    o = acc;
}

// ---------------------------------------------------------------------------
// E(Fq12) affine ops + Miller loop (mirrors pairing.py)
// ---------------------------------------------------------------------------

struct P12 {
    F12 x, y;
    bool inf;
};

static void p12_add(P12 &o, const P12 &p1, const P12 &p2) {
    if (p1.inf) { o = p2; return; }
    if (p2.inf) { o = p1; return; }
    F12 lam, t, u;
    if (f12_eq(p1.x, p2.x)) {
        F12 negy;
        f12_neg(negy, p2.y);
        if (f12_eq(p1.y, negy) || f12_eq(p1.y, f12_zero())) {
            if (!f12_eq(p1.y, p2.y)) { o.inf = true; return; }
            if (f12_eq(p1.y, f12_zero())) { o.inf = true; return; }
        }
        if (!f12_eq(p1.y, p2.y)) { o.inf = true; return; }
        // doubling: lam = 3x^2 / 2y
        f12_mul(t, p1.x, p1.x);
        F12 three = t;
        f12_add(three, three, t);
        f12_add(three, three, t);
        F12 twoy;
        f12_add(twoy, p1.y, p1.y);
        f12_inv(u, twoy);
        f12_mul(lam, three, u);
    } else {
        F12 dy, dx;
        f12_sub(dy, p2.y, p1.y);
        f12_sub(dx, p2.x, p1.x);
        f12_inv(u, dx);
        f12_mul(lam, dy, u);
    }
    F12 x3, y3;
    f12_mul(x3, lam, lam);
    f12_sub(x3, x3, p1.x);
    f12_sub(x3, x3, p2.x);
    f12_sub(y3, p1.x, x3);
    f12_mul(y3, lam, y3);
    f12_sub(y3, y3, p1.y);
    o.x = x3; o.y = y3; o.inf = false;
}

// line through t,r evaluated at p (all E(Fq12) affine, p not inf)
static void line_eval(F12 &o, const P12 &t, const P12 &r, const P12 &p) {
    F12 lam, u, tmp;
    if (f12_eq(t.x, r.x) && f12_eq(t.y, r.y)) {
        F12 x2;
        f12_mul(x2, t.x, t.x);
        F12 three = x2;
        f12_add(three, three, x2);
        f12_add(three, three, x2);
        F12 twoy;
        f12_add(twoy, t.y, t.y);
        f12_inv(u, twoy);
        f12_mul(lam, three, u);
    } else if (f12_eq(t.x, r.x)) {
        f12_sub(o, p.x, t.x);   // vertical line
        return;
    } else {
        F12 dy, dx;
        f12_sub(dy, r.y, t.y);
        f12_sub(dx, r.x, t.x);
        f12_inv(u, dx);
        f12_mul(lam, dy, u);
    }
    f12_sub(o, p.y, t.y);
    f12_sub(tmp, p.x, t.x);
    f12_mul(tmp, lam, tmp);
    f12_sub(o, o, tmp);
}

// Frobenius x -> x^p on a point via generic pow (mirrors pairing.py)
static void f12_pow_u256(F12 &o, const F12 &a, const U256 &e) {
    uint8_t bytes[32];
    memcpy(bytes, e.v, 32);
    f12_pow_bytes(o, a, bytes, 32);
}

// 6x+2 = 29793968203157093288 = 2^64 + 0x9D797039BE763BA8 (65 bits: the
// leading 1 is implicit in the loop start, then the 64 low bits follow)
static const u64 ATE_LOOP_LO = 0x9D797039BE763BA8ULL;

static void miller_loop(F12 &f, const P12 &q, const P12 &p) {
    f = f12_one();
    if (q.inf || p.inf) return;
    P12 t = q;
    F12 l;
    for (int i = 63; i >= 0; --i) {
        f12_mul(f, f, f);
        line_eval(l, t, t, p);
        f12_mul(f, f, l);
        P12 t2;
        p12_add(t2, t, t);
        t = t2;
        if ((ATE_LOOP_LO >> i) & 1) {
            line_eval(l, t, q, p);
            f12_mul(f, f, l);
            P12 t3;
            p12_add(t3, t, q);
            t = t3;
        }
    }
    P12 q1, q2;
    f12_pow_u256(q1.x, q.x, FQ.p);
    f12_pow_u256(q1.y, q.y, FQ.p);
    q1.inf = false;
    f12_pow_u256(q2.x, q1.x, FQ.p);
    f12_pow_u256(q2.y, q1.y, FQ.p);
    f12_neg(q2.y, q2.y);
    q2.inf = false;
    line_eval(l, t, q1, p);
    f12_mul(f, f, l);
    P12 t4;
    p12_add(t4, t, q1);
    t = t4;
    line_eval(l, t, q2, p);
    f12_mul(f, f, l);
}

// ---------------------------------------------------------------------------
// G1 Jacobian (over Fq, Montgomery)
// ---------------------------------------------------------------------------

struct G1J {
    U256 x, y, z;  // z==0 => infinity
};

static void g1_dbl(G1J &o, const G1J &a) {
    if (is_zero(a.z)) { o = a; return; }
    U256 A, B, C, D, E, F, t, u;
    FQ.sqr(A, a.x);
    FQ.sqr(B, a.y);
    FQ.sqr(C, B);
    FQ.add(t, a.x, B);
    FQ.sqr(t, t);
    FQ.sub(t, t, A);
    FQ.sub(t, t, C);
    FQ.add(D, t, t);
    FQ.add(E, A, A);
    FQ.add(E, E, A);
    FQ.sqr(F, E);
    U256 x3, y3, z3;
    FQ.sub(x3, F, D);
    FQ.sub(x3, x3, D);
    FQ.sub(t, D, x3);
    FQ.mul(t, E, t);
    U256 c8;
    FQ.add(c8, C, C);
    FQ.add(c8, c8, c8);
    FQ.add(c8, c8, c8);
    FQ.sub(y3, t, c8);
    FQ.mul(u, a.y, a.z);
    FQ.add(z3, u, u);
    o.x = x3; o.y = y3; o.z = z3;   // o may alias a
}

static void g1_add(G1J &o, const G1J &a, const G1J &b) {
    if (is_zero(a.z)) { o = b; return; }
    if (is_zero(b.z)) { o = a; return; }
    U256 z1z1, z2z2, u1, u2, s1, s2, h, i, j, r, v, t;
    FQ.sqr(z1z1, a.z);
    FQ.sqr(z2z2, b.z);
    FQ.mul(u1, a.x, z2z2);
    FQ.mul(u2, b.x, z1z1);
    FQ.mul(s1, a.y, b.z);
    FQ.mul(s1, s1, z2z2);
    FQ.mul(s2, b.y, a.z);
    FQ.mul(s2, s2, z1z1);
    if (memcmp(&u1, &u2, 32) == 0) {
        if (memcmp(&s1, &s2, 32) == 0) { g1_dbl(o, a); return; }
        o.x = FQ.one; o.y = FQ.one;
        memset(&o.z, 0, 32);
        return;
    }
    FQ.sub(h, u2, u1);
    FQ.add(i, h, h);
    FQ.sqr(i, i);
    FQ.mul(j, h, i);
    FQ.sub(r, s2, s1);
    FQ.add(r, r, r);
    FQ.mul(v, u1, i);
    U256 x3, y3, z3;
    FQ.sqr(x3, r);
    FQ.sub(x3, x3, j);
    FQ.sub(x3, x3, v);
    FQ.sub(x3, x3, v);
    FQ.sub(t, v, x3);
    FQ.mul(t, r, t);
    U256 s1j;
    FQ.mul(s1j, s1, j);
    FQ.add(s1j, s1j, s1j);
    FQ.sub(y3, t, s1j);
    FQ.add(t, a.z, b.z);
    FQ.sqr(t, t);
    FQ.sub(t, t, z1z1);
    FQ.sub(t, t, z2z2);
    FQ.mul(z3, t, h);
    o.x = x3; o.y = y3; o.z = z3;   // o may alias a or b
}

static void g1_mul(G1J &o, const G1J &a, const U256 &k) {
    G1J acc;
    acc.x = FQ.one;
    acc.y = FQ.one;
    memset(&acc.z, 0, 32);
    for (int w = 3; w >= 0; --w) {
        for (int i = 63; i >= 0; --i) {
            g1_dbl(acc, acc);
            if ((k.v[w] >> i) & 1) g1_add(acc, acc, a);
        }
    }
    o = acc;
}

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

static void load_u256(U256 &o, const uint8_t *le32) {
    memcpy(o.v, le32, 32);
}

static void store_u256(uint8_t *le32, const U256 &a) {
    memcpy(le32, a.v, 32);
}

static void load_g1(G1J &o, const uint8_t *pt64, uint8_t inf) {
    if (inf) {
        o.x = FQ.one;
        o.y = FQ.one;
        memset(&o.z, 0, 32);
        return;
    }
    U256 x, y;
    load_u256(x, pt64);
    load_u256(y, pt64 + 32);
    FQ.to_mont(o.x, x);
    FQ.to_mont(o.y, y);
    o.z = FQ.one;
}

extern "C" {

// out: inf flag + affine x,y (canonical LE)
void zk_g1_msm(const uint8_t *pts, const uint8_t *infs,
               const uint8_t *scalars, int n, uint8_t *out65) {
    ensure_init();
    G1J acc;
    acc.x = FQ.one;
    acc.y = FQ.one;
    memset(&acc.z, 0, 32);
    for (int i = 0; i < n; ++i) {
        G1J p;
        load_g1(p, pts + 64 * i, infs[i]);
        U256 k;
        load_u256(k, scalars + 32 * i);
        G1J kp;
        g1_mul(kp, p, k);
        g1_add(acc, acc, kp);
    }
    if (is_zero(acc.z)) {
        out65[0] = 1;
        memset(out65 + 1, 0, 64);
        return;
    }
    U256 zinv, zi2, zi3, xa, ya;
    FQ.inv(zinv, acc.z);
    FQ.sqr(zi2, zinv);
    FQ.mul(zi3, zi2, zinv);
    FQ.mul(xa, acc.x, zi2);
    FQ.mul(ya, acc.y, zi3);
    FQ.from_mont(xa, xa);
    FQ.from_mont(ya, ya);
    out65[0] = 0;
    store_u256(out65 + 1, xa);
    store_u256(out65 + 33, ya);
}

// pairing product check: prod e(P_i, Q_i) == 1.
// g1s: n×64 (x,y LE canonical), g1inf: n flags; g2s: n×128 (x0,x1,y0,y1).
// exp: little-endian bytes of (p^12-1)/r.
int zk_pairing_check(const uint8_t *g1s, const uint8_t *g1inf,
                     const uint8_t *g2s, const uint8_t *g2inf, int n,
                     const uint8_t *exp, int exp_len) {
    ensure_init();
    F12 accf = f12_one();
    for (int i = 0; i < n; ++i) {
        if (g1inf[i] || g2inf[i]) continue;
        // embed G1 point into Fq12
        P12 p;
        U256 gx, gy;
        load_u256(gx, g1s + 64 * i);
        load_u256(gy, g1s + 64 * i + 32);
        FQ.to_mont(gx, gx);
        FQ.to_mont(gy, gy);
        f12_scalar(p.x, gx);
        f12_scalar(p.y, gy);
        p.inf = false;
        // untwist G2: (x w^2, y w^3)
        F2 qx, qy;
        load_u256(qx.c0, g2s + 128 * i);
        load_u256(qx.c1, g2s + 128 * i + 32);
        load_u256(qy.c0, g2s + 128 * i + 64);
        load_u256(qy.c1, g2s + 128 * i + 96);
        FQ.to_mont(qx.c0, qx.c0);
        FQ.to_mont(qx.c1, qx.c1);
        FQ.to_mont(qy.c0, qy.c0);
        FQ.to_mont(qy.c1, qy.c1);
        F12 xe = f12_zero(), ye = f12_zero(), w2 = f12_zero(),
            w3 = f12_zero();
        xe.c0.c0 = qx;
        ye.c0.c0 = qy;
        // w^2 = v (c0.c1 slot); w^3 = v*w (c1.c1 slot)
        w2.c0.c1 = f2_one();
        w3.c1.c1 = f2_one();
        P12 q;
        f12_mul(q.x, xe, w2);
        f12_mul(q.y, ye, w3);
        q.inf = false;
        F12 ml;
        miller_loop(ml, q, p);
        f12_mul(accf, accf, ml);
    }
    F12 res;
    f12_pow_bytes(res, accf, exp, exp_len);
    return f12_eq(res, f12_one()) ? 1 : 0;
}

int zk_selftest() {
    ensure_init();
    // field sanity: (2*3) == 6 in Montgomery round trip
    U256 two = {{2, 0, 0, 0}}, three = {{3, 0, 0, 0}}, six = {{6, 0, 0, 0}};
    U256 a, b, c;
    FQ.to_mont(a, two);
    FQ.to_mont(b, three);
    FQ.mul(c, a, b);
    FQ.from_mont(c, c);
    if (memcmp(&c, &six, 32) != 0) return 1;
    // inversion sanity
    FQ.to_mont(a, three);
    FQ.inv(b, a);
    FQ.mul(c, a, b);
    if (memcmp(&c, &FQ.one, 32) != 0) return 2;
    // G1: 2*G + G == 3*G
    uint8_t gen[64];
    memset(gen, 0, 64);
    gen[0] = 1;
    gen[32] = 2;
    G1J g, g2, g3a, g3b;
    load_g1(g, gen, 0);
    g1_dbl(g2, g);
    g1_add(g3a, g2, g);
    U256 k3 = {{3, 0, 0, 0}};
    g1_mul(g3b, g, k3);
    // compare affine forms
    U256 zi, zi2, zi3, xa, xb, ya, yb;
    FQ.inv(zi, g3a.z);
    FQ.sqr(zi2, zi);
    FQ.mul(zi3, zi2, zi);
    FQ.mul(xa, g3a.x, zi2);
    FQ.mul(ya, g3a.y, zi3);
    FQ.inv(zi, g3b.z);
    FQ.sqr(zi2, zi);
    FQ.mul(zi3, zi2, zi);
    FQ.mul(xb, g3b.x, zi2);
    FQ.mul(yb, g3b.y, zi3);
    if (memcmp(&xa, &xb, 32) || memcmp(&ya, &yb, 32)) return 3;
    return 0;
}

}  // extern "C"
