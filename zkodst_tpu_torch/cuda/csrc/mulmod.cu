// Elementwise field kernels and the prefix product, for Fr and Fq.
//
//   zk_mulmod        <- zkodst_tpu/pallas/mulmod.py:_mulmod_kernel
//   zk_addmod        <- zkodst_tpu/pallas/mulmod.py:_addmod_kernel
//   zk_submod        <- zkodst_tpu/pallas/mulmod.py:_submod_kernel
//   zk_chain_cumprod <- zkodst_tpu/pallas/mulmod.py:_mul_chain_kernel
//   zk_cumprod_tile  <- zkodst_tpu/pallas/mulmod.py:_mul_scan_tile_kernel
//
// An element is 8 contiguous 32-bit limbs (32 bytes, one L2 sector), read
// and written as two 16-byte vectors. mulmod, addmod and submod run one
// thread per element. Each operand is read in place through a divisor and
// a period: output element i reads element (i / div) mod period of it.
// div = 1, period = n is one element per thread; period = 1 one constant
// for all (R², raw 1, β, γ, θ^k, the quotient's 1 − l_last and 0 − x);
// div = 1, 1 < period < n a column broadcast over a leading batch
// dimension (SHPLONK's ω^j against every claim); div > 1 a value per row
// of a leading dimension (the carry of each run of the prefix product,
// SHPLONK's coefficient per claim). So a broadcast operand is never
// materialised. All three are bound on the H100 by device memory (64
// bytes moved per element with one broadcast operand, 96 without, against
// ~260 32-bit multiply results for a product and none for a sum or a
// difference), so every intermediate stays in registers, each input and
// output word is touched once, and the index arithmetic is 32-bit where
// the output allows it.
//
// The inclusive prefix product of n elements is three launches (the
// caller, Field.cumprod_incl, chains them): chain_cumprod gives the local
// products of W runs of S = n/W contiguous elements; cumprod_tile scans
// the W run totals in one block; mulmod then multiplies each run by the
// exclusive product of the runs before it. The TPU kernel carries its
// accumulator across sequential grid steps; chain_cumprod is a segmented
// scan with a block per run instead (see its kernel).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileThreads = 256;

__device__ __forceinline__ void load8(const uint4* p, int64_t i, uint32_t x[8]) {
  uint4 a0 = p[2 * i], a1 = p[2 * i + 1];
  x[0] = a0.x; x[1] = a0.y; x[2] = a0.z; x[3] = a0.w;
  x[4] = a1.x; x[5] = a1.y; x[6] = a1.z; x[7] = a1.w;
}

__device__ __forceinline__ void store8(uint4* p, int64_t i, const uint32_t r[8]) {
  p[2 * i] = make_uint4(r[0], r[1], r[2], r[3]);
  p[2 * i + 1] = make_uint4(r[4], r[5], r[6], r[7]);
}

enum Op { kMul, kAdd, kSub };

// Element (i / div) mod period of an operand. The tests of period and div
// are uniform over a launch: an operand with one element per thread costs
// no division.
template <class I>
__device__ __forceinline__ I operand_index(I i, I period, I div) {
  if (period == 1) return 0;
  const I q = div == 1 ? i : i / div;
  return q < period ? q : q % period;
}

// I: the index type, 32-bit where n fits (a 64-bit division is a long
// software sequence on the card).
template <class M, Op kOp, class I>
__global__ void __launch_bounds__(kThreads)
binop_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
             uint4* __restrict__ o, I n, I a_period, I a_div, I b_period,
             I b_div) {
  const I i = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], r[8];
  load8(a, operand_index(i, a_period, a_div), x);
  load8(b, operand_index(i, b_period, b_div), y);
  if (kOp == kAdd)
    zk::add_mod<M>(x, y, r);
  else if (kOp == kSub)
    zk::sub_mod<M>(x, y, r);
  else
    zk::mont_mul<M>(x, y, r);
  store8(o, i, r);
}

// chain_cumprod: a segmented inclusive product scan whose segments are the
// runs. o[e] = x[l·S] · … · x[e] for e in run l = [l·S, (l+1)·S).
//
// Bound on the H100: the multiply rate. The work is one product per
// element that does not start a run (n − W), ~264 32-bit multiply results
// each, against 64 bytes moved per element; a card-wide scan at ~2.6
// products an element needs ~0.4 ms for SHPLONK's 9.6 M elements, the
// bytes 0.18 ms. So the design spreads the products over every SM and
// keeps the scan's extra products few (a thread per run would leave 8
// blocks on 8 of the 132 SMs at W = 2048, each thread a chain of S
// dependent products: 4,672 in SHPLONK's inversion):
// - A block of kChainThreads threads owns R = max(1, kChunk / S) whole
//   runs (R·S ≤ kChunk elements, or one run of many chunks), so blocks
//   share no carry and there are W / R of them: 2048 blocks at S ≥ 1024,
//   128 at the grand products' S = 64. At 56 registers a thread an SM
//   holds 9 blocks (36 warps): 1,188 blocks at a time on the card, so
//   SHPLONK's 2048 take two waves.
// - The block walks its elements in chunks of kChunk = 128 threads × 8.
//   Thread t takes 8 contiguous elements: their product, restarted at a
//   run head (e mod S = 0), and whether one was met (7 products).
// - Each warp scans its 32 (product, has-head) pairs with shuffles of the
//   8 words (5 levels); warp 0 scans the 4 warp totals behind the carry
//   of the chunks before (3 levels), through shared memory.
// - Each thread then walks its 8 elements again from its exclusive prefix
//   (one product to form it, then one an element), writing each result.
//   The second walk reads its inputs again from L1 or L2, instead of
//   holding 64 more registers.
// ~21 products per thread and chunk: 2.6 an element. Field values are
// canonical and the product commutes, so the result does not depend on
// this association and the plain twin may walk each run in order.
// What still bounds it is those products, not its memory access: a thread
// reads and writes 8 contiguous elements (lanes 256 bytes apart), yet the
// same scan with every chunk staged through shared memory by coalesced
// cp.async copies and written back coalesced (cuda/csrc/probe_mulmod.cu,
// run by tools/scan_probe.py) took from 2.3% less to 0.1% more time
// with one chunk buffer, and up to 13% more with two (3 blocks an SM
// instead of 9), at the path's shapes.
constexpr int kChainThreads = 128;
constexpr int kChainPer = 8;
constexpr int kChainWarps = kChainThreads / 32;
constexpr int64_t kChunk = kChainThreads * kChainPer;

__device__ __forceinline__ void copy8(uint32_t d[8], const uint32_t s[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = s[i];
}

// (b, bh) <- (a, ah) ∘ (b, bh): a earlier, b later in the scan.
template <class M>
__device__ __forceinline__ void seg_mul(const uint32_t a[8], bool ah,
                                        uint32_t b[8], bool& bh) {
  if (!bh) {
    uint32_t r[8];
    zk::mont_mul<M>(a, b, r);
    copy8(b, r);
  }
  bh = bh || ah;
}

template <class M>
__global__ void __launch_bounds__(kChainThreads)
chain_cumprod_kernel(const uint4* __restrict__ x, uint4* __restrict__ o,
                     int64_t W, int64_t S, int64_t R) {
  __shared__ uint32_t wv[kChainWarps][8];  // warp totals
  __shared__ bool wh[kChainWarps];
  __shared__ uint32_t pv[kChainWarps + 1][8];  // exclusive prefix per warp,
                                               // then the next carry
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * R;
  const int64_t e_end = (r0 + R < W ? r0 + R : W) * S;
  uint32_t carry[8];
  M::one(carry);                  // the block starts at a run head
  for (int64_t base = r0 * S; base < e_end; base += kChunk) {
    const int64_t e0 = base + (int64_t)t * kChainPer;
    const int cnt = e0 >= e_end ? 0
        : (e_end - e0 < kChainPer ? (int)(e_end - e0) : kChainPer);
    const int64_t pos0 = cnt ? e0 % S : 0;     // e0's place in its run
    // 1. this thread's elements: product since the last run head
    uint32_t v[8], xv[8], r[8];
    M::one(v);
    bool h = false;
    int64_t pos = pos0;
    for (int j = 0; j < cnt; ++j) {
      load8(x, e0 + j, xv);
      if (j == 0 || pos == 0) {
        copy8(v, xv);
      } else {
        zk::mont_mul<M>(v, xv, r);
        copy8(v, r);
      }
      h = h || pos == 0;
      if (++pos == S) pos = 0;
    }
    // 2. inclusive scan of the warp's 32 pairs
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      uint32_t u[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) u[i] = __shfl_up_sync(0xFFFFFFFFu, v[i], d);
      const bool uh = __shfl_up_sync(0xFFFFFFFFu, (int)h, d);
      if (lane >= d) seg_mul<M>(u, uh, v, h);
    }
    uint32_t lv[8];               // inclusive pair of the lane before
#pragma unroll
    for (int i = 0; i < 8; ++i) lv[i] = __shfl_up_sync(0xFFFFFFFFu, v[i], 1);
    bool lh = __shfl_up_sync(0xFFFFFFFFu, (int)h, 1);
    if (lane == 31) {
      copy8(wv[warp], v);
      wh[warp] = h;
    }
    __syncthreads();
    // 3. warp 0: the carry, then the warp totals, scanned (lane k ends
    //    with the prefix of warp k; lane kChainWarps with the next carry)
    if (warp == 0) {
      uint32_t c[8];
      bool ch = false;
      if (lane == 0) {
        copy8(c, carry);
      } else if (lane <= kChainWarps) {
        copy8(c, wv[lane - 1]);
        ch = wh[lane - 1];
      } else {
        M::one(c);
      }
#pragma unroll
      for (int d = 1; d <= kChainWarps; d <<= 1) {
        uint32_t u[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          u[i] = __shfl_up_sync(0xFFFFFFFFu, c[i], d);
        const bool uh = __shfl_up_sync(0xFFFFFFFFu, (int)ch, d);
        if (lane >= d && lane <= kChainWarps) seg_mul<M>(u, uh, c, ch);
      }
      if (lane <= kChainWarps) copy8(pv[lane], c);
    }
    __syncthreads();
    // 4. the exclusive prefix of this thread, then its elements again
    uint32_t acc[8];
    copy8(acc, pv[warp]);
    if (lane > 0) {
      seg_mul<M>(acc, false, lv, lh);
      copy8(acc, lv);
    }
    copy8(carry, pv[kChainWarps]);
    pos = pos0;
    for (int j = 0; j < cnt; ++j) {
      load8(x, e0 + j, xv);
      if (pos == 0) {
        copy8(acc, xv);
      } else {
        zk::mont_mul<M>(acc, xv, r);
        copy8(acc, r);
      }
      store8(o, e0 + j, acc);
      if (++pos == S) pos = 0;
    }
  }
}

// Inclusive prefix product of m elements in one block: each thread walks a
// run of ceil(m / threads) elements, the run totals are scanned
// Hillis–Steele in shared memory, and each run is then multiplied by the
// product of the runs before it.
template <class M>
__global__ void __launch_bounds__(kTileThreads)
cumprod_tile_kernel(const uint4* __restrict__ x, uint4* __restrict__ o,
                    int64_t m) {
  __shared__ uint32_t sv[8 * kTileThreads];
  const int t = threadIdx.x, nthr = blockDim.x;
  const int64_t run = (m + nthr - 1) / nthr;
  const int64_t e0 = t * run;
  const int64_t e1 = e0 + run < m ? e0 + run : m;
  uint32_t acc[8], v[8], r[8];
  M::one(acc);
  for (int64_t e = e0; e < e1; ++e) {
    load8(x, e, v);
    zk::mont_mul<M>(acc, v, r);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = r[i];
    store8(o, e, acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) sv[8 * t + i] = acc[i];
  __syncthreads();
  for (int d = 1; d < nthr; d <<= 1) {
    if (t >= d) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = sv[8 * (t - d) + i];
    }
    __syncthreads();
    if (t >= d) {
      zk::mont_mul<M>(v, acc, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i] = r[i];
        sv[8 * t + i] = r[i];
      }
    }
    __syncthreads();
  }
  if (t > 0) {
    uint32_t carry[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) carry[i] = sv[8 * (t - 1) + i];
    for (int64_t e = e0; e < e1; ++e) {
      load8(o, e, v);
      zk::mont_mul<M>(carry, v, r);
      store8(o, e, r);
    }
  }
}

unsigned grid(int64_t work, int threads) {
  return (unsigned)((work + threads - 1) / threads);
}

template <class M, Op kOp, class I>
void binop(const void* a, const void* b, void* o, long long n,
           long long a_period, long long a_div, long long b_period,
           long long b_div, cudaStream_t s) {
  binop_kernel<M, kOp, I><<<grid(n, kThreads), kThreads, 0, s>>>(
      (const uint4*)a, (const uint4*)b, (uint4*)o, (I)n, (I)a_period,
      (I)a_div, (I)b_period, (I)b_div);
}

template <Op kOp>
int launch_binop(const void* a, const void* b, void* o, long long n,
                 long long a_period, long long a_div, long long b_period,
                 long long b_div, int field, void* stream) {
  if (n <= 0) return 0;
  if (a_period <= 0 || b_period <= 0 || a_div <= 0 || b_div <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool narrow = n <= 0x7FFFFFFFLL;
  if (field == 0 && narrow)
    binop<zk::Fr, kOp, uint32_t>(a, b, o, n, a_period, a_div, b_period,
                                 b_div, s);
  else if (field == 0)
    binop<zk::Fr, kOp, int64_t>(a, b, o, n, a_period, a_div, b_period,
                                b_div, s);
  else if (narrow)
    binop<zk::Fq, kOp, uint32_t>(a, b, o, n, a_period, a_div, b_period,
                                 b_div, s);
  else
    binop<zk::Fq, kOp, int64_t>(a, b, o, n, a_period, a_div, b_period,
                                b_div, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// field: 0 = Fr, 1 = Fq. n output elements; an operand holds `period`
// elements and element i of the output reads its element
// (i / div) mod period (period n, div 1: one per output element;
// period 1: one for all).
#define ZK_BINOP(name, op)                                                   \
  extern "C" int name(const void* a, const void* b, void* o, long long n,   \
                      long long a_period, long long a_div,                  \
                      long long b_period, long long b_div, int field,       \
                      void* stream) {                                       \
    return launch_binop<op>(a, b, o, n, a_period, a_div, b_period, b_div,   \
                            field, stream);                                 \
  }
ZK_BINOP(zk_mulmod, kMul)
ZK_BINOP(zk_addmod, kAdd)
ZK_BINOP(zk_submod, kSub)
#undef ZK_BINOP

// x, o: W·S elements; run l is elements [l·S, (l+1)·S).
extern "C" int zk_chain_cumprod(const void* x, void* o, long long W,
                                long long S, int field, void* stream) {
  if (W <= 0 || S <= 0) return 0;
  const long long R = S >= kChunk ? 1 : (kChunk / S < W ? kChunk / S : W);
  const unsigned blocks = (unsigned)((W + R - 1) / R);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    chain_cumprod_kernel<zk::Fr><<<blocks, kChainThreads, 0, s>>>(
        (const uint4*)x, (uint4*)o, W, S, R);
  else
    chain_cumprod_kernel<zk::Fq><<<blocks, kChainThreads, 0, s>>>(
        (const uint4*)x, (uint4*)o, W, S, R);
  return (int)cudaGetLastError();
}

// x, o: m elements, scanned by one block.
extern "C" int zk_cumprod_tile(const void* x, void* o, long long m,
                               int field, void* stream) {
  if (m <= 0) return 0;
  const int threads = m < kTileThreads ? (int)m : kTileThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    cumprod_tile_kernel<zk::Fr><<<1, threads, 0, s>>>(
        (const uint4*)x, (uint4*)o, m);
  else
    cumprod_tile_kernel<zk::Fq><<<1, threads, 0, s>>>(
        (const uint4*)x, (uint4*)o, m);
  return (int)cudaGetLastError();
}
