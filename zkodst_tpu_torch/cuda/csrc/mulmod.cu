// Elementwise field kernels and the prefix product, for BN254's Fr and Fq;
// the elementwise kernels also for the two Pasta fields (IPA backend).
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
// the W run totals, read in place at a stride of S, into the exclusive
// product of the runs before each run; mulmod then multiplies each run by
// it. The suffix product is the same three launches walking the column
// from its end: the loads and stores of chain_cumprod and cumprod_tile
// mirror their indices, so nothing is flipped or copied. The TPU kernel
// carries its accumulator across sequential grid steps; chain_cumprod is
// a segmented scan with a block per run instead, and cumprod_tile a scan
// spread over a thread-block cluster (see their kernels).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "field.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

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
// runs. o[e] = x[l·S] · … · x[e] for e in run l = [l·S, (l+1)·S); with
// `rev`, o[e] = x[e] · … · x[(l+1)·S − 1], and the run's total sits at its
// head. The kernel walks logical element e, which is element e of the
// column, or element W·S − 1 − e with `rev`: only the loads and stores
// mirror their index, the chunks, scans and walks stay the same.
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
// cp.async copies and written back coalesced (a probe kernel; PERF.md §6,
// design measurements) took from 2.3% less to 0.1% more time
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
                     int64_t W, int64_t S, int64_t R, int rev) {
  __shared__ uint32_t wv[kChainWarps][8];  // warp totals
  __shared__ bool wh[kChainWarps];
  __shared__ uint32_t pv[kChainWarps + 1][8];  // exclusive prefix per warp,
                                               // then the next carry
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * R;
  const int64_t e_end = (r0 + R < W ? r0 + R : W) * S;
  const int64_t mirror = W * S - 1;     // logical e <-> element mirror − e
  auto at = [&](int64_t e) { return rev ? mirror - e : e; };
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
      load8(x, at(e0 + j), xv);
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
      load8(x, at(e0 + j), xv);
      if (pos == 0) {
        copy8(acc, xv);
      } else {
        zk::mont_mul<M>(acc, xv, r);
        copy8(acc, r);
      }
      store8(o, at(e0 + j), acc);
      if (++pos == S) pos = 0;
    }
  }
}

// cumprod_tile: the prefix product of m ≤ kTileMax elements read in place
// at a stride: logical element i is x[offset + i·stride], or, with `rev`,
// x[offset + (m − 1 − i)·stride]; output i (inclusive: the product of
// logical elements 0..i; exclusive: 0..i − 1, 1 for i = 0) is written at
// o[i], or o[m − 1 − i] with `rev`. So one launch gives the prefix or the
// suffix products of a short column, or the carries of the chained
// prefix product: the exclusive products of the run totals that
// chain_cumprod leaves at a stride of S in its output, with no gather,
// flip or concatenation around it.
//
// Bound on the H100: the latency of its chain of dependent products. The
// path scans m = 2048 totals 42 times; the bytes (64 KB) and the 2,047
// products are nothing to the card, but a scan puts ~log2(m) products in
// series and one warp alone takes ~0.43 µs a product (PERF.md §6, design
// measurements).
// The design keeps that chain short and spreads the products over several
// SMs, instead of one block walking runs and scanning its run totals
// Hillis–Steele through shared memory (~24 products in series, ~5,600 on
// one SM):
// - Two elements a thread (kTilePer), at most 32 warps a call, so one
//   warp 0 can scan every warp total of the call on its lanes. The
//   warps form a thread-block cluster of C blocks (cudaLaunchKernelEx
//   with a cluster dimension): at m = 2048, 1024 threads, C blocks of
//   1024 / C threads each on an SM of its own.
// - Each thread multiplies its two elements (1 product in series); each
//   warp scans its 32 lane products with shuffles of the 8 words (5);
//   warp 0 of each block reads the call's ≤ 32 warp totals from the
//   cluster's blocks through distributed shared memory, scans them (≤ 5)
//   and hands each warp of its block the product of the warps before it;
//   each thread then multiplies that by its two local prefixes, which it
//   formed before the barrier (1, two independent products). 12 products
//   in series, and 1/C of the call's products on each SM.
// Measured on an H100 (PERF.md §6, design measurements): 13.4–13.8 µs at
// m = 2048 on 8 or 16 blocks, 15.0 on 4, 20.0 on 2, 30.4 on 1, against
// 12 × 0.436 µs = 5.2 µs for the chain. A warp issues 14 products on the
// path (its local prefix before the cluster barrier, its two outputs one
// after the other), and the launch, the first loads and the barriers take
// the rest.
// - Threads past m hold the field's 1, which multiplies exactly, so no
//   flag rides along the scan.
// Every product is canonical and the product commutes, so the result does
// not depend on this association: the plain twin scans its own way.
constexpr int kTilePer = 2;                        // elements a thread
constexpr int kTileMaxWarps = 32;                  // warps of a call
constexpr int64_t kTileMax = kTilePer * 32 * kTileMaxWarps;

template <class M>
__device__ __forceinline__ void tile_load(const uint4* __restrict__ x,
                                          int64_t i, int64_t m,
                                          int64_t stride, int64_t offset,
                                          int rev, uint32_t r[8]) {
  if (i < m)
    load8(x, offset + (rev ? m - 1 - i : i) * stride, r);
  else
    M::one(r);
}

template <class M>
__global__ void __launch_bounds__(32 * kTileMaxWarps)
cumprod_tile_kernel(const uint4* __restrict__ x, uint4* __restrict__ o,
                    int64_t m, int64_t stride, int64_t offset, int rev,
                    int excl) {
  __shared__ uint32_t tv[kTileMaxWarps][8];  // this block's warp totals
  __shared__ uint32_t xv[kTileMaxWarps][8];  // product of the warps before
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bw = blockDim.x >> 5;              // warps a block
  const int64_t i0 =
      ((int64_t)rank * blockDim.x + threadIdx.x) * kTilePer;
  uint32_t v[8], u[8], r[8];
  // 1. the product of this thread's two elements
  tile_load<M>(x, i0, m, stride, offset, rev, v);
  tile_load<M>(x, i0 + 1, m, stride, offset, rev, u);
  zk::mont_mul<M>(v, u, r);
  copy8(v, r);
  // 2. inclusive scan of the warp's 32 products
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) u[i] = __shfl_up_sync(0xFFFFFFFFu, v[i], d);
    if (lane >= d) {
      zk::mont_mul<M>(u, v, r);
      copy8(v, r);
    }
  }
  if (lane == 31) copy8(tv[warp], v);
  // the products of the warp's elements before each of this thread's two
  // (a before the first, b before the second for an exclusive scan; a
  // through the first, b through the second for an inclusive one)
  uint32_t a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = __shfl_up_sync(0xFFFFFFFFu, v[i], 1);
  if (lane == 0) M::one(a);
  tile_load<M>(x, i0, m, stride, offset, rev, u);
  zk::mont_mul<M>(a, u, r);                    // through the first
  if (excl) {
    copy8(b, r);
  } else {
    copy8(a, r);
    copy8(b, v);
  }
  cluster.sync();
  // 3. warp 0 of each block: every warp total of the call, scanned; lane k
  //    of the block's warps gets the product of the call's warps before it
  if (warp == 0) {
    const int nw = C * bw;
    uint32_t w[8];
    if (lane < nw) {
      const uint32_t* t = cluster.map_shared_rank(&tv[0][0], lane / bw);
      copy8(w, t + 8 * (lane % bw));
    } else {
      M::one(w);
    }
#pragma unroll 1
    for (int d = 1; d < nw; d <<= 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        u[i] = __shfl_up_sync(0xFFFFFFFFu, w[i], d);
      if (lane >= d) {
        zk::mont_mul<M>(u, w, r);
        copy8(w, r);
      }
    }
    const int g = rank * bw + lane;            // the call's warp g
#pragma unroll
    for (int i = 0; i < 8; ++i)
      u[i] = __shfl_sync(0xFFFFFFFFu, w[i], g > 0 ? (g - 1) & 31 : 0);
    if (g == 0) M::one(u);
    if (lane < bw) copy8(xv[lane], u);
  }
  // done with the other blocks' shared memory: they may leave after the
  // wait at the end
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __syncthreads();
  // 4. the outputs: the warps before times each local prefix
  copy8(u, xv[warp]);
  if (i0 < m) {
    zk::mont_mul<M>(u, a, r);
    store8(o, rev ? m - 1 - i0 : i0, r);
  }
  if (i0 + 1 < m) {
    zk::mont_mul<M>(u, b, r);
    store8(o, rev ? m - 2 - i0 : i0 + 1, r);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
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

template <class M, Op kOp>
int launch_field(const void* a, const void* b, void* o, long long n,
                 long long a_period, long long a_div, long long b_period,
                 long long b_div, cudaStream_t s) {
  if (n <= 0x7FFFFFFFLL)
    binop<M, kOp, uint32_t>(a, b, o, n, a_period, a_div, b_period, b_div, s);
  else
    binop<M, kOp, int64_t>(a, b, o, n, a_period, a_div, b_period, b_div, s);
  return (int)cudaGetLastError();
}

template <Op kOp>
int launch_binop(const void* a, const void* b, void* o, long long n,
                 long long a_period, long long a_div, long long b_period,
                 long long b_div, int field, void* stream) {
  if (n <= 0) return 0;
  if (a_period <= 0 || b_period <= 0 || a_div <= 0 || b_div <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return launch_field<zk::Fr, kOp>(a, b, o, n, a_period, a_div,
                                             b_period, b_div, s);
    case 1: return launch_field<zk::Fq, kOp>(a, b, o, n, a_period, a_div,
                                             b_period, b_div, s);
    case 2: return launch_field<zk::PallasFp, kOp>(a, b, o, n, a_period,
                                                   a_div, b_period, b_div, s);
    case 3: return launch_field<zk::PallasFr, kOp>(a, b, o, n, a_period,
                                                   a_div, b_period, b_div, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// field: 0 = Fr, 1 = Fq, 2 = Pasta PallasFp, 3 = Pasta PallasFr (the
// prefix product takes 0 and 1 alone). n output elements; an operand
// holds `period`
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

// x, o: W·S elements; run l is elements [l·S, (l+1)·S), walked from its
// end with `reverse`.
extern "C" int zk_chain_cumprod(const void* x, void* o, long long W,
                                long long S, int reverse, int field,
                                void* stream) {
  if (W <= 0 || S <= 0) return 0;
  if (field != 0 && field != 1) return (int)cudaErrorInvalidValue;
  const long long R = S >= kChunk ? 1 : (kChunk / S < W ? kChunk / S : W);
  const unsigned blocks = (unsigned)((W + R - 1) / R);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    chain_cumprod_kernel<zk::Fr><<<blocks, kChainThreads, 0, s>>>(
        (const uint4*)x, (uint4*)o, W, S, R, reverse);
  else
    chain_cumprod_kernel<zk::Fq><<<blocks, kChainThreads, 0, s>>>(
        (const uint4*)x, (uint4*)o, W, S, R, reverse);
  return (int)cudaGetLastError();
}

// m elements of x read at offset + i·stride, their prefix products (or,
// with `reverse`, suffix products; with `exclusive`, each without its own
// element) written to the m contiguous elements of o. One cluster of
// `cluster` blocks of `threads` threads (a multiple of 32), two elements a
// thread: cluster·threads·2 ≥ m and at most 32 warps in all. Above 8
// blocks the cluster size is non-portable and is allowed first. A cluster
// launch the card refuses is returned as its error, not run another way.
extern "C" int zk_cumprod_tile(const void* x, void* o, long long m,
                               long long stride, long long offset,
                               int reverse, int exclusive, int threads,
                               int cluster, int field, void* stream) {
  if (m <= 0) return 0;
  if (field != 0 && field != 1) return (int)cudaErrorInvalidValue;
  if (m > kTileMax || stride < 1 || offset < 0 || threads < 32 ||
      threads % 32 || cluster < 1 ||
      cluster * (threads / 32) > kTileMaxWarps ||
      (long long)cluster * threads * kTilePer < m)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const uint4*, uint4*, int64_t, int64_t, int64_t, int,
                 int) = field == 0 ? cumprod_tile_kernel<zk::Fr>
                                   : cumprod_tile_kernel<zk::Fq>;
  cudaError_t err = cudaSuccess;
  if (cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const uint4*)x, (uint4*)o,
                           (int64_t)m, (int64_t)stride, (int64_t)offset,
                           reverse, exclusive);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
