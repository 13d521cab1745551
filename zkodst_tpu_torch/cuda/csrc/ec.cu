// BN254 G1 kernels of the MSM and the SRS ladder, on packed points.
//
// A packed point tensor is (batch, 24, n) 32-bit words (see field.cuh), a
// flag tensor (batch, n) bytes. Every kernel is built on zk::ec_add, the
// complete RCB16 addition (12 Montgomery products, ~3,200 32-bit
// multiply results), inlined so that its points stay in registers; an add
// moves 288 bytes at most, so on the H100 these kernels are bound by the
// integer multiply rate wherever they do one add per element, and by
// latency where a thread walks a chain sequentially.
//
//   zk_ec_add          <- zkodst_tpu/pallas/ec.py:_ec_add_kernel
//   zk_seg_step        <- zkodst_tpu/pallas/ec.py:_seg_step_kernel
//   zk_seg_scan_tiles  <- zkodst_tpu/pallas/ec.py:_seg_scan_tile_kernel
//   zk_chain_scan      <- zkodst_tpu/pallas/ec.py:_chain_scan_kernel
//   zk_scale_reduce    <- zkodst_tpu/pallas/ec.py:_scale_reduce_kernel
//
// The TPU kernels carry state across sequential grid steps; here a thread
// owns a chain and loops over it instead, and the tile scan runs inside one
// block through shared memory. Each kernel's plain PyTorch twin in
// kernels/ec.py repeats the same association of additions and doublings,
// so the two agree limb for limb, not only as group elements.
//
// chain_scan (kernel 11) is the MSM's largest kernel: 80 rows × 2048
// chains of 64 elements at 2^17 points, one thread per chain. It is bound
// by the integer multiply rate, so the add stays in registers (no
// local-memory frame to compete with L1), its products are the paired
// wide multiply-adds of field.cuh, and each thread requests its next
// element before the add of the current one: the load's latency hides
// under the add instead of sitting on the chain. Its registers leave two
// blocks of 128 threads on an SM; more warps, through a register cap or
// 256 threads a block, did not measure faster.
//
// scale_reduce (kernel 12) is latency-bound: 4 to 14 batch rows, each a
// Horner walk of c doublings per window, c·(nlive − 1) doublings and
// nlive − 1 adds in series (252 + 63 at c = 4, nlive = 64). No regrouping
// of the windows shortens that chain, so the kernel shortens each step:
// the complete doubling (8 products in three layers) in place of an add of
// the point to itself (12 in two), and a warp per row that computes each
// layer's independent products on separate lanes, so that a doubling
// costs three products' latency and an add two.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kScanThreads = 256;

// o = p + q, elementwise over batch·n.
__global__ void __launch_bounds__(kThreads)
ec_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
              uint32_t* __restrict__ o, int64_t batch, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * n) return;
  int64_t b = i / n, e = i % n;
  zk::Pt x, y, s;
  zk::load_pt(p + b * 24 * n, n, e, x);
  zk::load_pt(q + b * 24 * n, n, e, y);
  zk::ec_add(x, y, s);
  zk::store_pt(o + b * 24 * n, n, e, s);
}

// o = keep ? p : p + q. Applies a carry q to the elements whose segment
// began before them (keep = 0).
__global__ void __launch_bounds__(kThreads)
seg_step_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                const uint8_t* __restrict__ keep, uint32_t* __restrict__ o,
                int64_t batch, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * n) return;
  int64_t b = i / n, e = i % n;
  zk::Pt x;
  zk::load_pt(p + b * 24 * n, n, e, x);
  if (!keep[i]) {
    zk::Pt y, s;
    zk::load_pt(q + b * 24 * n, n, e, y);
    zk::ec_add(x, y, s);
    x = s;
  }
  zk::store_pt(o + b * 24 * n, n, e, x);
}

// Per-chain segmented inclusive scan. Chain l of a batch row owns elements
// l, W+l, 2W+l, ...; one thread walks one chain: out = f ? p : acc + p.
// A chain's head starts a segment (cross-chain carries are the caller's).
// Element k + 1 (24 words and its flag) is loaded before the add of
// element k.
__global__ void __launch_bounds__(kThreads)
chain_scan_kernel(const uint32_t* __restrict__ p, const uint8_t* __restrict__ f,
                  uint32_t* __restrict__ o, int64_t batch, int64_t n,
                  int64_t W) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * W) return;
  int64_t b = i / W, l = i % W, S = n / W;
  const uint32_t* pb = p + b * 24 * n;
  const uint8_t* fb = f + b * n;
  uint32_t* ob = o + b * 24 * n;
  zk::Pt acc, next;
  uint8_t next_f = 0;
  zk::load_pt(pb, n, l, acc);
  zk::store_pt(ob, n, l, acc);
  if (S > 1) {
    zk::load_pt(pb, n, W + l, next);
    next_f = fb[W + l];
  }
  for (int64_t k = 1; k < S; ++k) {
    const int64_t e = k * W + l;
    const zk::Pt x = next;
    const uint8_t fx = next_f;
    if (k + 1 < S) {
      zk::load_pt(pb, n, e + W, next);
      next_f = fb[e + W];
    }
    if (fx)
      acc = x;
    else
      zk::ec_add(acc, x, acc);
    zk::store_pt(ob, n, e, acc);
  }
}

// Segmented inclusive scan of a row as one tile: block = one batch row of n
// elements, thread t = a run of n/blockDim consecutive elements. Each thread
// scans its run sequentially, the runs' (sum, has-start) aggregates are
// scanned Hillis–Steele in shared memory, and each run's elements before its
// first segment start then take the exclusive carry of the runs before it.
__global__ void __launch_bounds__(kScanThreads)
seg_scan_tiles_kernel(const uint32_t* __restrict__ p,
                      const uint8_t* __restrict__ f, uint32_t* __restrict__ o,
                      int64_t n) {
  __shared__ uint32_t sv[24 * kScanThreads];
  __shared__ uint8_t sf[kScanThreads];
  const int nthr = blockDim.x, t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const uint32_t* pb = p + b * 24 * n;
  const uint8_t* fb = f + b * n;
  uint32_t* ob = o + b * 24 * n;
  const int64_t run = n / nthr, e0 = t * run;

  zk::Pt acc, x, s;
  uint8_t has = 0;
  for (int64_t k = 0; k < run; ++k) {
    int64_t e = e0 + k;
    zk::load_pt(pb, n, e, x);
    if (k == 0 || fb[e]) {
      acc = x;
    } else {
      zk::ec_add(acc, x, s);
      acc = s;
    }
    has |= fb[e];
    zk::store_pt(ob, n, e, acc);
  }
  zk::store_pt(sv, nthr, t, acc);
  sf[t] = has;
  __syncthreads();
  for (int d = 1; d < nthr; d <<= 1) {
    uint8_t of = 0;
    if (t >= d) {
      zk::load_pt(sv, nthr, t - d, x);
      of = sf[t - d];
    }
    __syncthreads();
    if (t >= d) {
      if (!has) {
        zk::ec_add(x, acc, s);
        acc = s;
      }
      has |= of;
      zk::store_pt(sv, nthr, t, acc);
      sf[t] = has;
    }
    __syncthreads();
  }
  if (t > 0) {
    zk::Pt carry;
    zk::load_pt(sv, nthr, t - 1, carry);
    for (int64_t k = 0; k < run; ++k) {
      int64_t e = e0 + k;
      if (fb[e]) break;
      zk::load_pt(ob, n, e, x);
      zk::ec_add(carry, x, s);
      zk::store_pt(ob, n, e, s);
    }
  }
}

// One layer of independent Fq products across the lanes of a warp: lane j
// (of each group of 8) computes product j (lanes past the layer's width
// repeat product 0), and every lane reads all of the layer's products back
// with shuffles, so a layer costs the latency of one product.
struct WarpLayer {
  int j;

  template <int N>
  __device__ __forceinline__ void operator()(
      const uint32_t* const (&a)[N], const uint32_t* const (&b)[N],
      uint32_t* const (&r)[N]) const {
    uint32_t x[8], y[8], t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = a[0][i];
      y[i] = b[0][i];
    }
#pragma unroll
    for (int k = 1; k < N; ++k) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] = j == k ? a[k][i] : x[i];
        y[i] = j == k ? b[k][i] : y[i];
      }
    }
    zk::mont_mul<zk::Fq>(x, y, t);
#pragma unroll
    for (int k = 0; k < N; ++k) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        r[k][i] = __shfl_sync(0xFFFFFFFFu, t[i], k, 8);
    }
  }
};

constexpr int kReduceRows = kThreads / 32;     // batch rows per block

// Σ_w 2^(c·w)·P_w over the nlive window sums of one batch row, by Horner
// from the top window down: c complete doublings (zk::ec_dbl's sequence),
// then one complete add per window. One warp per batch row, its products
// spread over the lanes; the sums and differences run in every lane.
__global__ void __launch_bounds__(kThreads)
scale_reduce_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ o,
                    int64_t batch, int64_t nlive, int c) {
  int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (b >= batch) return;                // whole warps leave together
  const WarpLayer mul{lane & 7};
  const uint32_t* pb = p + b * 24 * nlive;
  zk::Pt acc, x;
  zk::load_pt(pb, nlive, nlive - 1, acc);
  for (int64_t w = nlive - 2; w >= 0; --w) {
    for (int j = 0; j < c; ++j) zk::ec_dbl_by(mul, acc, acc);
    zk::load_pt(pb, nlive, w, x);
    zk::ec_add_by(mul, acc, x, acc);
  }
  if (lane == 0) zk::store_pt(o + b * 24, 1, 0, acc);
}

unsigned grid(int64_t work, int threads) {
  return (unsigned)((work + threads - 1) / threads);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
extern "C" int zk_ec_add(const void* p, const void* q, void* o,
                         long long batch, long long n, void* stream) {
  if (batch * n == 0) return 0;
  ec_add_kernel<<<grid(batch * n, kThreads), kThreads, 0,
                  (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)o, batch, n);
  return (int)cudaGetLastError();
}

extern "C" int zk_seg_step(const void* p, const void* q, const void* keep,
                           void* o, long long batch, long long n,
                           void* stream) {
  if (batch * n == 0) return 0;
  seg_step_kernel<<<grid(batch * n, kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, (const uint8_t*)keep,
      (uint32_t*)o, batch, n);
  return (int)cudaGetLastError();
}

extern "C" int zk_chain_scan(const void* p, const void* f, void* o,
                             long long batch, long long n, long long W,
                             void* stream) {
  if (batch * n == 0) return 0;
  chain_scan_kernel<<<grid(batch * W, kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint8_t*)f, (uint32_t*)o, batch, n, W);
  return (int)cudaGetLastError();
}

// threads = the run count per row, chosen by the caller (n % threads == 0,
// threads <= 256).
extern "C" int zk_seg_scan_tiles(const void* p, const void* f, void* o,
                                 long long batch, long long n, int threads,
                                 void* stream) {
  if (batch * n == 0) return 0;
  seg_scan_tiles_kernel<<<(unsigned)batch, threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint8_t*)f, (uint32_t*)o, n);
  return (int)cudaGetLastError();
}

extern "C" int zk_scale_reduce(const void* p, void* o, long long batch,
                               long long nlive, int c, void* stream) {
  if (batch == 0) return 0;
  scale_reduce_kernel<<<grid(batch, kReduceRows), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)p, (uint32_t*)o, batch, nlive, c);
  return (int)cudaGetLastError();
}
