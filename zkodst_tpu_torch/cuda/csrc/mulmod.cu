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
// thread per element. Each operand repeats with a period of m elements:
// output element i reads its element i mod m. m = n is one element per
// thread, m = 1 one constant for all (R², raw 1, β, γ, θ^k, the
// quotient's 1 − l_last and 0 − x), and 1 < m < n a column broadcast over
// a leading batch dimension (SHPLONK's ω^j against every claim), so a
// broadcast operand is never materialised. All three are bound on the
// H100 by device memory (64 bytes moved per element with one constant
// operand, 96 without, against ~260 32-bit multiply results for a product
// and none for a sum or a difference), so every intermediate stays in
// registers and each input and output word is touched once.
//
// The inclusive prefix product of n elements is three launches (the caller,
// Field.cumprod_incl, chains them): chain_cumprod gives each of W threads a
// run of S = n/W contiguous elements to walk, writing the run's local
// products; cumprod_tile scans the W run totals in one block; mulmod then
// multiplies each run by the exclusive product of the runs before it. The
// TPU kernel carries its accumulator across sequential grid steps; here a
// thread walks its run instead. A run walk is latency-bound (S dependent
// products), the tile scan is one block and small.
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

__device__ __forceinline__ int64_t wrap(int64_t i, int64_t m) {
  return m == 1 ? 0 : (i < m ? i : i % m);
}

template <class M, Op kOp>
__global__ void __launch_bounds__(kThreads)
binop_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
             uint4* __restrict__ o, int64_t n, int64_t a_period,
             int64_t b_period) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], r[8];
  load8(a, wrap(i, a_period), x);
  load8(b, wrap(i, b_period), y);
  if (kOp == kAdd)
    zk::add_mod<M>(x, y, r);
  else if (kOp == kSub)
    zk::sub_mod<M>(x, y, r);
  else
    zk::mont_mul<M>(x, y, r);
  store8(o, i, r);
}

// Thread l walks elements [l·S, (l+1)·S): o[e] = x[l·S] · … · x[e].
template <class M>
__global__ void __launch_bounds__(kThreads)
chain_cumprod_kernel(const uint4* __restrict__ x, uint4* __restrict__ o,
                     int64_t W, int64_t S) {
  int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= W) return;
  uint32_t acc[8], v[8], r[8];
  load8(x, l * S, acc);
  store8(o, l * S, acc);
  for (int64_t k = 1; k < S; ++k) {
    load8(x, l * S + k, v);
    zk::mont_mul<M>(acc, v, r);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = r[i];
    store8(o, l * S + k, acc);
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

template <Op kOp>
int launch_binop(const void* a, const void* b, void* o, long long n,
                 long long a_period, long long b_period, int field,
                 void* stream) {
  if (n <= 0) return 0;
  if (a_period <= 0 || b_period <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    binop_kernel<zk::Fr, kOp><<<grid(n, kThreads), kThreads, 0, s>>>(
        (const uint4*)a, (const uint4*)b, (uint4*)o, n, a_period, b_period);
  else
    binop_kernel<zk::Fq, kOp><<<grid(n, kThreads), kThreads, 0, s>>>(
        (const uint4*)a, (const uint4*)b, (uint4*)o, n, a_period, b_period);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// field: 0 = Fr, 1 = Fq. n output elements; a_period / b_period: the
// operand holds that many elements and element i of the output reads its
// element i mod period (n: one per output element, 1: one for all).
extern "C" int zk_mulmod(const void* a, const void* b, void* o, long long n,
                         long long a_period, long long b_period, int field,
                         void* stream) {
  return launch_binop<kMul>(a, b, o, n, a_period, b_period, field, stream);
}

extern "C" int zk_addmod(const void* a, const void* b, void* o, long long n,
                         long long a_period, long long b_period, int field,
                         void* stream) {
  return launch_binop<kAdd>(a, b, o, n, a_period, b_period, field, stream);
}

extern "C" int zk_submod(const void* a, const void* b, void* o, long long n,
                         long long a_period, long long b_period, int field,
                         void* stream) {
  return launch_binop<kSub>(a, b, o, n, a_period, b_period, field, stream);
}

// x, o: W·S elements; run l is elements [l·S, (l+1)·S).
extern "C" int zk_chain_cumprod(const void* x, void* o, long long W,
                                long long S, int field, void* stream) {
  if (W <= 0 || S <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    chain_cumprod_kernel<zk::Fr><<<grid(W, kThreads), kThreads, 0, s>>>(
        (const uint4*)x, (uint4*)o, W, S);
  else
    chain_cumprod_kernel<zk::Fq><<<grid(W, kThreads), kThreads, 0, s>>>(
        (const uint4*)x, (uint4*)o, W, S);
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
