// Radix-2 decimation-in-time NTT over Fr or Fq, natural order in and out.
//
//   zk_ntt_tail <- zkodst_tpu/pallas/ntt.py:_tail_kernel
//   zk_ntt_head <- zkodst_tpu/pallas/ntt.py:_head_kernel
//
// Data is (batch, n, 8) 32-bit words: element e of a row is 8 contiguous
// limbs (32 bytes). The twiddle of butterfly j at half-size h is
// w^((n/2h)·j), read from one table pw of w^0 … w^(n/2−1) (Montgomery).
//
// tail: one block per slab of T elements of one row. The block loads its
// slab in bit-reversed order (element g of the slab's range takes input
// element bitrev(g), so the permutation costs no pass of its own) into
// shared memory (T·32 bytes: 64 KB at T = 2048, dynamic above 48 KB) and
// runs every stage h = 1 … T/2 there: a butterfly's partner lies in the
// slab while 2h ≤ T. head: one launch per remaining stage h ≥ T, one
// thread per butterfly, reading u and v from device memory.
//
// What bounds it on the H100: a stage does n/2 Montgomery products
// (~260 32-bit multiply results each) against 64 bytes per element read
// and written. The tail pays one device-memory pass for log2(T) stages and
// is bound by the multiply rate; each head stage is one full pass for one
// stage and is near the memory bound. The TPU's split at h = 128 comes from
// its 128-lane vectors; on Hopper the split is where the slab stops fitting
// in shared memory.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kTailThreads = 512;
constexpr int kHeadThreads = 256;

__device__ __forceinline__ void load8(const uint32_t* p, uint32_t x[8]) {
  const uint4* q = (const uint4*)p;
  uint4 a0 = q[0], a1 = q[1];
  x[0] = a0.x; x[1] = a0.y; x[2] = a0.z; x[3] = a0.w;
  x[4] = a1.x; x[5] = a1.y; x[6] = a1.z; x[7] = a1.w;
}

__device__ __forceinline__ void store8(uint32_t* p, const uint32_t r[8]) {
  uint4* q = (uint4*)p;
  q[0] = make_uint4(r[0], r[1], r[2], r[3]);
  q[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

template <class M>
__global__ void __launch_bounds__(kTailThreads)
ntt_tail_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ o,
                const uint32_t* __restrict__ pw, int64_t n, int logn,
                int64_t T, int logT) {
  extern __shared__ uint4 smem[];
  uint32_t* sm = (uint32_t*)smem;              // T elements × 8 limbs
  const int64_t row = blockIdx.y;
  const int64_t base = (int64_t)blockIdx.x * T;
  const uint32_t* xr = x + row * n * 8;
  uint32_t* orow = o + row * n * 8;
  uint32_t u[8], v[8], w[8];
  for (int64_t i = threadIdx.x; i < T; i += blockDim.x) {
    const int64_t g = base + i;
    const int64_t src =
        logn ? (int64_t)(__brevll((unsigned long long)g) >> (64 - logn)) : 0;
    load8(xr + src * 8, u);
    store8(sm + i * 8, u);
  }
  __syncthreads();
  for (int s = 0; s < logT; ++s) {
    const int64_t h = (int64_t)1 << s;
    const int64_t tstride = n >> (s + 1);      // n / 2h
    for (int64_t k = threadIdx.x; k < T / 2; k += blockDim.x) {
      const int64_t j = k & (h - 1);
      const int64_t iu = ((k >> s) << (s + 1)) + j;
      load8(sm + iu * 8, u);
      load8(sm + (iu + h) * 8, v);
      load8(pw + tstride * j * 8, w);
      zk::butterfly<M>(u, v, w);
      store8(sm + iu * 8, u);
      store8(sm + (iu + h) * 8, v);
    }
    __syncthreads();
  }
  for (int64_t i = threadIdx.x; i < T; i += blockDim.x) {
    load8(sm + i * 8, u);
    store8(orow + (base + i) * 8, u);
  }
}

template <class M>
__global__ void __launch_bounds__(kHeadThreads)
ntt_head_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ o,
                const uint32_t* __restrict__ pw, int64_t batch, int64_t n,
                int64_t h) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t half = n / 2;
  if (i >= batch * half) return;
  const int64_t row = i / half, k = i % half;
  const int64_t j = k % h;
  const int64_t iu = (k / h) * 2 * h + j;
  const uint32_t* xr = x + row * n * 8;
  uint32_t* orow = o + row * n * 8;
  uint32_t u[8], v[8], w[8];
  load8(xr + iu * 8, u);
  load8(xr + (iu + h) * 8, v);
  load8(pw + (n / (2 * h)) * j * 8, w);
  zk::butterfly<M>(u, v, w);
  store8(orow + iu * 8, u);
  store8(orow + (iu + h) * 8, v);
}

int log2i(long long v) {
  int r = 0;
  while ((1LL << r) < v) ++r;
  return r;
}

template <class M>
int launch_tail(const void* x, void* o, const void* pw, long long batch,
                long long n, long long T, cudaStream_t s) {
  const size_t smem = (size_t)T * 32;
  cudaError_t err = cudaFuncSetAttribute(
      ntt_tail_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = T / 2 < kTailThreads ? (int)(T / 2) : kTailThreads;
  dim3 grid((unsigned)(n / T), (unsigned)batch);
  ntt_tail_kernel<M><<<grid, threads > 0 ? threads : 1, smem, s>>>(
      (const uint32_t*)x, (uint32_t*)o, (const uint32_t*)pw, n, log2i(n), T,
      log2i(T));
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// field: 0 = Fr, 1 = Fq (BN254 alone). n and T are powers of two, T ≤ n,
// T ≤ 4096.
// x (batch, n, 8) natural order -> o: bit-reversed, then stages h < T.
extern "C" int zk_ntt_tail(const void* x, void* o, const void* pw,
                           long long batch, long long n, long long T,
                           int field, void* stream) {
  if (batch * n == 0) return 0;
  if (field != 0 && field != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return field == 0 ? launch_tail<zk::Fr>(x, o, pw, batch, n, T, s)
                    : launch_tail<zk::Fq>(x, o, pw, batch, n, T, s);
}

// One stage of half-size h over (batch, n, 8): o = the butterflies of x.
extern "C" int zk_ntt_head(const void* x, void* o, const void* pw,
                           long long batch, long long n, long long h,
                           int field, void* stream) {
  if (batch * n == 0) return 0;
  if (field != 0 && field != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long work = batch * (n / 2);
  const unsigned blocks = (unsigned)((work + kHeadThreads - 1) / kHeadThreads);
  if (field == 0)
    ntt_head_kernel<zk::Fr><<<blocks, kHeadThreads, 0, s>>>(
        (const uint32_t*)x, (uint32_t*)o, (const uint32_t*)pw, batch, n, h);
  else
    ntt_head_kernel<zk::Fq><<<blocks, kHeadThreads, 0, s>>>(
        (const uint32_t*)x, (uint32_t*)o, (const uint32_t*)pw, batch, n, h);
  return (int)cudaGetLastError();
}
