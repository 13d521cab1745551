// Dependent-chain probes of kernel 10's add and of the Montgomery product,
// run by zkodst_tpu_torch/tools/scan_probe.py (not part of the main path,
// and not built by kernels/build.py). One warp, alone on the card, runs
// `steps` dependent steps; the caller times the launch, so a step's time
// is what one warp takes for it: its latency where the SM sub-partition's
// pipes keep up, its issue time where they do not.
#include "ec.cu"

namespace {

__device__ __forceinline__ void load_pt_words(const uint32_t* w, zk::Pt& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a.x[i] = w[i];
    a.y[i] = w[8 + i];
    a.z[i] = w[16 + i];
  }
}

// a <- a + q, `steps` times, each add's products split over L lanes
// (kernel 10's SplitLayer; L = 1 is one thread).
template <int L>
__global__ void add_chain_kernel(const uint32_t* __restrict__ p,
                                 uint32_t* __restrict__ o, int steps) {
  const int lane = threadIdx.x, j = lane % L;
  const SplitLayer<L, zk::Fq> mul{j, ((1u << L) - 1) << (lane - j)};
  zk::Pt a, q;
  load_pt_words(p, a);
  load_pt_words(p + 24, q);
  for (int s = 0; s < steps; ++s) zk::ec_add_by(mul, a, q, a);
  if (j == 0)
    for (int i = 0; i < 8; ++i) o[24 * (lane / L) + i] = a.x[i];
}

// K independent chains a_k <- a_k · b in one thread, `steps` times.
template <int K>
__global__ void mul_chain_kernel(const uint32_t* __restrict__ p,
                                 uint32_t* __restrict__ o, int steps) {
  uint32_t a[K][8], b[8], r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    b[i] = p[8 + i];
#pragma unroll
    for (int k = 0; k < K; ++k) a[k][i] = p[16 * k + i];
  }
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      zk::mont_mul<zk::Fq>(a[k], b, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[k][i] = r[i];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int i = 0; i < 8; ++i) o[8 * (K * threadIdx.x + k) + i] = a[k][i];
}

}  // namespace

// p: two points (48 words) or K + 1 field elements; o: 32·24 words.
extern "C" int zk_probe_add_chain(const void* p, void* o, int steps,
                                  int lanes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pp = (const uint32_t*)p;
  uint32_t* oo = (uint32_t*)o;
  if (lanes == 1)
    add_chain_kernel<1><<<1, 32, 0, s>>>(pp, oo, steps);
  else if (lanes == 2)
    add_chain_kernel<2><<<1, 32, 0, s>>>(pp, oo, steps);
  else if (lanes == 4)
    add_chain_kernel<4><<<1, 32, 0, s>>>(pp, oo, steps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int zk_probe_mul_chain(const void* p, void* o, int steps,
                                  int chains, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pp = (const uint32_t*)p;
  uint32_t* oo = (uint32_t*)o;
  if (chains == 1)
    mul_chain_kernel<1><<<1, 32, 0, s>>>(pp, oo, steps);
  else if (chains == 2)
    mul_chain_kernel<2><<<1, 32, 0, s>>>(pp, oo, steps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
