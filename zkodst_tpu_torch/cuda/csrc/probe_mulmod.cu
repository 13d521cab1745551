// Access-pattern probe of chain_cumprod, run by
// zkodst_tpu_torch/tools/scan_probe.py (not part of the main path, and not
// built by kernels/build.py): the same segmented product scan as
// chain_cumprod_kernel (same chunks, threads and association), with each
// chunk staged through shared memory instead of read in place. Every
// thread copies 16-byte vectors of the chunk with cp.async, neighbouring
// lanes on neighbouring vectors; results are written over the chunk's
// inputs in shared memory and leave it the same coalesced way. With
// kStages = 2 the next chunk's copy is in flight while this one is scanned
// (64 KB of dynamic shared memory a block: 3 blocks, 12 warps, an SM);
// with kStages = 1 it is copied after this one has left (32 KB: 6 blocks).
// A thread's 8 elements are 16 vectors in a row of the buffer; vector u
// is stored at u XOR ((u >> 4) & 7), so the 8 lanes of a quarter-warp
// touch 8 different bank groups both in the copies and in the walks.
#include "mulmod.cu"

namespace {

constexpr int kChunkVecs = 2 * (int)kChunk;            // 16-byte vectors

__device__ __forceinline__ int swz(int u) { return u ^ ((u >> 4) & 7); }

__device__ __forceinline__ void lds8(const uint4* c, int j, uint32_t x[8]) {
  const uint4 a0 = c[swz(2 * j)], a1 = c[swz(2 * j + 1)];
  x[0] = a0.x; x[1] = a0.y; x[2] = a0.z; x[3] = a0.w;
  x[4] = a1.x; x[5] = a1.y; x[6] = a1.z; x[7] = a1.w;
}

__device__ __forceinline__ void sts8(uint4* c, int j, const uint32_t r[8]) {
  c[swz(2 * j)] = make_uint4(r[0], r[1], r[2], r[3]);
  c[swz(2 * j + 1)] = make_uint4(r[4], r[5], r[6], r[7]);
}

// Start copying the chunk of `len` elements at global g into buffer c, as
// one commit group.
__device__ __forceinline__ void fetch_chunk(uint4* c, const uint4* g,
                                            int len) {
  for (int u = threadIdx.x; u < 2 * len; u += kChainThreads) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(c + swz(u));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(d), "l"(g + u) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <class M, int kStages>
__global__ void __launch_bounds__(kChainThreads)
chain_staged_kernel(const uint4* __restrict__ x, uint4* __restrict__ o,
                    int64_t W, int64_t S, int64_t R) {
  extern __shared__ uint4 bufs[];
  __shared__ uint32_t wv[kChainWarps][8];
  __shared__ bool wh[kChainWarps];
  __shared__ uint32_t pv[kChainWarps + 1][8];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * R;
  const int64_t e_beg = r0 * S;
  const int64_t e_end = (r0 + R < W ? r0 + R : W) * S;
  auto chunk_len = [&](int64_t base) {
    return e_end - base < kChunk ? (int)(e_end - base) : (int)kChunk;
  };
  uint32_t carry[8];
  M::one(carry);
  if (kStages == 2) fetch_chunk(bufs, x + 2 * e_beg, chunk_len(e_beg));
  int which = 0;
  for (int64_t base = e_beg; base < e_end; base += kChunk) {
    const int len = chunk_len(base);
    uint4* c = bufs + which * kChunkVecs;
    if (kStages == 1) fetch_chunk(c, x + 2 * base, len);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (kStages == 2 && base + kChunk < e_end)
      fetch_chunk(bufs + (which ^ 1) * kChunkVecs, x + 2 * (base + kChunk),
                  chunk_len(base + kChunk));
    const int j0 = t * kChainPer;
    const int cnt = j0 >= len ? 0
        : (len - j0 < kChainPer ? len - j0 : kChainPer);
    const int64_t pos0 = cnt ? (base + j0) % S : 0;
    uint32_t v[8], xv[8], r[8];
    M::one(v);
    bool h = false;
    int64_t pos = pos0;
    for (int j = 0; j < cnt; ++j) {
      lds8(c, j0 + j, xv);
      if (j == 0 || pos == 0) {
        copy8(v, xv);
      } else {
        zk::mont_mul<M>(v, xv, r);
        copy8(v, r);
      }
      h = h || pos == 0;
      if (++pos == S) pos = 0;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      uint32_t u[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) u[i] = __shfl_up_sync(0xFFFFFFFFu, v[i], d);
      const bool uh = __shfl_up_sync(0xFFFFFFFFu, (int)h, d);
      if (lane >= d) seg_mul<M>(u, uh, v, h);
    }
    uint32_t lv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) lv[i] = __shfl_up_sync(0xFFFFFFFFu, v[i], 1);
    bool lh = __shfl_up_sync(0xFFFFFFFFu, (int)h, 1);
    if (lane == 31) {
      copy8(wv[warp], v);
      wh[warp] = h;
    }
    __syncthreads();
    if (warp == 0) {
      uint32_t cv[8];
      bool ch = false;
      if (lane == 0) {
        copy8(cv, carry);
      } else if (lane <= kChainWarps) {
        copy8(cv, wv[lane - 1]);
        ch = wh[lane - 1];
      } else {
        M::one(cv);
      }
#pragma unroll
      for (int d = 1; d <= kChainWarps; d <<= 1) {
        uint32_t u[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          u[i] = __shfl_up_sync(0xFFFFFFFFu, cv[i], d);
        const bool uh = __shfl_up_sync(0xFFFFFFFFu, (int)ch, d);
        if (lane >= d && lane <= kChainWarps) seg_mul<M>(u, uh, cv, ch);
      }
      if (lane <= kChainWarps) copy8(pv[lane], cv);
    }
    __syncthreads();
    uint32_t acc[8];
    copy8(acc, pv[warp]);
    if (lane > 0) {
      seg_mul<M>(acc, false, lv, lh);
      copy8(acc, lv);
    }
    copy8(carry, pv[kChainWarps]);
    pos = pos0;
    for (int j = 0; j < cnt; ++j) {
      lds8(c, j0 + j, xv);
      if (pos == 0) {
        copy8(acc, xv);
      } else {
        zk::mont_mul<M>(acc, xv, r);
        copy8(acc, r);
      }
      sts8(c, j0 + j, acc);
      if (++pos == S) pos = 0;
    }
    __syncthreads();
    for (int u = t; u < 2 * len; u += kChainThreads)
      o[2 * base + u] = c[swz(u)];
    if (kStages == 1) __syncthreads();   // c is refilled next
    which ^= kStages - 1;
  }
}

template <int kStages>
int launch_staged(const void* x, void* o, long long W, long long S,
                  int field, cudaStream_t s) {
  const long long R = S >= kChunk ? 1 : (kChunk / S < W ? kChunk / S : W);
  const unsigned blocks = (unsigned)((W + R - 1) / R);
  const int smem = kStages * kChunkVecs * (int)sizeof(uint4);
  auto kernel = field == 0 ? chain_staged_kernel<zk::Fr, kStages>
                           : chain_staged_kernel<zk::Fq, kStages>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kChainThreads, smem, s>>>((const uint4*)x, (uint4*)o, W,
                                             S, R);
  return (int)cudaGetLastError();
}

}  // namespace

// chain_cumprod's contract (x, o: W·S elements), staged with `stages`
// (1 or 2) chunk buffers.
extern "C" int zk_probe_chain_staged(const void* x, void* o, long long W,
                                     long long S, int field, int stages,
                                     void* stream) {
  if (W <= 0 || S <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (stages == 1) return launch_staged<1>(x, o, W, S, field, s);
  if (stages == 2) return launch_staged<2>(x, o, W, S, field, s);
  return (int)cudaErrorInvalidValue;
}
