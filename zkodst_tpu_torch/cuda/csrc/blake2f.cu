// The BLAKE2f circuit's witness stream and the batched BLAKE2f
// compression, on 64-bit words (blake2f.cuh).
//
//   zk_blake2f_witness  <- no Pallas kernel: the `lax.scan` over rounds in
//                          zkodst_tpu/circuit/blake2f.py:_numeric_stream
//                          (513–567), jitted with the scatter by
//                          Blake2fCircuit.witness
//   zk_blake2f_compress <- no Pallas kernel: the `lax.scan` over rounds in
//                          zkodst_tpu/ops/blake2.py:blake2f (96–150), under
//                          jax.jit in the reference's bench
//
// The JAX package never runs these as single operations: XLA compiles each
// scan into one program. Run as eager PyTorch operations they took ~12,780
// launches a flagship witness and ~1,930 a compression batch, and the host
// bound them (PERF.md §5, §6). Here each is one launch.
//
// Witness (kernel 13): one warp per instance. The 16-word work vector, the
// message and h live in shared memory; lanes 0–3 run the four G calls of a
// half-round (the column calls, then the diagonal ones, a __syncwarp
// between), each writing its 131 cells at g_offset(round, half, lane);
// lane 0 writes the 143 init cells, lanes 0–7 an output word's 33 final
// cells each. What bounds it on the H100: it writes 12,983 cells of 16
// bytes per instance (7.7 MB at 37 instances, 2.3 µs at 3.35 TB/s), but
// each instance is a chain of 24 half-rounds of one G call each, and a G
// call is ~1,000 dependent-ish instructions of one thread (59 spreads, 131
// stores): at 37 instances the card is nearly empty and the chain, not
// the bytes, sets the time.
//
// Compression (kernel 14): one thread per compression, the 16 words and
// the message in registers (each round's message indices are compile-time
// constants: the rounds run in unrolled blocks of ten). It reads 200 and
// writes 128 bytes per compression and does ~2,500 32-bit operations
// (6 adds, 4 xors, 3 rotations of 64 bits a G call), so at 8192
// compressions it is near both the memory and the integer bound.
#include <cuda_runtime.h>

#include "blake2f.cuh"

namespace {

constexpr int kWitnessWarps = 4;
constexpr int kCompressThreads = 128;

__global__ void __launch_bounds__(32 * kWitnessWarps)
blake2f_witness_kernel(const int64_t* __restrict__ h,
                       const int64_t* __restrict__ m,
                       const int64_t* __restrict__ t,
                       const int64_t* __restrict__ f,
                       int64_t* __restrict__ stream,
                       int64_t* __restrict__ hout, int64_t batch,
                       int rounds) {
  __shared__ uint64_t sv[kWitnessWarps][16], sm[kWitnessWarps][16],
      sh[kWitnessWarps][8];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWitnessWarps + w;
  if (b >= batch) return;                       // the whole warp
  uint64_t *v = sv[w], *mw = sm[w], *hw = sh[w];
  int64_t* out = stream + b * zkb::n_cells(rounds) * 2;
  if (lane < 16) mw[lane] = zkb::load_word(m + (b * 16 + lane) * 2);
  if (lane < 8) hw[lane] = zkb::load_word(h + (b * 8 + lane) * 2);
  __syncwarp();
  if (lane == 0) {
    zkb::Cells s{out};
    zkb::init_cells(s, hw, mw, zkb::load_word(t + b * 4),
                    zkb::load_word(t + b * 4 + 2), f[b] != 0, v);
  }
  __syncwarp();
  for (int rd = 0; rd < rounds; ++rd) {
    const int r10 = rd % 10;
    for (int half = 0; half < 2; ++half) {
      if (lane < 4) {
        const int gi = 4 * half + lane;
        const int ia = zkb::g_index(gi, 0), ib = zkb::g_index(gi, 1),
                  ic = zkb::g_index(gi, 2), id = zkb::g_index(gi, 3);
        uint64_t va = v[ia], vb = v[ib], vc = v[ic], vd = v[id];
        zkb::Cells s{out + 2 * zkb::g_offset(rd, half, lane)};
        zkb::g_cells(s, va, vb, vc, vd, mw[zkb::sigma(r10, 2 * gi)],
                     mw[zkb::sigma(r10, 2 * gi + 1)]);
        v[ia] = va;
        v[ib] = vb;
        v[ic] = vc;
        v[id] = vd;
      }
      __syncwarp();
    }
  }
  if (lane < 8) {
    zkb::Cells s{out + 2 * (zkb::final_offset(rounds)
                            + zkb::kFinalWordCells * lane)};
    zkb::store_word(hout + (b * 8 + lane) * 2,
                    zkb::final_cells(s, v[lane], v[lane + 8], hw[lane]));
  }
}

__global__ void __launch_bounds__(kCompressThreads)
blake2f_compress_kernel(const int64_t* __restrict__ h,
                        const int64_t* __restrict__ m,
                        const int64_t* __restrict__ t,
                        const uint8_t* __restrict__ f,
                        int64_t* __restrict__ hout, int64_t n,
                        uint64_t rounds) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  zkb::compress_one(h + i * 16, m + i * 32, t + i * 4, f[i] != 0, rounds,
                    hout + i * 16);
}

}  // namespace

// The witness stream of `batch` instances: h (batch, 8, 2), m (batch, 16,
// 2), t (batch, 2, 2) int64 pairs, f (batch,) int64 0 or 1 ->
// stream (batch, n_cells(rounds), 2) and hout (batch, 8, 2) int64.
extern "C" int zk_blake2f_witness(const void* h, const void* m, const void* t,
                                  const void* f, void* stream, void* hout,
                                  long long batch, int rounds, void* s) {
  if (batch == 0) return 0;
  if (rounds < 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((batch + kWitnessWarps - 1) / kWitnessWarps);
  blake2f_witness_kernel<<<blocks, 32 * kWitnessWarps, 0,
                           (cudaStream_t)s>>>(
      (const int64_t*)h, (const int64_t*)m, (const int64_t*)t,
      (const int64_t*)f, (int64_t*)stream, (int64_t*)hout, batch, rounds);
  return (int)cudaGetLastError();
}

// h' of n compressions: h (n, 8, 2), m (n, 16, 2), t (n, 2, 2) int64
// pairs, f (n,) bytes (nonzero: the final block), rounds < 2^32 ->
// hout (n, 8, 2) int64.
extern "C" int zk_blake2f_compress(const void* h, const void* m, const void* t,
                                   const void* f, void* hout, long long n,
                                   long long rounds, void* s) {
  if (n == 0) return 0;
  if (rounds < 0 || rounds > 0xffffffffll) return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((n + kCompressThreads - 1) / kCompressThreads);
  blake2f_compress_kernel<<<blocks, kCompressThreads, 0, (cudaStream_t)s>>>(
      (const int64_t*)h, (const int64_t*)m, (const int64_t*)t,
      (const uint8_t*)f, (int64_t*)hout, n, (uint64_t)rounds);
  return (int)cudaGetLastError();
}
