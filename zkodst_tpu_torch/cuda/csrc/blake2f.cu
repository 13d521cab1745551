// The BLAKE2f circuit's witness, written straight into its advice columns,
// and the batched BLAKE2f compression, on 64-bit words (blake2f.cuh).
//
//   zk_blake2f_advice   <- no Pallas kernel: the `lax.scan` over rounds in
//   zk_blake2f_witness     zkodst_tpu/circuit/blake2f.py:_numeric_stream
//                          (513–567) and the scatter into the columns,
//                          jitted as one program by _witness_impl (725)
//   zk_blake2f_compress <- no Pallas kernel: the `lax.scan` over rounds in
//                          zkodst_tpu/ops/blake2.py:blake2f (96–150), under
//                          jax.jit in the reference's bench
//
// The JAX package never runs these as single operations: XLA compiles each
// into one program. Run as eager PyTorch operations they took ~12,780
// launches a flagship witness and ~1,930 a compression batch.
//
// Witness (kernel 13, one kernel behind two entry points). What bounds it:
// the flagship (37 instances, 12 rounds) writes 19,479 placed cells of 16
// bytes an instance into 14 columns of 2^17 rows that must be zero
// elsewhere, and each instance's cells hang on a chain of 24 half-rounds.
// One thread per instance, running each G call's ~1,000 instructions in
// turn, took 31× the byte bound (PERF.md §6). So the chain is cut from
// the cells. A G call's 131 cells are a pure function of its six input
// words, which the plain rounds give in ~30 word operations a call. A block
// takes one group of one instance: the init cells, one round's eight G
// calls, or the eight output words, 37 × 14 blocks at the flagship size.
// Lanes 0–3 of warp 0 rerun the chain up to the block's round on a quad (a
// lane a column, shuffles for the diagonals: ~0.2 µs a round), capturing
// that round's G inputs. Rerunning the chain costs less than a second
// launch and a round trip through device memory, and makes the blocks
// independent. Then warp p writes part p of each of the eight G calls (a
// lane a call; the parts are the four line pairs of G, 27–39 cells each)
// in stream order into shared memory, and every thread of the block
// places the group's cells: each reads its cell's placement entries
// (coalesced) and writes the cell to its rows. Placing a cell from the
// thread that computed it, a dependent table read between each cell's
// stores, took 36–40 µs at the flagship size on an H100.
// Warps 1–7 of the init block write the constant cells and the instance
// column. The wrapper zeroes the columns first with one memset, for the
// rows no placement reaches. The stream form (zk_blake2f_witness) is the
// same kernel with the identity placement, no constants and no memset.
//
// Compression (kernel 14): a quad of lanes per compression, lane i holding
// column i of the work matrix and its two output words, the message in
// shared memory (each lane needs other words as the rounds permute them),
// the diagonals by shuffles. The chain a lane runs is 24 G calls, not 96,
// and 8192 compressions are 32,768 threads over all SMs. It reads 200 and
// writes 128 bytes per compression and does ~2,500 32-bit operations.
#include <cuda_runtime.h>

#include "blake2f.cuh"

namespace {

constexpr int kPlaceThreads = 256;     // warp 0: chain and cells; all: placing
constexpr int kCompressThreads = 128;  // 32 compressions

struct PlaceArgs {
  const int64_t *h, *m, *t, *f;  // (B, 8, 2), (B, 16, 2), (B, 2, 2), (B,)
  const int32_t *slots, *more;   // placements: (cells, 4) and the lists
  const int32_t* cdst;           // constant cells: destination
  const int64_t* cval;           // and (lo, hi)
  int n_const;
  int64_t* out;                  // the columns (or the stream)
  int64_t inst_rows;             // rows an instance
  int64_t* pub;                  // the instance column or null
  int64_t* hout;                 // (B, 8, 2) or null
  int rounds;
};

__global__ void __launch_bounds__(kPlaceThreads)
blake2f_place_kernel(const PlaceArgs a) {
  __shared__ zkb::Words w;
  __shared__ zkb::GIn gin[8];
  __shared__ uint64_t v[16];
  __shared__ __align__(16) int64_t cell[2 * zkb::kRoundCells];
  const int64_t b = blockIdx.x;
  const int grp = blockIdx.y, tid = threadIdx.x;
  if (tid < 32) {
    if (tid < 8) w.h[tid] = zkb::load_word(a.h + (b * 8 + tid) * 2);
    if (tid < 16) w.m[tid] = zkb::load_word(a.m + (b * 16 + tid) * 2);
    if (tid == 0) {
      w.t0 = zkb::load_word(a.t + b * 4);
      w.t1 = zkb::load_word(a.t + b * 4 + 2);
      w.f = a.f[b] != 0;
    }
    __syncwarp();
    if (grp > 0 && tid < 4)
      zkb::group_chain(zkb::WarpLanes{tid, 0xfu}, w, grp, a.rounds, gin, v);
  }
  __syncthreads();
  const int64_t row0 = b * a.inst_rows;
  const int k = tid & 31, part = tid >> 5;     // a warp a part of G
  if (k < zkb::group_items(grp) && part < zkb::item_parts(grp, a.rounds)) {
    const uint64_t o = zkb::group_part(zkb::Cells{cell}, w, grp, a.rounds,
                                       k, part, gin, v);
    if (grp == a.rounds + 1) {
      if (a.pub)
        zkb::store_word(a.pub + 2 * (b * zkb::kPubRows + zkb::kRowOut + k),
                        o);
      if (a.hout) zkb::store_word(a.hout + (b * 8 + k) * 2, o);
    }
  } else if (grp == 0 && tid >= 32) {
    for (int i = tid - 32; i < a.n_const; i += kPlaceThreads - 32)
      zkb::put_cell(a.out + 2 * (row0 + a.cdst[i]), a.cval[2 * i],
                    a.cval[2 * i + 1]);
    if (a.pub)
      for (int i = tid - 32; i < zkb::kRowOut; i += kPlaceThreads - 32)
        zkb::store_word(a.pub + 2 * (b * zkb::kPubRows + i),
                        zkb::pub_input(w, i));
  }
  __syncthreads();
  // the group's cells to their placements, by every thread of the block
  const int32_t* slots = a.slots + 4 * zkb::group_begin(grp, a.rounds);
  const int cells = zkb::group_cells(grp, a.rounds);
#pragma unroll 4
  for (int i = tid; i < cells; i += kPlaceThreads)
    zkb::place_cell(slots + 4 * i, a.more, a.out, row0, cell[2 * i],
                    cell[2 * i + 1]);
}

__global__ void __launch_bounds__(kCompressThreads)
blake2f_compress_kernel(const int64_t* __restrict__ h,
                        const int64_t* __restrict__ m,
                        const int64_t* __restrict__ t,
                        const uint8_t* __restrict__ f, int f_bytes,
                        int64_t* __restrict__ hout, int64_t n,
                        uint64_t rounds) {
  __shared__ zkb::Words ws[kCompressThreads / 4];
  const int lane = threadIdx.x & 31, i = lane & 3;
  const int64_t c = ((int64_t)blockIdx.x * kCompressThreads + threadIdx.x)
                    >> 2;
  const int64_t k = c < n ? c : n - 1;   // a short last quad repeats the last
  zkb::Words& w = ws[threadIdx.x >> 2];
  for (int j = 0; j < 4; ++j)
    w.m[4 * i + j] = zkb::load_word(m + (k * 16 + 4 * i + j) * 2);
  w.h[i] = zkb::load_word(h + (k * 8 + i) * 2);
  w.h[4 + i] = zkb::load_word(h + (k * 8 + 4 + i) * 2);
  if (i == 0) {
    w.t0 = zkb::load_word(t + k * 4);
    w.t1 = zkb::load_word(t + k * 4 + 2);
    bool fin = false;
    for (int j = 0; j < f_bytes; ++j) fin |= f[k * f_bytes + j] != 0;
    w.f = fin;
  }
  __syncwarp();
  uint64_t o0, o1;
  zkb::quad_compress(zkb::WarpLanes{lane, 0xffffffffu}, w, rounds, o0, o1);
  if (c < n) {
    zkb::store_word(hout + (c * 8 + i) * 2, o0);
    zkb::store_word(hout + (c * 8 + 4 + i) * 2, o1);
  }
}

cudaError_t launch_place(const PlaceArgs& a, long long batch,
                         long long zero_bytes, cudaStream_t s) {
  if (a.rounds < 0 || a.rounds + 2 > 65535) return cudaErrorInvalidValue;
  if (zero_bytes > 0) {
    const cudaError_t err = cudaMemsetAsync(a.out, 0, (size_t)zero_bytes, s);
    if (err != cudaSuccess) return err;
  }
  if (batch == 0) return cudaSuccess;
  blake2f_place_kernel<<<dim3((unsigned)batch, (unsigned)(a.rounds + 2)),
                         kPlaceThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The witness of `batch` instances written into the circuit's columns:
// h (batch, 8, 2), m (batch, 16, 2), t (batch, 2, 2) int64 pairs, f
// (batch,) int64 0 or 1; `slots` (cells, 4) and `more` the placements of
// one instance's stream (blake2f.cuh, Place), cdst / cval its n_const
// constant cells; out the columns, zeroed first over zero_bytes (the
// memset, then the kernel), instance b's rows from b·inst_rows; pub the
// instance column (kPubRows rows an instance) or null.
extern "C" int zk_blake2f_advice(const void* h, const void* m, const void* t,
                                 const void* f, const void* slots,
                                 const void* more, const void* cdst,
                                 const void* cval, long long n_const,
                                 void* out, long long inst_rows, void* pub,
                                 long long zero_bytes, long long batch,
                                 int rounds, void* s) {
  const PlaceArgs a{(const int64_t*)h, (const int64_t*)m, (const int64_t*)t,
                    (const int64_t*)f, (const int32_t*)slots,
                    (const int32_t*)more, (const int32_t*)cdst,
                    (const int64_t*)cval, (int)n_const, (int64_t*)out,
                    inst_rows, (int64_t*)pub, nullptr, rounds};
  return (int)launch_place(a, batch, zero_bytes, (cudaStream_t)s);
}

// The witness stream of `batch` instances (the same kernel, `slots` the
// identity placement of n_cells(rounds) cells) -> stream (batch,
// n_cells(rounds), 2) and hout (batch, 8, 2) int64.
extern "C" int zk_blake2f_witness(const void* h, const void* m, const void* t,
                                  const void* f, const void* slots,
                                  void* stream, void* hout, long long batch,
                                  int rounds, void* s) {
  const PlaceArgs a{(const int64_t*)h, (const int64_t*)m, (const int64_t*)t,
                    (const int64_t*)f, (const int32_t*)slots, nullptr,
                    nullptr, nullptr, 0, (int64_t*)stream,
                    zkb::n_cells(rounds), nullptr, (int64_t*)hout, rounds};
  return (int)launch_place(a, batch, 0, (cudaStream_t)s);
}

// h' of n compressions: h (n, 8, 2), m (n, 16, 2), t (n, 2, 2) int64
// pairs, f (n,) flags of f_bytes bytes each (nonzero: the final block),
// rounds < 2^32 -> hout (n, 8, 2) int64.
extern "C" int zk_blake2f_compress(const void* h, const void* m, const void* t,
                                   const void* f, int f_bytes, void* hout,
                                   long long n, long long rounds, void* s) {
  if (n == 0) return 0;
  if (rounds < 0 || rounds > 0xffffffffll || f_bytes < 1 || f_bytes > 8)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((4 * n + kCompressThreads - 1) / kCompressThreads);
  blake2f_compress_kernel<<<blocks, kCompressThreads, 0, (cudaStream_t)s>>>(
      (const int64_t*)h, (const int64_t*)m, (const int64_t*)t,
      (const uint8_t*)f, f_bytes, (int64_t*)hout, n, (uint64_t)rounds);
  return (int)cudaGetLastError();
}
