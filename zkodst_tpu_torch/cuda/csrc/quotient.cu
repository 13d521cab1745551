// Kernel 15: the quotient's numerator over the extended coset, in one
// launch, for BN254's Fr.
//
//   zk_quotient <- no Pallas kernel: XLA's fusion of the jitted
//                  zkodst_tpu/proof/prover.py:_quotient_fn
//
// The constraint system of a proving key is compiled once, on the host,
// into a straight-line tape (kernels/quotient.py: Tape; proof/prover.py:
// compile_quotient): steps (op, dst, a, b) over a small slot file, whose
// operands are a slot, an input (a column read at a fixed row shift), an
// entry of the key's constant table or one of the four challenges. One
// thread evaluates the whole tape at one row of the coset (grid-stride),
// so every intermediate stays on the chip and each launch of the eager
// walk it replaces (~500 of kernels 1–3 a prove, each a pass over whole
// columns) becomes a few instructions. The tape is read uniformly: every
// thread of a warp takes the same branch of each step.
//
// What bounds it on the H100: the multiply rate. The BLAKE2f circuit's
// tape is ~250 Montgomery products a row (~264 32-bit multiply results
// each) against ~100 inputs of 32 bytes read and one element written; at
// 2^22 rows the products take ~16 ms at 1.6727e13/s, the bytes ~4 ms at
// 3.35 TB/s. So the design spends no instruction it can avoid between
// the products:
// - An input is read in place, at row (i + shift) mod rows (rows a power
//   of two): a rotation costs an add and a mask, no rolled copy. Reads of
//   neighbouring threads are neighbouring 32-byte elements. An input is
//   read again wherever the tape uses it, never held in a slot: the tape
//   then needs few slots (6 for BLAKE2f).
// - The slot file lives in shared memory, 32 bytes a slot and thread, laid
//   out so that a warp's read of one half of a slot is 512 contiguous
//   bytes (two 16-byte loads a slot, no bank conflict). Measured against
//   it (PERF.md §6, design measurements), a slot file in registers,
//   indexed by the tape's slot number, is a select over every slot for
//   each limb and took 3.1× as long (240 registers and a stack); one in
//   local memory 5% longer. Blocks of 128 threads (46 registers, 24 KB of
//   slots at 6 slots) beat 256 and 512 by 4–5%.
// - The column pointers and the challenges travel in the launch's
//   parameters (a __grid_constant__ struct read in place); the steps, the
//   inputs' (column, shift) table and the constants (Montgomery form) are
//   uploaded once per key and read through the read-only cache, one
//   broadcast for the warp.
#include <cuda_runtime.h>
#include <string.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSlots = 16;        // kernels/quotient.py MAX_SLOTS
constexpr int kMaxCols = 192;     // MAX_COLS
constexpr int kKindShift = 12;    // KIND_SHIFT
constexpr int kIndexMask = (1 << kKindShift) - 1;
enum Kind { kSlot, kInput, kConst, kChal };
enum Op { kMul, kAdd, kSub };

struct Args {
  const uint4* col[kMaxCols];
  uint32_t chal[4][8];            // θ, β, γ, y in Montgomery form
};

__device__ __forceinline__ void unpack(uint4 lo, uint4 hi, uint32_t x[8]) {
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// Operand v of a step at row i into x. slots: this thread's slot file
// (slot s's halves at slots[(2s) * nt] and slots[(2s + 1) * nt]).
__device__ __forceinline__ void fetch(int v, uint32_t i, uint32_t mask,
                                      const uint4* slots, uint32_t nt,
                                      const int2* __restrict__ inputs,
                                      const uint4* __restrict__ consts,
                                      const Args& args, uint32_t x[8]) {
  const int k = v & kIndexMask;
  switch (v >> kKindShift) {
    case kSlot:
      unpack(slots[2 * k * nt], slots[(2 * k + 1) * nt], x);
      break;
    case kInput: {
      const int2 e = __ldg(&inputs[k]);
      const uint4* c = args.col[e.x] + 2 * ((i + (uint32_t)e.y) & mask);
      unpack(__ldg(c), __ldg(c + 1), x);
      break;
    }
    case kConst:
      unpack(__ldg(&consts[2 * k]), __ldg(&consts[2 * k + 1]), x);
      break;
    default:
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = args.chal[k][j];
  }
}

__global__ void __launch_bounds__(kThreads)
quotient_kernel(const int4* __restrict__ steps, int n_steps,
                const int2* __restrict__ inputs,
                const uint4* __restrict__ consts, uint4* __restrict__ out,
                uint32_t rows, int out_slot,
                const __grid_constant__ Args args) {
  extern __shared__ uint4 smem[];
  const uint32_t nt = blockDim.x, mask = rows - 1;
  uint4* slots = smem + threadIdx.x;
  for (uint32_t i = blockIdx.x * nt + threadIdx.x; i < rows;
       i += gridDim.x * nt) {
    for (int s = 0; s < n_steps; ++s) {
      const int4 st = __ldg(&steps[s]);
      uint32_t a[8], b[8], r[8];
      fetch(st.z, i, mask, slots, nt, inputs, consts, args, a);
      fetch(st.w, i, mask, slots, nt, inputs, consts, args, b);
      if (st.x == kMul)
        zk::mont_mul<zk::Fr>(a, b, r);
      else if (st.x == kAdd)
        zk::add_mod<zk::Fr>(a, b, r);
      else
        zk::sub_mod<zk::Fr>(a, b, r);
      slots[2 * st.y * nt] = make_uint4(r[0], r[1], r[2], r[3]);
      slots[(2 * st.y + 1) * nt] = make_uint4(r[4], r[5], r[6], r[7]);
    }
    out[2 * i] = slots[2 * out_slot * nt];
    out[2 * i + 1] = slots[(2 * out_slot + 1) * nt];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). steps: n_steps
// int32 quads (op, dst, a, b); inputs: int32 pairs (column, shift);
// consts: the constant table, 8 limbs an entry; cols: a host array of
// n_cols device pointers to (rows, 8) columns; chal: a host array of 32
// words, θ, β, γ, y in Montgomery form; out: (rows, 8). rows is a power
// of two up to 2^31; the tape uses `slots` slots, the result in
// `out_slot` after the last step.
extern "C" int zk_quotient(const void* steps, int n_steps, const void* inputs,
                           const void* consts, const void* const* cols,
                           int n_cols, const uint32_t* chal, void* out,
                           long long rows, int slots, int out_slot,
                           void* stream) {
  if (rows <= 0) return 0;
  if ((rows & (rows - 1)) || rows > (1LL << 31) || n_steps < 1 ||
      n_cols < 0 || n_cols > kMaxCols || slots < 1 || slots > kSlots ||
      out_slot < 0 || out_slot >= slots)
    return (int)cudaErrorInvalidValue;
  Args args = {};
  for (int c = 0; c < n_cols; ++c) args.col[c] = (const uint4*)cols[c];
  memcpy(args.chal, chal, sizeof(args.chal));
  const size_t smem = (size_t)slots * 32 * kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      quotient_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((rows + kThreads - 1) / kThreads);
  quotient_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int4*)steps, n_steps, (const int2*)inputs, (const uint4*)consts,
      (uint4*)out, (uint32_t)rows, out_slot, args);
  return (int)cudaGetLastError();
}
