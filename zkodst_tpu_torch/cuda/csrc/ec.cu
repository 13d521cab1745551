// G1 kernels of the MSM, the SRS ladder and the IPA opening, on packed
// points, each a template on the curve: BN254 G1 (zk::Bn254) and the Pasta
// pallas curve (zk::Pallas, the IPA backend's second curve). Both have
// 8-limb coordinates and a = 0; they differ in the modulus and in b3 (9 on
// BN254, 15 on pallas: a chain of 4 or 5 modular additions), so a pallas
// instance runs its BN254 instance's code with the other modulus and one
// more addition for each b3 product. Every entry point takes `curve`
// (0 BN254, 1 pallas); the Pasta IPA's MSMs run kernels 9–12 on pallas
// through the same Pippenger as BN254's (ops/msm.py).
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
// owns a chain and loops over it instead, and the tile scan spreads a row
// over a thread-block cluster (see seg_scan_tiles_kernel). Each kernel's plain PyTorch twin in
// kernels/ec.py repeats the same association of additions and doublings,
// so the two agree limb for limb, not only as group elements.
//
// chain_scan (kernel 11) is the MSM's largest kernel: 80 rows × 2048
// chains of 64 elements at 2^17 points, one thread per chain. It is bound
// by the integer multiply rate, so the add stays in registers (no
// local-memory frame to compete with L1), its products are the paired
// wide multiply-adds of field.cuh, and each thread requests its next
// element before the add of the current one: the load's latency hides
// under the add instead of sitting on the chain. It asks for two blocks of
// 128 threads an SM (__launch_bounds__(128, 2): 200 and 224 registers for
// BN254's gathered and dense forms); more warps, through a register cap
// or 256 threads a block, did not measure faster, and ptxas left to itself
// gives the template 168 registers, three blocks and a spill, 3.5% slower
// (PERF.md §6, design measurements). On the MSM's windows it runs
// gathered: each thread reads its elements' points through the window's
// sorted point indices, 96 contiguous bytes a point from the table msm_many
// was given, so the windows make no (rows, 24, n) gathered copy of the
// points and no transpose of one.
//
// scale_reduce (kernel 12) is latency-bound: 4 to 14 batch rows, each a
// Horner walk of c doublings per window, c·(nlive − 1) doublings and
// nlive − 1 adds in series (252 + 63 at c = 4, nlive = 64). No regrouping
// of the windows shortens that chain, so the kernel shortens each step:
// the complete doubling (8 products in three layers) in place of an add of
// the point to itself (12 in two), and a warp per row that computes each
// layer's independent products on separate lanes, so that a doubling
// costs three products' latency and an add two.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "field.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;

// o = p + q, elementwise over batch·n, on curve C (zk::Bn254 or
// zk::Pallas).
template <class C>
__global__ void __launch_bounds__(kThreads)
ec_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
              uint32_t* __restrict__ o, int64_t batch, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * n) return;
  int64_t b = i / n, e = i % n;
  zk::Pt x, y, s;
  zk::load_pt(p + b * 24 * n, n, e, x);
  zk::load_pt(q + b * 24 * n, n, e, y);
  zk::ec_add<C>(x, y, s);
  zk::store_pt(o + b * 24 * n, n, e, s);
}

// seg_step (kernel 9): o = keep ? p : p + q, a carry q applied to the
// elements whose segment began before them. Three forms, one kernel
// (SegStep holds which):
// - natural: o[e] = p[e] (+ q[e]), q of p's shape, a keep byte a element;
// - gathered: the same, with q read at q_index[e] from a (batch, 24, nq)
//   tensor (the MSM's bucket tails: each reads its chain's carry);
// - chains: p chain-major with W chains of S = n / W (element s·W + l is
//   chain l's s-th), q one carry a chain (batch, 24, W), and element
//   (l, s) needs its add iff s < fs[l], the chain's first segment start
//   (a prefix of each chain).
// o may be p (in place).
//
// What bounds it on the H100. An add is ~3,200 32-bit multiply results
// and moves at most three points, so the kernel is bound by the multiply
// rate over the adds the data needs: the MSM's calls need a quarter of
// their elements (bucket tails after a chain boundary) to all of them
// (the suffix scan). One thread a element with a branch on keep paid a
// whole add in every warp with one needing lane, so at 25% a call cost
// what a dense one did. A sparse call has few adds for the card (41,000
// at (20, 24, 8192), ten warps' worth an SM), so where they run matters
// too: blocks of a fixed tile leave some SMs a block more than others,
// and a tile with one add more than its threads runs a second round.
//
// This design compacts a tile of the call's elements a block, each tile a
// contiguous run of the batch·n elements (rows end anywhere in it):
// 1. each warp ballots its words of 32 elements (eight requested before
//    they are balloted); a word with at least kStepDirect needing lanes
//    adds them at once (three lanes in four or more busy, no list and
//    no wait: a dense call runs as one thread a element); of the other
//    words, warp 0 scans the counts and every needing element's place
//    goes into a list in shared memory, in order;
// 2. every thread runs adds from that list, a round of blockDim a time:
//    each lane of a warp adds and a round's lanes read neighbouring
//    elements;
// 3. out of place, the kept elements are moved (coalesced, 4 bytes a
//    lane and plane); in place they are neither read nor written.
// The tile follows the data the forms carry on the MSM's path. The
// natural and gathered forms (the bucket tails, a quarter adding) take
// the tile that makes the call one wave of the blocks the card holds at
// once, so that every SM gets the same share of the adds (~104 of 416
// elements a block at (20, 24, 8192): one round). The chains form (on
// the suffix scan every chain but one adds throughout) takes one round a
// block, a tile of blockDim: blocks then start staggered, and one
// block's loads overlap the others' adds; tiles of 512 and 2048 run 4
// and 16 rounds a block in step, their loads exposed, 2% and 28% slower
// on the H100 (PERF.md §6, design measurements).
constexpr int kStepMaxTile = 2048;      // elements a block at most
constexpr int kStepWords = 8;           // words a warp requests at a time
constexpr int kStepDirect = 24;         // needs that a word adds in place

struct SegStep {
  const uint32_t* p;
  const uint32_t* q;
  const uint8_t* keep;      // natural and gathered forms: 1 keeps p
  const int64_t* qidx;      // gathered form: q's element of each element
  const int64_t* fs;        // chains form: (batch, W) first starts
  uint32_t* o;
  int64_t batch, n, nq, W;  // W = 0: not the chains form
  int tile;                 // elements a block, a multiple of 32
};

// Element L = b·n + j of p and o (j its place in its row): its row and
// q's element it adds. batch·n < 2^31, so the divisions are 32-bit.
struct StepAt {
  int64_t b, j, qi;
};

__device__ __forceinline__ StepAt step_at(const SegStep& a, int64_t L) {
  StepAt t;
  const uint32_t row = (uint32_t)L / (uint32_t)a.n;
  t.b = row;
  t.j = (uint32_t)L - row * (uint32_t)a.n;
  if (a.W) {
    t.qi = (uint32_t)t.j % (uint32_t)a.W;
  } else {
    t.qi = a.qidx ? a.qidx[L] : t.j;
  }
  return t;
}

__device__ __forceinline__ bool step_needs(const SegStep& a, int64_t L) {
  if (!a.W) return !a.keep[L];
  const uint32_t b = (uint32_t)L / (uint32_t)a.n;
  const uint32_t j = (uint32_t)L - b * (uint32_t)a.n;
  const uint32_t s = j / (uint32_t)a.W;
  return s < a.fs[(int64_t)b * a.W + (j - s * (uint32_t)a.W)];
}

// The operands of element t's add.
__device__ __forceinline__ void step_load(const SegStep& a, const StepAt& t,
                                          zk::Pt& x, zk::Pt& y) {
  zk::load_pt(a.p + t.b * 24 * a.n, a.n, t.j, x);
  zk::load_pt(a.q + t.b * 24 * a.nq, a.nq, t.qi, y);
}

// Element t's add, its operands loaded.
template <class C>
__device__ __forceinline__ void step_add(const SegStep& a, const StepAt& t,
                                         const zk::Pt& x, const zk::Pt& y) {
  zk::Pt r;
  zk::ec_add<C>(x, y, r);
  zk::store_pt(a.o + t.b * 24 * a.n, a.n, t.j, r);
}

template <class C>
__global__ void __launch_bounds__(kThreads, 3)
seg_step_kernel(const SegStep a) {
  __shared__ uint32_t need[kStepMaxTile / 32];   // ballot words
  __shared__ uint32_t rest[kStepMaxTile / 32];   // their needs left to list
  __shared__ int before[kStepMaxTile / 32];      // listed before a word
  __shared__ uint16_t list[kStepMaxTile];        // needing elements
  __shared__ int count;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int64_t total = a.batch * a.n;
  const int64_t L0 = (int64_t)blockIdx.x * a.tile;
  const int m = (int)(total - L0 < a.tile ? total - L0 : a.tile);
  const int words = (m + 31) >> 5;
  StepAt t;
  zk::Pt x, y;
  bool listing = false;            // this thread has an element to list
  // 1. the tile's needs, a ballot a word; the list of needing elements
  for (int wb = warp; wb < words; wb += nw * kStepWords) {
    uint32_t xs = 0;                          // this lane's needs, a bit a word
#pragma unroll
    for (int u = 0; u < kStepWords; ++u) {
      const int i = 32 * (wb + u * nw) + lane;
      if (i < m && step_needs(a, L0 + i)) xs |= 1u << u;
    }
#pragma unroll 1
    for (int u = 0; u < kStepWords; ++u) {
      const int w = wb + u * nw;
      if (w >= words) break;                  // the same in the whole warp
      const bool mine = (xs >> u) & 1u;
      const uint32_t bits = __ballot_sync(0xFFFFFFFFu, mine);
      // a word that needs nearly every add is added here, by its lanes
      const bool here = __popc(bits) >= kStepDirect;
      if (here && mine) {
        t = step_at(a, L0 + 32 * w + lane);
        step_load(a, t, x, y);
        step_add<C>(a, t, x, y);
      }
      listing |= mine && !here;
      if (lane == 0) {
        need[w] = bits;
        rest[w] = here ? 0u : bits;
      }
    }
  }
  // a tile whose words were all added here lists nothing (the condition
  // is the block's: the barriers inside are reached by all or none)
  if (__syncthreads_or(listing)) {
    if (warp == 0) {               // ≤ 64 words: two a lane
      const int c0 = 2 * lane < words ? __popc(rest[2 * lane]) : 0;
      const int c1 = 2 * lane + 1 < words ? __popc(rest[2 * lane + 1]) : 0;
      int s = c0 + c1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, s, d);
        if (lane >= d) s += v;
      }
      if (2 * lane < words) before[2 * lane] = s - c0 - c1;
      if (2 * lane + 1 < words) before[2 * lane + 1] = s - c1;
      if (lane == 31) count = s;
    }
    __syncthreads();
    for (int w = warp; w < words; w += nw) {
      const uint32_t bits = rest[w];
      if ((bits >> lane) & 1u)
        list[before[w] + __popc(bits & ((1u << lane) - 1u))] =
            (uint16_t)(32 * w + lane);
    }
    __syncthreads();
    // 2. the listed adds, every lane busy
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      t = step_at(a, L0 + list[k]);
      step_load(a, t, x, y);
      step_add<C>(a, t, x, y);
    }
  }
  // 3. out of place: the kept elements moved, a warp a word
  if (a.o == a.p) return;
  for (int w = warp; w < words; w += nw) {
    const int i = 32 * w + lane;
    if (i >= m || (need[w] >> lane) & 1u) continue;
    t = step_at(a, L0 + i);
    for (int plane = 0; plane < 24; ++plane)
      a.o[(t.b * 24 + plane) * a.n + t.j] =
          a.p[(t.b * 24 + plane) * a.n + t.j];
  }
}

// chain_scan (kernel 11): a per-chain segmented inclusive scan. Chain l of
// a batch row walks S = n / W elements, one thread a chain: out = f ? x :
// acc + x, written chain-major (its k-th element at k·W + l of the row's
// (24, n) planes). A chain's head starts a segment (cross-chain carries are
// the caller's). Two forms, one template (Gathered):
// - dense: x and its flag are the row's (k·W + l)-th packed point and flag,
//   chain-major as the output (the MSM's Σ d·B_d scans, buckets laid out);
// - gathered: chain l's k-th element is the row's (l·S + k)-th in sorted
//   order: the point p[idx[b·n + l·S + k]] of a point-major (m, 3, 8)
//   table, read as six 16-byte loads (three 32-byte sectors), and the flag
//   f[b·n + l·S + k]. The MSM's windows pass their points as msm_many gets
//   them, the sorted point indices and their segment starts, so that no
//   gathered copy of the points is made; at 2^17 points the table (12.6 MB)
//   stays in L2. A warp's index and flag loads walk 32 runs at a stride of S
//   elements, each sector of a run read by the next steps of its thread.
// Element k + 1 (its point and flag) is loaded before the add of element
// k; in the gathered form the index of element k + 2 as well, so that the
// point's load does not wait for its index.
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ row,
                                         zk::Pt& x) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
  uint4 v[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) v[i] = __ldg(r + i);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x.x[i] = w[i];
    x.y[i] = w[8 + i];
    x.z[i] = w[16 + i];
  }
}

template <class C, bool Gathered>
__global__ void __launch_bounds__(kThreads, 2)
chain_scan_kernel(const uint32_t* __restrict__ p,
                  const int64_t* __restrict__ idx,
                  const uint8_t* __restrict__ f, uint32_t* __restrict__ o,
                  int64_t batch, int64_t n, int64_t W) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * W) return;
  int64_t b = i / W, l = i % W, S = n / W;
  // element k's flag (and index) is fc[k · step]
  const int64_t step = Gathered ? 1 : W;
  const uint8_t* fc = f + b * n + (Gathered ? l * S : l);
  const int64_t* ic = Gathered ? idx + b * n + l * S : nullptr;
  const uint32_t* pb = Gathered ? nullptr : p + b * 24 * n;
  uint32_t* ob = o + b * 24 * n;
  zk::Pt acc, next;
  uint8_t next_f = 0;
  int64_t next_j = 0;                  // gathered: element k + 2's index
  if (Gathered) {
    load_row(p + 24 * ic[0], acc);
    if (S > 1) load_row(p + 24 * ic[1], next);
    if (S > 2) next_j = ic[2];
  } else {
    zk::load_pt(pb, n, l, acc);
    if (S > 1) zk::load_pt(pb, n, W + l, next);
  }
  if (S > 1) next_f = fc[step];
  zk::store_pt(ob, n, l, acc);
  for (int64_t k = 1; k < S; ++k) {
    const zk::Pt x = next;
    const uint8_t fx = next_f;
    if (k + 1 < S) {
      if (Gathered) {
        load_row(p + 24 * next_j, next);
        if (k + 2 < S) next_j = ic[k + 2];
      } else {
        zk::load_pt(pb, n, (k + 1) * W + l, next);
      }
      next_f = fc[(k + 1) * step];
    }
    if (fx)
      acc = x;
    else
      zk::ec_add<C>(acc, x, acc);
    zk::store_pt(ob, n, k * W + l, acc);
  }
}

// seg_scan_tiles (kernel 10): a segmented inclusive scan of each row of
// n ≤ 2048 lanes, out = f ? p : acc + p, where a row's first lane starts a
// segment.
//
// What bounds it on the H100. The multiply-rate bound counts the adds the
// data needs (31 µs for the whole (80, 24, 2048) call over 132 SMs), but a
// scan cannot reach it: it puts 2·run + log2(threads) + 1 complete adds
// in series, and one warp alone takes ~5.8 µs for an add in one thread,
// ~3.2 µs split over two lanes, ~2.5 µs over four (PERF.md §6, design
// measurements):
// a lone warp already fills its SM sub-partition's issue (two independent
// Montgomery products in one thread take twice one), so the chain's length
// in issued instructions is the bound. Every call on the path (rows of 16
// to 2048 lanes, 4 to 896 rows) is bound by that chain at the card's
// occupancy, not by the multiply rate.
// A row in one block would leave 52 of the 132 SMs idle at the largest
// shape, and a Hillis–Steele scan of its run totals in shared memory adds
// ~2.7 times a lane with two block barriers a level. This design:
// - Splits each add over two lanes that hold the same pair (SplitLayer):
//   each computes 3 of a layer's 6 products and reads the other 3 with
//   shuffles, so an add's chain is 6 products long, not 12. A warp is
//   G = 16 threads of the scan.
// - Puts a row on a thread-block cluster of C blocks (cudaLaunchKernelEx
//   with a cluster dimension, one launch a call). A thread of the scan
//   owns `run` consecutive lanes; the wrapper picks the least power of two
//   that keeps a row at ≤ 256 threads and the call at ≤ 16,384 (what the
//   card keeps resident: more only queues), so a long row is spread over
//   several SMs and a short one keeps its chain short. The result depends
//   on `run` and G only, not on C or the block size. One block a row (the
//   same kernel at C = 1, with runs twice as long where a row would exceed
//   a block) is within 6% of it at 70 and 80 rows but 1.25–2.2 times
//   slower at 20 and 60 rows (PERF.md §6, design measurements).
// - Scans work-efficiently: each thread reduces its run (run − 1 adds,
//   nothing written); each warp scans its 16 (sum, has-start) pairs with
//   shuffles of the 24 words (4 levels); warp 0 of each block reads the
//   row's ≤ 16 warp totals from the cluster's blocks (distributed shared
//   memory), scans them (≤ 4 levels) and hands each warp of its block its
//   prefix; each thread forms its exclusive prefix (one add) and walks its
//   run again from it, writing every lane once. Each walk requests the
//   next lane's point before the add of this one; the second reads its
//   inputs from L1 or L2. Nothing is added through shared memory.
// - 180 registers a thread: at 128 threads a block an SM holds 2 blocks
//   (8 warps). A cap of 128 registers for more warps spills; it was not
//   kept.
// Pairs are combined as (a earlier, b later): a missing pair (a lane past
// the row's end) neither changes one nor takes one; b with a start keeps
// its sum, else the sum is ec_add(a, b). The twin in kernels/ec.py repeats
// this association, so the two agree limb for limb.
constexpr int kTileMaxWarps = 8;        // warps a block (blockDim ≤ 256)
constexpr uint32_t kHas = 1, kOk = 2;   // pair flags: has a start, exists

// One layer of independent products in the field M split over a group of
// L lanes that hold the same operands: lane j computes products j, j + L,
// ... and every lane reads the others back with shuffles inside its
// group, so a layer of N products costs the latency of ceil(N / L) of
// them.
template <int L, class M>
struct SplitLayer {
  int j;           // this lane's place in its group
  unsigned mask;   // the group's lanes

  template <int N>
  __device__ __forceinline__ void operator()(
      const uint32_t* const (&a)[N], const uint32_t* const (&b)[N],
      uint32_t* const (&r)[N]) const {
#pragma unroll
    for (int k = 0; k < N; k += L) {
      uint32_t x[8], y[8], t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] = a[k][i];
        y[i] = b[k][i];
      }
#pragma unroll
      for (int m = 1; m < L; ++m) {
        if (k + m < N) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            x[i] = j == m ? a[k + m][i] : x[i];
            y[i] = j == m ? b[k + m][i] : y[i];
          }
        }
      }
      zk::mont_mul<M>(x, y, t);
#pragma unroll
      for (int m = 0; m < L; ++m) {
        if (k + m < N) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            r[k + m][i] = __shfl_sync(mask, t[i], m, L);
        }
      }
    }
  }
};

struct Pair {
  zk::Pt v;
  uint32_t fl;
};

// b <- a ∘ b on curve C
template <class C, class Layer>
__device__ __forceinline__ void combine(const Layer& mul, const Pair& a,
                                        Pair& b) {
  if (!(a.fl & kOk) || !(b.fl & kOk)) return;
  if (!(b.fl & kHas)) zk::ec_add_by<Layer, C>(mul, a.v, b.v, b.v);
  b.fl |= a.fl;
}

// The pair held `d` lanes below (up) or at lane `src` (not up).
__device__ __forceinline__ Pair shfl_pair(const Pair& p, int src, bool up) {
  Pair q;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    q.v.x[i] = up ? __shfl_up_sync(0xFFFFFFFFu, p.v.x[i], src)
                  : __shfl_sync(0xFFFFFFFFu, p.v.x[i], src);
    q.v.y[i] = up ? __shfl_up_sync(0xFFFFFFFFu, p.v.y[i], src)
                  : __shfl_sync(0xFFFFFFFFu, p.v.y[i], src);
    q.v.z[i] = up ? __shfl_up_sync(0xFFFFFFFFu, p.v.z[i], src)
                  : __shfl_sync(0xFFFFFFFFu, p.v.z[i], src);
  }
  q.fl = up ? __shfl_up_sync(0xFFFFFFFFu, p.fl, src)
            : __shfl_sync(0xFFFFFFFFu, p.fl, src);
  return q;
}

__device__ __forceinline__ void put_pair(uint32_t* sv, uint32_t* sf, int k,
                                         const Pair& p) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sv[24 * k + i] = p.v.x[i];
    sv[24 * k + 8 + i] = p.v.y[i];
    sv[24 * k + 16 + i] = p.v.z[i];
  }
  sf[k] = p.fl;
}

__device__ __forceinline__ void get_pair(const uint32_t* sv,
                                         const uint32_t* sf, int k, Pair& p) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p.v.x[i] = sv[24 * k + i];
    p.v.y[i] = sv[24 * k + 8 + i];
    p.v.z[i] = sv[24 * k + 16 + i];
  }
  p.fl = sf[k];
}

// kScanLanes lanes a thread of the scan; G of them a warp (kernels/ec.py's
// SCAN_LANES and its twin's warp width).
constexpr int kScanLanes = 2;

template <class C>
__global__ void __launch_bounds__(kTileMaxWarps * 32)
seg_scan_tiles_kernel(const uint32_t* __restrict__ p,
                      const uint8_t* __restrict__ f, uint32_t* __restrict__ o,
                      int64_t n, int run) {
  constexpr int L = kScanLanes, G = 32 / L;
  __shared__ uint32_t tv[kTileMaxWarps * 24], tf[kTileMaxWarps];  // totals
  __shared__ uint32_t xv[kTileMaxWarps * 24], xf[kTileMaxWarps];  // prefixes
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nt = blockDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = lane % L, q = lane / L;        // place in group, group
  using Layer = SplitLayer<L, typename C::F>;
  const Layer mul{j, ((1u << L) - 1) << (lane - j)};
  const int bw = nt >> 5;                      // warps a block
  const int nwarps = nblk * bw;                // warps of the row (≤ G)
  const int64_t b = blockIdx.x / nblk;
  const uint32_t* pb = p + b * 24 * n;
  const uint8_t* fb = f + b * n;
  uint32_t* ob = o + b * 24 * n;
  const int64_t e0 = ((int64_t)(rank * bw + warp) * G + q) * run;
  const int64_t e1 = e0 + run < n ? e0 + run : n;

  // 1. this thread's run: its sum since its last segment start
  Pair mine;
  mine.fl = 0;
  zk::Pt x, next;
  bool nst = false;
  if (e0 < e1) {
    zk::load_pt(pb, n, e0, next);
    nst = e0 == 0 || fb[e0];
  }
  for (int64_t e = e0; e < e1; ++e) {
    x = next;
    const bool st = nst;
    if (e + 1 < e1) {
      zk::load_pt(pb, n, e + 1, next);
      nst = fb[e + 1];
    }
    if (e == e0 || st)
      mine.v = x;
    else
      zk::ec_add_by<Layer, C>(mul, mine.v, x, mine.v);
    mine.fl |= kOk | (st ? kHas : 0u);
  }
  // 2. inclusive scan of the warp's G pairs
#pragma unroll 1
  for (int d = 1; d < G; d <<= 1) {
    const Pair a = shfl_pair(mine, d * L, true);
    if (q >= d) combine<C>(mul, a, mine);
  }
  Pair acc = shfl_pair(mine, L, true);         // the pair of the thread
  if (q == 0) acc.fl = 0;                      // before
  if (lane == 32 - L) put_pair(tv, tf, warp, mine);
  cluster.sync();
  // 3. warp 0 of each block scans the row's warp totals on its threads
  //    and hands each warp of the block the pair of the warps before it
  if (warp == 0) {
    Pair w;
    w.fl = 0;
    if (q < nwarps)
      get_pair(cluster.map_shared_rank(tv, q / bw),
               cluster.map_shared_rank(tf, q / bw), q % bw, w);
#pragma unroll 1
    for (int d = 1; d < nwarps; d <<= 1) {
      const Pair a = shfl_pair(w, d * L, true);
      if (q >= d) combine<C>(mul, a, w);
    }
    const int first = rank * bw;               // this block's first warp
    const int src = first + q - 1;
    const Pair pre = shfl_pair(w, (src >= 0 && src < G ? src : 0) * L + j,
                               false);
    if (q < bw && j == 0) {
      Pair r = pre;
      if (src < 0) r.fl = 0;
      put_pair(xv, xf, q, r);
    }
  }
  // done with the other blocks' shared memory: they may leave after the
  // wait at the end
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __syncthreads();
  // 4. the exclusive prefix of this thread, then its run again
  Pair wp;
  get_pair(xv, xf, warp, wp);
  if (!(acc.fl & kOk))
    acc = wp;
  else
    combine<C>(mul, wp, acc);
  if (e0 < e1) zk::load_pt(pb, n, e0, next);
  for (int64_t e = e0; e < e1; ++e) {
    x = next;
    const bool st = e == 0 || fb[e];
    if (e + 1 < e1) zk::load_pt(pb, n, e + 1, next);
    if (st || !(acc.fl & kOk)) {
      acc.v = x;
      acc.fl = kOk;
    } else {
      zk::ec_add_by<Layer, C>(mul, acc.v, x, acc.v);
    }
    if (j == 0) zk::store_pt(ob, n, e, acc.v);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// One layer of independent products in the field M across the lanes of a
// warp: lane j (of each group of 8) computes product j (lanes past the
// layer's width repeat product 0), and every lane reads all of the layer's
// products back with shuffles, so a layer costs the latency of one
// product.
template <class M>
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
    zk::mont_mul<M>(x, y, t);
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
template <class C>
__global__ void __launch_bounds__(kThreads)
scale_reduce_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ o,
                    int64_t batch, int64_t nlive, int c) {
  int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (b >= batch) return;                // whole warps leave together
  using Layer = WarpLayer<typename C::F>;
  const Layer mul{lane & 7};
  const uint32_t* pb = p + b * 24 * nlive;
  zk::Pt acc, x;
  zk::load_pt(pb, nlive, nlive - 1, acc);
  for (int64_t w = nlive - 2; w >= 0; --w) {
    for (int j = 0; j < c; ++j) zk::ec_dbl_by<Layer, C>(mul, acc, acc);
    zk::load_pt(pb, nlive, w, x);
    zk::ec_add_by<Layer, C>(mul, acc, x, acc);
  }
  if (lane == 0) zk::store_pt(o + b * 24, 1, 0, acc);
}

unsigned grid(int64_t work, int threads) {
  return (unsigned)((work + threads - 1) / threads);
}

// The instance of a kernel on `curve` (0 BN254, 1 pallas), or nullptr.
template <class Fn>
Fn* on_curve(int curve, Fn* bn254, Fn* pallas) {
  return curve == 0 ? bn254 : curve == 1 ? pallas : nullptr;
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError();
// an unknown curve is cudaErrorInvalidValue.
// curve: 0 = BN254 G1, 1 = Pasta pallas.
extern "C" int zk_ec_add(const void* p, const void* q, void* o,
                         long long batch, long long n, int curve,
                         void* stream) {
  if (batch * n == 0) return 0;
  const auto kernel = on_curve(curve, ec_add_kernel<zk::Bn254>,
                               ec_add_kernel<zk::Pallas>);
  if (!kernel) return (int)cudaErrorInvalidValue;
  kernel<<<grid(batch * n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)o, batch, n);
  return (int)cudaGetLastError();
}

// Kernel 9 in one of its three forms (see seg_step_kernel): keep for
// the natural and gathered forms, qidx (nullable) for the gathered one,
// fs and W > 0 for the chains form (then keep and qidx are null and
// nq = W); o may be p. A block
// takes `tile` elements (a multiple of 32, ≤ 2048), or where tile is 0:
// in the chains form kThreads, in the others the least multiple of 32
// that makes the call one wave of the blocks the card holds at once (at
// most 2048).
extern "C" int zk_seg_step(const void* p, const void* q, const void* keep,
                           const void* qidx, const void* fs, void* o,
                           long long batch, long long n, long long nq,
                           long long W, int tile, int curve, void* stream) {
  if (batch * n == 0) return 0;
  const auto kernel = on_curve(curve, seg_step_kernel<zk::Bn254>,
                               seg_step_kernel<zk::Pallas>);
  const bool chains = W > 0;
  if (!kernel || tile < 0 || tile > kStepMaxTile || tile % 32 ||
      batch * n > 0x7FFFFFFFLL || chains != (fs != nullptr) ||
      chains == (keep != nullptr) ||
      (chains && (qidx != nullptr || n % W || nq != W)))
    return (int)cudaErrorInvalidValue;
  // blocks the card holds at once, per instance
  static int resident[2] = {0, 0};
  if (!resident[curve]) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (sms * per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    resident[curve] = sms * per_sm;
  }
  if (!tile && chains) tile = kThreads;
  if (!tile) {
    const long long per = (batch * n + resident[curve] - 1) / resident[curve];
    tile = (int)((per + 31) / 32 * 32);
    if (tile > kStepMaxTile) tile = kStepMaxTile;
  }
  SegStep a;
  a.p = (const uint32_t*)p;
  a.q = (const uint32_t*)q;
  a.keep = (const uint8_t*)keep;
  a.qidx = (const int64_t*)qidx;
  a.fs = (const int64_t*)fs;
  a.o = (uint32_t*)o;
  a.batch = batch;
  a.n = n;
  a.nq = nq;
  a.W = W;
  a.tile = tile;
  const long long blocks = (batch * n + tile - 1) / tile;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel 11 in one of its two forms (see chain_scan_kernel): idx null for
// the dense form; given, p is the point-major (m, 3, 8) table (16-byte
// aligned) and idx and f are in the rows' sorted order.
extern "C" int zk_chain_scan(const void* p, const void* idx, const void* f,
                             void* o, long long batch, long long n,
                             long long W, int curve, void* stream) {
  if (batch * n == 0) return 0;
  const auto kernel =
      idx ? on_curve(curve, chain_scan_kernel<zk::Bn254, true>,
                     chain_scan_kernel<zk::Pallas, true>)
          : on_curve(curve, chain_scan_kernel<zk::Bn254, false>,
                     chain_scan_kernel<zk::Pallas, false>);
  if (!kernel || W < 1 || n % W ||
      (idx && reinterpret_cast<uintptr_t>(p) % 16))
    return (int)cudaErrorInvalidValue;
  kernel<<<grid(batch * W, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const int64_t*)idx, (const uint8_t*)f,
      (uint32_t*)o, batch, n, W);
  return (int)cudaGetLastError();
}

// Each row is a cluster of `cluster` blocks of `threads` threads (a
// multiple of 32, ≤ 256), each pair of lanes a thread of the scan owning
// `run` lanes of the row: cluster·threads / 2 · run ≥ n, and a row has at
// most 16 warps. A cluster launch the card refuses is returned as its
// error, not run another way.
extern "C" int zk_seg_scan_tiles(const void* p, const void* f, void* o,
                                 long long batch, long long n, int run,
                                 int threads, int cluster, int curve,
                                 void* stream) {
  if (batch * n == 0) return 0;
  const auto kernel = on_curve(curve, seg_scan_tiles_kernel<zk::Bn254>,
                               seg_scan_tiles_kernel<zk::Pallas>);
  if (!kernel || threads % 32 || threads > kTileMaxWarps * 32 ||
      cluster < 1 || cluster * (threads / 32) > 32 / kScanLanes ||
      (long long)cluster * threads / kScanLanes * run < n)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const uint32_t*)p, (const uint8_t*)f, (uint32_t*)o,
      (int64_t)n, run);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int zk_scale_reduce(const void* p, void* o, long long batch,
                               long long nlive, int c, int curve,
                               void* stream) {
  if (batch == 0) return 0;
  const auto kernel = on_curve(curve, scale_reduce_kernel<zk::Bn254>,
                               scale_reduce_kernel<zk::Pallas>);
  if (!kernel) return (int)cudaErrorInvalidValue;
  kernel<<<grid(batch, kReduceRows), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (uint32_t*)o, batch, nlive, c);
  return (int)cudaGetLastError();
}
