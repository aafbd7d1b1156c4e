// The Gauss-Newton normal equations' per-pair blocks summed into the block
// matrix H and the vector g in one fixed order, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package scatter-adds the blocks with
// `.at[].add` (bundletrack_tpu/solver/residuals.py:81, scatter_blocks),
// which XLA's CPU backend adds in update order.  On the card index_add_
// adds them with f32 atomics in an order that changes from run to run, so
// the same inputs gave other bits in H and g from one call to the next, and
// a chaotic tracked pass (a long orbit on poor masks) landed elsewhere on
// every run.  This kernel adds each output entry's terms in one sequence,
// the one index_add_ follows on the CPU (the plain version,
// kernels/normal_blocks.py, which the CPU tests hold to jax.jit of the JAX
// function bit for bit):
//   H[b, r, c]: from +0.0, with plain f32 adds (__fadd_rn, no fast math),
//     every pair p in order whose (i, i) is (r, c), adding Hii[b, p]; then
//     every p with (j, j) = (r, c), adding Hjj[b, p]; then (i, j) = (r, c),
//     Hij[b, p]; then (j, i) = (r, c), Hij[b, p] transposed.
//   g[b, r]: every p with i = r, adding gi[b, p]; then every p with j = r,
//     adding gj[b, p].
// The pair indices [P] are shared by the batch; an index outside 0..K-1
// lands on no entry.
//
// What bounds it.  At K=16 frames and P=120 pairs a graph's H and g are
// 9312 floats and its blocks 14400: ~97 KB in all with the indices, 0.03 us
// at 3.35 TB/s, and the fleet's 8 graphs ~0.76 MB, 0.23 us; the adds are
// fewer still.  Neither bounds it: latency does.  An entry's chain cannot be
// split without changing its order, so the design shortens what stands in
// front of each chain and puts every block's chains on the card at once.
// What is left in front of a block's adds is two dependent device-memory
// round trips (its index tile, then its listed terms) with a barrier and at
// most 16 ballot steps between them, over the launch floor (an empty
// kernel: ~0.9 device us at one block, ~2.0 at the fleet's grid).  On an
// NVIDIA H100 (700 W) it takes ~5.3 device us at batch 1 and ~7.1 at batch
// 8, where the design before it (one thread per entry, each testing all 4P
// pairs and loading its matched terms inside its add chain) took ~18.3 and
// ~34.5 (blocks_bench, PERF.md).  A block whose list runs to hundreds of
// terms (a graph with many pairs on one frame pair) adds them a stage after
// another, each stage a device-memory round trip: ~62 us at K=2, P=300.
// -Xptxas -v (sm_90a): 56 registers, no spills, 11136 bytes of shared
// memory; __launch_bounds__ keeps 16 blocks resident per SM.
//
// Design: one block of 64 threads per 6x6 output block (b, r, c), B*K*K
// blocks (256 at K=16, batch 1; the fleet's batch 8, 2048, all resident at
// once on 132 SMs).  Lanes 0-35 add the entries of H[b, r, c]; on a
// diagonal block (r == c) lanes 36-41 add g[b, r], whose terms are those of
// the kinds (i, i) and (j, j): the first terms of the block's list.
//  1. The block stages the pair indices in shared memory as int32 (an index
//     outside 0..K-1 as -1), PAIR_TILE at a time, all loads issued at once.
//  2. It lists its terms once, in add order: for each kind in turn (an
//     off-diagonal block skips (i, i) and (j, j), which cannot land there;
//     a self pair i == j does land on (i, j) and (j, i) of a diagonal
//     block) both warps test 32 pairs a step, __ballot_sync the hits, and
//     warp 0 writes each hit (pair, kind) at its rank among the lower lanes'
//     (__popc), so the list keeps pair order; both warps count alike, so no
//     count is exchanged.  At P=120 that is 16 steps on a diagonal block
//     and 8 on the others, where the design before it made every thread test 480
//     pairs one after another.
//  3. It copies the listed terms' blocks (and 6-vectors) into shared memory,
//     TERM_TILE terms a stage, the warps taking alternate terms, a lane an
//     entry, every copy a cp.async issued before any completes (a (j, i)
//     term staged transposed), then after one barrier
//     each lane adds its entry of each term in list order from shared
//     memory: the chain waits on shared-memory reads, not on device memory.
//     A list that an index tile could take past LIST_CAP (many pairs on
//     one block, or P over one tile) is added before that tile, so a long
//     list is added in parts, in order; P over one index tile takes the
//     tiles in turn for each kind.
//  4. Every element of H and g is written, so the outputs need no zero fill.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 64;     // lanes 0-35: H's entries; 36-41: g's (diagonal blocks)
constexpr int MIN_BLOCKS = 16;  // resident per SM: the fleet's 2048 blocks on 132 SMs in one wave
constexpr int PAIR_TILE = 256;  // pair indices staged at a time
constexpr int LIST_CAP = 256;   // terms listed before they are added (>= PAIR_TILE)
constexpr int TERM_TILE = 48;   // terms staged in shared memory at a time
constexpr int SLOT = 42;        // floats of a staged term: its 6x6 block, then its 6-vector
static_assert(LIST_CAP >= PAIR_TILE, "one tile's terms of one kind must fit the list");

// no "memory" clobber: the list reads around it may be issued early; the
// stage is read only after cp_async_wait_all and a barrier
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ int frame_or_none(int64_t v, int K) { return v >= 0 && v < K ? (int)v : -1; }

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
normal_blocks_kernel(int K, int P, const int64_t* __restrict__ pair_i, const int64_t* __restrict__ pair_j,
                     const float* __restrict__ Hii, const float* __restrict__ Hjj, const float* __restrict__ Hij,
                     const float* __restrict__ gi, const float* __restrict__ gj, float* __restrict__ H,
                     float* __restrict__ g) {
  __shared__ int si[PAIR_TILE];
  __shared__ int sj[PAIR_TILE];
  __shared__ int list[LIST_CAP];  // (pair << 2) | kind, in add order
  __shared__ float stage[TERM_TILE * SLOT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // where entry lane (and 32 + lane) of a (j, i) term is read: its transpose
  const int lane_t = (lane % 6) * 6 + lane / 6, lane_t2 = ((32 + lane) % 6) * 6 + (32 + lane) / 6;
  const long long blk = blockIdx.x;  // (b * K + r) * K + c
  const int c = (int)(blk % K), r = (int)((blk / K) % K);
  const long long b = blk / ((long long)K * K);
  const bool diag = r == c;
  const long long first = b * P;  // graph b's first pair in the block arrays
  float acc = 0.0f;
  int count = 0;      // terms listed (block-uniform)
  int g_count = 0;    // of them the first g_count, kinds (i, i) and (j, j), also add to g
  int staged = -1;    // first pair of the index tile in si / sj

  // adds the listed terms in list order, TERM_TILE at a time; empties the list
  auto add_listed = [&]() {
    __syncthreads();  // warp 0's list is written
    for (int t0 = 0; t0 < count; t0 += TERM_TILE) {
      const int nt = min(TERM_TILE, count - t0);
      // warp w copies terms w, w + 2, ...: lane e entry e of the 6x6 block,
      // lanes 0-3 also entries 32-35, lanes 4-9 the 6-vector (kinds 0, 1)
#pragma unroll 2
      for (int t = warp; t < nt; t += 2) {
        const int term = list[t0 + t], kind = term & 3;
        const long long q = first + (term >> 2);
        const float* block = (kind == 0 ? Hii : kind == 1 ? Hjj : Hij) + q * 36;
        float* dst = &stage[t * SLOT];
        cp_async4(dst + lane, block + (kind == 3 ? lane_t : lane));
        if (lane < 4) {
          cp_async4(dst + 32 + lane, block + (kind == 3 ? lane_t2 : 32 + lane));
        } else if (lane < 10 && kind < 2) {
          cp_async4(dst + 32 + lane, (kind == 0 ? gi : gj) + q * 6 + (lane - 4));
        }
      }
      cp_async_wait_all();
      __syncthreads();
      const int n = tid < 36 ? nt : tid < 42 ? min(max(g_count - t0, 0), nt) : 0;
#pragma unroll 4
      for (int t = 0; t < n; ++t) acc = __fadd_rn(acc, stage[t * SLOT + tid]);
      __syncthreads();  // the stage and the list are read
    }
    count = g_count = 0;
  };

  for (int kind = diag ? 0 : 2; kind < 4; ++kind) {
    // kind 0: (i, i), 1: (j, j), 2: (i, j), 3: (j, i)
    const bool row_i = kind == 0 || kind == 2, col_i = kind == 0 || kind == 3;
    for (int p0 = 0; p0 < P; p0 += PAIR_TILE) {
      const int n = min(PAIR_TILE, P - p0);
      if (count + n > LIST_CAP) add_listed();
      if (staged != p0) {
        __syncthreads();  // every ballot has read the last tile
        for (int k = tid; k < n; k += THREADS) {
          si[k] = frame_or_none(pair_i[p0 + k], K);
          sj[k] = frame_or_none(pair_j[p0 + k], K);
        }
        __syncthreads();
        staged = p0;
      }
      for (int s = 0; s < n; s += 32) {
        const int k = s + lane;
        bool hit = false;
        if (k < n) {
          const int a = si[k], z = sj[k];
          hit = (row_i ? a : z) == r && (col_i ? a : z) == c;
        }
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit && tid < 32) list[count + __popc(m & ((1u << lane) - 1u))] = ((p0 + k) << 2) | kind;
        count += __popc(m);
      }
      if (kind < 2) g_count = count;
    }
  }
  add_listed();
  if (tid < 36) {
    H[blk * 36 + tid] = acc;
  } else if (tid < 42 && diag) {
    g[(b * K + r) * 6 + (tid - 36)] = acc;
  }
}

}  // namespace

extern "C" {

// pair_i, pair_j: [P] int64; Hii, Hjj, Hij: [B, P, 6, 6] f32; gi, gj:
// [B, P, 6] f32; H: [B, K, K, 6, 6] f32; g: [B, K, 6] f32; all contiguous
// on the device.  Every element of H and g is written.  Returns the CUDA
// error of the launch (0 when it was accepted).
int normal_blocks_launch(int B, int K, int P, const void* pair_i, const void* pair_j, const void* Hii,
                         const void* Hjj, const void* Hij, const void* gi, const void* gj, void* H, void* g,
                         void* stream) {
  if (B < 0 || K < 0 || P < 0 || P >= (1 << 29)) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * K * K;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  normal_blocks_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      K, P, (const int64_t*)pair_i, (const int64_t*)pair_j, (const float*)Hii, (const float*)Hjj,
      (const float*)Hij, (const float*)gi, (const float*)gj, (float*)H, (float*)g);
  return (int)cudaGetLastError();
}

}  // extern "C"
