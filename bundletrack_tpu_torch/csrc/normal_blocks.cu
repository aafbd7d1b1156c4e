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
// fewer still.  Neither bounds it: latency does.  Every thread tests 4P
// pairs against its entry (480 at P=120) from shared memory, one after
// another, and each matched term is a global load feeding its add chain
// (15 on a diagonal entry); a graph fills 37 blocks, two warps per
// scheduler, too few to hide either.  On an H100 it takes ~18 us of device
// time per launch at batch 1 (PERF.md).  An entry's chain cannot be split
// without changing its order; the design is the simplest that keeps the
// order and one launch per call, and skipping the scan (each entry's terms
// listed once per pair graph) is left for later.
//
// Design: one thread per output element, H's B*K*K*36 and then g's B*K*6,
// 256 threads a block; neighbouring threads take neighbouring entries of a
// 6x6 block, so their reads of a pair's block are coalesced and their index
// tests agree.  Each block stages the pair indices in shared memory, TILE
// pairs at a time, once per kind (the kinds are added one after another);
// every thread, in range or not, takes part in each stage.  The kernel
// writes every output element, so the outputs need no zero fill.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;  // pair indices staged in shared memory at a time

__global__ void __launch_bounds__(THREADS)
normal_blocks_kernel(int B, int K, int P, const int64_t* __restrict__ pair_i, const int64_t* __restrict__ pair_j,
                     const float* __restrict__ Hii, const float* __restrict__ Hjj, const float* __restrict__ Hij,
                     const float* __restrict__ gi, const float* __restrict__ gj, float* __restrict__ H,
                     float* __restrict__ g) {
  __shared__ int si[TILE];
  __shared__ int sj[TILE];
  const long long nH = (long long)B * K * K * 36;
  const long long nG = (long long)B * K * 6;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  // this thread's entry: graph b, block (r, c), element e (et transposed);
  // kinds it adds: 4 for H, 2 for g (its block is (r, r)), none out of range
  int r = -1, c = -1, e = 0, et = 0, kinds = 0, stride = 36;
  long long b = 0;
  const float* src[4] = {Hii, Hjj, Hij, Hij};
  if (t < nH) {
    e = (int)(t % 36);
    et = (e % 6) * 6 + e / 6;
    const long long q = t / 36;
    c = (int)(q % K);
    r = (int)((q / K) % K);
    b = q / ((long long)K * K);
    kinds = 4;
  } else if (t < nH + nG) {
    const long long u = t - nH;
    e = et = (int)(u % 6);
    r = c = (int)((u / 6) % K);
    b = u / (6LL * K);
    kinds = 2;
    stride = 6;
    src[0] = gi;
    src[1] = gj;
  }
  const long long base = b * P * stride;
  float acc = 0.0f;
  for (int kind = 0; kind < 4; ++kind) {
    // kind 0: (i, i), 1: (j, j), 2: (i, j), 3: (j, i)
    const bool row_i = kind == 0 || kind == 2, col_i = kind == 0 || kind == 3;
    const float* s = src[kind] + base + (kind == 3 ? et : e);
    for (int p0 = 0; p0 < P; p0 += TILE) {
      const int n = min(TILE, P - p0);
      __syncthreads();
      for (int k = threadIdx.x; k < n; k += THREADS) {
        si[k] = (int)pair_i[p0 + k];
        sj[k] = (int)pair_j[p0 + k];
      }
      __syncthreads();
      if (kind < kinds) {
        for (int k = 0; k < n; ++k) {
          const int pr = row_i ? si[k] : sj[k];
          const int pc = col_i ? si[k] : sj[k];
          if (pr == r && pc == c) acc = __fadd_rn(acc, s[(long long)(p0 + k) * stride]);
        }
      }
    }
  }
  if (t < nH) {
    H[t] = acc;
  } else if (t < nH + nG) {
    g[t - nH] = acc;
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
  if (B < 0 || K < 0 || P < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * K * K * 36 + (long long)B * K * 6;
  if (n == 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  normal_blocks_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      B, K, P, (const int64_t*)pair_i, (const int64_t*)pair_j, (const float*)Hii, (const float*)Hjj,
      (const float*)Hij, (const float*)gi, (const float*)gj, (float*)H, (float*)g);
  return (int)cudaGetLastError();
}

}  // extern "C"
