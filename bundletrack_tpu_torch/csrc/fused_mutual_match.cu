// Fused descriptor matching with geometric gating, for Hopper (sm_90a).
//
// Replaces the TPU kernel bundletrack_tpu/pallas_kernels/matching.py
// (fused_mutual_match, body _match_kernel).  For each of P frame pairs and
// each A-keypoint i it computes, over the B-keypoints j:
//   dist[i,j]  = |a_i|^2 + |b_j|^2 - 2 * dot(bf16(a_i), bf16(b_j))   (f32 norms,
//                f32 accumulation; every bf16 x bf16 product is exact in f32)
//   gate[i,j]  = (wa_i - wb_j)^2 summed in exact f32 < max_dist^2
//                and  na_i . nb_j > cos(max_normal_deg)
//   gated      = gate ? dist : 1e30
//   best_b[i]  = argmin_j gated[i,j]   (first index wins ties, as jnp.argmin)
//   dist[i]    = min_j gated[i,j]      (1e30 when no column passes)
//   mutual[i]  = dist[i] < 1e30 && dist[i] <= min_i' gated[i', best_b[i]]
// Invalid keypoints arrive moved to +-1e4 by the wrapper, so the gate drops them.
//
// Bound at the main-path shapes (P=120, N=512, D=256): the inputs as given
// are 2*P*N*D*4 B ~= 126 MB of descriptors (~38 us at 3.35 TB/s), and the
// products are 2*P*N^2*D ~= 16.1 GFLOP (~16 us at the 989 TFLOP/s bf16
// tensor-core rate), so reading the inputs bounds it: memory-bound.
//
// Design: simple and correct, two passes.  One pair's [N,N] f32 tile is 1 MB
// and does not fit in a block's 227 KB of shared memory, and the column
// minimum spans every row, so:
//   pass 1, grid (ceil(N/64), P): a block takes 64 A-rows as bf16 in shared
//     memory, walks the B side in 64-column tiles (ascending), computes the
//     64x64 gated distances on CUDA cores, keeps a running row min/argmin,
//     and writes each tile's partial column minimum to a scratch buffer
//     [P, ceil(N/64), N] f32;
//   pass 2, grid (P): reduces the column minimum over the row tiles and
//     sets mutual[i] = has[i] && row_min[i] <= col_min[best_b[i]]
//     (gated[i, best_b[i]] == row_min[i]).
// No atomics, so the result is deterministic.  The gate is computed with
// __fmul_rn/__fadd_rn so no multiply-add contraction changes its rounding:
// it is bit-identical to the plain PyTorch version.
//
// Later work, not this kernel: read the [K,N,D] descriptor table in place of
// the gathered [P,N,D] copies (~8.4 MB of input instead of ~126 MB), and run
// the dot on the tensor cores with wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;              // A-rows per block, B-columns per tile
constexpr int TDIM = 16;              // 16 x 16 threads
constexpr int THREADS = TDIM * TDIM;  // each thread owns 4 rows x 4 columns
constexpr int RPT = TILE / TDIM;      // 4
constexpr float BIG = 1e30f;
constexpr int GEO = 7;                // x y z nx ny nz |b|^2 per B-column

// words (bf16 pairs) per shared-memory row: odd, so the 16 columns a
// half-warp reads sit in 16 different banks
__host__ __device__ inline int row_words(int D) {
  int w = (D + 1) / 2;
  return (w % 2 == 0) ? w + 1 : w;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// bf16 copy of `rows` rows (row-major, padded to W words) plus f32 norms
__device__ void load_tile(const float* __restrict__ src, int row0, int N, int D, int W,
                          __nv_bfloat162* dst, float* norm) {
  const int tid = threadIdx.y * TDIM + threadIdx.x;
  for (int idx = tid; idx < TILE * W; idx += THREADS) {
    const int r = idx / W, k = 2 * (idx % W), gr = row0 + r;
    float x = 0.f, y = 0.f;
    if (gr < N) {
      const float* p = src + (size_t)gr * D;
      if (k < D) x = p[k];
      if (k + 1 < D) y = p[k + 1];
    }
    dst[idx] = __floats2bfloat162_rn(x, y);
  }
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < TILE; r += THREADS / 32) {
    const int gr = row0 + r;
    float s = 0.f;
    if (gr < N) {
      const float* p = src + (size_t)gr * D;
      for (int k = lane; k < D; k += 32) s = fmaf(p[k], p[k], s);
    }
    s = warp_sum(s);
    if (lane == 0) norm[r] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
match_rows_kernel(const float* __restrict__ desc_a, const float* __restrict__ desc_b,
                  const float* __restrict__ wa, const float* __restrict__ wb,
                  const float* __restrict__ na, const float* __restrict__ nb,
                  int N, int D, float max_dist_sq, float cos_thresh,
                  int* __restrict__ best_b, float* __restrict__ best_dist,
                  float* __restrict__ col_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = row_words(D);
  __nv_bfloat162* As = reinterpret_cast<__nv_bfloat162*>(smem);  // [TILE][W]
  __nv_bfloat162* Bs = As + TILE * W;                             // [TILE][W]
  float* geo_b = reinterpret_cast<float*>(Bs + TILE * W);         // [GEO][TILE]
  float* col_red = geo_b + GEO * TILE;                            // [TDIM][TILE]
  float* norm_a = col_red + TDIM * TILE;                          // [TILE]

  const int p = blockIdx.y, row_tile = blockIdx.x, row0 = row_tile * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TDIM + tx;
  const size_t pair_nd = (size_t)p * N * D, pair_n3 = (size_t)p * N * 3;

  load_tile(desc_a + pair_nd, row0, N, D, W, As, norm_a);

  // this thread's 4 A-rows: geometry in registers
  float ax[RPT][6];
  bool row_ok[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gr = row0 + ty + TDIM * i;
    row_ok[i] = gr < N;
    const int g = row_ok[i] ? gr : 0;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      ax[i][q] = wa[pair_n3 + (size_t)g * 3 + q];
      ax[i][3 + q] = na[pair_n3 + (size_t)g * 3 + q];
    }
  }
  float rbv[RPT];
  int rbi[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) { rbv[i] = __int_as_float(0x7f800000); rbi[i] = 0; }

  for (int c0 = 0; c0 < N; c0 += TILE) {
    __syncthreads();  // the previous tile's Bs/geo_b/col_red are no longer read
    load_tile(desc_b + pair_nd, c0, N, D, W, Bs, geo_b + 6 * TILE);
    for (int idx = tid; idx < 6 * TILE; idx += THREADS) {
      const int q = idx / TILE, c = idx % TILE, gc = c0 + c;
      const float* src = q < 3 ? wb : nb;
      geo_b[idx] = gc < N ? src[pair_n3 + (size_t)gc * 3 + (q % 3)] : 0.f;
    }
    __syncthreads();

    float acc[RPT][RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) acc[i][j] = 0.f;
    const int KW = (D + 1) / 2;
    for (int k2 = 0; k2 < KW; ++k2) {
      float2 a[RPT], b[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = __bfloat1622float2(As[(ty + TDIM * i) * W + k2]);
#pragma unroll
      for (int j = 0; j < RPT; ++j) b[j] = __bfloat1622float2(Bs[(tx + TDIM * j) * W + k2]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        }
    }

    float cmin[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) cmin[j] = __int_as_float(0x7f800000);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int c = tx + TDIM * j, gc = c0 + c;
      if (gc >= N) continue;
      const float bx = geo_b[c], by = geo_b[TILE + c], bz = geo_b[2 * TILE + c];
      const float bnx = geo_b[3 * TILE + c], bny = geo_b[4 * TILE + c], bnz = geo_b[5 * TILE + c];
      const float nb2 = geo_b[6 * TILE + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (!row_ok[i]) continue;
        const int r = ty + TDIM * i;
        const float dist = __fsub_rn(__fadd_rn(norm_a[r], nb2), __fmul_rn(2.f, acc[i][j]));
        const float dx = __fsub_rn(ax[i][0], bx), dy = __fsub_rn(ax[i][1], by),
                    dz = __fsub_rn(ax[i][2], bz);
        float d2 = __fmul_rn(dx, dx);
        d2 = __fadd_rn(d2, __fmul_rn(dy, dy));
        d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
        float cs = __fmul_rn(ax[i][3], bnx);
        cs = __fadd_rn(cs, __fmul_rn(ax[i][4], bny));
        cs = __fadd_rn(cs, __fmul_rn(ax[i][5], bnz));
        const float g = (d2 < max_dist_sq && cs > cos_thresh) ? dist : BIG;
        if (better(g, gc, rbv[i], rbi[i])) { rbv[i] = g; rbi[i] = gc; }
        cmin[j] = fminf(cmin[j], g);
      }
    }
    // column minimum of this row tile: reduce the 16 thread rows in shared memory
#pragma unroll
    for (int j = 0; j < RPT; ++j) col_red[ty * TILE + tx + TDIM * j] = cmin[j];
    __syncthreads();
    if (tid < TILE && c0 + tid < N) {
      float m = col_red[tid];
      for (int t = 1; t < TDIM; ++t) m = fminf(m, col_red[t * TILE + tid]);
      col_part[((size_t)p * gridDim.x + row_tile) * N + c0 + tid] = m;
    }
  }

  // row winners: reduce across the 16 threads (one half-warp) sharing a row
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float v = rbv[i];
    int idx = rbi[i];
    for (int off = TDIM / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
      if (better(ov, oi, v, idx)) { v = ov; idx = oi; }
    }
    if (tx == 0 && row_ok[i]) {
      const size_t o = (size_t)p * N + row0 + ty + TDIM * i;
      best_b[o] = idx;
      best_dist[o] = v;
    }
  }
}

__global__ void mutual_kernel(const int* __restrict__ best_b, const float* __restrict__ best_dist,
                              const float* __restrict__ col_part, int N, int row_tiles,
                              unsigned char* __restrict__ mutual) {
  extern __shared__ float col_min[];  // [N]
  const int p = blockIdx.x;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float m = __int_as_float(0x7f800000);
    for (int t = 0; t < row_tiles; ++t) m = fminf(m, col_part[((size_t)p * row_tiles + t) * N + c]);
    col_min[c] = m;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < N; r += blockDim.x) {
    const size_t o = (size_t)p * N + r;
    const float v = best_dist[o];
    mutual[o] = (v < BIG && v <= col_min[best_b[o]]) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// rows per pass-1 block: the scratch buffer is [P, ceil(N / tile), N] f32
int fused_mutual_match_row_tile() { return TILE; }

// All pointers are device pointers to contiguous tensors:
//   desc_a, desc_b [P,N,D] f32; wa, wb, na, nb [P,N,3] f32;
//   best_b [P,N] i32; best_dist [P,N] f32; mutual [P,N] u8;
//   col_part [P, ceil(N/64), N] f32 scratch.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError().
int fused_mutual_match_launch(const float* desc_a, const float* desc_b, const float* wa,
                              const float* wb, const float* na, const float* nb, int P, int N,
                              int D, float max_dist_sq, float cos_thresh, int* best_b,
                              float* best_dist, unsigned char* mutual, float* col_part,
                              void* stream) {
  if (P <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = row_words(D);
  const size_t smem = 2 * (size_t)TILE * W * sizeof(__nv_bfloat162) +
                      (size_t)(GEO + TDIM + 1) * TILE * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(match_rows_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int row_tiles = (N + TILE - 1) / TILE;
  match_rows_kernel<<<dim3(row_tiles, P), dim3(TDIM, TDIM), smem, s>>>(
      desc_a, desc_b, wa, wb, na, nb, N, D, max_dist_sq, cos_thresh, best_b, best_dist,
      col_part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mutual_kernel<<<P, 256, (size_t)N * sizeof(float), s>>>(best_b, best_dist, col_part, N,
                                                        row_tiles, mutual);
  return (int)cudaGetLastError();
}

}  // extern "C"
