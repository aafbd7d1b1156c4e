// Fused descriptor matching with geometric gating over a frame table, for
// Hopper (sm_90a): bf16 products on the tensor cores (wgmma).
//
// Replaces the TPU kernel bundletrack_tpu/pallas_kernels/matching.py
// (fused_mutual_match, body _match_kernel).  Given a table of K frames
// (desc [K,N,D] f32, positions and normals [K,N,3], valid [K,N]) and P
// pairs (a, b) = (pair_i[p], pair_j[p]), for each A-keypoint i of frame a
// and each B-keypoint j of frame b:
//   dist[i,j]  = |a_i|^2 + |b_j|^2 - 2 * dot(bf16(a_i), bf16(b_j))   (f32 norms of the
//                f32 rows, f32 accumulation; every bf16 x bf16 product is exact in f32)
//   gate[i,j]  = (wa_i - wb_j)^2 summed x, y, z in exact f32 < max_dist^2
//                and  na_i . nb_j (x, y, z) > cos(max_normal_deg)
//   gated      = gate ? dist : 1e30
//   best_b[i]  = argmin_j gated[i,j]   (first index wins ties, as jnp.argmin)
//   dist[i]    = min_j gated[i,j]      (1e30 when no column passes; best_b is then 0)
//   mutual[i]  = dist[i] < 1e30 && dist[i] <= min_i' gated[i', best_b[i]]  (a tie is mutual)
// An invalid keypoint is moved to +1e4 when its frame is the A side and to
// -1e4 when it is the B side, so the gate drops it (and an invalid pair too).
//
// Bound at the main-path shapes (K=16, P=120, N=512, D=256), the largest of:
//   bytes:  the table once (8.39 MB of descriptors, 0.2 MB of geometry and
//           validity) plus the [P,N] outputs (0.55 MB) = 9.15 MB / 3.35 TB/s
//           = 0.0027 ms;
//   bf16 products: 2*P*N^2*D = 16.1 GFLOP / 989 TFLOP/s = 0.0163 ms;
//   gate and epilogue: ~20 f32 instructions per candidate (see gated_dist
//           and the epilogue) * P*N^2 = 0.63 G / (132 SMs * 128 lanes *
//           1.98 GHz) = 0.019 ms.
// So the epilogue's f32 instructions set the bound, not the products.
//
// The PR 1 design of this file ran 1.2806 ms (kernel alone, prepared
// tensors) and 1.5755 ms (wrapper) at those shapes on an H100 80GB HBM3 at
// 700 W (PERF.md), 33x its bound.  What held it back, and what this design
// does about each:
//   1. products on CUDA cores (scalar fmaf on bf16 values widened to f32)
//      -> pass 1 issues wgmma.m64n128k16 bf16 -> f32 on the tensor cores;
//   2. gathered [P,N,D] f32 copies (126 MB per frame) read back and each B
//      tile re-read and re-converted by every row-tile block
//      -> pass 0 converts the [K,N,D] table once (4.2 MB of bf16, which stays
//      in the 50 MB L2) and pass 1 reads it in place through pair_i/pair_j,
//      one bulk copy per tile;
//   3. separate device ops in the wrapper (where, full_like, contiguous)
//      -> pass 0 applies the validity move, the norms and the layout; the
//      wrapper only allocates and launches.
//
// Passes (all on the caller's stream, no host synchronisation):
//   pass 0, prepare_kernel, one warp per table row (K * Np rows, N padded
//     to the 128-row tile with zero rows):
//       - a bf16 copy of the descriptors, D zero-padded to Dp (a multiple of
//         16, wgmma's depth), in the byte order of wgmma's no-swizzle K-major
//         operand (core_matrix_offset): any run of whole 8-row groups is one
//         contiguous block, so a tile is one cp.async.bulk (no tensor map);
//       - the f32 squared norm of each f32 row;
//       - the A-side geometry [K,Np,8] (x y z nx ny nz |d|^2 0, invalid moved
//         to +1e4) and the B-side geometry in 128-column tiles, component-major
//         [K,Np/128,8,128] (invalid moved to -1e4): one frame is A in some
//         pairs and B in others, so both sides are written;
//       - the column-minimum buffer [P,N] set to the image of +inf.
//   pass 1, match_kernel, grid (Np/128 row tiles, P), 256 threads = two
//     warpgroups, 64 A-rows each:
//       - the A tile (128 x Dp bf16, 64 KB at Dp=256) lands once by bulk
//         copy; B streams in 128-column tiles (desc + geometry) through a ring
//         of 2 stages, each with an mbarrier that counts the copy's bytes;
//       - per B tile, each warpgroup issues Dp/16 wgmma.m64n128k16, waits, and
//         runs the epilogue on its 64 accumulator registers: the distance from
//         the norms, the exact-f32 gate from its rows' geometry (registers)
//         and the tile's columns (shared memory), a running row min/argmin per
//         thread (columns visited in ascending order, so the first index wins),
//         and each column's minimum over the block's rows, reduced across the
//         8 lanes that share it (a reduce-scatter: 28 shuffles for 32
//         columns), then across the 8 warps in shared memory;
//       - the block's column minima go to the [P,N] buffer with atomicMin on
//         the order-preserving integer image of the float (negative values
//         included); min is exact and order-free, so the result is
//         deterministic;
//       - at the end, each row's (value, index) pairs are merged across the
//         4 lanes of its quad, smaller value first, then smaller index.
//     One thread issues the bulk copies after the block barrier that frees a
//     stage; there is no producer warp and no setmaxnreg: the block holds
//     one B tile in flight while it computes the other, which is enough at
//     4 B tiles per block.
//   pass 2, mutual_kernel, over P * N rows: mutual = dist < 1e30 &&
//     dist <= column minimum at best_b.
//
// The gate uses __fmul_rn/__fadd_rn so no multiply-add contraction changes
// its rounding: it is bit-identical to the plain PyTorch version.  The
// distance's dot sums in the tensor cores' order, ~1e-6 from the plain
// version's f32 matmul on O(1) distances.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ptx.cuh"

namespace {

constexpr int BM = 128;      // A rows per block: two warpgroups x 64 (wgmma m)
constexpr int BN = 128;      // B columns per tile (wgmma n)
constexpr int STAGES = 2;    // B tiles in flight
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DP = 256;  // A tile + 2 B tiles = 192 KB of shared memory at Dp=256
constexpr int GEO = 8;       // x y z nx ny nz |d|^2 0 per keypoint
constexpr float BIG = 1e30f;
constexpr float FAR = 1e4f;
constexpr unsigned ORDERED_INF = 0xFF800000u;  // ordered(+inf)
static_assert(BM == BN, "an A tile and a B tile share one size and one layout");
static_assert(BM == 2 * 64 && THREADS == 2 * 128, "two warpgroups, one wgmma m64 each");

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Byte offset of (row r, element k) in one frame's bf16 block: 8-row groups
// one after the other (16*Dp bytes each), inside a group the 8x8 core
// matrices along K (128 bytes each), inside a core matrix row-major.  So
// the descriptor's K stride (LBO) is 128 and its row-group stride (SBO) 16*Dp.
__device__ __forceinline__ size_t core_matrix_offset(int r, int k, int Dp) {
  return (size_t)(r >> 3) * (16 * Dp) + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

// order-preserving map of a float to an unsigned int, negatives included
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_ordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

struct Workspace {
  size_t table, geo_a, geo_b, col_min, total;
};

Workspace workspace_layout(int K, int N, int D, int P) {
  const size_t Np = round_up(N, BM), Dp = round_up(D, 16);
  Workspace w{};
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += (bytes + 255) / 256 * 256;
    return at;
  };
  w.table = take((size_t)K * Np * Dp * 2);
  w.geo_a = take((size_t)K * Np * GEO * 4);
  w.geo_b = take((size_t)K * Np * GEO * 4);
  w.col_min = take((size_t)P * N * 4);
  w.total = off;
  return w;
}

// ---- pass 0 ------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
prepare_kernel(const float* __restrict__ desc, const float* __restrict__ world,
               const float* __restrict__ wnrm, const unsigned char* __restrict__ valid, int K,
               int N, int D, int Np, int Dp, unsigned char* __restrict__ table,
               float* __restrict__ geo_a, float* __restrict__ geo_b,
               unsigned* __restrict__ col_min, int PN) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < PN; i += gridDim.x * blockDim.x)
    col_min[i] = ORDERED_INF;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= K * Np) return;
  const int f = row / Np, r = row % Np;
  const bool in = r < N;
  const float* src = desc + ((size_t)f * N + (in ? r : 0)) * D;
  unsigned char* frame = table + (size_t)f * Np * Dp * 2;

  float s = 0.f;
  for (int kc = lane; kc < Dp / 8; kc += 32) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = kc * 8 + e;
      v[e] = (in && k < D) ? src[k] : 0.f;
      s = fmaf(v[e], v[e], s);
    }
    const uint4 packed = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
    *reinterpret_cast<uint4*>(frame + core_matrix_offset(r, kc * 8, Dp)) = packed;
  }
  s = warp_sum(s);

  if (lane < GEO) {
    const size_t kp = (size_t)f * N + (in ? r : 0);
    const bool ok = in && valid[kp];
    float ga = 0.f, gb = 0.f;
    if (lane < 3) {
      ga = ok ? world[kp * 3 + lane] : FAR;
      gb = ok ? world[kp * 3 + lane] : -FAR;
    } else if (lane < 6) {
      ga = gb = in ? wnrm[kp * 3 + lane - 3] : 0.f;
    } else if (lane == 6) {
      ga = gb = s;
    }
    geo_a[((size_t)f * Np + r) * GEO + lane] = ga;
    geo_b[(((size_t)f * (Np / BN) + r / BN) * GEO + lane) * BN + r % BN] = gb;
  }
}

// ---- pass 1 ------------------------------------------------------------------

// the gated distance of one candidate: with the row and column minimum in
// the epilogue, 22 f32 instructions (counted in chip_smoke.py's bound)
__device__ __forceinline__ float gated_dist(float dot, float na2, const float (&a)[6], float nb2,
                                            float bx, float by, float bz, float bnx, float bny,
                                            float bnz, float max_dist_sq, float cos_thresh) {
  // (na2 + nb2) - 2*dot: 2*dot is exact, so the fma rounds once, as the
  // plain version's subtraction does
  const float dist = fmaf(-2.f, dot, __fadd_rn(na2, nb2));
  const float dx = __fsub_rn(a[0], bx), dy = __fsub_rn(a[1], by), dz = __fsub_rn(a[2], bz);
  float d2 = __fmul_rn(dx, dx);
  d2 = __fadd_rn(d2, __fmul_rn(dy, dy));
  d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
  float cs = __fmul_rn(a[3], bnx);
  cs = __fadd_rn(cs, __fmul_rn(a[4], bny));
  cs = __fadd_rn(cs, __fmul_rn(a[5], bnz));
  return (d2 < max_dist_sq && cs > cos_thresh) ? dist : BIG;
}

__global__ void __launch_bounds__(THREADS, 1)
match_kernel(const unsigned char* __restrict__ table, const float* __restrict__ geo_a,
             const float* __restrict__ geo_b, const int* __restrict__ pair_i,
             const int* __restrict__ pair_j, int K, int N, int Np, int Dp, float max_dist_sq,
             float cos_thresh, int* __restrict__ best_b, float* __restrict__ best_dist,
             unsigned* __restrict__ col_min) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t tile_bytes = (uint32_t)BN * Dp * 2;  // == BM * Dp * 2
  const uint32_t geo_bytes = GEO * BN * 4;
  unsigned char* sA = smem;
  unsigned char* sB = sA + tile_bytes;                                   // [STAGES] tiles
  float* sG = reinterpret_cast<float*>(sB + STAGES * tile_bytes);        // [STAGES][GEO][BN]
  float* sCol = sG + STAGES * GEO * BN;                                  // [2][WARPS][BN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sCol + 2 * WARPS * BN);  // [STAGES] B, then A

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32, q = lane % 4;
  const int p = blockIdx.y, r0 = blockIdx.x * BM;
  const int fa = pair_i[p], fb = pair_j[p];
  // a frame index outside the table ends the launch with a CUDA error
  // instead of reading past it (checking on the host would synchronise)
  if ((unsigned)fa >= (unsigned)K || (unsigned)fb >= (unsigned)K) __trap();
  const int ntiles = Np / BN;
  const size_t frame_bytes = (size_t)Np * Dp * 2;
  const unsigned char* b_frame = table + (size_t)fb * frame_bytes;
  const float* gb_frame = geo_b + (size_t)fb * Np * GEO;

  auto load_b = [&](int t, int s) {
    hopper::mbar_arrive_expect_tx(&bars[s], tile_bytes + geo_bytes);
    hopper::bulk_g2s(sB + s * tile_bytes, b_frame + (size_t)t * tile_bytes, tile_bytes, &bars[s]);
    hopper::bulk_g2s(sG + s * GEO * BN, gb_frame + (size_t)t * GEO * BN, geo_bytes, &bars[s]);
  };
  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(&bars[STAGES], tile_bytes);
    hopper::bulk_g2s(sA, table + (size_t)fa * frame_bytes + (size_t)r0 * Dp * 2, tile_bytes,
                     &bars[STAGES]);
    for (int s = 0; s < STAGES && s < ntiles; ++s) load_b(s, s);
  }
  __syncwarp();

  // this thread's two A-rows (accumulator rows lane/4 and lane/4 + 8 of its warp)
  const int row0 = r0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  float ax[2][6], an2[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    row_ok[h] = r < N;
    const float4* g = reinterpret_cast<const float4*>(geo_a + ((size_t)fa * Np + r) * GEO);
    const float4 g0 = g[0], g1 = g[1];
    ax[h][0] = g0.x; ax[h][1] = g0.y; ax[h][2] = g0.z;
    ax[h][3] = g0.w; ax[h][4] = g1.x; ax[h][5] = g1.y;
    an2[h] = g1.z;
  }
  float best_v[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
  int best_i[2] = {0, 0};

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t lbo = 128, sbo = 16 * Dp;
  const unsigned char* a_base = sA + (size_t)wg * 64 * Dp * 2;
  hopper::mbar_wait(&bars[STAGES], 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    hopper::mbar_wait(&bars[s], (t / STAGES) & 1);

    const unsigned char* b_base = sB + s * tile_bytes;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    for (int ks = 0; ks < Dp / 16; ++ks)
      hopper::wgmma_m64n128k16_bf16(acc, hopper::smem_desc(a_base + ks * 256, lbo, sbo),
                                    hopper::smem_desc(b_base + ks * 256, lbo, sbo), ks > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);

    // epilogue: acc[4j + 2h + e] is (row0 + 8h, column 8j + 2q + e of the tile)
    const float* gB = sG + s * GEO * BN;
    const int c0 = t * BN;
    float cm[32];  // column minima over this thread's two rows, index 2j + e
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * q;
      float2 b[7];
#pragma unroll
      for (int g = 0; g < 7; ++g) b[g] = *reinterpret_cast<const float2*>(gB + g * BN + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gc = c0 + c + e;
        float m = __int_as_float(0x7f800000);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float g = gated_dist(
              acc[4 * j + 2 * h + e], an2[h], ax[h], e ? b[6].y : b[6].x, e ? b[0].y : b[0].x,
              e ? b[1].y : b[1].x, e ? b[2].y : b[2].x, e ? b[3].y : b[3].x,
              e ? b[4].y : b[4].x, e ? b[5].y : b[5].x, max_dist_sq, cos_thresh);
          if (gc < N && g < best_v[h]) { best_v[h] = g; best_i[h] = gc; }
          m = fminf(m, row_ok[h] ? g : __int_as_float(0x7f800000));
        }
        cm[2 * j + e] = m;
      }
    }
    // reduce-scatter over the 8 lanes that share q (lane bits 4, 3, 2): each
    // step keeps half of the columns and takes the partner's half
    float v16[16], v8[8], v4[4];
    const bool up4 = lane & 16, up3 = lane & 8, up2 = lane & 4;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      v16[k] = fminf(up4 ? cm[16 + k] : cm[k],
                     __shfl_xor_sync(0xffffffffu, up4 ? cm[k] : cm[16 + k], 16));
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v8[k] = fminf(up3 ? v16[8 + k] : v16[k],
                    __shfl_xor_sync(0xffffffffu, up3 ? v16[k] : v16[8 + k], 8));
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v4[k] = fminf(up2 ? v8[4 + k] : v8[k],
                    __shfl_xor_sync(0xffffffffu, up2 ? v8[k] : v8[4 + k], 4));
    // v4[k] is column 8j + 2q + e with j = 8*up4 + 4*up3 + 2*up2 + k/2, e = k%2
    float* col_out = sCol + ((t & 1) * WARPS + warp) * BN;
    const int jb = 8 * up4 + 4 * up3 + 2 * up2;
#pragma unroll
    for (int k = 0; k < 4; ++k) col_out[8 * (jb + k / 2) + 2 * q + k % 2] = v4[k];

    __syncthreads();  // stage s and this tile's column partials are complete
    if (tid == 0 && t + STAGES < ntiles) load_b(t + STAGES, s);
    if (tid < BN) {
      const float* cb = sCol + (t & 1) * WARPS * BN + tid;
      float m = cb[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) m = fminf(m, cb[w * BN]);
      const int gc = c0 + tid;
      // a column minimum is read only through a row whose minimum is below
      // 1e30, and is then below 1e30 itself, so the others are left out
      if (gc < N && m < BIG) atomicMin(col_min + (size_t)p * N + gc, ordered(m));
    }
    __syncwarp();
  }

  // row winners: merge (value, index) across the quad, first index on ties
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = best_v[h];
    int idx = best_i[h];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
      if (ov < v || (ov == v && oi < idx)) { v = ov; idx = oi; }
    }
    if (q == 0 && row_ok[h]) {
      const size_t o = (size_t)p * N + row0 + 8 * h;
      best_b[o] = idx;
      best_dist[o] = v;
    }
  }
}

// ---- pass 2 ------------------------------------------------------------------

__global__ void mutual_kernel(const int* __restrict__ best_b, const float* __restrict__ best_dist,
                              const unsigned* __restrict__ col_min, int N, int PN,
                              unsigned char* __restrict__ mutual) {
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < PN; o += gridDim.x * blockDim.x) {
    const float v = best_dist[o];
    const size_t c = (size_t)(o / N) * N + best_b[o];
    mutual[o] = (v < BIG && v <= from_ordered(col_min[c])) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// the largest descriptor width the kernel takes
int fused_mutual_match_max_dim() { return MAX_DP; }

// bytes of device scratch the launch needs (bf16 table, geometry, column minima)
size_t fused_mutual_match_workspace_bytes(int K, int N, int D, int P) {
  return workspace_layout(K, N, D, P).total;
}

// All pointers are device pointers to contiguous tensors:
//   desc [K,N,D] f32; world, wnrm [K,N,3] f32; valid [K,N] u8;
//   pair_i, pair_j [P] i32 in [0, K) (an index outside traps: a CUDA error);
//   best_b [P,N] i32; best_dist [P,N] f32; mutual [P,N] u8;
//   workspace: fused_mutual_match_workspace_bytes(K, N, D, P) bytes, 256-byte aligned.
// Launches passes 0, 1, 2 on `stream`, does not synchronise, and returns
// the first CUDA error (cudaErrorInvalidValue for D > fused_mutual_match_max_dim()).
int fused_mutual_match_pairs_launch(const float* desc, const float* world, const float* wnrm,
                                    const unsigned char* valid, const int* pair_i,
                                    const int* pair_j, int K, int N, int D, int P,
                                    float max_dist_sq, float cos_thresh, int* best_b,
                                    float* best_dist, unsigned char* mutual, void* workspace,
                                    void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (K <= 0 || D <= 0 || round_up(D, 16) > MAX_DP) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Np = round_up(N, BM), Dp = round_up(D, 16);
  const Workspace w = workspace_layout(K, N, D, P);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  unsigned char* table = ws + w.table;
  float* geo_a = reinterpret_cast<float*>(ws + w.geo_a);
  float* geo_b = reinterpret_cast<float*>(ws + w.geo_b);
  unsigned* col_min = reinterpret_cast<unsigned*>(ws + w.col_min);
  const int PN = P * N;

  prepare_kernel<<<(K * Np + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      desc, world, wnrm, valid, K, N, D, Np, Dp, table, geo_a, geo_b, col_min, PN);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem = (size_t)(1 + STAGES) * BN * Dp * 2 + (size_t)STAGES * GEO * BN * 4 +
                      (size_t)2 * WARPS * BN * 4 + (STAGES + 1) * sizeof(uint64_t);
  e = cudaFuncSetAttribute(match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  match_kernel<<<dim3(Np / BM, P), THREADS, smem, st>>>(table, geo_a, geo_b, pair_i, pair_j, K,
                                                         N, Np, Dp, max_dist_sq, cos_thresh,
                                                         best_b, best_dist, col_min);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int blocks = (PN + 255) / 256 < 1024 ? (PN + 255) / 256 : 1024;
  mutual_kernel<<<blocks, 256, 0, st>>>(best_b, best_dist, col_min, N, PN, mutual);
  return (int)cudaGetLastError();
}

}  // extern "C"
