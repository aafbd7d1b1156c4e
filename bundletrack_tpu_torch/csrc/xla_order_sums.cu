// Per-sample sums and sums of squares of an f32 tensor, added in the order
// XLA's CPU backend adds them, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package runs its LF-Net jitted, and XLA
// reduces the norms' f32 statistics (Flax GroupNorm's mean and mean square,
// detector_ops.instance_norm's mean and variance) in an order of its own;
// with bf16 convolutions around them a sum that differs in its last bit
// flips the bf16 rounding of whole masked-out regions.  This kernel adds in
// that order, so the port's bf16 forward computes what the jitted JAX
// forward computes (the plain version, kernels/norm_sums.py, holds it to
// jax.jit bit for bit on the LF-Net shapes in the CPU tests).
//
// The order.  A group's reduced axes are viewed as XLA lays them out, NHWC
// row-major with the channel innermost: [H, W, Cg] (Cg = C for a whole
// sample, 1 for one channel of a sample).  Each axis of size n is cut into
// windows of min(32, n) with "SAME" zero padding, pad // 2 of it before;
// each window is added sequentially in row-major (h, w, c) order from 0,
// then the windows' partials sequentially in window row-major order.
// Padded elements add nothing.  The sum of squares adds each square
// rounded to f32 (no fused multiply-add); with `round_bf16` each value is
// rounded to bf16 first, with `shift` the group's shift is subtracted first.
//
// What bounds it.  Each window is one chain of dependent f32 adds (two
// chains, the sum and the sum of squares, interleaved): 16384 adds for a
// 32x32x16 window of the detector at 400x400 (169 windows), 8192 for the
// descriptor's first norm [512, 64, 16, 16] (1024 windows).  At 4 cycles
// per dependent add and 1.98 GHz that is 33 us and 17 us, against 3 us and
// 10 us to read the bytes once at 3.35 TB/s: the chain is the bound, and
// the parallelism is across windows, which are few (169 on the detector).
//
// Design, two kernels on the caller's stream.
//   1. window_layout: one block per (window, RB window rows): each row's
//      [wc channels] x [ww positions] tile is read along w (coalesced,
//      NCHW), transposed through shared memory and written along (w, c),
//      so each window lands contiguous in its chain order ([chains][Wsz4],
//      the window's elements rounded / shifted, padding 0, each window
//      padded to a multiple of 4).
//   2. window_chains: a block holds up to 32 windows, as few as spreads them
//      over the 132 SMs; lane j of warp 0 runs the sum's chain of window j,
//      lane j of warp 2 its sum of squares, and warp 1 streams the windows
//      through a ring of STAGES chunks of E floats per window in shared
//      memory, one 16-byte cp.async per lane and window per chunk (a
//      window's chunk is 512 contiguous bytes), chunk k + STAGES - 1 in
//      flight while warps 0 and 2 add chunk k out of shared memory, four
//      elements per 16-byte read (a window's row stride is 4 mod 32 floats:
//      no bank conflict), with __fadd_rn / __fmul_rn (no contraction).
//      Each block writes its partials; the last block to finish (a ticket
//      on a counter that it resets) adds every group's partials in window
//      order, one thread per group.  Two launches in flight at once must
//      not share the counter: the wrapper keeps one per stream.
// Measured on an H100 (PERF.md, `sums_bench`): ~11 us of layout and ~58 us
// of chains on [1, 16, 400, 400] against its 33 us chain bound, at the 4.2
// cycles per dependent add and 1.98 GHz that `xla_order_sums_add_probe`
// reads on the card.  Staging straight from NCHW was slower: with 4-byte
// copies, and with 16-byte copies whose rounding the adding lanes did (a
// warp issues in order, and its conversions run at a quarter of the adds'
// rate).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 32;          // XLA's window along each reduced axis
constexpr int E = 128;           // floats of one window per staged chunk
constexpr int STAGES = 12;       // chunks in flight per window
constexpr int CHAINS = 32;       // the most windows per block: the adding warp's lanes
constexpr int SMS = 132;         // the H100's streaming multiprocessors
constexpr int ROW = E + 4;       // shared-memory floats per window and stage: 4 mod 32
constexpr int RB = 4;            // window rows per block of the layout kernel

struct Geometry {
  int B, C, H, W;
  int per_channel;    // 1: a group is one channel of a sample; 0: a whole sample
  int G, Cg;          // groups and channels per group
  int wh, ww, wc;     // window extents along h, w, c
  int nwh, nww, nwc;  // windows along h, w, c
  int loh, low, loc;  // "SAME" padding before, along h, w, c
  int NW;             // windows per group
  int Wsz, Wsz4;      // elements per window, and rounded up to a multiple of 4
  long long chains;   // G * NW
  int per_block;      // windows per block of window_chains
};

void axis_windows(int n, int* w, int* nw, int* lo) {
  *w = n < WIN ? n : WIN;
  *nw = (n + *w - 1) / *w;
  *lo = (*nw * *w - n) / 2;
}

int make_geometry(int B, int C, int H, int W, int per_channel, Geometry* g) {
  if (B < 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  g->B = B; g->C = C; g->H = H; g->W = W; g->per_channel = per_channel;
  g->G = per_channel ? B * C : B;
  g->Cg = per_channel ? 1 : C;
  axis_windows(H, &g->wh, &g->nwh, &g->loh);
  axis_windows(W, &g->ww, &g->nww, &g->low);
  axis_windows(g->Cg, &g->wc, &g->nwc, &g->loc);
  g->NW = g->nwh * g->nww * g->nwc;
  g->Wsz = g->wh * g->ww * g->wc;
  g->Wsz4 = (g->Wsz + 3) / 4 * 4;
  g->chains = (long long)g->G * g->NW;
  // spread the windows over the SMs: a block's windows share its SM's
  // L2 bandwidth, and 32 windows of one block drew ~10 B per cycle
  const long long per_sm = (g->chains + SMS - 1) / SMS;
  g->per_block = per_sm < 1 ? 1 : (per_sm > CHAINS ? CHAINS : (int)per_sm);
  return 0;
}

// Kernel 1: block (window chain, rows [RB * y, RB * y + RB)), ww * wc
// threads (rounded up to 32); each thread loads its element of every row
// first, then stores them.
template <bool ROUND, bool SHIFT>
__global__ void window_layout_kernel(const float* __restrict__ x, Geometry g, const float* __restrict__ shift,
                                     float* __restrict__ out) {
  __shared__ float tile[RB][WIN][WIN + 1];  // [row][c][w]
  const long long chain = blockIdx.x;
  const int grp = (int)(chain / g.NW);
  int k = (int)(chain - (long long)grp * g.NW);
  const int kc = k % g.nwc;
  k /= g.nwc;
  const int kw = k % g.nww, kh = k / g.nww;
  const int hl0 = blockIdx.y * RB;
  const int w0 = kw * g.ww - g.low, c0 = kc * g.wc - g.loc;
  const long long plane = (long long)g.H * g.W;
  const float* src = x + (g.per_channel ? (long long)grp * plane : (long long)grp * g.C * plane);
  const float sh = SHIFT ? shift[grp] : 0.f;
  const int n = g.ww * g.wc, t = threadIdx.x;
  if (t < n) {  // read along w
    const int cl = t / g.ww, wl = t - cl * g.ww;
    const int w = w0 + wl, c = c0 + cl;
    const bool wc_in = (unsigned)w < (unsigned)g.W && (unsigned)c < (unsigned)g.Cg;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int h = kh * g.wh - g.loh + hl0 + r;
      float v = 0.f;
      if (wc_in && hl0 + r < g.wh && (unsigned)h < (unsigned)g.H) {
        v = src[(long long)c * plane + (long long)h * g.W + w];
        if (ROUND) v = __bfloat162float(__float2bfloat16_rn(v));
        if (SHIFT) v = __fsub_rn(v, sh);
      }
      tile[r][cl][wl] = v;
    }
  }
  __syncthreads();
  float* dst = out + chain * g.Wsz4;
  if (t < n) {  // write along (w, c)
    const int wl = t / g.wc, cl = t - wl * g.wc;
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (hl0 + r < g.wh) dst[(long long)(hl0 + r) * n + t] = tile[r][cl][wl];
  }
  if (hl0 + RB >= g.wh && t < g.Wsz4 - g.Wsz) dst[g.Wsz + t] = 0.f;  // the window's tail, to a multiple of 4
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// What the last block derives from each group's sums besides them (null
// mean: nothing): mean = sum * inv, variance = max(0, fma(sum2, inv,
// -square)), square = mean * mean, or (sum * sum) * inv2 for a single group,
// inv = f32(1 / n) and inv2 = f32(inv * inv) for n elements per group.
struct Stats {
  float inv, inv2;
  float* mean;
  float* var;
};

// Kernel 2: g.per_block (<= CHAINS) windows per block and THREADS2
// threads: warp 0 adds the sums (lane j: window j), warp 2 the sums of
// squares, warp 1 stages the windows' chunks ahead of both.
constexpr int THREADS2 = 96;

__global__ void __launch_bounds__(THREADS2, 1) window_chains_kernel(const float* __restrict__ xt, Geometry g,
                                                                 float* __restrict__ partials,
                                                                 float* __restrict__ out_sum,
                                                                 float* __restrict__ out_sumsq,
                                                                 unsigned int* __restrict__ counter, Stats stats) {
  extern __shared__ __align__(16) float ring[];  // [STAGES][per_block][ROW]
  __shared__ unsigned int ticket;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pb = g.per_block;
  const long long first = (long long)blockIdx.x * pb;
  const int nchain = g.chains - first < pb ? (int)(g.chains - first) : pb;
  const int nchunks = (g.Wsz4 + E - 1) / E;

  // warp 1: chunk k of every window of the block into its ring slot; lane
  // l copies floats [4l, 4l + 4) of each window's chunk (512 contiguous
  // bytes per window)
  auto stage = [&](int k) {
    if (k < nchunks && k * E + 4 * lane < g.Wsz4) {
      const float* src = xt + first * g.Wsz4 + k * E + 4 * lane;
      float* slot = ring + (k % STAGES) * pb * ROW + 4 * lane;
      for (int j = 0; j < nchain; ++j) cp_async16(slot + j * ROW, src + (long long)j * g.Wsz4);
    }
    cp_async_commit();
  };

  if (warp == 1) {
    for (int k = 0; k < STAGES - 1; ++k) stage(k);
    cp_async_wait<STAGES - 2>();  // chunk 0 has landed
  }
  __syncthreads();
  float acc = 0.f;  // warp 0: the sum; warp 2: the sum of squares
  for (int k = 0; k < nchunks; ++k) {
    if (warp == 1) {
      stage(k + STAGES - 1);  // into the slot added at k - 1
      cp_async_wait<STAGES - 2>();  // chunk k + 1 has landed
    } else if (lane < nchain) {
      // a whole chunk's reads issued before its adds; one dependent chain
      // per lane (the sum and the sum of squares on two warps: one warp
      // adding both ran at ~8 cycles per element)
      const float4* row = reinterpret_cast<const float4*>(ring + ((k % STAGES) * pb + lane) * ROW);
      const int n4 = (g.Wsz4 - k * E < E ? g.Wsz4 - k * E : E) / 4;
      if (warp == 0) {
        if (n4 == E / 4) {
          float4 v[E / 4];
#pragma unroll
          for (int u = 0; u < E / 4; ++u) v[u] = row[u];
          asm volatile("" ::: "memory");  // the chunk's reads issued before its adds
#pragma unroll
          for (int u = 0; u < E / 4; ++u) {
            acc = __fadd_rn(acc, v[u].x);
            acc = __fadd_rn(acc, v[u].y);
            acc = __fadd_rn(acc, v[u].z);
            acc = __fadd_rn(acc, v[u].w);
          }
        } else {
          for (int u = 0; u < n4; ++u) {
            const float4 v = row[u];
            acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v.x), v.y), v.z), v.w);
          }
        }
      } else {
        if (n4 == E / 4) {
          float4 v[E / 4];
#pragma unroll
          for (int u = 0; u < E / 4; ++u) {
            v[u] = row[u];
            v[u] = make_float4(__fmul_rn(v[u].x, v[u].x), __fmul_rn(v[u].y, v[u].y), __fmul_rn(v[u].z, v[u].z),
                               __fmul_rn(v[u].w, v[u].w));
          }
          asm volatile("" ::: "memory");  // the chunk's reads issued before its adds
#pragma unroll
          for (int u = 0; u < E / 4; ++u) {
            acc = __fadd_rn(acc, v[u].x);
            acc = __fadd_rn(acc, v[u].y);
            acc = __fadd_rn(acc, v[u].z);
            acc = __fadd_rn(acc, v[u].w);
          }
        } else {
          for (int u = 0; u < n4; ++u) {
            const float4 v = row[u];
            acc = __fadd_rn(acc, __fmul_rn(v.x, v.x));
            acc = __fadd_rn(acc, __fmul_rn(v.y, v.y));
            acc = __fadd_rn(acc, __fmul_rn(v.z, v.z));
            acc = __fadd_rn(acc, __fmul_rn(v.w, v.w));
          }
        }
      }
    }
    __syncthreads();
  }
  if (warp == 1) cp_async_wait<0>();

  if (warp != 1 && lane < nchain) partials[2 * (first + lane) + (warp == 2)] = acc;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
  __syncthreads();
  if (ticket != gridDim.x - 1) return;

  // the last block: every group's window partials, in window order, staged
  // through shared memory TG groups at a time (read by every thread), then
  // one thread per group
  __threadfence();
  const int tid = threadIdx.x;
  const int cap = (STAGES * pb * ROW) / (2 * g.NW);  // groups whose partials fit
  const int TG = cap < 1 ? 1 : cap;
  for (int g0 = 0; g0 < g.G; g0 += TG) {
    const int ng = g.G - g0 < TG ? g.G - g0 : TG;
    const long long off = 2LL * g0 * g.NW;
    if (cap >= 1) {
      for (int i = tid; i < 2 * ng * g.NW; i += THREADS2) ring[i] = __ldcg(partials + off + i);
      __syncthreads();
    }
    for (int j = tid; j < ng; j += THREADS2) {
      float a = 0.f, a2 = 0.f;
      for (int k = 0; k < g.NW; ++k) {
        const int i = 2 * (j * g.NW + k);
        a = __fadd_rn(a, cap >= 1 ? ring[i] : __ldcg(partials + off + i));
        a2 = __fadd_rn(a2, cap >= 1 ? ring[i + 1] : __ldcg(partials + off + i + 1));
      }
      out_sum[g0 + j] = a;
      out_sumsq[g0 + j] = a2;
      if (stats.mean) {  // Flax's mean and fast variance as jax.jit computes them (ops/numerics.xla_mean_var)
        const float m = __fmul_rn(a, stats.inv);
        const float sq = g.G == 1 ? __fmul_rn(__fmul_rn(a, a), stats.inv2) : __fmul_rn(m, m);
        const float v = __fmaf_rn(a2, stats.inv, -sq);
        stats.mean[g0 + j] = m;
        stats.var[g0 + j] = v > 0.f ? v : 0.f;
      }
    }
    __syncthreads();
  }
  if (tid == 0) *counter = 0u;
}

// One warp, one dependent chain of n f32 adds per lane (n a multiple of 8):
// t[0] the SM cycles (clock64) and t[1] the nanoseconds (globaltimer) the
// chain took, out[lane] its result.
__global__ void add_chain_probe_kernel(int n, float step, float* out, long long* t) {
  float acc = (float)threadIdx.x;
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, step);
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) {
    t[0] = c1 - c0;
    t[1] = (long long)(g1 - g0);
  }
}

constexpr size_t RING_BYTES = sizeof(float) * STAGES * CHAINS * ROW;  // the most a block takes

template <bool ROUND, bool SHIFT>
int launch_layout(const float* x, const Geometry& g, const float* shift, float* xt, cudaStream_t st) {
  const dim3 grid((unsigned)g.chains, (unsigned)((g.wh + RB - 1) / RB));
  const int threads = (g.ww * g.wc + 31) / 32 * 32;
  window_layout_kernel<ROUND, SHIFT><<<grid, threads, 0, st>>>(x, g, shift, xt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// floats of device scratch one launch needs: the windows laid out in chain
// order, then their partials
size_t xla_order_sums_workspace_floats(int B, int C, int H, int W, int per_channel) {
  Geometry g;
  if (make_geometry(B, C, H, W, per_channel, &g) != 0) return 0;
  return (size_t)(g.chains * g.Wsz4 + 2 * g.chains);
}

// x: [B, C, H, W] f32, contiguous, on the device ([B, F] as [B, F, 1, 1]).
// A group is a sample (per_channel 0) or one channel of a sample (1); its
// sum and sum of squares go to out_sum[g], out_sumsq[g] ([B] or [B * C]).
// shift: null, or [G] f32 subtracted from every element of its group first;
// round_bf16: round every element to bf16 first (not with a shift).
// workspace: xla_order_sums_workspace_floats(...) floats, 16-byte aligned;
// counter: one unsigned int that holds 0 (the launch leaves it 0), used by
// no launch on another stream while this one runs.
// out_mean, out_var: null, or [G] each for the group's mean and variance as
// jax.jit computes Flax GroupNorm's (struct Stats; inv = f32(1 / n), inv2 =
// f32(inv * inv), n the elements per group).
// Launches on `stream`, does not synchronise, returns the CUDA error of the
// launches (or cudaErrorInvalidValue for a shape or flags it does not take).
int xla_order_sums_launch(const float* x, int B, int C, int H, int W, int per_channel, int round_bf16,
                          const float* shift, float* out_sum, float* out_sumsq, float* workspace,
                          unsigned int* counter, float inv, float inv2, float* out_mean, float* out_var,
                          void* stream) {
  Geometry g;
  const int err = make_geometry(B, C, H, W, per_channel, &g);
  if (err != 0) return err;
  if (round_bf16 && shift) return (int)cudaErrorInvalidValue;
  if ((out_mean == nullptr) != (out_var == nullptr)) return (int)cudaErrorInvalidValue;
  if (g.chains == 0) return 0;
  if (g.chains > 0x7fffffffLL || g.wh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* xt = workspace;
  float* partials = workspace + g.chains * g.Wsz4;
  int e = round_bf16 ? launch_layout<true, false>(x, g, shift, xt, st)
          : shift    ? launch_layout<false, true>(x, g, shift, xt, st)
                     : launch_layout<false, false>(x, g, shift, xt, st);
  if (e != 0) return e;
  // set on every launch: the attribute belongs to the current device
  const cudaError_t a = cudaFuncSetAttribute(window_chains_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)RING_BYTES);
  if (a != cudaSuccess) return (int)a;
  const unsigned blocks = (unsigned)((g.chains + g.per_block - 1) / g.per_block);
  const size_t ring = sizeof(float) * STAGES * g.per_block * ROW;
  window_chains_kernel<<<blocks, THREADS2, ring, st>>>(xt, g, partials, out_sum, out_sumsq, counter,
                                                      Stats{inv, inv2, out_mean, out_var});
  return (int)cudaGetLastError();
}

// One warp adds a dependent chain of n f32 adds (n a multiple of 8) per
// lane on `stream`: t[0] <- SM cycles, t[1] <- nanoseconds; out: 32 floats.
int xla_order_sums_add_probe(int n, float* out, long long* t, void* stream) {
  if (n <= 0 || n % 8) return (int)cudaErrorInvalidValue;
  add_chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(n, 1e-7f, out, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
