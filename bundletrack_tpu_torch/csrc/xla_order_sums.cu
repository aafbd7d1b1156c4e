// Per-group sums and sums of squares of f32 tensors, added in the order
// XLA's CPU backend adds them, for Hopper (sm_90a); and the instance norms'
// mean and variance built on them, for a ragged list of maps in one launch.
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
// Padded elements add 0.  The sum of squares adds each square rounded to
// f32 (no fused multiply-add); with `round_bf16` each value is rounded to
// bf16 first, with `shift` the group's shift is subtracted first.  Zeros
// added anywhere in a chain leave it unchanged (up to the sign of a zero),
// so the kernel pads freely: a window's columns and channels in a chunk to
// the extents it works in, each chunk to a multiple of 64 floats, and in a
// ragged launch each map's windows to the largest window.
//
// What bounds it.  Each window is one chain of dependent f32 adds: 16384
// for a 32x32x16 window of the detector at 400x400 (169 windows), 8192 for
// the descriptor's first norm [512, 64, 16, 16] (1024 windows).  At ~4.2
// cycles per dependent add and 1.98 GHz that is ~35 us and ~17 us, against
// 3 us and 10 us to read the bytes once at 3.35 TB/s: the chain is the
// bound, and the parallelism is across windows, one chain per thread.
//
// Design: one kernel, one launch per call, warp-specialised (12 warps).  A
// block takes a run of windows, in rounds of up to 32 (sums) or 64
// (instance norms), each window cut into chunks of up to CHUNK floats.
//   - Consumers, warps 0 and 1: lane j runs the chain of window j of the
//     round, warp 0 the sums and warp 1 the sums of squares (instance
//     norms: both warps sum, 32 windows each, then both add the shifted
//     squares).  A lane reads its row of the ring 32 floats at a time, the
//     next piece's reads issued before this piece's adds and never under a
//     branch, squares each value inside the add loop (__fadd_rn,
//     __fmul_rn: no contraction), and waits once per chunk on its stage's
//     "full" barrier, polling (it has a scheduler of its own).
//   - Producers, warps 2, 3, 6, 7, 10, 11 (the two schedulers without a
//     consumer), or every warp from 2 where a window's chunk is small and
//     the loads bound the kernel.  A chunk's chain positions (r, w, c) are
//     cut into items of four: four channels at (r, w), or with one channel
//     four columns at r; the channel extent is a power of two, so an item
//     unpacks by shifts and one exact multiply-high division.  (window,
//     batch) tasks go round the warps; lane l takes items l, l + 32, ...
//     (neighbouring lanes on neighbouring columns: coalesced), issues all
//     32 loads of its batch before it uses any (unguarded: an element
//     outside the tensor or the window reads its group's first element and
//     is zeroed after), rounds them to bf16 (nearest even, two per
//     conversion) or shifts them, and stores each item with one 16-byte
//     write.  One arrival per warp on "full" after __syncwarp; a producer
//     waits on the stage's "empty" barrier (suspended) before it stores.
//   - The ring: up to MAX_STAGES chunks per window in shared memory, a row
//     of E + 4 floats per window (4 mod 32: the consumers' 16-byte reads hit
//     no bank twice), 16-byte granules XOR-swizzled within each group of
//     eight (g ^ ((g >> 3) & 7)) so the producers' 16-byte stores do not
//     collide either.
//   - Each round's window partials go to global memory.  Where a group's
//     windows fit in one round (at most 32: the descriptor's norms at 512
//     and 4096 keypoints), rounds hold whole groups and each block adds its
//     own groups' partials in window order, one thread per group, and for a
//     GroupNorm derives its mean and variance.  Otherwise the last block (a
//     ticket on a counter that it resets) does so for every group, its
//     partials staged through shared memory.  Instance norms run two passes
//     in one cooperative launch (every block resident): the last block of
//     the first pass derives each map's means (sum * f32(1 / (H * W))) and
//     releases the others, which subtract them (__fsub_rn) in the second
//     pass; the last block of the second derives the variances.  Two
//     launches in flight at once must not share the counters: the wrapper
//     keeps them per stream.
// PERF.md holds the times on the card beside the chain and bytes bounds
// (`python3 -m bundletrack_tpu_torch.sums_bench`).  Measured there and
// dropped: guarded loads each followed by their use (a warp issues in
// order: the loads ran one at a time), 4-byte asynchronous copies into the
// ring converted in place (their instructions per element bound the
// producers), shared-memory reads under a branch (each exposed its
// latency), squares right behind their reads, two chunks for a small
// window (each handoff cost ~1 us), and one last block adding the partials
// of every group where blocks hold whole groups (on [4096, 512] 0.189 ms a
// call by CUDA events on the H100, against 0.102-0.110 with each block
// adding its own).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int WIN = 32;         // XLA's window along each reduced axis
constexpr int THREADS = 384;    // 12 warps: 2 consumers, 6 or 10 producers, the rest only meet the block barriers
constexpr int CONSUMERS = 64;   // warps 0 and 1
// producer warps: 2, 3, 6, 7, 10, 11 (the two schedulers without a consumer),
// or, for small windows, where the loads bound the kernel, every warp from 2
template <bool SMALL>
__host__ __device__ constexpr int producer_warps() { return SMALL ? 10 : 6; }
constexpr int IB = 8;            // items per producer lane whose loads are issued together
constexpr int MAX_STAGES = 6;
constexpr int MAX_SLOTS = 64;   // windows per round
constexpr int MAX_MAPS = 16;    // maps per ragged launch
constexpr int CHUNK = 2048;     // floats of a window per chunk, as far as the ring allows
constexpr size_t RING_LIMIT = 200 * 1024;

// SUMS takes an optional shift per group (a runtime switch: no path of the
// forward runs it, the tests and sums_bench do)
enum Mode { SUMS = 0, SUMS_ROUND = 1, INSTANCE = 2 };

// One tensor's groups: group g is [Cg, H, W] at x + g * gstride.
struct Map {
  const float* x;
  long long gstride;
  int H, W, Cg;
  int wh, ww, wc;     // window extents along h, w, c
  int nwh, nww, nwc;  // windows along h, w, c
  int loh, low, loc;  // "SAME" padding before, along h, w, c
  int NW, G;          // windows per group, groups
  long long first_win;
  int first_group;
  float inv, inv2;    // f32(1 / n) and f32(inv * inv), n the elements per group
};

struct Params {
  Map maps[MAX_MAPS];
  int nmaps;
  long long Wtot;     // windows of all maps
  int Gtot;           // groups of all maps
  int PH, PW, PC;     // the chunked window's extents (each map's own windows lie inside): PW and
  int lpw, lpc;       // PC a power of two (log2 lpc), 1 or at least 4; with PC 1, PW a power of two
                      // (log2 lpw), at least 4
  int items;          // items (four chain positions) of a window's chunk
  unsigned int mpw, mitems;  // ceil(2^32 / PW), ceil(2^32 / items): exact division by multiply-high
  int R, E, nchunks;  // window rows per chunk, ring floats per window and chunk, chunks per window
  int stages, per_round, rounds;
  long long per_block;
  int local;          // sums mode: every block holds whole groups and adds their partials itself
  const float* shift;       // SUMS: null, or [Gtot] subtracted first
  float* partials;          // [2 * Wtot]: sums mode (sum, square) per window; instance mode per pass
  float* out_a;             // sums, or the instance norms' means
  float* out_b;             // sums of squares, or the instance norms' variances
  float* out_mean;          // null, or a GroupNorm's mean and variance (sums mode)
  float* out_var;
  unsigned int* counters;   // [3]: last ticket, first-pass ticket, means released
};

// A window of the current round, as the producers need it.
struct Slot {
  const float* base;  // its group
  int h0, w0, c0;     // its origin in the group (negative in the padding)
  int wh, ww, wc, H, W, Cg;
  float sh;           // subtracted from every element (0: nothing)
};

void axis_windows(int n, int* w, int* nw, int* lo) {
  *w = n < WIN ? n : WIN;
  *nw = (n + *w - 1) / *w;
  *lo = (*nw * *w - n) / 2;
}

int make_map(const float* x, int B, int C, int H, int W, int per_channel, Map* m) {
  if (B < 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  m->x = x;
  m->H = H;
  m->W = W;
  m->G = per_channel ? B * C : B;
  m->Cg = per_channel ? 1 : C;
  m->gstride = (long long)m->Cg * H * W;
  if (m->gstride > INT_MAX || (long long)B * C > INT_MAX) return (int)cudaErrorInvalidValue;
  axis_windows(H, &m->wh, &m->nwh, &m->loh);
  axis_windows(W, &m->ww, &m->nww, &m->low);
  axis_windows(m->Cg, &m->wc, &m->nwc, &m->loc);
  m->NW = m->nwh * m->nww * m->nwc;
  return 0;
}

// 16-byte granule g of a ring row lives at granule g ^ ((g >> 3) & 7)
__device__ __forceinline__ int swz_granule(int g) { return g ^ ((g >> 3) & 7); }
__device__ __forceinline__ int swz(int pos) { return (swz_granule(pos >> 2) << 2) | (pos & 3); }

template <bool SMALL>
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * producer_warps<SMALL>()) : "memory");
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* a) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(a) : "memory");
  return v;
}

__device__ __forceinline__ void next_stage(int& s, unsigned int& n, int stages) {
  if (++s == stages) {
    s = 0;
    ++n;
  }
}

// piece u of a window's chunk (floats [32u, 32u + 32), in chain order),
// its granules read where the swizzle put them
__device__ __forceinline__ void load_piece(float4 (&v)[8], const float* row, int u) {
  const float4* r = reinterpret_cast<const float4*>(row) + 8 * u;
  const int x = u & 7;
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = r[i ^ x];
}

// the piece added to the chain, each value (with SQUARES its square,
// f32-rounded) in order; the squares read values loaded a piece earlier,
// so they wait on nothing (a square right behind its shared-memory read
// held the warp, in order, at every piece)
template <bool SQUARES>
__device__ __forceinline__ float add_piece(float acc, const float4 (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (SQUARES) {
      acc = __fadd_rn(acc, __fmul_rn(v[i].x, v[i].x));
      acc = __fadd_rn(acc, __fmul_rn(v[i].y, v[i].y));
      acc = __fadd_rn(acc, __fmul_rn(v[i].z, v[i].z));
      acc = __fadd_rn(acc, __fmul_rn(v[i].w, v[i].w));
    } else {
      acc = __fadd_rn(acc, v[i].x);
      acc = __fadd_rn(acc, v[i].y);
      acc = __fadd_rn(acc, v[i].z);
      acc = __fadd_rn(acc, v[i].w);
    }
  }
  return acc;
}

// One consumer lane: the chain of ring row `slot` over a round's chunks,
// 32 floats at a time, each piece's reads issued before the previous
// piece's adds.  The reads are unconditional (past the chunk's end they
// read its last piece again): a read under a branch waits for its data at
// the branch's end, which put shared memory's latency on the chain.  A
// chunk is ~2048 floats, so its one wait on the "full" barrier is rare.
template <bool SQUARES>
__device__ float consume(const Params& p, const float* ring, uint64_t* full, uint64_t* empty, int slot, int& s,
                         unsigned int& n) {
  const int rowf = p.E + 4, last = p.E / 32 - 1;  // pieces per chunk: even
  float acc = 0.f;
  float4 a[8], b[8];
  for (int k = 0; k < p.nchunks; ++k) {
    hopper::mbar_wait_spin(&full[s], n & 1);
    const float* row = ring + ((size_t)s * p.per_round + slot) * rowf;
    load_piece(a, row, 0);
    for (int u = 0; u < last; u += 2) {
      load_piece(b, row, u + 1);
      acc = add_piece<SQUARES>(acc, a);
      load_piece(a, row, min(u + 2, last));
      acc = add_piece<SQUARES>(acc, b);
    }
    __syncwarp();  // after the adds: the warp's reads of the stage are done
    if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&empty[s]);
    next_stage(s, n, p.stages);
  }
  return acc;
}

// Where a window's chunk meets its group: element (r, w, c) of the chunk is
// in the tensor and in the window iff (unsigned)(r - rlo) < rn, and so on.
struct Box {
  int rlo, rn, wlo, wn, clo, cn;
  __device__ __forceinline__ bool in(int r, int w, int c) const {
    return (unsigned)(r - rlo) < (unsigned)rn && (unsigned)(w - wlo) < (unsigned)wn && (unsigned)(c - clo) < (unsigned)cn;
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// chunk k of a window: the box and the address of its element (0, 0, 0)
__device__ __forceinline__ const float* chunk_origin(const Params& p, const Slot sl, int k, Box& b, bool& interior) {
  const int hb = sl.h0 + k * p.R;  // the chunk's first row in the group
  const int plane = sl.H * sl.W;
  b.rlo = clampi(-hb, 0, p.R);
  b.rn = clampi(min(min(p.R, sl.wh - k * p.R), sl.H - hb) - b.rlo, 0, p.R);
  b.wlo = clampi(-sl.w0, 0, p.PW);
  b.wn = clampi(min(sl.ww, sl.W - sl.w0) - b.wlo, 0, p.PW);
  b.clo = clampi(-sl.c0, 0, p.PC);
  b.cn = clampi(min(sl.wc, sl.Cg - sl.c0) - b.clo, 0, p.PC);
  interior = b.rlo == 0 && b.rn == p.R && b.wlo == 0 && b.wn == p.PW && b.clo == 0 && b.cn == p.PC;
  return sl.base + (long long)sl.c0 * plane + (long long)hb * sl.W + sl.w0;
}

__device__ __forceinline__ float keep_if(float x, unsigned int bit) {
  return __int_as_float(__float_as_int(x) & -(int)bit);
}

// Item m of a window's chunk: its elements' offset from the chunk's origin
// (element e at off + e * step), its granule in the ring row, and its (r,
// w, c) for the edge check.
struct Item {
  int r, w, c, g;
};
__device__ __forceinline__ Item unpack_item(int m, bool cquads, int pw, unsigned int mpw, int lq) {
  Item it;
  if (cquads) {  // m = (r * PW + w) << lq + c / 4, w fastest across lanes; t = m / PW exactly
    const int t = pw == 1 ? m : (int)__umulhi((unsigned int)m, mpw);
    it.w = m - t * pw;
    it.c = 4 * (t & ((1 << lq) - 1));
    it.r = t >> lq;
    it.g = ((it.r * pw + it.w) << lq) + (it.c >> 2);
  } else {  // m = (r << lq) + w / 4
    it.w = 4 * (m & ((1 << lq) - 1));
    it.c = 0;
    it.r = m >> lq;
    it.g = m;
  }
  return it;
}

// The four elements of an item, loaded unguarded (an element outside the
// tensor or the window reads its group's first element, and `keep` says
// to zero it).
__device__ __forceinline__ void load_item(float (&v)[4], unsigned long long& keep, int bit0, bool ok, const Item& it,
                                          const Slot& sl, const float* o, const Box& b, bool interior, bool cquads) {
  const int plane = sl.H * sl.W, step = cquads ? plane : 1;
  const int off = it.c * plane + it.r * sl.W + it.w;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool in = ok && (interior || (cquads ? b.in(it.r, it.w, it.c + e) : b.in(it.r, it.w + e, it.c)));
    keep |= (unsigned long long)in << (bit0 + e);
    v[e] = __ldg(in ? o + (off + e * step) : sl.base);
  }
}

// An item's values as the chain adds them: rounded to bf16 (nearest even,
// two per conversion) or shifted, and zeroed outside the tensor or window.
template <int MODE>
__device__ __forceinline__ void finish_item(float (&v)[4], unsigned long long keep, int bit0, bool shifts, float sh) {
  if (MODE == SUMS_ROUND) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    v[0] = __low2float(lo);
    v[1] = __high2float(lo);
    v[2] = __low2float(hi);
    v[3] = __high2float(hi);
  }
  if (shifts) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __fsub_rn(v[e], sh);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = keep_if(v[e], (unsigned int)(keep >> (bit0 + e)) & 1u);
}

// One producer warp, chunk by chunk: the (window, batch) tasks pw, pw +
// PWARPS, ... of a round, or, where a window's chunk has fewer items than
// a batch (SMALL), items of several windows per batch.  Lane l takes items
// l, l + 32, ... (neighbouring lanes on neighbouring columns: the loads
// coalesce).  A batch's loads are all issued before any value is used (a
// warp issues in order: a use right behind its load would hold back every
// load after it); each item is stored with one 16-byte write.  Every
// producer warp waits for each stage to drain and arrives on its "full"
// barrier, tasks or not: a warp that arrived early for the next use of a
// stage would complete the current one.
template <int MODE, bool SMALL>
__device__ void produce(const Params& p, float* ring, uint64_t* full, uint64_t* empty, const Slot* slots, int nwin,
                        int pw, int lane, int pass, int& s, unsigned int& n) {
  const int rowf = p.E + 4, lpw = p.lpw, lpc = p.lpc;
  const bool cquads = lpc >= 2;  // items along c (else along w)
  const int lq = cquads ? lpc - 2 : lpw - 2;  // log2 of the items per (r, w) or per r
  const unsigned int mpw = p.mpw;
  const int items = p.items;
  const bool shifts = (MODE == SUMS && p.shift != nullptr) || (MODE == INSTANCE && pass == 1);
  constexpr int PWARPS = producer_warps<SMALL>();
  const int mine = pw < nwin ? (nwin - pw + PWARPS - 1) / PWARPS : 0;  // this warp's windows
  for (int k = 0; k < p.nchunks; ++k) {
    float* rows = ring + (size_t)s * p.per_round * rowf;
    bool ready = false;
    if (!SMALL) {  // (window, batch) tasks over the producer warps (items >= 32 * IB)
      const int nbat = (items + 32 * IB - 1) / (32 * IB);
      for (int task = pw; task < nwin * nbat; task += PWARPS) {
        const int j = task / nbat, m0 = (task - j * nbat) * 32 * IB;
        const Slot sl = slots[j];
        Box b;
        bool interior;
        const float* o = chunk_origin(p, sl, k, b, interior);
        float4* row = reinterpret_cast<float4*>(rows + j * rowf);
        float v[IB][4];
        int g[IB];
        unsigned long long keep = 0;
#pragma unroll
        for (int i = 0; i < IB; ++i) {
          const int m = m0 + 32 * i + lane;
          const Item it = unpack_item(m < items ? m : 0, cquads, p.PW, mpw, lq);
          g[i] = m < items ? it.g : -1;
          load_item(v[i], keep, 4 * i, m < items, it, sl, o, b, interior, cquads);
        }
#pragma unroll
        for (int i = 0; i < IB; ++i) finish_item<MODE>(v[i], keep, 4 * i, shifts, sl.sh);
        if (!ready) {  // the first loads are in flight while the stage drains
          if (n > 0) hopper::mbar_wait(&empty[s], (n - 1) & 1);
          ready = true;
        }
#pragma unroll
        for (int i = 0; i < IB; ++i)
          if (g[i] >= 0) row[swz_granule(g[i])] = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      }
    } else {  // small windows (items < 32 * IB): a batch spans windows
      constexpr int SB = IB;
      const int total = mine * items;
      for (int f0 = 0; f0 < total; f0 += 32 * SB) {
        float v[SB][4];
        int g[SB], j[SB];
        float sh[SB];
        unsigned long long keep = 0;
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          const int f = f0 + 32 * i + lane;
          const bool ok = f < total;
          const int jl = !ok ? 0 : items == 1 ? f : (int)__umulhi((unsigned int)f, p.mitems);  // f / items
          j[i] = pw + PWARPS * jl;
          const Slot sl = slots[j[i]];
          Box b;
          bool interior;
          const float* o = chunk_origin(p, sl, k, b, interior);
          const Item it = unpack_item(f - jl * items, cquads, p.PW, mpw, lq);
          g[i] = ok ? it.g : -1;
          sh[i] = sl.sh;
          load_item(v[i], keep, 4 * i, ok, it, sl, o, b, interior, cquads);
        }
#pragma unroll
        for (int i = 0; i < SB; ++i) finish_item<MODE>(v[i], keep, 4 * i, shifts, sh[i]);
        if (!ready) {
          if (n > 0) hopper::mbar_wait(&empty[s], (n - 1) & 1);
          ready = true;
        }
#pragma unroll
        for (int i = 0; i < SB; ++i)
          if (g[i] >= 0)
            reinterpret_cast<float4*>(rows + j[i] * rowf)[swz_granule(g[i])] =
                make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      }
    }
    if (!ready && n > 0) hopper::mbar_wait(&empty[s], (n - 1) & 1);
    __syncwarp();  // the warp's stores, ordered before its one arrival
    if (lane == 0) hopper::mbar_arrive(&full[s]);
    next_stage(s, n, p.stages);
  }
}

template <int MODE>
__device__ Slot make_slot(const Params& p, long long win, int pass) {
  int m = 0;
  while (m + 1 < p.nmaps && win >= p.maps[m + 1].first_win) ++m;
  const Map& mp = p.maps[m];
  const long long local = win - mp.first_win;
  const int gl = (int)(local / mp.NW);
  int k = (int)(local - (long long)gl * mp.NW);
  const int kc = k % mp.nwc;
  k /= mp.nwc;
  const int kw = k % mp.nww, kh = k / mp.nww;
  Slot sl;
  sl.base = mp.x + gl * mp.gstride;
  sl.h0 = kh * mp.wh - mp.loh;
  sl.w0 = kw * mp.ww - mp.low;
  sl.c0 = kc * mp.wc - mp.loc;
  sl.wh = mp.wh;
  sl.ww = mp.ww;
  sl.wc = mp.wc;
  sl.H = mp.H;
  sl.W = mp.W;
  sl.Cg = mp.Cg;
  const int g = mp.first_group + gl;
  sl.sh = MODE == SUMS && p.shift ? p.shift[g] : (MODE == INSTANCE && pass == 1 ? __ldcg(p.out_a + g) : 0.f);
  return sl;
}

// src[0, n) -> dst by the whole block, eight loads per thread issued
// before any is stored (a loop of load-then-store waited on each load)
__device__ void stage_to_shared(float* dst, const float* src, long long n) {
  for (long long i0 = threadIdx.x; i0 < n; i0 += 8LL * THREADS) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long i = i0 + (long long)u * THREADS;
      v[u] = __ldcg(src + (i < n ? i : 0));
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long i = i0 + (long long)u * THREADS;
      if (i < n) dst[i] = v[u];
    }
  }
  __syncthreads();
}

// Group g's sum a and sum of squares a2 (its window partials added in
// window order), and for a GroupNorm also Flax's mean and fast variance as
// jax.jit computes them (ops/numerics.xla_mean_var): mean = sum * inv,
// variance = max(0, fma(sum2, inv, -square)), square = mean * mean, or
// (sum * sum) * inv2 for a single group.
__device__ __forceinline__ void group_out(const Params& p, long long g, float a, float a2) {
  const Map& m = p.maps[0];
  p.out_a[g] = a;
  p.out_b[g] = a2;
  if (p.out_mean) {
    const float mean = __fmul_rn(a, m.inv);
    const float sq = m.G == 1 ? __fmul_rn(__fmul_rn(a, a), m.inv2) : __fmul_rn(mean, mean);
    const float v = __fmaf_rn(a2, m.inv, -sq);
    p.out_mean[g] = mean;
    p.out_var[g] = v > 0.f ? v : 0.f;
  }
}

// Sums mode where every block holds whole groups: the block's groups [g0,
// g1), one thread each, from the partials this block wrote (no last block).
__device__ void sums_local(const Params& p, long long g0, long long g1) {
  const int NW = p.maps[0].NW;
  for (long long g = g0 + threadIdx.x; g < g1; g += THREADS) {
    const float* part = p.partials + 2 * g * NW;
    float a = 0.f, a2 = 0.f;
#pragma unroll 8
    for (int k = 0; k < NW; ++k) {
      a = __fadd_rn(a, part[2 * k]);
      a2 = __fadd_rn(a2, part[2 * k + 1]);
    }
    group_out(p, g, a, a2);
  }
}

// The last block, sums mode: every group's window partials in window order
// (staged through shared memory as many groups at a time as fit), one
// thread per group.
__device__ void sums_final(const Params& p, float* buf, int buf_floats) {
  const Map& m = p.maps[0];
  const int cap = buf_floats / (2 * m.NW);
  const int TG = cap < 1 ? 1 : cap;
  for (int g0 = 0; g0 < m.G; g0 += TG) {
    const int ng = m.G - g0 < TG ? m.G - g0 : TG;
    const long long off = 2LL * g0 * m.NW;
    if (cap >= 1) stage_to_shared(buf, p.partials + off, 2LL * ng * m.NW);
    for (int j = threadIdx.x; j < ng; j += THREADS) {
      float a = 0.f, a2 = 0.f;
      for (int k = 0; k < m.NW; ++k) {
        const long long i = 2LL * ((long long)j * m.NW + k);
        a = __fadd_rn(a, cap >= 1 ? buf[i] : __ldcg(p.partials + off + i));
        a2 = __fadd_rn(a2, cap >= 1 ? buf[i + 1] : __ldcg(p.partials + off + i + 1));
      }
      group_out(p, g0 + j, a, a2);
    }
    __syncthreads();
  }
}

// The last block, instance mode: each group's partials of `pass` in window
// order (staged through shared memory when they fit), times the map's
// f32(1 / (H * W)): the means (pass 0) or variances (pass 1).
__device__ void instance_final(const Params& p, int pass, float* buf, int buf_floats) {
  const float* part = p.partials + pass * p.Wtot;
  const bool staged = p.Wtot <= buf_floats;
  if (staged) stage_to_shared(buf, part, p.Wtot);
  for (int g = threadIdx.x; g < p.Gtot; g += THREADS) {
    int m = 0;
    while (m + 1 < p.nmaps && g >= p.maps[m + 1].first_group) ++m;
    const Map& mp = p.maps[m];
    const long long first = mp.first_win + (long long)(g - mp.first_group) * mp.NW;
    float a = 0.f;
    if (staged) {
      for (int k = 0; k < mp.NW; ++k) a = __fadd_rn(a, buf[first + k]);
    } else {
#pragma unroll 8
      for (int k = 0; k < mp.NW; ++k) a = __fadd_rn(a, __ldcg(part + first + k));
    }
    (pass == 0 ? p.out_a : p.out_b)[g] = __fmul_rn(a, mp.inv);
  }
  __syncthreads();
}

// Ring positions [real, E) of every row hold 0 (the chunk's padding).
__device__ void zero_tails(const Params& p, float* ring) {
  const int rowf = p.E + 4, real = p.R * p.PW * p.PC, tail = p.E - real;
  for (int i = threadIdx.x; i < p.stages * p.per_round * tail; i += THREADS) {
    const int row = i / tail;
    ring[row * rowf + swz(real + i - row * tail)] = 0.f;
  }
}

template <int MODE, bool SMALL>
__global__ void __launch_bounds__(THREADS, 1) xla_order_sums_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float ring[];  // [stages][per_round][E + 4]
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[MAX_STAGES];
  __shared__ Slot slots[MAX_SLOTS];
  __shared__ unsigned int ticket;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ring_floats = p.stages * p.per_round * (p.E + 4);

  zero_tails(p, ring);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(&full[s], producer_warps<SMALL>());  // one arrival per warp
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  const bool consumer = warp < 2, producer = SMALL ? warp >= 2 : (warp & 2) != 0;
  const int pw = SMALL ? warp - 2 : (warp >> 2) * 2 + (warp & 1);  // producer warp
  const long long first = (long long)blockIdx.x * p.per_block;
  const long long end = p.Wtot < first + p.per_block ? p.Wtot : first + p.per_block;
  int s = 0;           // the ring's stage and its use count: the same sequence
  unsigned int n = 0;  // on both sides, across rounds and passes
  constexpr int PASSES = MODE == INSTANCE ? 2 : 1;
  bool last = false;
  for (int pass = 0; pass < PASSES; ++pass) {
    for (int t = 0; t < p.rounds; ++t) {
      const long long w0 = first + (long long)t * p.per_round;
      if (w0 >= end) break;
      const int nwin = (int)(end - w0 < p.per_round ? end - w0 : p.per_round);
      if (producer) {
        producer_sync<SMALL>();  // the previous round's slots are read
        const int ptid = pw * 32 + lane;
        if (ptid < nwin) slots[ptid] = make_slot<MODE>(p, w0 + ptid, pass);
        producer_sync<SMALL>();
        produce<MODE, SMALL>(p, ring, full, empty, slots, nwin, pw, lane, pass, s, n);
      } else if (consumer) {
        const int slot_raw = MODE == INSTANCE ? tid : lane;
        const int slot = slot_raw < nwin ? slot_raw : nwin - 1;  // idle lanes read a live row
        const bool squares = MODE == INSTANCE ? pass == 1 : warp == 1;
        const float acc = squares ? consume<true>(p, ring, full, empty, slot, s, n)
                                  : consume<false>(p, ring, full, empty, slot, s, n);
        if (slot_raw < nwin)
          p.partials[MODE == INSTANCE ? pass * p.Wtot + w0 + slot_raw : 2 * (w0 + slot_raw) + squares] = acc;
      }
    }
    __syncthreads();  // this block's partials are written
    if (MODE != INSTANCE && p.local) {
      const int NW = p.maps[0].NW;
      sums_local(p, first / NW, end / NW);
      return;
    }
    if (tid == 0) {
      __threadfence();
      ticket = atomicAdd(&p.counters[pass == PASSES - 1 ? 0 : 1], 1u);
    }
    __syncthreads();
    last = ticket == gridDim.x - 1;
    if (MODE == INSTANCE && pass == 0) {  // the means, then every block's second pass
      if (last) {
        __threadfence();
        instance_final(p, 0, ring, ring_floats);
        zero_tails(p, ring);
        if (tid == 0) {
          __threadfence();
          atomicExch(&p.counters[2], 1u);
        }
      } else if (tid == 0) {
        const long long start = clock64();
        while (ld_acquire(&p.counters[2]) == 0u) {
          if (clock64() - start > 20000000000LL) __trap();  // a block that never came: an error, not a hang
          __nanosleep(100);
        }
        __threadfence();
      }
      __syncthreads();
    }
  }
  if (!last) return;
  __threadfence();
  if (MODE == INSTANCE)
    instance_final(p, 1, ring, ring_floats);
  else
    sums_final(p, ring, ring_floats);
  if (tid == 0) {  // every block has passed every counter
    p.counters[0] = 0u;
    p.counters[1] = 0u;
    p.counters[2] = 0u;
  }
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

int pow2_at_least(int v) {
  int q = 1;
  while (q < v) q <<= 1;
  return q;
}
// ceil(2^32 / d): m / d == __umulhi(m, magic(d)) for m < 2^16 and 1 < d <= 2^16 (d = 1: the caller divides by nothing)
unsigned int magic(int d) { return d <= 1 ? 0u : (unsigned int)((0x100000000ULL + d - 1) / d); }
int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

bool ring_fits(int per_round, int E, int stages) {
  return (size_t)stages * per_round * (E + 4) * sizeof(float) <= RING_LIMIT;
}

int sm_count() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cache[dev]) return cache[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < 64) cache[dev] = n;
  return n;
}

template <int MODE, bool SMALL>
int launch(Params& p, unsigned blocks, size_t smem, cudaStream_t st) {
  // set on every launch: the attribute belongs to the current device
  const cudaError_t a = cudaFuncSetAttribute(xla_order_sums_kernel<MODE, SMALL>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (a != cudaSuccess) return (int)a;
  if (MODE == INSTANCE) {  // its blocks wait for each other: all resident, or the launch is refused
    void* args[] = {&p};
    return (int)cudaLaunchCooperativeKernel((const void*)xla_order_sums_kernel<MODE, SMALL>, dim3(blocks),
                                            dim3(THREADS), args, smem, st);
  }
  xla_order_sums_kernel<MODE, SMALL><<<blocks, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// The ring for rounds of per_round windows (halved until a ring fits):
// rows R of the window per chunk, E floats per row and chunk, stages.  The
// whole window in one chunk where it fits in CHUNK floats, else the most
// rows, a power of two, in CHUNK floats (fewer chunks: fewer handoffs, each
// ~1 us on the card); as many stages as RING_LIMIT holds (up to MAX_STAGES,
// at least 3, else 2), fewer rows before fewer than 3 stages.
void fit_ring(int& per_round, int PH, int rowsz, int& R, int& E, int& stages) {
  R = E = stages = 0;
  for (;;) {
    int r = 1;
    if (PH * rowsz <= CHUNK)
      r = PH;
    else
      while (2 * r * rowsz <= CHUNK && r < PH) r *= 2;
    for (;; r /= 2) {
      const int e = (r * rowsz + 63) / 64 * 64;
      for (int k = MAX_STAGES; k >= 3 && !stages; --k)
        if (ring_fits(per_round, e, k)) R = r, E = e, stages = k;
      if (stages || r == 1) break;
    }
    const int e1 = (rowsz + 63) / 64 * 64;
    if (!stages && ring_fits(per_round, e1, 2)) R = 1, E = e1, stages = 2;
    if (stages) return;
    per_round = (per_round + 1) / 2;
  }
}

// The producers' waves of loads in a round of per_round windows of `items`
// items a chunk: its (window, batch) tasks over the producer warps, or
// with small windows its batches of items.
int producer_waves(int per_round, int items) {
  constexpr int B = 32 * IB;
  if (items < B) return (per_round * items + B * producer_warps<true>() - 1) / (B * producer_warps<true>());
  return (per_round * ((items + B - 1) / B) + producer_warps<false>() - 1) / producer_warps<false>();
}

// Fills the launch plan (windows per round and block, chunking, stages) and
// launches: rounds of at most `cap` windows spread over the SMs, the ring
// as fit_ring sizes it.
template <int MODE>
int plan_and_launch(Params& p, int cap, cudaStream_t st) {
  const int nsm = sm_count();
  if (nsm <= 0) return (int)cudaErrorInvalidDevice;
  // the chunk's extents padded to powers of two (zeros in the chain)
  p.PC = p.PC == 1 ? 1 : pow2_at_least(p.PC < 4 ? 4 : p.PC);
  if (p.PC == 1) p.PW = pow2_at_least(p.PW < 4 ? 4 : p.PW);
  p.lpw = log2i(p.PW);
  p.lpc = log2i(p.PC);
  const int rowsz = p.PW * p.PC;
  long long rounds = (p.Wtot + (long long)cap * nsm - 1) / ((long long)cap * nsm);
  const int spread = (int)((p.Wtot + rounds * nsm - 1) / (rounds * nsm));
  int per_round = spread, R = 0, E = 0, stages = 0;
  fit_ring(per_round, p.PH, rowsz, R, E, stages);
  // sums mode: where a group's windows fit in a round, rounds of whole
  // groups, so that each block adds its own groups' partials (no last
  // block), unless the ring then takes fewer rows per chunk or the
  // producers more waves of loads (on the H100, [1, 1, 68, 68]: its 9 windows in one
  // block took 10.9 us, over 9 blocks and a last block 9.1)
  const int NW = p.maps[0].NW;
  if (MODE != INSTANCE && NW <= cap) {
    const int whole = (spread + NW - 1) / NW;
    int pr = (whole < cap / NW ? whole : cap / NW) * NW, r2 = 0, e2 = 0, s2 = 0;
    fit_ring(pr, p.PH, rowsz, r2, e2, s2);
    if (pr % NW == 0 && r2 >= R && producer_waves(pr, r2 * rowsz / 4) <= producer_waves(per_round, R * rowsz / 4))
      per_round = pr, R = r2, E = e2, stages = s2;
  }
  rounds = (p.Wtot + (long long)per_round * nsm - 1) / ((long long)per_round * nsm);
  p.R = R;
  p.items = R * rowsz / 4;
  p.mpw = magic(p.PW);
  p.mitems = magic(p.items);
  p.E = E;
  p.nchunks = (p.PH + R - 1) / R;
  p.stages = stages;
  p.per_round = per_round;
  p.rounds = (int)rounds;
  p.per_block = per_round * rounds;
  p.local = MODE != INSTANCE && p.per_block % NW == 0;
  const long long blocks = (p.Wtot + p.per_block - 1) / p.per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * stages * per_round * (E + 4);
  const bool small = (R * rowsz) / 4 < 32 * IB;  // a window's chunk has fewer items than a producer batch
  return small ? launch<MODE, true>(p, (unsigned)blocks, smem, st) : launch<MODE, false>(p, (unsigned)blocks, smem, st);
}

int instance_maps(int nmaps, const void* const* xs, const int* shapes, const float* invs, Params* p) {
  if (nmaps <= 0 || nmaps > MAX_MAPS) return (int)cudaErrorInvalidValue;
  p->nmaps = nmaps;
  p->Wtot = 0;
  p->Gtot = 0;
  p->PH = p->PW = 1;
  p->PC = 1;
  for (int i = 0; i < nmaps; ++i) {
    Map& m = p->maps[i];
    const int* s = shapes + 4 * i;
    const int err = make_map(static_cast<const float*>(xs ? xs[i] : nullptr), s[0], s[1], s[2], s[3], 1, &m);
    if (err != 0) return err;
    m.first_win = p->Wtot;
    m.first_group = p->Gtot;
    m.inv = invs ? invs[i] : 0.f;
    m.inv2 = 0.f;
    p->Wtot += (long long)m.G * m.NW;
    if ((long long)p->Gtot + m.G > INT_MAX) return (int)cudaErrorInvalidValue;
    p->Gtot += m.G;
    if (m.wh > p->PH) p->PH = m.wh;
    if (m.ww > p->PW) p->PW = m.ww;
  }
  return 0;
}

}  // namespace

extern "C" {

// floats of device scratch one launch needs: the window partials
size_t xla_order_sums_workspace_floats(int B, int C, int H, int W, int per_channel) {
  Map m;
  if (make_map(nullptr, B, C, H, W, per_channel, &m) != 0) return 0;
  return (size_t)(2LL * m.G * m.NW);
}

// x: [B, C, H, W] f32, contiguous, on the device ([B, F] as [B, F, 1, 1]).
// A group is a sample (per_channel 0) or one channel of a sample (1); its
// sum and sum of squares go to out_sum[g], out_sumsq[g] ([B] or [B * C]).
// shift: null, or [G] f32 subtracted from every element of its group first;
// round_bf16: round every element to bf16 first (not with a shift).
// workspace: xla_order_sums_workspace_floats(...) floats; counters: three
// unsigned ints that hold 0 (the launch leaves them 0), used by no launch
// on another stream while this one runs.
// out_mean, out_var: null, or [G] each for the group's mean and variance as
// jax.jit computes Flax GroupNorm's (inv = f32(1 / n), inv2 = f32(inv *
// inv), n the elements per group).
// One launch on `stream`, no synchronisation; returns the CUDA error of the
// launch (or cudaErrorInvalidValue for a shape or flags it does not take).
int xla_order_sums_launch(const float* x, int B, int C, int H, int W, int per_channel, int round_bf16,
                          const float* shift, float* out_sum, float* out_sumsq, float* workspace,
                          unsigned int* counters, float inv, float inv2, float* out_mean, float* out_var,
                          void* stream) {
  Params p{};
  Map& m = p.maps[0];
  const int err = make_map(x, B, C, H, W, per_channel, &m);
  if (err != 0) return err;
  if (round_bf16 && shift) return (int)cudaErrorInvalidValue;
  if ((out_mean == nullptr) != (out_var == nullptr)) return (int)cudaErrorInvalidValue;
  m.first_win = 0;
  m.first_group = 0;
  m.inv = inv;
  m.inv2 = inv2;
  p.nmaps = 1;
  p.Wtot = (long long)m.G * m.NW;
  p.Gtot = m.G;
  if (p.Wtot == 0) return 0;
  p.PH = m.wh;
  p.PW = m.ww;
  p.PC = m.wc;
  p.shift = shift;
  p.partials = workspace;
  p.out_a = out_sum;
  p.out_b = out_sumsq;
  p.out_mean = out_mean;
  p.out_var = out_var;
  p.counters = counters;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return round_bf16 ? plan_and_launch<SUMS_ROUND>(p, 32, st) : plan_and_launch<SUMS>(p, 32, st);
}

// floats of device scratch an instance-statistics launch needs
size_t xla_order_instance_workspace_floats(int nmaps, const int* shapes) {
  Params p{};
  if (instance_maps(nmaps, nullptr, shapes, nullptr, &p) != 0) return 0;
  return (size_t)(2 * p.Wtot);
}

// The instance norms' statistics of nmaps maps in one launch: map i is
// xs[i], [B, C, H, W] = shapes[4i .. 4i + 3], f32, contiguous, on the
// device; each channel of each sample is a group, groups numbered map by
// map.  out_mean[g] = f32(sum * invs[i]) and out_var[g] = f32(sum of
// (x - mean)^2 * invs[i]), both sums in XLA's order, invs[i] = f32(1 / (H *
// W)) (detector_ops.instance_norm's).  workspace and counters as for
// xla_order_sums_launch.  One cooperative launch on `stream`; returns its
// CUDA error (cudaErrorCooperativeLaunchTooLarge if its blocks cannot all be
// resident).
int xla_order_instance_stats_launch(int nmaps, const void* const* xs, const int* shapes, const float* invs,
                                    float* out_mean, float* out_var, float* workspace, unsigned int* counters,
                                    void* stream) {
  Params p{};
  const int err = instance_maps(nmaps, xs, shapes, invs, &p);
  if (err != 0) return err;
  if (p.Wtot == 0) return 0;
  p.partials = workspace;
  p.out_a = out_mean;
  p.out_b = out_var;
  p.counters = counters;
  return plan_and_launch<INSTANCE>(p, 2 * 32, static_cast<cudaStream_t>(stream));
}

// One warp adds a dependent chain of n f32 adds (n a multiple of 8) per
// lane on `stream`: t[0] <- SM cycles, t[1] <- nanoseconds; out: 32 floats.
int xla_order_sums_add_probe(int n, float* out, long long* t, void* stream) {
  if (n <= 0 || n % 8) return (int)cudaErrorInvalidValue;
  add_chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(n, 1e-7f, out, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
