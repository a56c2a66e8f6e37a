// The layout probes of the criss-cross attention redesign, for Hopper (sm_90a):
// probe_mid_batch_dot, probe_swap_leading, probe_scale.
//
// Replaces the five Pallas kernels of scripts/probe_mosaic.py, which ask
// what Mosaic can lower for a fused CCA kernel. They are three operations:
//   probe_mid_batch_dot  <- _mid_batch_kernel (P1, (H, T, C) operands) and
//                           _mid_batch4_kernel (P4, NHWC (B, H, W, C) on a
//                           (B, column tile) grid)
//   probe_swap_leading   <- _swap_kernel (P2, (H, T, C) -> (T, H, C)) and
//                           _store_transposed_kernel (P5, NHWC ->
//                           column-major (B, W, H, C) on a grid)
//   probe_scale          <- _tile_kernel (P3, 2 x over a ragged 16-row grid)
// P4 is the column path's logits of K1 (e = q.k^T over the H pixels of each
// NHWC column) and P5 the column-major copy the TPU's legacy route made
// with _to_col, so timed at the model's shapes they measure the two layout
// choices of the K1-K4 redesign: read columns in place, or copy them first.
// The TPU kernels pad their outputs to a multiple of the 16-column tile;
// nothing reads those rows, and these kernels write only the used part.
//
// What bounds them on the H100: all three are memory-bound. At the model's
// shapes (B 8, 97 x 97, q/k 64, v 512, bf16) the dot moves 19.3 MB in and
// 29.2 MB of f32 logits out for 0.93 GFLOP (19 FLOP per byte, far below the
// ~295 of the bf16 tensor cores); the copies move every byte twice and do
// no arithmetic; the scale does one multiply per 8 bytes.
//
// probe_mid_batch_dot: e[n, t, h, g] = sum_c q[n, h, t, c] k[n, g, t, c],
// f32 sums of bf16 products. Pixel (n, h, t) sits at n sN + h sH + t sT
// elements with contiguous channels, so P1 is (sN, sH, sT) = (0, T C, C) and
// P4 reads the NHWC columns in place with (H W C, W C, C). A line (n, t)'s
// logits are one contiguous run of H H floats of e, and 60 % of the bytes,
// so the design is built around reading each line's q and k once and
// writing that run with full 16-byte stores:
// - a work item is a band of query rows of one line, with all the line's
//   keys: the band's q rows and the keys are staged into dynamic shared
//   memory, 64 channels at a time, with 16-byte cp.async (a scalar path
//   when C % 8 or a stride or base is not 16-byte aligned), rows padded to
//   72 bf16 so ldmatrix is conflict-free and zero-filled to a multiple of
//   16 (112 x 112 at H = 97, where the old 64-row tiles padded to 128 x
//   128, and staged q again for every 64 keys);
// - each warp holds an even run of up to 64 / warps consecutive 16 x 16
//   output tiles of the band (row-major, so mostly one row of tiles: q's
//   fragment is loaded once per row) in f32 registers across the channel
//   chunks (ldmatrix + mma.sync m16n8k16: wgmma's 64-row tiles would pad 97
//   to 128, and the tensor cores are not the limit), then writes them into
//   an f32 copy of the band's run of e in shared memory, placed at the
//   run's offset modulo 16 bytes;
// - the run goes out as a scalar head to e's 16-byte boundary, a float4
//   body read straight from shared memory, and a scalar tail (the split of
//   the scale below), no 2-byte or misaligned stores;
// - one block per resident slot loops over its items; two staging buffers
//   let the next stage's loads fly while this stage multiplies and stores;
// - two builds: blocks of 8 warps, two per SM (128 registers a thread), when
//   the lines fill every SM (P4: 776 whole-line items on 264 blocks), and
//   of 16 warps, one per SM, when they do not (P1: 97 whole lines), so a
//   line's products and stores spread over twice the warps;
// - the plan (ops/probes.py dot_plan, passed as one struct) picks the
//   build and the band: the whole line when the lines fill the resident
//   slots, else bands of whole 16-row tiles so that the items do, fewer
//   rows when the staging and the band outgrow 227 KB of shared memory or
//   64 tiles (H >= 129), and keys in passes of 512 past H = 512. Its CPU
//   replay (dot_coverage) holds that every logit is written once.
//
// What holds it back (chip_smoke.dot_diagnostics, PERF.md): the staging
// loads. With the products, the band and the stores left out, P4's loads
// alone take 19 us, 1 TB/s for rows of 128 bytes at a 12 KB stride.

// probe_swap_leading: y[n, b, a, :] = x[n, a, b, :] for rows of R 16-byte
// chunks (C bf16 values with C % 8 == 0), bit exact: it moves bytes. A
// swap of the two leading axes moves whole rows, so no chunk needs another
// thread's data and nothing is staged in shared memory: consecutive threads
// own consecutive 16-byte chunks of y (stores fully coalesced) and read x
// in runs of R chunks (1 KB rows at the model's width). The destination ->
// source map costs two divisions by multiply-shift (by R, then by A) in
// 32-bit arithmetic within a plane (a plane's chunks fit 32 bits: in and
// out would need 128 GB otherwise). The grid is (tiles of a plane, n).
//
// probe_scale: y = s x over n f32 values, exact for s = 2. A scalar head up
// to x's first 16-byte boundary, a float4 body, and a scalar tail; y has
// x's alignment modulo 16 bytes (the wrapper allocates it so), so one split
// serves both.
//
// What bounds the two on the H100: HBM, 16 bytes read and 16 written per
// chunk, no arithmetic to speak of. Both take one tile of COPY_THREADS x
// COPY_UNROLL chunks per block, one chunk per thread: the loads in flight
// come from occupancy (2048 threads on each SM). What chose that, timed in
// turns on the card by chip_smoke.probe_variants (PERF.md §6): a grid of
// one or four waves of resident blocks striding over the tiles was slower
// than one tile per block (by 8 % on the scale at one wave), 2 or 4 loads
// per thread before the stores bought nothing on the scale or P5's copy
// (P2's small copy, whose time the host's pace sets, gains 0.3 us with 4),
// and the streaming hints (ld.global.cs / st.global.cs) cost about 1 %, so
// plain loads and stores. Both kernels keep a grid-stride loop, so
// any grid covers the work; the plans (ops/probes.py swap_plan /
// scale_plan, held on the CPU against the Pallas kernels and for covering
// every element once) are computed in Python and passed as one struct, so
// a launch is four or five ctypes arguments.

#include "mma_bf16.cuh"

namespace {

constexpr int DOT_TILES = 64;     // 16 x 16 output tiles a block holds per pass
constexpr int KC = 64;            // channels staged per chunk: 4 mma steps of 16
constexpr int KP = KC + 8;        // padded row: 36 words, ldmatrix rows hit 32 banks

}  // namespace

// The launch plan of ops/probes.py dot_plan, field for field.
struct DotPlan {
  long long sN, sH, sT;  // element strides of pixel (n, h, t) in q and k
  int T, H, C;
  int band;              // query rows per work item
  int bands;             // items per line: ceil(H / band)
  int group;             // keys per pass: H, or a multiple of 16 below it
  int vec;               // 1: 16-byte cp.async staging (bases, strides and C aligned)
  int warps;             // 8 (two blocks per SM) or 16 (one block per SM, for few lines)
  int es_bytes;          // the band's f32 run of e in shared memory, 16-byte rounded
  int smem;              // dynamic shared memory: es_bytes + two staging buffers
  unsigned items;        // N T bands (line, band) items
  unsigned blocks;       // grid; block b takes items b, b + blocks, ...
};

namespace {

__host__ __device__ constexpr int ceil16(int x) { return (x + 15) & ~15; }

// One stage of a block's work: a chunk of channels of one pass of keys of
// one (line, band) item.
struct DotStage {
  const __nv_bfloat16* qb;  // the band's first q row, the line's first key
  const __nv_bfloat16* kb;
  long long start;          // the band's run of e
  int bh, g0, gn, c0, cw;   // band rows, the pass's keys, the chunk's channels
  bool first, last_chunk, last;  // the pass's first chunk, its last, the item's last
};

__device__ __forceinline__ DotStage dot_stage(const DotPlan& p, const __nv_bfloat16* q,
                                              const __nv_bfloat16* k, unsigned s) {
  const int chunks = (p.C + KC - 1) / KC, passes = (p.H + p.group - 1) / p.group;
  const unsigned per_item = chunks * passes, local = s / per_item;
  const int pass = (s - local * per_item) / chunks, chunk = s - local * per_item - pass * chunks;
  const unsigned item = blockIdx.x + local * gridDim.x;
  const unsigned line = item / p.bands, n = line / p.T, t = line - n * p.T;
  const int h0 = (item - line * p.bands) * p.band;
  DotStage w;
  w.qb = q + n * p.sN + t * p.sT + h0 * p.sH;
  w.kb = k + n * p.sN + t * p.sT;
  w.start = (long long)line * p.H * p.H + (long long)h0 * p.H;
  w.bh = min(p.band, p.H - h0);
  w.g0 = pass * p.group;
  w.gn = min(p.group, p.H - w.g0);
  w.c0 = chunk * KC;
  w.cw = min(KC, p.C - w.c0);
  w.first = chunk == 0;
  w.last_chunk = chunk == chunks - 1;
  w.last = w.last_chunk && pass == passes - 1;
  return w;
}

// rows [0, rows_p) x channels [0, cwp) of dst <- src[r sH + c0 + c] for
// r < rows and c < cw, zero elsewhere: 16-byte cp.async (committed as one
// group) or, unaligned, plain 2-byte loads
template <int WARPS>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                      long long sH, int rows, int rows_p, int c0, int cw,
                                      bool vec) {
  const int tid = threadIdx.x, cwp = ceil16(cw);
  if (vec) {  // 8 chunks of 16 bytes per row
    for (int i = tid; i < rows_p * (KC / 8); i += 32 * WARPS) {
      const int r = i >> 3, j = (i & 7) * 8;
      if (j < cwp) {
        const bool valid = r < rows && j < cw;
        cp_async16(dst + r * KP + j, valid ? src + r * sH + c0 + j : src, valid);
      }
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int r = tid >> 5; r < rows_p; r += WARPS)
      for (int c = tid & 31; c < cwp; c += 32)
        dst[r * KP + c] = (r < rows && c < cw) ? src[r * sH + c0 + c] : zero;
  }
}

// a stage's q band and keys into buf (q rows first, keys after band_p rows)
template <int WARPS>
__device__ __forceinline__ void stage_both(__nv_bfloat16* buf, const DotStage& w,
                                           const DotPlan& p, int band_p) {
  stage<WARPS>(buf, w.qb, p.sH, w.bh, ceil16(w.bh), w.c0, w.cw, p.vec);
  stage<WARPS>(buf + band_p * KP, w.kb + w.g0 * p.sH, p.sH, w.gn, ceil16(w.gn), w.c0, w.cw,
               p.vec);
  if (p.vec) cp_async_commit();
}

// WARPS warps, each holding up to DOT_TILES / WARPS tiles: 8 warps at two
// blocks per SM (128 registers a thread), or 16 at one
template <int WARPS>
__global__ void __launch_bounds__(32 * WARPS, 16 / WARPS)
mid_batch_dot_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     float* __restrict__ e, DotPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int band_p = ceil16(p.band);
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(smem + p.es_bytes);
  const int buf_elems = (band_p + ceil16(min(p.group, p.H))) * KP;
  const unsigned mine = (p.items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const unsigned stages = mine * ((p.C + KC - 1) / KC) * ((p.H + p.group - 1) / p.group);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;  // the mma fragment coordinates
  constexpr int ITEMS = DOT_TILES / WARPS;
  int arow[ITEMS], brow[ITEMS];               // this warp's tiles: q row, key row (-1: none)
  float acc[ITEMS][2][4];
  if (p.vec && stages > 0) stage_both<WARPS>(bufs, dot_stage(p, q, k, 0), p, band_p);
  for (unsigned s = 0; s < stages; ++s) {
    const DotStage w = dot_stage(p, q, k, s);
    __nv_bfloat16* cur = bufs + (s & 1) * buf_elems;
    if (p.vec) {
      cp_async_wait<0>();
    } else {
      stage_both<WARPS>(cur, w, p, band_p);
    }
    __syncthreads();  // stage s is in cur; every warp is done with stage s - 1
    if (p.vec && s + 1 < stages)  // the next stage's loads overlap this one's work
      stage_both<WARPS>(bufs + ((s + 1) & 1) * buf_elems, dot_stage(p, q, k, s + 1), p,
                        band_p);
    if (w.first) {  // the pass's tiles, row-major, in even runs of consecutive tiles per warp
      const int nps = ceil16(w.gn) >> 4, tiles = (ceil16(w.bh) >> 4) * nps;
      const int per = (tiles + WARPS - 1) / WARPS;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int tile = warp * per + i;
        const bool has = i < per && tile < tiles;
        arow[i] = has ? (tile / nps) * 16 : -1;
        brow[i] = has ? (tile % nps) * 16 : -1;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j >> 2][j & 3] = 0.f;
      }
    }
    const __nv_bfloat16* qs = cur;
    const __nv_bfloat16* ks = cur + band_p * KP;
    for (int kk = 0; kk < ceil16(w.cw); kk += 16) {
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        if (arow[i] < 0) continue;
        if (i == 0 || arow[i] != arow[i - 1]) load_a(a, qs, KP, arow[i], kk, lane);
        uint32_t b[4];
        load_b2(b, ks, KP, brow[i], kk, lane);
        mma_2(acc[i][0], acc[i][1], a, b);
      }
    }
    if (!w.last_chunk) continue;
    // es[j] holds e[start + j]; es + head is 16-byte aligned where e + start + head is
    float* es = reinterpret_cast<float*>(smem) + (w.start & 3);
    const int H = p.H;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (arow[i] < 0) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // n-tile j >> 2, row half (j >> 1) & 1, column j & 1
        const int r = arow[i] + gid + 8 * ((j >> 1) & 1);
        const int g = w.g0 + brow[i] + 8 * (j >> 2) + 2 * tig + (j & 1);
        if (r < w.bh && g < H) es[r * H + g] = acc[i][j >> 2][j & 3];
      }
    }
    if (!w.last) continue;
    __syncthreads();  // the band's run is whole in es
    const int run = w.bh * H;
    const int head = min(run, (int)((4 - (w.start & 3)) & 3));
    const int body = (run - head) >> 2, tail = run - head - 4 * body;
    float* out = e + w.start;
    const float4* es4 = reinterpret_cast<const float4*>(es + head);
    float4* out4 = reinterpret_cast<float4*>(out + head);
    for (int i = threadIdx.x; i < body; i += 32 * WARPS) out4[i] = es4[i];
    if (threadIdx.x < head) out[threadIdx.x] = es[threadIdx.x];
    if (threadIdx.x < tail) out[head + 4 * body + threadIdx.x] = es[head + 4 * body + threadIdx.x];
  }
}

constexpr int COPY_THREADS = 256;
constexpr int COPY_UNROLL = 1;  // 16-byte loads per thread before its stores

}  // namespace

// The launch plans of ops/probes.py (swap_plan, scale_plan), field for field.
struct SwapPlan {
  unsigned n, a, b, r;      // x (n, a, b, r chunks) -> y (n, b, a, r chunks)
  unsigned r_mul, r_shift;  // i / r == (umulhi(i, r_mul) + i) >> r_shift
  unsigned a_mul, a_shift;  // likewise i / a
  unsigned blocks;          // grid (blocks, n)
};

struct ScalePlan {
  unsigned long long head, body, tail;  // scalars to x's 16-byte boundary, float4s, scalars
  unsigned blocks;
};

namespace {

// i / d for every 32-bit i, with (mul, shift) from ops/probes.py fast_divider(d)
__device__ __forceinline__ unsigned fast_div(unsigned i, unsigned mul, unsigned shift) {
  return (unsigned)(((unsigned long long)__umulhi(i, mul) + i) >> shift);
}

__global__ void __launch_bounds__(COPY_THREADS)
swap_leading_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, SwapPlan p) {
  const unsigned plane = p.a * p.b * p.r;
  x += (size_t)blockIdx.y * plane;
  y += (size_t)blockIdx.y * plane;
  const unsigned step = gridDim.x * COPY_THREADS * COPY_UNROLL;
  for (unsigned base = blockIdx.x * COPY_THREADS * COPY_UNROLL + threadIdx.x; base < plane;
       base += step) {
    uint4 v[COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const unsigned i = base + u * COPY_THREADS;
      if (i < plane) {
        const unsigned row = fast_div(i, p.r_mul, p.r_shift);  // y's row: b * A + a
        const unsigned b = fast_div(row, p.a_mul, p.a_shift);
        const unsigned a = row - b * p.a;
        v[u] = x[(a * p.b + b) * p.r + (i - row * p.r)];
      }
    }
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const unsigned i = base + u * COPY_THREADS;
      if (i < plane) y[i] = v[u];
    }
  }
}

__global__ void __launch_bounds__(COPY_THREADS)
scale_kernel(const float* __restrict__ x, float* __restrict__ y, ScalePlan p, float s) {
  const float4* x4 = reinterpret_cast<const float4*>(x + p.head);
  float4* y4 = reinterpret_cast<float4*>(y + p.head);
  const size_t step = (size_t)gridDim.x * COPY_THREADS * COPY_UNROLL;
  for (size_t base = (size_t)blockIdx.x * COPY_THREADS * COPY_UNROLL + threadIdx.x;
       base < p.body; base += step) {
    float4 v[COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const size_t i = base + u * COPY_THREADS;
      if (i < p.body) v[u] = x4[i];
    }
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const size_t i = base + u * COPY_THREADS;
      if (i < p.body) y4[i] = make_float4(v[u].x * s, v[u].y * s, v[u].z * s, v[u].w * s);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < p.head) y[threadIdx.x] = x[threadIdx.x] * s;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < p.tail) {
    const size_t i = p.head + 4 * p.body + threadIdx.x;
    y[i] = x[i] * s;
  }
}

}  // namespace

namespace {

// Raise the dot kernel's dynamic shared-memory limit to smem bytes, on the
// current device, once per larger plan, and ask for the SM's largest
// shared-memory carveout (two blocks of a whole 97-pixel line take 204 KB).
template <int WARPS>
cudaError_t dot_allow_smem(int smem) {
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= 64)) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && smem > allowed[dev]) {
    err = cudaFuncSetAttribute(mid_batch_dot_kernel<WARPS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mid_batch_dot_kernel<WARPS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) allowed[dev] = smem;
  }
  return err;
}

template <int WARPS>
cudaError_t dot_launch(const void* q, const void* k, void* e, const DotPlan& p, void* stream) {
  const cudaError_t err = dot_allow_smem<WARPS>(p.smem);
  if (err != cudaSuccess) return err;
  mid_batch_dot_kernel<WARPS><<<p.blocks, 32 * WARPS, p.smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<float*>(e), p);
  return cudaGetLastError();
}

template <int WARPS>
cudaError_t dot_occupancy(int smem, int* blocks) {
  cudaError_t err = dot_allow_smem<WARPS>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mid_batch_dot_kernel<WARPS>,
                                                        32 * WARPS, smem);
  return err;
}

}  // namespace

extern "C" {

// Blocks of the dot kernel of `warps` warps resident on one SM at smem bytes
// of dynamic shared memory (into *blocks). Returns the CUDA error.
int probe_mid_batch_dot_occupancy(int warps, int smem, int* blocks) {
  if (warps != 8 && warps != 16) return (int)cudaErrorInvalidValue;
  return (int)(warps == 8 ? dot_occupancy<8>(smem, blocks) : dot_occupancy<16>(smem, blocks));
}

// q, k bf16 with pixel (n, h, t) at n*sN + h*sH + t*sT elements, channels
// contiguous; e (N, T, H, H) f32 contiguous and 16-byte aligned; the grid and
// the shared memory as *plan says. Returns cudaGetLastError().
int probe_mid_batch_dot(const void* q, const void* k, void* e, const DotPlan* plan,
                        void* stream) {
  const DotPlan p = *plan;
  const bool aligned = (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 && p.C % 8 == 0 &&
                       p.sN % 8 == 0 && p.sH % 8 == 0 && p.sT % 8 == 0;
  const int keys = p.group < p.H ? p.group : p.H;  // staged per pass
  const long long stages = (long long)p.items * ((p.C + KC - 1) / KC) *
                           ((p.H + p.group - 1) / p.group);
  if (p.T < 1 || p.H < 1 || p.C < 1 || p.band < 1 || p.bands != (p.H + p.band - 1) / p.band ||
      p.group < 1 || (p.group < p.H && p.group % 16 != 0) || p.items < 1 ||
      p.items % p.bands != 0 || p.blocks < 1 || p.blocks > p.items ||
      stages + p.blocks >= (1ll << 32) || (p.vec && !aligned) || (uintptr_t)e % 16 != 0 ||
      (p.warps != 8 && p.warps != 16) || (ceil16(p.band) >> 4) * (ceil16(keys) >> 4) > DOT_TILES ||
      p.es_bytes != ceil16((p.band * p.H + 3) * 4) ||
      p.smem != p.es_bytes + 2 * (ceil16(p.band) + ceil16(keys)) * KP * 2)
    return (int)cudaErrorInvalidValue;
  return (int)(p.warps == 8 ? dot_launch<8>(q, k, e, p, stream)
                            : dot_launch<16>(q, k, e, p, stream));
}

// x (n, a, b, r chunks) -> y (n, b, a, r chunks), both contiguous and
// 16-byte aligned, as *plan says. Returns cudaGetLastError().
int probe_swap_leading(const void* x, void* y, const SwapPlan* plan, void* stream) {
  const SwapPlan p = *plan;
  if (p.n < 1 || p.n > 65535 || p.a < 1 || p.b < 1 || p.r < 1 || p.blocks < 1 ||
      p.r_shift > 31 || p.a_shift > 31 || (uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0 ||
      (unsigned long long)p.a * p.b * p.r + (unsigned long long)p.blocks * COPY_THREADS *
      COPY_UNROLL >= (1ull << 32))  // a plane's indices, one grid stride past its end
    return (int)cudaErrorInvalidValue;
  swap_leading_kernel<<<dim3(p.blocks, p.n), COPY_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), p);
  return (int)cudaGetLastError();
}

// y = s * x over head + 4 body + tail f32 values split as *plan says; x + head
// and y + head 16-byte aligned. Returns cudaGetLastError().
int probe_scale(const void* x, void* y, const ScalePlan* plan, float s, void* stream) {
  const ScalePlan p = *plan;
  const uintptr_t body_x = (uintptr_t)x + 4 * p.head, body_y = (uintptr_t)y + 4 * p.head;
  if (p.blocks < 1 || p.head > 3 || p.tail > 3 || p.head + p.body + p.tail < 1 ||
      body_x % 16 != 0 || body_y % 16 != 0)
    return (int)cudaErrorInvalidValue;
  scale_kernel<<<p.blocks, COPY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), p, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
