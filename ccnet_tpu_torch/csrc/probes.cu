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
// P4 reads the NHWC columns in place with (H W C, W C, C). One block of 4
// warps per (n, line t, 64 query rows h); the line's keys stream through
// shared memory in tiles of 64 rows x 64 channels (bf16, rows padded to 72
// so the fragment loads are conflict-free), and each warp multiplies its 16
// query rows by the key tile on the tensor cores, mma.sync m16n8k16 bf16
// with f32 accumulators, fragments read straight from the staged strided
// columns (no transposed copy). Ragged H and C are zero-filled in shared
// memory and masked at the store; every line is its own block, so the
// ragged column tile of the TPU grid does not arise. This is the K1
// redesign's experiment: how close column logits read in place come to the
// bytes they must move.
//
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

constexpr int MT = 64;            // query rows h per block: 4 warps x 16
constexpr int NT = 64;            // key rows g per tile: 8 mma tiles of 8
constexpr int KC = 64;            // channels staged per pass: 4 mma steps of 16
constexpr int KP = KC + 8;        // padded row: 36 words, fragment loads hit 32 banks
constexpr int DOT_THREADS = 128;

__global__ void __launch_bounds__(DOT_THREADS)
mid_batch_dot_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     float* __restrict__ e, int T, int H, int C, long long sN, long long sH,
                     long long sT) {
  __shared__ __align__(16) __nv_bfloat16 qs[MT][KP];
  __shared__ __align__(16) __nv_bfloat16 ks[NT][KP];
  const int h0 = blockIdx.x * MT, t = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // the mma fragment coordinates
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const __nv_bfloat16* qb = q + n * sN + t * sT;
  const __nv_bfloat16* kb = k + n * sN + t * sT;
  float* eb = e + ((size_t)n * T + t) * H * H;
  const int ar = warp * 16 + gid;  // this thread's A rows: ar and ar + 8
  for (int g0 = 0; g0 < H; g0 += NT) {
    float acc[NT / 8][4];
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int c0 = 0; c0 < C; c0 += KC) {
      for (int i = tid; i < MT * KC; i += DOT_THREADS) {
        const int r = i / KC, c = i % KC, cc = c0 + c;
        const int h = h0 + r, g = g0 + r;
        qs[r][c] = (h < H && cc < C) ? qb[h * sH + cc] : zero;
        ks[r][c] = (g < H && cc < C) ? kb[g * sH + cc] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        const int c = kk + tig * 2;
        const uint32_t a[4] = {pair(&qs[ar][c]), pair(&qs[ar + 8][c]), pair(&qs[ar][c + 8]),
                               pair(&qs[ar + 8][c + 8])};
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const uint32_t b[2] = {pair(&ks[j * 8 + gid][c]), pair(&ks[j * 8 + gid][c + 8])};
          mma_16816(acc[j], a, b);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int g = g0 + j * 8 + tig * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int h = h0 + ar + 8 * half;
        if (h >= H) continue;
        if (g < H) eb[(size_t)h * H + g] = acc[j][2 * half];
        if (g + 1 < H) eb[(size_t)h * H + g + 1] = acc[j][2 * half + 1];
      }
    }
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

unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

extern "C" {

// q, k bf16 with pixel (n, h, t) at n*sN + h*sH + t*sT elements, channels
// contiguous; e (N, T, H, H) f32 contiguous. Returns cudaGetLastError().
int probe_mid_batch_dot(const void* q, const void* k, void* e, int N, int T, int H, int C,
                        long long sN, long long sH, long long sT, void* stream) {
  if (N < 1 || T < 1 || H < 1 || C < 1 || N > 65535 || T > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(cdiv(H, MT), T, N);
  mid_batch_dot_kernel<<<grid, DOT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<float*>(e), T, H, C, sN, sH, sT);
  return (int)cudaGetLastError();
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
