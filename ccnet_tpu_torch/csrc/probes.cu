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
// chunks (C bf16 values with C % 8 == 0). One block per (n, 8 a, 8 b)
// tile: the 64 rows go through shared memory (512 bytes of each per pass),
// loaded in x's order and stored in y's, with 16-byte loads and stores along
// the row, so both sides are read and written in runs of whole rows. Bit
// exact: it moves bytes.
//
// probe_scale: y = s x, one thread per element, the tail of the last block
// masked. Exact for s = 2.

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;

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

constexpr int ST = 8;   // a and b per tile
constexpr int SR = 32;  // 16-byte chunks of a row staged per pass

__global__ void __launch_bounds__(THREADS)
swap_leading_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int A, int Bd, int R) {
  __shared__ uint4 tile[ST * ST][SR];  // 32 KB
  const int a0 = blockIdx.x * ST, b0 = blockIdx.y * ST;
  const size_t plane = (size_t)A * Bd * R;
  const uint4* xn = x + blockIdx.z * plane;
  uint4* yn = y + blockIdx.z * plane;
  for (int r0 = 0; r0 < R; r0 += SR) {
    const int nr = min(SR, R - r0);
    for (int i = threadIdx.x; i < ST * ST * SR; i += THREADS) {
      const int row = i / SR, c = i % SR;
      const int a = a0 + row / ST, b = b0 + row % ST;  // x's order: b fastest
      if (c < nr && a < A && b < Bd) tile[row][c] = xn[((size_t)a * Bd + b) * R + r0 + c];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < ST * ST * SR; i += THREADS) {
      const int row = i / SR, c = i % SR;
      const int ib = row / ST, ia = row % ST;  // y's order: a fastest
      const int a = a0 + ia, b = b0 + ib;
      if (c < nr && a < A && b < Bd)
        yn[((size_t)b * A + a) * R + r0 + c] = tile[ia * ST + ib][c];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
scale_kernel(const float* __restrict__ x, float* __restrict__ y, long long n, float s) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) y[i] = x[i] * s;
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

// x (N, A, Bd, row_bytes) -> y (N, Bd, A, row_bytes), both contiguous and
// 16-byte aligned, row_bytes % 16 == 0. Returns cudaGetLastError().
int probe_swap_leading(const void* x, void* y, int N, int A, int Bd, int row_bytes,
                       void* stream) {
  if (N < 1 || A < 1 || Bd < 1 || row_bytes < 16 || row_bytes % 16 != 0 || N > 65535 ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(cdiv(A, ST), cdiv(Bd, ST), N);
  swap_leading_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), A, Bd, row_bytes / 16);
  return (int)cudaGetLastError();
}

// y = s * x over n f32 values. Returns cudaGetLastError().
int probe_scale(const void* x, void* y, long long n, float s, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  scale_kernel<<<cdiv(n, THREADS), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
