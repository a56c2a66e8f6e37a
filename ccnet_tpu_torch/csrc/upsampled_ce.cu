// Fused align-corners upsample + NLL for Hopper (sm_90a): K5 upsampled_nll_fwd,
// K6 upsampled_nll_bwd.
//
// Replaces the TPU kernels of ccnet_tpu/ops/upsampled_ce.py:
//   K5 upsampled_nll_fwd  <- _fwd_kernel
//   K6 upsampled_nll_bwd  <- _bwd_kernel
// The training loss upsamples OS-8 logits (B, C, h, w) bilinearly with
// align_corners=True to the label size (H, W) = ((h-1) r + 1, (w-1) r + 1)
// for an integer ratio r, then takes the per-pixel NLL
//   nll[y, x] = logsumexp_c u[c, y, x] - u[label, y, x]   (0 off [0, C)).
// Neither kernel builds the (B, C, H, W) upsampled tensor: every u value is
// recomputed from its 2 x 2 coarse neighbours with the JAX package's
// weights, exactly:
//   width  (_interp_matrix): lo, frac = divmod(x, r); weight 1 on column
//          w-1 once lo >= w-1, else (1 - frac/r, frac/r) on (lo, lo+1),
//          computed in double and rounded to f32 as numpy does;
//   height (_fwd_kernel): a lerp of coarse rows min(seg, h-1) and
//          min(seg+1, h-1) at wy = (y mod r) / r in f32, seg = y / r.
// Logits are NCHW f32 as the model emits them; labels are (B, H, W) int32
// or uint8 (255 = ignore, out of [0, C) for C <= 32).
//
// K5: one thread per fine pixel; the C <= 32 class values of u live in
// registers. Bound by the label read and the nll write (8 bytes per fine
// pixel; the coarse logits, 5.7 MB at 8 x 19 x 97 x 97 counted from the
// shapes, stay in L2) and the C exponentials.
//
// K6: the gather form, one warp per coarse logit column (b, k, x0). Its
// lanes visit the (2r-1)^2 fine pixels whose tent weights cover (k, x0),
// recompute u and the softmax there, and sum wy * wx * g * (p_c - [c =
// label]) for every class; a warp reduction gives the C gradients. Each u
// is recomputed about four times (once per covering coarse point), but no
// (B, C, H, W) tensor, no atomics, and the result is deterministic: this
// also settles the TPU kernel's sequential-band accumulation, which a GPU
// cannot run in parallel without atomics or partial sums. Bound by the
// recompute (C exponentials per visit) and L1 reads of the logits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Width tap of fine column x: coarse columns (x0, x1) and their weights.
__device__ __forceinline__ void width_taps(int x, int w, int r, int& x0, int& x1, float& w0,
                                           float& w1) {
  const int lo = x / r, frac = x - lo * r;
  if (lo >= w - 1) {
    x0 = x1 = w - 1;
    w0 = 1.f;
    w1 = 0.f;
  } else {
    const double f = (double)frac / r;
    x0 = lo;
    x1 = lo + 1;
    w0 = (float)(1.0 - f);
    w1 = (float)f;
  }
}

// u[c] at fine pixel (y, x) of image b, and its logsumexp.
__device__ __forceinline__ float upsampled_logits(const float* __restrict__ img, int C, int h,
                                                  int w, int r, int y, int x, float (&u)[MAX_C]) {
  const int seg = y / r;
  const float wy = (float)(y - seg * r) / (float)r;
  const int k0 = min(seg, h - 1), k1 = min(seg + 1, h - 1);
  int x0, x1;
  float w0, w1;
  width_taps(x, w, r, x0, x1, w0, w1);
  const size_t plane = (size_t)h * w;
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c < C) {
      const float* pc = img + c * plane;
      const float r0 = pc[k0 * w + x0] * w0 + pc[k0 * w + x1] * w1;
      const float r1 = pc[k1 * w + x0] * w0 + pc[k1 * w + x1] * w1;
      u[c] = r0 * (1.f - wy) + r1 * wy;
      mx = fmaxf(mx, u[c]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    if (c < C) s += expf(u[c] - mx);
  return mx + logf(s);
}

template <typename LabT>
__global__ void __launch_bounds__(THREADS)
upsampled_nll_fwd_kernel(const float* __restrict__ logits, const LabT* __restrict__ labels,
                         float* __restrict__ nll, int B, int C, int h, int w, int H, int W,
                         int r) {
  const long long n = (long long)B * H * W;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n) return;
  const int x = (int)(idx % W);
  const int y = (int)((idx / W) % H);
  const int b = (int)(idx / ((long long)H * W));
  float u[MAX_C];
  const float lse =
      upsampled_logits(logits + (size_t)b * C * h * w, C, h, w, r, y, x, u);
  const int lab = (int)labels[idx];
  float ulab = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    if (c < C && c == lab) ulab = u[c];
  nll[idx] = (lab >= 0 && lab < C) ? lse - ulab : 0.f;
}

template <typename LabT>
__global__ void __launch_bounds__(THREADS)
upsampled_nll_bwd_kernel(const float* __restrict__ logits, const LabT* __restrict__ labels,
                         const float* __restrict__ g, float* __restrict__ dlogits, int B, int C,
                         int h, int w, int H, int W, int r) {
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (gw >= (long long)B * h * w) return;  // whole warps leave together
  const int x0 = (int)(gw % w);
  const int k = (int)((gw / w) % h);
  const int b = (int)(gw / ((long long)h * w));

  // fine rows y with y / r == k (weight 1 - wy) or y / r == k - 1 (weight wy)
  const int ylo = max(0, (k - 1) * r + 1), yhi = min(H - 1, k * r + r - 1);
  const int xlo = max(0, (x0 - 1) * r + 1), xhi = min(W - 1, x0 * r + r - 1);
  const int nx = xhi - xlo + 1;
  const int total = (yhi - ylo + 1) * nx;
  const float* img = logits + (size_t)b * C * h * w;
  const size_t img_px = (size_t)b * H * W;

  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.f;

  for (int pi = lane; pi < total; pi += 32) {
    const int y = ylo + pi / nx, x = xlo + pi % nx;
    const size_t px = img_px + (size_t)y * W + x;
    const int lab = (int)labels[px];
    const float gg = g[px];
    if (lab < 0 || lab >= C || gg == 0.f) continue;  // contributes exactly 0
    const int seg = y / r;
    const float wy = (float)(y - seg * r) / (float)r;
    const float wgt_y = seg == k ? 1.f - wy : wy;
    int c0, c1;
    float w0, w1;
    width_taps(x, w, r, c0, c1, w0, w1);
    const float wgt_x = c0 == x0 ? w0 : w1;
    float u[MAX_C];
    const float lse = upsampled_logits(img, C, h, w, r, y, x, u);
    const float s = gg * wgt_y * wgt_x;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < C) acc[c] = fmaf(s, expf(u[c] - lse) - (c == lab ? 1.f : 0.f), acc[c]);
  }

  float mine = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c < C) {
      float a = acc[c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == c) mine = a;
    }
  }
  if (lane < C) dlogits[(((size_t)b * C + lane) * h + k) * w + x0] = mine;
}

bool valid_shape(int B, int C, int h, int w, int H, int W, int r) {
  return B >= 1 && C >= 1 && C <= MAX_C && h >= 2 && w >= 2 && r >= 1 &&
         H == (h - 1) * r + 1 && W == (w - 1) * r + 1;
}

}  // namespace

extern "C" {

// K5. logits (B, C, h, w) f32, labels (B, H, W) int32 (label_bytes 4) or
// uint8 (1), nll (B, H, W) f32. Returns cudaGetLastError().
int upsampled_nll_fwd(const void* logits, const void* labels, void* nll, int B, int C, int h,
                      int w, int H, int W, int r, int label_bytes, void* stream) {
  if (!valid_shape(B, C, h, w, H, W, r)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)B * H * W;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  const float* L = static_cast<const float*>(logits);
  float* out = static_cast<float*>(nll);
  if (label_bytes == 4)
    upsampled_nll_fwd_kernel<int32_t><<<blocks, THREADS, 0, st>>>(
        L, static_cast<const int32_t*>(labels), out, B, C, h, w, H, W, r);
  else if (label_bytes == 1)
    upsampled_nll_fwd_kernel<uint8_t><<<blocks, THREADS, 0, st>>>(
        L, static_cast<const uint8_t*>(labels), out, B, C, h, w, H, W, r);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K6. g (B, H, W) f32 upstream grad, dlogits (B, C, h, w) f32, every entry
// written. Returns cudaGetLastError().
int upsampled_nll_bwd(const void* logits, const void* labels, const void* g, void* dlogits,
                      int B, int C, int h, int w, int H, int W, int r, int label_bytes,
                      void* stream) {
  if (!valid_shape(B, C, h, w, H, W, r)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long warps = (long long)B * h * w;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  const float* L = static_cast<const float*>(logits);
  const float* G = static_cast<const float*>(g);
  float* out = static_cast<float*>(dlogits);
  if (label_bytes == 4)
    upsampled_nll_bwd_kernel<int32_t><<<blocks, THREADS, 0, st>>>(
        L, static_cast<const int32_t*>(labels), G, out, B, C, h, w, H, W, r);
  else if (label_bytes == 1)
    upsampled_nll_bwd_kernel<uint8_t><<<blocks, THREADS, 0, st>>>(
        L, static_cast<const uint8_t*>(labels), G, out, B, C, h, w, H, W, r);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
