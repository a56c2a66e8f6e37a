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
// Neither kernel builds the (B, C, H, W) upsampled tensor. Every u value is
// the JAX package's, in f32:
//   width  (_interp_matrix): lo, frac = divmod(x, r); weight 1 on column
//          w-1 once lo >= w-1, else (1 - frac/r, frac/r) on (lo, lo+1),
//          computed in double and rounded to f32 as numpy does;
//   height (_fwd_kernel): a lerp of coarse rows min(seg, h-1) and
//          min(seg+1, h-1) at wy = (y mod r) / r in f32, seg = y / r.
// Logits are NCHW f32 as the model emits them; labels are (B, H, W) int32
// or uint8 (255 = ignore, out of [0, C) for C <= 32).
//
// What bounds them on the H100. At (8, 19, 97, 97) -> 769^2 the bytes the
// functions must move are 43.6 MB (K5: logits, labels, nll) and 49.3 MB
// (K6: logits, labels, g, dlogits), 0.013 / 0.015 ms at 3.35 TB/s; the f32
// arithmetic per fine pixel and class (the lerp, the max, an exponential,
// the sums; K6 also p - onehot and its weighted sum) is ~12 instructions,
// about 1.1 G per pass over the 4.7 M pixels: ~0.04 ms of the 67 TFLOP/s of
// f32 CUDA cores. So the kernels are bound by the CUDA cores' arithmetic and
// the exponentials, and the design keeps everything else off that path:
//   * a block takes one band of coarse rows, for all C classes and a tile of
//     T coarse columns plus a one-column halo, into shared memory with
//     cp.async (2 or 3 rows: 4 / 6 KB at C = 19, T = 25), so no thread
//     gathers its 4 C taps from device memory;
//   * each thread owns one fine column: it computes the column's width taps
//     once, lerps the staged rows across the width once into registers
//     (C values per coarse row), and reuses them for the r fine rows that
//     share the band, so a u costs one height lerp;
//   * labels, g and nll are read and written by neighbouring threads at
//     neighbouring fine columns, ROWS rows' worth of loads issued together;
//   * the softmax is taken in base 2 on logits pre-scaled by log2(e) once
//     per column, so a class costs one ex2.approx on the special-function
//     unit, a subtraction and the lerp (the nll and grads stay within
//     1e-5 and 1e-4 x max of the f32 plain version; chip_smoke.py checks).
// No tensor cores: the width product of _row_band is a two-tap product per
// fine column at HIGHEST precision, which TF32 would round.
//
// K5: one block per (image, band k = fine rows k r .. k r + r - 1, tile of T
// coarse columns); each fine pixel's softmax is computed once.
//
// K6: the transposed lerps as a gather, no float atomics, deterministic: one
// block per (image, coarse row k, tile of T coarse columns) writes
// dlogits[:, k, tile] and nothing else. The coarse row k takes weight from
// the fine rows (k-1) r + 1 .. k r + r - 1 (wy on those of segment k - 1,
// 1 - wy on those of segment k) and the fine columns (j-1) r + 1 .. j r + r - 1
// of each coarse column j: the block walks those rows for the tile's fine
// columns plus r - 1 of halo, with the coarse rows k - 1, k, k + 1 staged.
// Each thread keeps one column's C-vector of sum_y wgt_y g (p - onehot) in
// registers; then the block reduces each coarse column's 2r - 1 fine columns
// from shared memory in a fixed order and writes dlogits directly. Every
// fine row lies in two bands and the halo columns in two tiles, so each
// softmax is computed about twice. Pixels with g == 0 or a label off
// [0, C) contribute exactly 0 and are skipped: each thread first reads its
// column's labels and g (coalesced) into a bit mask of the rows that count,
// then takes only those rows, so a warp runs as many softmax steps as its
// busiest lane has rows, not as many as the band has (OHEM's g is sparse
// once the model is trained).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 32;
constexpr int THREADS = 256;  // fine columns a block covers at once, one per thread
constexpr int ROWS = 8;       // fine rows whose labels (and g) a thread loads at once
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// 2^x on the special-function unit (relative error ~2^-22; subnormal results
// flush to 0, which no softmax weight here needs)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The block's place: image b, coarse row (K6) or band (K5) k, coarse columns
// [j0, j1) of tile blockIdx % ntiles.
struct Tile {
  int b, k, j0, j1;
};

__device__ __forceinline__ Tile tile_of_block(int h, int w, int T, int ntiles) {
  Tile t;
  const int bk = blockIdx.x / ntiles;
  t.j0 = (blockIdx.x - bk * ntiles) * T;
  t.j1 = min(t.j0 + T, w);
  t.k = bk % h;
  t.b = bk / h;
  return t;
}

// S[s][c][t] = logits[b][c][clamp(row0 + s)][cs + t] for s < slots, t < ncs;
// returns when every thread's copies have landed
__device__ __forceinline__ void stage_rows(float* S, int ld, const float* __restrict__ logits,
                                           int C, int h, int w, int b, int row0, int slots,
                                           int cs, int ncs) {
  const int n = slots * C * ncs;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int sc = e / ncs, t = e - sc * ncs, s = sc / C, c = sc - s * C;
    const int row = min(max(row0 + s, 0), h - 1);
    cp_async4(S + sc * ld + t, logits + (((size_t)b * C + c) * h + row) * w + cs + t);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// R[c] = one staged coarse row lerped across the width at a fine column
// whose taps sit at staged columns t0, t1, times log2(e): the softmax is
// taken in base 2, one ex2 per class
template <int CB>
__device__ __forceinline__ void width_lerp(float (&R)[CB], const float* S, int ld, int C, int t0,
                                           int t1, float w0, float w1) {
#pragma unroll
  for (int c = 0; c < CB; ++c)
    R[c] = c < C ? (S[c * ld + t0] * w0 + S[c * ld + t1] * w1) * LOG2E : 0.f;
}

// ------------------------------------------------------------------- K5

template <int CB, typename LabT>
__global__ void __launch_bounds__(THREADS)
upsampled_nll_fwd_kernel(const float* __restrict__ logits, const LabT* __restrict__ labels,
                         float* __restrict__ nll, int C, int h, int w, int H, int W, int r, int T,
                         int ntiles) {
  extern __shared__ float band_smem[];  // [2][C][T + 1]: coarse rows k, k + 1 (clamped)
  const Tile tl = tile_of_block(h, w, T, ntiles);
  const int ld = T + 1, ncs = min(tl.j1, w - 1) - tl.j0 + 1;
  stage_rows(band_smem, ld, logits, C, h, w, tl.b, tl.k, 2, tl.j0, ncs);
  const int xe = tl.j1 == w ? W : tl.j1 * r;  // one past the tile's last fine column
  const int y0 = tl.k * r, y1 = min(y0 + r, H);
  for (int x = tl.j0 * r + threadIdx.x; x < xe; x += blockDim.x) {
    int x0, x1;
    float w0, w1;
    width_taps(x, w, r, x0, x1, w0, w1);
    float R0[CB], R1[CB];  // u log2(e) of coarse rows k, k + 1 at this column
    width_lerp(R0, band_smem, ld, C, x0 - tl.j0, x1 - tl.j0, w0, w1);
    width_lerp(R1, band_smem + C * ld, ld, C, x0 - tl.j0, x1 - tl.j0, w0, w1);
    const size_t col = (size_t)tl.b * H * W + x;
    for (int yb = y0; yb < y1; yb += ROWS) {
      int labs[ROWS];  // the labels of ROWS rows, loaded together
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        labs[i] = yb + i < y1 ? (int)labels[col + (size_t)(yb + i) * W] : -1;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int y = yb + i, lab = labs[i];
        if (y >= y1) break;
        const float wy = (float)(y - y0) / (float)r;
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c < C) mx = fmaxf(mx, R0[c] * (1.f - wy) + R1[c] * wy);
        float s = 0.f, ulab = 0.f;
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          if (c < C) {
            const float u = R0[c] * (1.f - wy) + R1[c] * wy;
            s += ex2(u - mx);
            if (c == lab) ulab = u;
          }
        }
        // logsumexp - u[label], back from base 2
        nll[col + (size_t)y * W] = (lab >= 0 && lab < C) ? (mx + log2f(s) - ulab) * LN2 : 0.f;
      }
    }
  }
}

// ------------------------------------------------------------------- K6

// acc[c] += wgt_y g (p_c - [c = label]) over the fine rows ys .. ye of one
// segment (its first row y0), at one fine column: rows R0 / R1 of the
// segment lerped at this column; `second` when the block's coarse row is the
// segment's second (weight wy), else its first (1 - wy). lab / gc point at
// the column's pixel of row 0.
template <int CB, typename LabT>
__device__ __forceinline__ void segment_rows(float (&acc)[CB], const float (&R0)[CB],
                                             const float (&R1)[CB], const LabT* __restrict__ lab,
                                             const float* __restrict__ gc, int W, int C, int r,
                                             int y0, int ys, int ye, bool second) {
  for (int base = ys; base <= ye; base += ROWS) {
    unsigned todo = 0;  // the rows that contribute: a label in [0, C) and g != 0
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {  // every load of the ROWS rows issued before any is used
      const size_t o = (size_t)min(base + i, ye) * W;  // rows past ye re-read ye, then drop out
      const int l = (int)lab[o];
      const float gg = gc[o];
      todo |= (unsigned)(base + i <= ye && l >= 0 && l < C && gg != 0.f) << i;
    }
    while (todo) {
      const int i = __ffs(todo) - 1;
      todo &= todo - 1;
      const int y = base + i;
      const size_t o = (size_t)y * W;
      const int l = (int)lab[o];
      const float wy = (float)(y - y0) / (float)r;
      const float wgt = gc[o] * (second ? wy : 1.f - wy);
      float e[CB];  // u log2(e), then 2^(u log2(e) - max)
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        e[c] = R0[c] * (1.f - wy) + R1[c] * wy;
        if (c < C) mx = fmaxf(mx, e[c]);
      }
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        if (c < C) {
          e[c] = ex2(e[c] - mx);
          s += e[c];
        }
      }
      const float inv = __frcp_rn(s);
#pragma unroll
      for (int c = 0; c < CB; ++c)  // p - onehot = e / s - [c = label]
        if (c < C) acc[c] = fmaf(wgt, fmaf(e[c], inv, c == l ? -1.f : 0.f), acc[c]);
    }
  }
}

// floats of K6's shared memory: the columns' width weights [T r + r][2],
// coarse rows [3][C][T + 2], the columns' sums [C][T r + r]
size_t bwd_smem_floats(int C, int T, int r) {
  return size_t(C + 2) * (T * r + r) + size_t(3) * C * (T + 2);
}

template <int CB, typename LabT>
__global__ void __launch_bounds__(THREADS, CB <= 20 ? 2 : 1)
upsampled_nll_bwd_kernel(const float* __restrict__ logits, const LabT* __restrict__ labels,
                         const float* __restrict__ g, float* __restrict__ dlogits, int C, int h,
                         int w, int H, int W, int r, int T, int ntiles) {
  extern __shared__ float band_smem[];
  const Tile tl = tile_of_block(h, w, T, ntiles);
  const int k = tl.k, ldc = T + 2, ldx = T * r + r;
  const int cs = max(tl.j0 - 1, 0), ncs = min(tl.j1, w - 1) - cs + 1;
  // the fine columns of the tile's coarse columns and the halo: xs .. xs + ncols - 1
  const int xs = max(0, (tl.j0 - 1) * r + 1), ncols = min(W - 1, tl.j1 * r - 1) - xs + 1;
  float2* sTap = reinterpret_cast<float2*>(band_smem);  // [ldx]: (w0, w1) of each column
  float* sL = band_smem + 2 * ldx;                       // [3][C][ldc]: rows k-1, k, k+1
  float* sAcc = sL + 3 * C * ldc;                        // [C][ldx]
  stage_rows(sL, ldc, logits, C, h, w, tl.b, k - 1, 3, cs, ncs);

  for (int xl = threadIdx.x; xl < ncols; xl += blockDim.x) {
    const int x = xs + xl;
    int x0, x1;
    float w0, w1;
    width_taps(x, w, r, x0, x1, w0, w1);
    sTap[xl] = make_float2(w0, w1);
    const int t0 = x0 - cs, t1 = x1 - cs;
    const size_t col = (size_t)tl.b * H * W + x;
    float acc[CB], Ra[CB], Rb[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = 0.f;
    if (k >= 1) {  // segment k - 1: its rows (k-1) r + 1 .. k r - 1 weigh wy on row k
      width_lerp(Ra, sL, ldc, C, t0, t1, w0, w1);
      width_lerp(Rb, sL + C * ldc, ldc, C, t0, t1, w0, w1);
      segment_rows(acc, Ra, Rb, labels + col, g + col, W, C, r, (k - 1) * r, (k - 1) * r + 1,
                   k * r - 1, true);
    }
    // segment k: its rows k r .. k r + r - 1 weigh 1 - wy on row k
    width_lerp(Ra, sL + C * ldc, ldc, C, t0, t1, w0, w1);
    width_lerp(Rb, sL + 2 * C * ldc, ldc, C, t0, t1, w0, w1);
    segment_rows(acc, Ra, Rb, labels + col, g + col, W, C, r, k * r, k * r,
                 min(k * r + r - 1, H - 1), false);
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c < C) sAcc[c * ldx + xl] = acc[c];
  }
  __syncthreads();

  // dlogits[c, k, j] = sum over the fine columns x of coarse column j, in
  // order, of M[j, x] acc[c, x]
  const int nt = tl.j1 - tl.j0;
  for (int o = threadIdx.x; o < C * nt; o += blockDim.x) {
    const int c = o / nt, j = tl.j0 + o - c * nt;
    const int xa = max(0, (j - 1) * r + 1), xb = min(W - 1, j * r + r - 1);
    float s = 0.f;
    for (int x = xa; x <= xb; ++x) {
      // x's taps are (j - 1, j) below j r, (j, j + 1) from there (or (w - 1,
      // w - 1) weighted (1, 0) at the last fine column)
      const float2 tw = sTap[x - xs];
      s = fmaf(x < j * r ? tw.y : tw.x, sAcc[c * ldx + x - xs], s);
    }
    dlogits[(((size_t)tl.b * C + c) * h + k) * w + j] = s;
  }
}

bool valid_shape(int B, int C, int h, int w, int H, int W, int r, int T) {
  return B >= 1 && C >= 1 && C <= MAX_C && h >= 2 && w >= 2 && r >= 1 &&
         H == (h - 1) * r + 1 && W == (w - 1) * r + 1 && T >= 1 && T <= w;
}

int block_threads(int cols) { return cols < THREADS ? (cols + 31) / 32 * 32 : THREADS; }

constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory one block may use on Hopper

// K5 and K6 with a class bound CB >= C (registers hold CB values per coarse
// row; 20 is Cityscapes' 19 classes) and label type LabT
template <int CB, typename LabT>
int launch_both(bool bwd, const void* logits, const void* labels, const void* g, void* out, int B,
                int C, int h, int w, int H, int W, int r, int T, cudaStream_t st) {
  const int ntiles = (w + T - 1) / T;
  const unsigned blocks = (unsigned)((long long)B * h * ntiles);
  const float* L = static_cast<const float*>(logits);
  const LabT* lab = static_cast<const LabT*>(labels);
  float* o = static_cast<float*>(out);
  if (!bwd) {
    const auto kernel = upsampled_nll_fwd_kernel<CB, LabT>;
    const size_t smem = sizeof(float) * 2 * C * (T + 1);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<blocks, block_threads(T * r), smem, st>>>(L, lab, o, C, h, w, H, W, r, T, ntiles);
    return (int)cudaGetLastError();
  }
  const auto kernel = upsampled_nll_bwd_kernel<CB, LabT>;
  const size_t smem = sizeof(float) * bwd_smem_floats(C, T, r);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, block_threads(T * r + r - 1), smem, st>>>(
      L, lab, static_cast<const float*>(g), o, C, h, w, H, W, r, T, ntiles);
  return (int)cudaGetLastError();
}

template <typename LabT>
int dispatch_classes(bool bwd, const void* logits, const void* labels, const void* g, void* out,
                     int B, int C, int h, int w, int H, int W, int r, int T, cudaStream_t st) {
  if (C <= 8) return launch_both<8, LabT>(bwd, logits, labels, g, out, B, C, h, w, H, W, r, T, st);
  if (C <= 16)
    return launch_both<16, LabT>(bwd, logits, labels, g, out, B, C, h, w, H, W, r, T, st);
  if (C <= 20)
    return launch_both<20, LabT>(bwd, logits, labels, g, out, B, C, h, w, H, W, r, T, st);
  return launch_both<32, LabT>(bwd, logits, labels, g, out, B, C, h, w, H, W, r, T, st);
}

int dispatch(bool bwd, const void* logits, const void* labels, const void* g, void* out, int B,
             int C, int h, int w, int H, int W, int r, int T, int label_bytes, void* stream) {
  if (!valid_shape(B, C, h, w, H, W, r, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (label_bytes == 4)
    return dispatch_classes<int32_t>(bwd, logits, labels, g, out, B, C, h, w, H, W, r, T, st);
  if (label_bytes == 1)
    return dispatch_classes<uint8_t>(bwd, logits, labels, g, out, B, C, h, w, H, W, r, T, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K5. logits (B, C, h, w) f32, labels (B, H, W) int32 (label_bytes 4) or
// uint8 (1), nll (B, H, W) f32; tiles of T coarse columns (band_tile of
// ccnet_tpu_torch/ops/upsampled_ce.py). Returns cudaGetLastError().
int upsampled_nll_fwd(const void* logits, const void* labels, void* nll, int B, int C, int h,
                      int w, int H, int W, int r, int T, int label_bytes, void* stream) {
  return dispatch(false, logits, labels, nullptr, nll, B, C, h, w, H, W, r, T, label_bytes,
                  stream);
}

// K6. g (B, H, W) f32 upstream grad, dlogits (B, C, h, w) f32, every entry
// written. Returns cudaGetLastError() (cudaErrorInvalidValue also for a
// ratio so large that a tile's columns overflow shared memory).
int upsampled_nll_bwd(const void* logits, const void* labels, const void* g, void* dlogits,
                      int B, int C, int h, int w, int H, int W, int r, int T, int label_bytes,
                      void* stream) {
  return dispatch(true, logits, labels, g, dlogits, B, C, h, w, H, W, r, T, label_bytes, stream);
}

}  // extern "C"
