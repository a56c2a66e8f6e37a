// Line helpers of the tensor-core criss-cross attention kernels (cca_fwd.cu
// K1/K2, cca_bwd.cu K3/K4, cca_lines_tc.cu K7a/K7b): the pixels of one line,
// bf16 tiles of a line staged into shared memory with cp.async, pair
// stores, and the q.k^T logits of a warp's 16 queries on mma.sync.
//
// A line is N pixels given by strides: line j of image b of (B, M, N)
// lines starts at pixel b * sb + j * sm and steps by sn. The columns of
// NHWC (B, H, W, C) tensors are (M, N, sb, sm, sn) = (W, H, HW, 1, W), its
// rows (H, W, HW, W, 1). K1-K4 hold a whole line in a block, padded to
// N_p = 16 ceil(N / 16) positions, and their warp w owns positions
// 16w .. 16w + 15; K7a/K7b tile the line.

#pragma once

#include "cca_common.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TC_MAX_N = 128;  // longest line: LONG_LINE of the wrapper, 8 warps
constexpr int TC_PAD = 8;      // row padding (bf16): an odd number of 16-byte units per
                               // row, so ldmatrix's 8 rows fall in 8 distinct bank groups

__host__ __device__ __forceinline__ int round16(int c) { return (c + 15) & ~15; }

// Pixel index of position 0 of line `line` (= b * M + j) of strided lines.
__device__ __forceinline__ long long line_base(int line, int M, long long sb, long long sm) {
  const int b = line / M;
  return b * sb + (long long)(line - b * M) * sm;
}

// Pixel index of position t of column or row `line` of NHWC (B, H, W, C)
// is base + t * step.
__device__ __forceinline__ void line_geometry(bool col, int line, int H, int W,
                                              long long& base, long long& step) {
  const long long hw = (long long)H * W;
  base = col ? line_base(line, W, hw, 1) : line_base(line, H, hw, W);
  step = col ? W : 1;
}

// S[t][c] = x[pixel t][c0 + c] for t < np, c < width (a multiple of 8),
// zero past N positions or C channels. 16-byte cp.async when C % 8 == 0;
// element copies otherwise (a row of 4 or 12 bf16 is not 16-byte aligned).
__device__ __forceinline__ void stage(bf16* S, int ld, const bf16* x, long long base,
                                      long long step, int N, int C, int c0, int np, int width) {
  if ((C & 7) == 0) {
    const int w8 = width / 8;
    for (int e = threadIdx.x; e < np * w8; e += blockDim.x) {
      const int t = e / w8, c = (e - t * w8) * 8;
      const bool ok = t < N && c0 + c < C;
      cp_async16(S + t * ld + c, ok ? x + (base + t * step) * C + c0 + c : x, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < np * width; e += blockDim.x) {
      const int t = e / width, c = e - t * width;
      S[t * ld + c] = (t < N && c0 + c < C) ? x[(base + t * step) * C + c0 + c] : zero;
    }
  }
}

// out[o], out[o + 1] = x0, x1 (plus add[o], add[o + 1] when add is given) as
// bf16, where o = pixel * C + c; c + 1 may be past the channels.
__device__ __forceinline__ void store_pair(bf16* out, const bf16* add, long long o, int c, int C,
                                           float x0, float x1) {
  if (c >= C) return;
  const bool two = c + 1 < C;
  if (add) {
    x0 += __bfloat162float(add[o]);
    if (two) x1 += __bfloat162float(add[o + 1]);
  }
  if (two && (C & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(x0, x1);
  } else {
    out[o] = __float2bfloat16(x0);
    if (two) out[o + 1] = __float2bfloat16(x1);
  }
}

// s = q.k^T for this warp's 16 queries (rows r0 ..) and keys j0 .. j0 + 15
__device__ __forceinline__ void scores(float (&s)[2][4], const bf16* sQ, const bf16* sK, int lq,
                                       int cqp, int r0, int j0, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
  for (int kk = 0; kk < cqp; kk += 16) {
    uint32_t a[4], b[4];
    load_a(a, sQ, lq, r0, kk, lane);
    load_b2(b, sK, lq, j0, kk, lane);
    mma_2(s[0], s[1], a, b);
  }
}

}  // namespace
