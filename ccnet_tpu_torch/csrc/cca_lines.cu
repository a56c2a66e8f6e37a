// Criss-cross attention, one path over lines, for Hopper (sm_90a), on the
// CUDA cores: K7a cca_line_fwd, K7b cca_line_bwd in f32 arithmetic. The
// wrapper sends them the f32 calls (the JAX package's "highest" precision);
// bf16 calls take the tensor-core kernels of cca_lines_tc.cu, which round
// as the TPU kernels do at the default precision. A forced bf16 call here
// (design="cuda_core", for timing) writes f32 outputs and rounds nothing.
//
// Replaces the TPU kernels of ccnet_tpu/ops/cc_attention_pallas.py:
//   K7a cca_line_fwd  <- _legacy_fwd_kernel  (launched by _legacy_run_path_fwd)
//   K7b cca_line_bwd  <- _legacy_bwd_kernel  (launched by _legacy_run_path_bwd)
// The JAX package takes this route when the (8, N, N) f32 slabs of the
// natural kernels no longer fit VMEM, i.e. on long lines. Each call runs ONE path over
// (B, M, N) lines, attention along N, with the diagonal at -1e9 when
// `masked` (the column path):
//   forward   e = q.k^T, m = max e, l = sum exp(e - m), o = exp(e - m).v
//   backward  p = exp(e - m) / L from the JOINT stats (m, L) of both paths,
//             dp = g.v^T, de = p (dp - delta), dq = de.k, dk = de^T.q,
//             dv = p^T.g
// The caller combines the two paths (ccnet_tpu_torch/ops/cc_attention_cuda.py).
//
// Layout. Position t of line (b, j) is pixel b*sb + j*sm + t*sn, and its
// channels are contiguous: q, k (pixel*Cq), v, g, o, dv (pixel*Cv), m, l,
// L, delta (pixel). Rows of an NHWC tensor are lines with (sm, sn) = (W, 1);
// its columns are lines with (1, W), read in place (no transposed copy), and
// the column outputs land in NHWC order.
//
// What bounds it on the H100. At the largest whole-image shape (1, 225,
// 449, q/k 64, v 512) the forward of both paths is ~87 GFLOP (the p.v term
// and the logits, recomputed once per 256-channel slice) over ~0.7 GB of
// traffic (the f32 o of both paths dominates), and the backward ~240 GFLOP
// (dp = g.v^T is computed twice, see K7b), counted from the shapes. Both are
// far above the f32 CUDA-core balance point, so these kernels, which
// multiply in f32 on the CUDA cores, are bound by FMA issue and
// shared-memory reads.
//
// K7a: one block per (line, 16 queries, 256 value channels), the design of
// K1 (csrc/cca_fwd.cu) on strided lines: keys stream through shared memory
// in tiles of 32 with an online softmax (running max and sum per query), so
// any N works without an N x N slab. o is written in f32, v's dtype on the
// calls the wrapper makes.
//
// K7b keeps no O(N) scratch per pixel: that is the point of this route. K3/K4
// (csrc/cca_bwd.cu) store each path's p and de, B*H*W*N floats each, to skip
// a second g.v^T product; at (1, 225, 449) that scratch would be 0.36 GB for
// the row path. K7b instead splits as FlashAttention-2's backward does, with
// no atomics (deterministic):
//   1. key-major (line_bwd_key_kernel): one block per (line, 32 keys, 512
//      value channels). The block keeps its keys' k and v in shared memory,
//      streams the line's queries in chunks of 16 (q, stats, and g in
//      128-channel slices), recomputes e, p and dp = g.v^T over all Cv, and
//      accumulates dv (64 values per thread) and dk.
//   2. query-major (line_bwd_query_kernel): one block per (line, 16
//      queries), K3's query pass without its scratch: streams the keys in
//      chunks of 32 (v in 128-channel slices), recomputes e, p, dp and de,
//      and accumulates dq.
// So dp = g.v^T, the largest term (2*N*N*Cv FLOP per line), is computed
// twice, where K3/K4 compute it once and pay for it with the scratch's
// memory and traffic (2 * 4 bytes * N per pixel written and read back).
// Any N works: 1 (column path all self slot), 97 ... 449, and beyond.

#include <math_constants.h>

#include "cca_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;

// K7a tiling
constexpr int TQ = 16;                // queries per block
constexpr int KT = 32;                // keys per streamed tile (one per lane)
constexpr int ROWS = TQ / NWARPS;     // query rows per warp

// K7b tiling
constexpr int QB = 2 * NWARPS;        // queries per query-major block / per key-major chunk
constexpr int KB = 32;                // keys per key-major block / per query-major chunk
constexpr int VC = 128;               // channels per streamed v or g slice
constexpr int CV_BLOCK = 512;         // dv channels per key-major block
constexpr int SLICES = CV_BLOCK / VC;           // 4
constexpr int DV_KEYS = KB * VC / THREADS;      // 16 keys of one channel per thread and slice
constexpr int DQ_PER_THREAD = QB * MAX_CQ / THREADS;  // 8
constexpr int DK_PER_THREAD = KB * MAX_CQ / THREADS;  // 16

// Pixel of position 0 of line `line` (= b * M + j).
__device__ __forceinline__ long long line_base(int line, int M, long long sb, long long sm) {
  const int b = line / M;
  return b * sb + (long long)(line - b * M) * sm;
}

__device__ __forceinline__ float dot4(const float4* a, const float4* b, int n4) {
  float s = 0.f;
  for (int c4 = 0; c4 < n4; ++c4) {
    const float4 x = a[c4], y = b[c4];
    s = fmaf(x.x, y.x, s); s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s); s = fmaf(x.w, y.w, s);
  }
  return s;
}

// Stage `rows` rows of C channels (rows past N, channels past C: 0) as f32
// in shared memory at row stride `stride`, from position t0 of the line.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int stride, const T* __restrict__ src,
                                      long long base, long long sn, int t0, int rows, int N,
                                      int C, int c0, int nc) {
  for (int e = threadIdx.x; e < rows * nc; e += THREADS) {
    const int i = e / nc, c = e - i * nc, t = t0 + i;
    dst[i * stride + c] =
        (t < N && c0 + c < C) ? to_f32(src[(base + t * sn) * C + c0 + c]) : 0.f;
  }
}

size_t fwd_smem_floats(int Cq) {
  return size_t(KT) * TQ + 3 * TQ + size_t(TQ + KT) * padded_stride(round4(Cq));
}

size_t key_smem_floats(int Cq, int Cv) {
  const int sq = padded_stride(round4(Cq)), sv = padded_stride(round4(Cv));
  return size_t(KB) * sq + size_t(KB) * sv + size_t(QB) * sq + size_t(QB) * VC +
         2 * size_t(QB) * KB + 3 * QB;
}

size_t query_smem_floats(int Cq, int Cv) {
  const int sq = padded_stride(round4(Cq)), sg = padded_stride(round4(Cv));
  return size_t(QB) * sq + size_t(QB) * sg + size_t(KB) * sq + size_t(KB) * padded_stride(VC) +
         size_t(QB) * (KB + 1) + 3 * QB;
}

// ------------------------------------------------------------------- K7a

template <typename T>
__global__ void __launch_bounds__(THREADS)
line_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                int M, int N, int Cq, int Cv, long long sb, long long sm, long long sn,
                bool masked) {
  extern __shared__ __align__(16) float smem[];
  const int cq4 = round4(Cq), sq = padded_stride(cq4);
  float* s_p = smem;                 // [KT][TQ] probabilities, key-major
  float* s_alpha = s_p + KT * TQ;    // [TQ] rescale of the running sums
  float* s_m = s_alpha + TQ;         // [TQ] final running max
  float* s_l = s_m + TQ;             // [TQ] final running sum
  float* s_q = s_l + TQ;             // [TQ][sq]
  float* s_k = s_q + TQ * sq;        // [KT][sq]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * TQ;
  const int c = blockIdx.z * THREADS + tid;
  const bool has_c = c < Cv;
  const long long base = line_base(blockIdx.x, M, sb, sm);

  stage(s_q, sq, q, base, sn, q0, TQ, N, Cq, 0, cq4);

  float acc[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) acc[i] = 0.f;
  // every lane of a warp carries the same running stats for its rows
  float m_run[ROWS], l_run[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m_run[r] = -CUDART_INF_F;
    l_run[r] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += KT) {
    stage(s_k, sq, k, base, sn, k0, KT, N, Cq, 0, cq4);
    float vr[KT];  // this thread's value channel for the tile's keys
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int t = k0 + j;
      vr[j] = (has_c && t < N) ? to_f32(v[(base + t * sn) * Cv + c]) : 0.f;
    }
    __syncthreads();

    // logits and online softmax: warp owns rows warp + r*NWARPS, lane = key
    const int t = k0 + lane;
    const bool valid = t < N;
    const float4* kj = reinterpret_cast<const float4*>(s_k + lane * sq);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = warp + r * NWARPS;
      float s = dot4(reinterpret_cast<const float4*>(s_q + i * sq), kj, cq4 / 4);
      if (masked && t == q0 + i) s = MASK;
      const float m_new = fmaxf(m_run[r], warp_max(valid ? s : -CUDART_INF_F));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_run[r] - m_new);  // 0 on the first tile
      l_run[r] = l_run[r] * alpha + warp_sum(p);
      m_run[r] = m_new;
      s_p[lane * TQ + i] = p;
      if (lane == 0) s_alpha[i] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TQ; ++i) acc[i] *= s_alpha[i];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float4* pj = reinterpret_cast<const float4*>(s_p + j * TQ);
#pragma unroll
      for (int i4 = 0; i4 < TQ / 4; ++i4) {
        const float4 p = pj[i4];
        acc[4 * i4 + 0] = fmaf(p.x, vr[j], acc[4 * i4 + 0]);
        acc[4 * i4 + 1] = fmaf(p.y, vr[j], acc[4 * i4 + 1]);
        acc[4 * i4 + 2] = fmaf(p.z, vr[j], acc[4 * i4 + 2]);
        acc[4 * i4 + 3] = fmaf(p.w, vr[j], acc[4 * i4 + 3]);
      }
    }
    __syncthreads();  // s_k, s_p, s_alpha are rewritten by the next tile
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      s_m[warp + r * NWARPS] = m_run[r];
      s_l[warp + r * NWARPS] = l_run[r];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int t = q0 + i;
    if (has_c && t < N) o[(base + t * sn) * Cv + c] = acc[i];
  }
  if (blockIdx.z == 0 && tid < TQ && q0 + tid < N) {
    const long long p = base + (long long)(q0 + tid) * sn;
    m_out[p] = s_m[tid];
    l_out[p] = s_l[tid];
  }
}

// ------------------------------------------------------------------- K7b

// Key-major pass: dv and dk of the block's KB keys. Thread (warp w, lane)
// forms p and dp for queries w and w + NWARPS of the chunk against key
// `lane`; for dv it owns channel (tid % VC) of each slice and keys
// (tid / VC) * DV_KEYS ... + DV_KEYS.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
line_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ m_in,
                    const float* __restrict__ L_in, const float* __restrict__ d_in,
                    float* __restrict__ dk_out, float* __restrict__ dv_out, int M, int N, int Cq,
                    int Cv, long long sb, long long sm, long long sn, bool masked) {
  extern __shared__ __align__(16) float smem[];
  const int cq4 = round4(Cq), cv4 = round4(Cv);
  const int sq = padded_stride(cq4), sv = padded_stride(cv4);
  float* s_k = smem;                  // [KB][sq]
  float* s_v = s_k + KB * sq;         // [KB][sv], all channels
  float* s_q = s_v + KB * sv;         // [QB][sq]
  float* s_g = s_q + QB * sq;         // [QB][VC], one channel slice
  float* s_p = s_g + QB * VC;         // [QB][KB]
  float* s_de = s_p + QB * KB;        // [QB][KB]
  float* s_m = s_de + QB * KB;        // [QB]
  float* s_L = s_m + QB;
  float* s_d = s_L + QB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.y * KB;
  const int cz = blockIdx.z * CV_BLOCK;  // first dv channel of this block
  const bool do_dk = blockIdx.z == 0;
  const long long base = line_base(blockIdx.x, M, sb, sm);
  const int tj = j0 + lane;
  const bool key_ok = tj < N;
  const int ia = warp, ib = warp + NWARPS;
  const int dv_c = tid % VC, dv_j = (tid / VC) * DV_KEYS;

  stage(s_k, sq, k, base, sn, j0, KB, N, Cq, 0, cq4);
  stage(s_v, sv, v, base, sn, j0, KB, N, Cv, 0, cv4);

  float dv[SLICES][DV_KEYS];
#pragma unroll
  for (int s = 0; s < SLICES; ++s)
#pragma unroll
    for (int j = 0; j < DV_KEYS; ++j) dv[s][j] = 0.f;
  float dk[DK_PER_THREAD];
#pragma unroll
  for (int r = 0; r < DK_PER_THREAD; ++r) dk[r] = 0.f;

  for (int i0 = 0; i0 < N; i0 += QB) {
    __syncthreads();  // the previous chunk's readers of s_q, s_p, s_de are done
    stage(s_q, sq, q, base, sn, i0, QB, N, Cq, 0, cq4);
    if (tid < QB) {
      const int t = i0 + tid;
      const bool ok = t < N;
      const long long p = base + (long long)t * sn;
      s_m[tid] = ok ? m_in[p] : 0.f;
      s_L[tid] = ok ? L_in[p] : 1.f;
      s_d[tid] = ok ? d_in[p] : 0.f;
    }
    __syncthreads();

    // p of (ia, lane) and (ib, lane) from the joint stats
    const float4* kj = reinterpret_cast<const float4*>(s_k + lane * sq);
    float pa, pb;
    {
      const int ta = i0 + ia, tb = i0 + ib;
      float ea = dot4(reinterpret_cast<const float4*>(s_q + ia * sq), kj, cq4 / 4);
      float eb = dot4(reinterpret_cast<const float4*>(s_q + ib * sq), kj, cq4 / 4);
      if (masked && ta == tj) ea = MASK;
      if (masked && tb == tj) eb = MASK;
      pa = (key_ok && ta < N) ? expf(ea - s_m[ia]) / s_L[ia] : 0.f;
      pb = (key_ok && tb < N) ? expf(eb - s_m[ib]) / s_L[ib] : 0.f;
      s_p[ia * KB + lane] = pa;
      s_p[ib * KB + lane] = pb;
    }

    // dp = g.v^T over all Cv, and dv of this block's channels, g streamed in
    // VC-channel slices; groups of SLICES keep dv's register index static
    float dpa = 0.f, dpb = 0.f;
    for (int s0 = 0; s0 < cv4; s0 += CV_BLOCK) {
#pragma unroll
      for (int s = 0; s < SLICES; ++s) {
        const int c0 = s0 + s * VC;
        if (c0 < cv4) {
          const int nc = min(VC, cv4 - c0);
          __syncthreads();  // the previous slice's readers of s_g are done (and s_p is written)
          stage(s_g, VC, g, base, sn, i0, QB, N, Cv, c0, nc);
          __syncthreads();
          const float4* vj = reinterpret_cast<const float4*>(s_v + lane * sv + c0);
          const float4* ga = reinterpret_cast<const float4*>(s_g + ia * VC);
          const float4* gb = reinterpret_cast<const float4*>(s_g + ib * VC);
          for (int c4 = 0; c4 < nc / 4; ++c4) {
            const float4 vv = vj[c4], a = ga[c4], b = gb[c4];
            dpa = fmaf(a.x, vv.x, dpa); dpa = fmaf(a.y, vv.y, dpa);
            dpa = fmaf(a.z, vv.z, dpa); dpa = fmaf(a.w, vv.w, dpa);
            dpb = fmaf(b.x, vv.x, dpb); dpb = fmaf(b.y, vv.y, dpb);
            dpb = fmaf(b.z, vv.z, dpb); dpb = fmaf(b.w, vv.w, dpb);
          }
          if (s0 == cz && dv_c < nc) {
            // dv[j][c] += sum_i p[i][j] g[i][c]
#pragma unroll 4
            for (int i = 0; i < QB; ++i) {
              const float gi = s_g[i * VC + dv_c];
              const float4* pi = reinterpret_cast<const float4*>(s_p + i * KB + dv_j);
#pragma unroll
              for (int j4 = 0; j4 < DV_KEYS / 4; ++j4) {
                const float4 p = pi[j4];
                dv[s][4 * j4 + 0] = fmaf(p.x, gi, dv[s][4 * j4 + 0]);
                dv[s][4 * j4 + 1] = fmaf(p.y, gi, dv[s][4 * j4 + 1]);
                dv[s][4 * j4 + 2] = fmaf(p.z, gi, dv[s][4 * j4 + 2]);
                dv[s][4 * j4 + 3] = fmaf(p.w, gi, dv[s][4 * j4 + 3]);
              }
            }
          }
        }
      }
    }

    if (do_dk) {
      s_de[ia * KB + lane] = pa * (dpa - s_d[ia]);
      s_de[ib * KB + lane] = pb * (dpb - s_d[ib]);
      __syncthreads();
      // dk[j][c] += sum_i de[i][j] q[i][c]
#pragma unroll
      for (int r = 0; r < DK_PER_THREAD; ++r) {
        const int e = tid + r * THREADS;
        if (e < KB * Cq) {
          const int j = e / Cq, c = e - j * Cq;
          float a = dk[r];
#pragma unroll 4
          for (int i = 0; i < QB; ++i) a = fmaf(s_de[i * KB + j], s_q[i * sq + c], a);
          dk[r] = a;
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < SLICES; ++s) {
    const int c = cz + s * VC + dv_c;
    if (c < Cv) {
#pragma unroll
      for (int j = 0; j < DV_KEYS; ++j) {
        const int t = j0 + dv_j + j;
        if (t < N) dv_out[(base + t * sn) * Cv + c] = dv[s][j];
      }
    }
  }
  if (do_dk) {
#pragma unroll
    for (int r = 0; r < DK_PER_THREAD; ++r) {
      const int e = tid + r * THREADS;
      if (e < KB * Cq) {
        const int j = e / Cq, c = e - j * Cq, t = j0 + j;
        if (t < N) dk_out[(base + t * sn) * Cq + c] = dk[r];
      }
    }
  }
}

// Query-major pass: dq of the block's QB queries (K3's query pass, without
// the p / de scratch). Thread (warp w, lane) forms p, dp and de for queries
// w and w + NWARPS against key `lane` of each chunk.
template <typename T>
__global__ void __launch_bounds__(THREADS)
line_bwd_query_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ g, const float* __restrict__ m_in,
                      const float* __restrict__ L_in, const float* __restrict__ d_in,
                      float* __restrict__ dq_out, int M, int N, int Cq, int Cv, long long sb,
                      long long sm, long long sn, bool masked) {
  extern __shared__ __align__(16) float smem[];
  const int cq4 = round4(Cq), cv4 = round4(Cv);
  const int sq = padded_stride(cq4), sg = padded_stride(cv4), sv = padded_stride(VC);
  float* s_q = smem;                   // [QB][sq]
  float* s_g = s_q + QB * sq;          // [QB][sg], all channels
  float* s_k = s_g + QB * sg;          // [KB][sq]
  float* s_v = s_k + KB * sq;          // [KB][sv], one VC-channel slice
  float* s_de = s_v + KB * sv;         // [QB][KB + 1]
  float* s_m = s_de + QB * (KB + 1);   // [QB]
  float* s_L = s_m + QB;
  float* s_d = s_L + QB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.y * QB;
  const long long base = line_base(blockIdx.x, M, sb, sm);

  stage(s_q, sq, q, base, sn, i0, QB, N, Cq, 0, cq4);
  stage(s_g, sg, g, base, sn, i0, QB, N, Cv, 0, cv4);
  if (tid < QB) {
    const int t = i0 + tid;
    const bool ok = t < N;
    const long long p = base + (long long)t * sn;
    s_m[tid] = ok ? m_in[p] : 0.f;
    s_L[tid] = ok ? L_in[p] : 1.f;
    s_d[tid] = ok ? d_in[p] : 0.f;
  }

  float acc[DQ_PER_THREAD];
#pragma unroll
  for (int r = 0; r < DQ_PER_THREAD; ++r) acc[r] = 0.f;

  const int ia = warp, ib = warp + NWARPS;
  const int ta = i0 + ia, tb = i0 + ib;
  for (int k0 = 0; k0 < N; k0 += KB) {
    __syncthreads();  // the previous chunk's readers of s_k and s_de are done
    stage(s_k, sq, k, base, sn, k0, KB, N, Cq, 0, cq4);
    __syncthreads();

    const float4* kj = reinterpret_cast<const float4*>(s_k + lane * sq);
    float ea = dot4(reinterpret_cast<const float4*>(s_q + ia * sq), kj, cq4 / 4);
    float eb = dot4(reinterpret_cast<const float4*>(s_q + ib * sq), kj, cq4 / 4);

    // dp = g.v^T over all Cv, v streamed in VC-channel slices
    float dpa = 0.f, dpb = 0.f;
    for (int c0 = 0; c0 < cv4; c0 += VC) {
      const int nc = min(VC, cv4 - c0);
      __syncthreads();  // the previous slice's readers are done
      stage(s_v, sv, v, base, sn, k0, KB, N, Cv, c0, nc);
      __syncthreads();
      const float4* vj = reinterpret_cast<const float4*>(s_v + lane * sv);
      const float4* ga = reinterpret_cast<const float4*>(s_g + ia * sg + c0);
      const float4* gb = reinterpret_cast<const float4*>(s_g + ib * sg + c0);
      for (int c4 = 0; c4 < nc / 4; ++c4) {
        const float4 vv = vj[c4], a = ga[c4], b = gb[c4];
        dpa = fmaf(a.x, vv.x, dpa); dpa = fmaf(a.y, vv.y, dpa);
        dpa = fmaf(a.z, vv.z, dpa); dpa = fmaf(a.w, vv.w, dpa);
        dpb = fmaf(b.x, vv.x, dpb); dpb = fmaf(b.y, vv.y, dpb);
        dpb = fmaf(b.z, vv.z, dpb); dpb = fmaf(b.w, vv.w, dpb);
      }
    }

    const int tj = k0 + lane;
    const bool key_ok = tj < N;
    if (masked && ta == tj) ea = MASK;
    if (masked && tb == tj) eb = MASK;
    const float pa = (key_ok && ta < N) ? expf(ea - s_m[ia]) / s_L[ia] : 0.f;
    const float pb = (key_ok && tb < N) ? expf(eb - s_m[ib]) / s_L[ib] : 0.f;
    s_de[ia * (KB + 1) + lane] = pa * (dpa - s_d[ia]);
    s_de[ib * (KB + 1) + lane] = pb * (dpb - s_d[ib]);
    __syncthreads();

    // dq[i][c] += sum_j de[i][j] k[j][c]
#pragma unroll
    for (int r = 0; r < DQ_PER_THREAD; ++r) {
      const int e = tid + r * THREADS;
      if (e < QB * Cq) {
        const int i = e / Cq, c = e - i * Cq;
        float a = acc[r];
        for (int j = 0; j < KB; ++j) a = fmaf(s_de[i * (KB + 1) + j], s_k[j * sq + c], a);
        acc[r] = a;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < DQ_PER_THREAD; ++r) {
    const int e = tid + r * THREADS;
    if (e < QB * Cq) {
      const int i = e / Cq, c = e - i * Cq, t = i0 + i;
      if (t < N) dq_out[(base + (long long)t * sn) * Cq + c] = acc[r];
    }
  }
}

bool bad_shape(int B, int M, int N, int Cq, int Cv) {
  return B < 1 || M < 1 || N < 1 || Cq < 1 || Cq > MAX_CQ || Cv < 1;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* m, void* l, int B,
               int M, int N, int Cq, int Cv, long long sb, long long sm, long long sn, bool masked,
               cudaStream_t stream) {
  if (bad_shape(B, M, N, Cq, Cv)) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * M, (N + TQ - 1) / TQ, (Cv + THREADS - 1) / THREADS);
  line_fwd_kernel<T><<<grid, THREADS, sizeof(float) * fwd_smem_floats(Cq), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l), M, N, Cq, Cv, sb,
      sm, sn, masked);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, const void* m,
               const void* L, const void* delta, void* dq, void* dk, void* dv, int B, int M, int N,
               int Cq, int Cv, long long sb, long long sm, long long sn, bool masked,
               cudaStream_t stream) {
  if (bad_shape(B, M, N, Cq, Cv)) return (int)cudaErrorInvalidValue;
  const size_t smem_k = sizeof(float) * key_smem_floats(Cq, Cv);
  const size_t smem_q = sizeof(float) * query_smem_floats(Cq, Cv);
  cudaError_t err = cudaFuncSetAttribute(line_bwd_key_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_k);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(line_bwd_query_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(g);
  const float* m_ = static_cast<const float*>(m);
  const float* L_ = static_cast<const float*>(L);
  const float* d_ = static_cast<const float*>(delta);
  const dim3 grid_k(B * M, (N + KB - 1) / KB, (Cv + CV_BLOCK - 1) / CV_BLOCK);
  line_bwd_key_kernel<T><<<grid_k, THREADS, smem_k, stream>>>(
      q_, k_, v_, g_, m_, L_, d_, static_cast<float*>(dk), static_cast<float*>(dv), M, N, Cq, Cv,
      sb, sm, sn, masked);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q(B * M, (N + QB - 1) / QB);
  line_bwd_query_kernel<T><<<grid_q, THREADS, smem_q, stream>>>(
      q_, k_, v_, g_, m_, L_, d_, static_cast<float*>(dq), M, N, Cq, Cv, sb, sm, sn, masked);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K7a. q, k, v of one dtype (is_bf16: bf16, else f32); o, m, l f32, all
// addressed through the pixel strides (sb, sm, sn). Returns cudaGetLastError().
int cca_line_fwd(const void* q, const void* k, const void* v, void* o, void* m, void* l, int B,
                 int M, int N, int Cq, int Cv, long long sb, long long sm, long long sn,
                 int masked, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd<__nv_bfloat16>(q, k, v, o, m, l, B, M, N, Cq, Cv, sb, sm, sn, masked != 0,
                                     st);
  return launch_fwd<float>(q, k, v, o, m, l, B, M, N, Cq, Cv, sb, sm, sn, masked != 0, st);
}

// K7b. q, k, v, g of one dtype; m, L, delta and the f32 grads dq, dk, dv
// through the same pixel strides. Launches the key-major then the
// query-major kernel. Returns cudaGetLastError().
int cca_line_bwd(const void* q, const void* k, const void* v, const void* g, const void* m,
                 const void* L, const void* delta, void* dq, void* dk, void* dv, int B, int M,
                 int N, int Cq, int Cv, long long sb, long long sm, long long sn, int masked,
                 int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(q, k, v, g, m, L, delta, dq, dk, dv, B, M, N, Cq, Cv, sb,
                                     sm, sn, masked != 0, st);
  return launch_bwd<float>(q, k, v, g, m, L, delta, dq, dk, dv, B, M, N, Cq, Cv, sb, sm, sn,
                           masked != 0, st);
}

// Bytes of dynamic shared memory the larger of K7b's two kernels needs (the
// wrapper checks it against the card's limit before launching).
long long cca_line_bwd_smem_bytes(int Cq, int Cv) {
  const size_t a = key_smem_floats(Cq, Cv), b = query_smem_floats(Cq, Cv);
  return (long long)(sizeof(float) * (a > b ? a : b));
}

}  // extern "C"
