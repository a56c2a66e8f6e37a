// Criss-cross attention, one path over lines, on the Hopper tensor cores
// (sm_90a), bf16: K7a cca_line_fwd_tc, K7b cca_line_bwd_tc.
//
// Replaces the TPU kernels of ccnet_tpu/ops/cc_attention_pallas.py:
//   K7a cca_line_fwd_tc  <- _legacy_fwd_kernel  (launched by _legacy_run_path_fwd)
//   K7b cca_line_bwd_tc  <- _legacy_bwd_kernel  (launched by _legacy_run_path_bwd)
// as they run for bf16 inputs at the JAX package's default precision (bf16
// MXU operands, f32 sums). Each call runs ONE path over (B, M, N) lines,
// attention along N, the diagonal at -1e9 when `masked` (the column path):
//   forward   e = q.k^T, m = max e, l = sum exp(e - m) from the f32 p,
//             o = bf16(exp(e - m)).v written in bf16;
//   backward  p = exp(e - m) / L from the JOINT stats (m, L) of both paths,
//             dp = g.v^T, de = bf16(p (dp - delta)), dq = de.k, dk = de^T.q,
//             dv = bf16(p)^T.g, each written in bf16.
// The caller combines the paths and sums their grads
// (ccnet_tpu_torch/ops/cc_attention_cuda.py). The f32 calls (the "highest"
// precision) keep the CUDA-core kernels of cca_lines.cu.
//
// K1-K4 on bf16 lines longer than 128 (the natural route of the JAX package,
// whose _fwd_*_kernel / _bwd_*_kernel round p and de as these do) run here
// too: K1 and K3 as K7a / K7b on the column view; K2 as K7a on the rows with
// its joint-softmax combine fused into the stores (o_col, m_col, l_col
// given: out = (o_col a_c + o a_r) / L in f32, rounded once, and the joint
// m, L written in place of the row stats), as the tensor-core K2 of
// cca_fwd.cu combines; K4 as K7b on the rows with K3's bf16 grads added in
// f32 before the one rounding (add_dq, add_dk, add_dv given).
//
// Lines are strided (cca_tc.cuh): position t of line (b, j) is pixel
// b*sb + j*sm + t*sn, its channels contiguous. The column path reads and
// writes NHWC tensors in place, the outputs landing in NHWC order.
//
// What bounds it on the H100. At the whole-image shape (1, 129, 257, q/k 64,
// v 512) both paths of the forward move 110.9 MB (0.033 ms at 3.35 TB/s) and
// do 25 GFLOP (0.025 ms at 989 TFLOP/s of bf16 tensor cores); the backward
// 161.7 MB and 55 GFLOP. Lines of 97 ... 449 no longer fit one block's
// registers as K1's do, so both kernels tile the keys, and both are close to
// the balance point of bytes and operations: the design reads each input
// from device memory about once per line (the tiles of a line are re-read
// from the L2) and keeps p and de out of device memory.
//
// K7a: one block per (line, 16 NWQ queries), NWQ = 4 warps (fewer on lines
// too long for the p tile), warp w owning queries 16w .. 16w + 15.
//   1. keys stream through shared memory in tiles of 64 (a ring of three
//      cp.async stages, one barrier per tile); s = q.k^T on mma.sync
//      m16n8k16; the row max;
//   2. the same tiles again: s recomputed, p = exp(s - m) in f32 summed into
//      l, rounded to bf16 into a shared tile of the block's queries x the
//      whole line (N_p = 16 ceil(N / 16) keys). The rounding needs the max
//      of the WHOLE line, so no online softmax: that would round
//      exp(s - m_running) and rescale afterwards, another function;
//   3. v streams through in tiles of 64 keys x 64 channels; each 64-channel
//      chunk of o = p.v sums in 32 f32 registers a thread and is written in
//      bf16.
//   The stream buffers of passes 1-2 (k) and 3 (v) are one ring. Shared
//   memory: 97 KB at N = 449, Cq = 64 (two blocks per SM), 73 KB at 257
//   (three).
//   Lines up to ~1,200 (Cq 128) take 4 warps, longer ones 2 or 1 (the
//   wrapper reads the limit from cca_line_fwd_tc_max_n, ~6,000).
//
// K7b: one block per (line, 64 keys), 4 warps. No O(N) scratch per pixel
// (the point of the route), no float atomics. With (m, L) given, p is exact
// per tile, so no online softmax either.
//   A. for each tile of 64 queries (warp w owns 16): s = q.k^T, p from the
//      joint stats; dp = g.v^T over all Cv in 64-channel chunks of g and v
//      (a ring of three cp.async stages), 32 f32 registers; de = p (dp - delta) in
//      f32, rounded to bf16 straight into the A fragments of dq = de.k (as
//      K1 passes p), and into a shared tile for dk += de^T.q (dk of the
//      block's 64 keys stays in registers over the whole line);
//      dq sums over the key blocks of the line: each block writes its part
//      (the tile's queries x Cq, f32) to a scratch of ceil(N/64) x pixels x
//      Cq floats, and a second kernel sums the parts in a fixed order and
//      writes dq in bf16: deterministic, 42 MB of scratch per path at
//      1 x 129 x 257, 207 MB for the row path at 1 x 225 x 449;
//   B. dv = p^T.g, 256 channels at a time (q and g tiles double-buffered):
//      for each query tile, the block's keys x the tile's queries of
//      s^T = k.q^T are recomputed on mma.sync, p^T = exp(s^T - m) / L
//      rounded to bf16 goes from the C to the A fragments in registers, and
//      the chunk's sums stay in 128 registers. Recomputing the logits once
//      per chunk (twice at Cv 512) costs 2 Cq of 2 Cv per pair and chunk,
//      +10 % of the FLOPs at Cq 64; a shared tile of p for the whole line
//      (144 B a query) would cap the line length and leave one block per SM
//      at N = 449.
//   Phases A and B share one region of shared memory: 97 KB at Cq = 64 (two
//   blocks per SM, as the registers allow), any N.
//
// Masks, as in K1-K4: the column self slot is e = -1e9 (it takes part in
// the max: at N = 1 the column is all self slot, m = -1e9, l = 1, o = v),
// keys and queries past the line end get p = 0 exactly.

#include <math_constants.h>

#include "cca_tc.cuh"

namespace {

constexpr int KT = 64;      // keys per streamed tile (K7a), keys per block (K7b)
constexpr int QT = 64;      // queries per tile (K7b)
constexpr int CH = 64;      // value channels per chunk of v and o (K7a), of g and v (K7b's dp)
constexpr int CHB = 256;    // value channels per chunk of g and dv (K7b's phase B)
constexpr int STAGES = 3;   // depth of the cp.async rings: tiles in flight while one is used

struct LineArgs {
  const bf16 *q, *k, *v, *g;
  const float *m, *L, *delta;  // K7b: the joint stats and delta = sum_c out g
  bf16* o;                     // K7a: o; K7b: dv
  float *m_out, *l_out;        // K7a
  bf16 *dq, *dk;               // K7b
  float* dq_part;              // K7b: [ceil(N / KT)][B M][N][Cq]
  const bf16* o_col;           // K2 on these kernels: K1's outputs, combined into o, m, l
  const float *m_col, *l_col;
  const bf16 *add_dq, *add_dk, *add_dv;  // K4 on these kernels: K3's grads, added
  int lines, M, N, Cq, Cv;
  long long sb, sm, sn;
  bool masked;
};

// row stride (bf16) of the q/k/v/g tiles: wide enough for Cq and a chunk
__host__ __device__ __forceinline__ int tile_ld(int cqp) { return (cqp > CH ? cqp : CH) + TC_PAD; }

// 4 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// The ring of both kernels: item it is loaded STAGES - 1 items ahead into
// slot it % STAGES; before using item it, a thread waits for its own copies
// of it and the block meets at one barrier, which also frees the slot of
// item it - 1 for item it + STAGES - 1.

// ------------------------------------------------------------------- K7a

size_t fwd_smem_bytes(int nwq, int cqp, int N) {
  const int ls = tile_ld(cqp), lp = round16(N) + TC_PAD;
  return sizeof(bf16) *
         (size_t(16 * nwq) * ls + size_t(STAGES) * KT * ls + size_t(16 * nwq) * lp);
}

template <int NWQ>
__global__ void __launch_bounds__(NWQ * 32, 3) line_fwd_tc_kernel(const LineArgs a) {
  constexpr int TQ = NWQ * 16, NG = CH / 8;
  extern __shared__ __align__(16) bf16 lines_smem[];
  const int N = a.N, cqp = round16(a.Cq), ls = tile_ld(cqp), lp = round16(N) + TC_PAD;
  bf16* sQ = lines_smem;             // [TQ][ls]
  bf16* sS = sQ + TQ * ls;           // [STAGES][KT][ls]: k tiles (passes 1, 2), v tiles (3)
  bf16* sP = sS + STAGES * KT * ls;  // [TQ][lp]: p in bf16

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int nqb = (N + TQ - 1) / TQ;
  const int line = blockIdx.x / nqb, q0 = (blockIdx.x - line * nqb) * TQ;
  const long long base = line_base(line, a.M, a.sb, a.sm), sn = a.sn;
  const int r0 = warp * 16;
  const int nkt = (N + KT - 1) / KT;

  // passes 1 and 2: item it < 2 nkt is key tile it mod nkt; the max, then p
  const int steps = 2 * nkt;
  auto load_k = [&](int item) {
    const int n0 = (item < nkt ? item : item - nkt) * KT;
    stage(sS + (item % STAGES) * KT * ls, ls, a.k, base + n0 * sn, sn, N - n0, a.Cq, 0, KT, cqp);
  };
  stage(sQ, ls, a.q, base + q0 * sn, sn, N - q0, a.Cq, 0, TQ, cqp);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_k(s);
    cp_async_commit();
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < steps) load_k(it + STAGES - 1);
    cp_async_commit();
    const int k0 = (it < nkt ? it : it - nkt) * KT;
    const bf16* K = sS + (it % STAGES) * KT * ls;
    float s[4][2][4];
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
      if (k0 + jp * 16 < N) scores(s[jp], sQ, K, ls, cqp, r0, jp * 16, lane);
    if (it == nkt) {  // the quad of lanes that shares a row holds the whole max
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (k0 + jp * 16 >= N) continue;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = q0 + r0 + gid + 8 * h, j = k0 + jp * 16 + t * 8 + 2 * tig;
          float e0 = s[jp][t][2 * h], e1 = s[jp][t][2 * h + 1];
          if (a.masked && j == i) e0 = MASK;
          if (a.masked && j + 1 == i) e1 = MASK;
          if (it < nkt) {
            if (j < N) mx[h] = fmaxf(mx[h], e0);
            if (j + 1 < N) mx[h] = fmaxf(mx[h], e1);
          } else {
            const float p0 = j < N ? expf(e0 - mx[h]) : 0.f;
            const float p1 = j + 1 < N ? expf(e1 - mx[h]) : 0.f;
            l[h] += p0 + p1;  // from the f32 p, as _legacy_fwd_kernel
            *reinterpret_cast<uint32_t*>(sP + (r0 + gid + 8 * h) * lp + j) = pack_bf16(p0, p1);
          }
        }
      }
    }
  }

  float wc[2] = {}, wr[2] = {}, Lj[2];  // K2's combine weights of this thread's two queries
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int i = q0 + r0 + gid + 8 * h;
    float m = mx[h];
    Lj[h] = l[h];
    if (a.o_col) {
      const bool ok = i < N;
      const float mc = ok ? a.m_col[base + i * sn] : 0.f, lc = ok ? a.l_col[base + i * sn] : 0.f;
      m = fmaxf(mc, mx[h]);
      wc[h] = expf(mc - m);
      wr[h] = expf(mx[h] - m);
      Lj[h] = lc * wc[h] + l[h] * wr[h];
    }
    if (tig == 0 && i < N) {
      a.m_out[base + i * sn] = m;
      a.l_out[base + i * sn] = Lj[h];
    }
  }
  __syncthreads();  // every warp is done with the ring before pass 3 refills it

  // pass 3: o = p.v; item it < nch nkt is (chunk it / nkt, key tile it mod nkt)
  const int nch = (a.Cv + CH - 1) / CH, steps3 = nch * nkt;
  auto load_v = [&](int item) {
    const int c = item / nkt, n0 = (item - c * nkt) * KT;
    stage(sS + (item % STAGES) * KT * ls, ls, a.v, base + n0 * sn, sn, N - n0, a.Cv, c * CH, KT,
          CH);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps3) load_v(s);
    cp_async_commit();
  }
  float acc[NG][4];
  for (int it = 0; it < steps3; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < steps3) load_v(it + STAGES - 1);
    cp_async_commit();
    const int ch = it / nkt, k0 = (it - ch * nkt) * KT;
    if (k0 == 0) {
#pragma unroll
      for (int n = 0; n < NG; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
    const bf16* V = sS + (it % STAGES) * KT * ls;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (k0 + jp * 16 >= N) continue;
      uint32_t ap[4];
      load_a(ap, sP, lp, r0, k0 + jp * 16, lane);  // A[i][j] = p[i][j]
#pragma unroll
      for (int n = 0; n < CH; n += 16) {
        uint32_t b[4];
        load_b2_trans(b, V, ls, jp * 16, n, lane);  // B[j][c] = v[j][c]
        mma_2(acc[n / 8], acc[n / 8 + 1], ap, b);
      }
    }
    if (k0 + KT >= N) {  // the chunk's last key tile: store it
#pragma unroll
      for (int n = 0; n < NG; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = q0 + r0 + gid + 8 * h, c = ch * CH + n * 8 + 2 * tig;
          if (i >= N || c >= a.Cv) continue;
          const long long o = (base + i * sn) * a.Cv + c;
          float x0 = acc[n][2 * h], x1 = acc[n][2 * h + 1];
          if (a.o_col) {
            x0 = (__bfloat162float(a.o_col[o]) * wc[h] + x0 * wr[h]) / Lj[h];
            if (c + 1 < a.Cv) x1 = (__bfloat162float(a.o_col[o + 1]) * wc[h] + x1 * wr[h]) / Lj[h];
          }
          store_pair(a.o, nullptr, o, c, a.Cv, x0, x1);
        }
      }
    }
  }
}

template <int NWQ>
int launch_fwd_nwq(const LineArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(NWQ, round16(a.Cq), a.N);
  const auto kernel = line_fwd_tc_kernel<NWQ>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nqb = (a.N + 16 * NWQ - 1) / (16 * NWQ);
  kernel<<<dim3((unsigned)(a.lines * (long long)nqb)), NWQ * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory one block may use on Hopper

// the most warps (4, 2, 1) whose p tile fits; 0 if none does
int fwd_warps(int Cq, int N) {
  for (int nwq = 4; nwq >= 1; nwq /= 2)
    if (fwd_smem_bytes(nwq, round16(Cq), N) <= MAX_SMEM) return nwq;
  return 0;
}

// ------------------------------------------------------------------- K7b

// slots of phase A's q (and stats) ring: a tile's q stays while its nch
// chunks pass, so the next tiles' q, loaded STAGES - 1 items ahead, need
// their own slots
__host__ __device__ __forceinline__ int bwd_q_slots(int nch) {
  return 1 + (STAGES - 1 + nch - 1) / nch;
}

// bf16 elements shared by phase A (the (g, v) ring, the q ring, the de
// tile) and phase B (two slots of a q tile and a CHB-channel g tile)
__host__ __device__ __forceinline__ int bwd_union_elems(int cqp, int nch) {
  const int ls = tile_ld(cqp), lc = CH + TC_PAD, lb = CHB + TC_PAD;
  const int ea = STAGES * (QT + KT) * lc + bwd_q_slots(nch) * QT * ls + QT * lc;
  const int eb = 2 * QT * (ls + lb);
  return ea > eb ? ea : eb;
}

size_t bwd_smem_bytes(int cqp, int Cv) {
  const int nch = (Cv + CH - 1) / CH, qs = bwd_q_slots(nch);
  return sizeof(bf16) * (size_t(KT) * tile_ld(cqp) + bwd_union_elems(cqp, nch)) +
         sizeof(float) * 3 * QT * (qs > 2 ? qs : 2);
}

// stage the stats of the QT queries from q0 (m, L, delta; 0 past N, which
// nothing reads: joint_p gives p = 0 there first)
__device__ __forceinline__ void stage_stats(float* S, const LineArgs& a, long long base, int q0) {
  for (int e = threadIdx.x; e < 3 * QT; e += blockDim.x) {
    const int which = e / QT, i = q0 + e - which * QT;
    const float* src = which == 0 ? a.m : which == 1 ? a.L : a.delta;
    const bool ok = i < a.N;
    cp_async4(S + e, ok ? src + base + i * a.sn : src, ok);
  }
}

// p of query i and key j (logit e) from the joint stats; exactly 0 past the
// line end; the column self slot at -1e9 as the TPU kernel
__device__ __forceinline__ float joint_p(float e, int i, int j, int N, bool masked, float m,
                                         float L) {
  if (i >= N || j >= N) return 0.f;
  return expf((masked && i == j ? MASK : e) - m) / L;
}

// BIGQ: Cq > 64, dk's sums take 16 n-tiles instead of 8
template <bool BIGQ>
__global__ void __launch_bounds__(128, 2) line_bwd_tc_kernel(const LineArgs a) {
  constexpr int LC = CH + TC_PAD, LB = CHB + TC_PAD, DKN = BIGQ ? 16 : 8, NB = CHB / 8;
  extern __shared__ __align__(16) bf16 lines_smem[];
  const int N = a.N, Cq = a.Cq, Cv = a.Cv, cqp = round16(Cq), ls = tile_ld(cqp);
  const int nqt = (N + QT - 1) / QT, nch = (Cv + CH - 1) / CH, qs = bwd_q_slots(nch);
  bf16* sK = lines_smem;          // [KT][ls]: the block's keys
  bf16* sU = sK + KT * ls;        // phase A, then phase B:
  bf16* sRing = sU;               //   A: [STAGES][g: QT, v: KT][LC]
  bf16* sQa = sRing + STAGES * (QT + KT) * LC;  // A: [qs][QT][ls]
  bf16* sDE = sQa + qs * QT * ls;  //  A: [QT][LC], de of one query tile
  bf16* sB = sU;                   //  B: [2][q: QT x ls, g: QT x LB]
  float* sStat = reinterpret_cast<float*>(sU + bwd_union_elems(cqp, nch));  // [][3][QT]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int nkb = (N + KT - 1) / KT;
  const int line = blockIdx.x / nkb, kb = blockIdx.x - line * nkb, k0 = kb * KT;
  const long long base = line_base(line, a.M, a.sb, a.sm), sn = a.sn;
  const int r0 = warp * 16;

  // A: item it = (query tile t, chunk ch) for t < nqt, ch < nch, with the
  // tile's q and stats loaded beside its first chunk
  const int steps = nqt * nch;
  auto load_a_item = [&](int item) {
    const int t = item / nch, c = item - t * nch;
    bf16* G = sRing + (item % STAGES) * (QT + KT) * LC;
    stage(G, LC, a.g, base + t * QT * sn, sn, N - t * QT, Cv, c * CH, QT, CH);
    stage(G + QT * LC, LC, a.v, base + k0 * sn, sn, N - k0, Cv, c * CH, KT, CH);
    if (c == 0) {
      stage(sQa + (t % qs) * QT * ls, ls, a.q, base + t * QT * sn, sn, N - t * QT, Cq, 0, QT,
            cqp);
      stage_stats(sStat + (t % qs) * 3 * QT, a, base, t * QT);
    }
  };
  stage(sK, ls, a.k, base + k0 * sn, sn, N - k0, Cq, 0, KT, cqp);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_a_item(s);
    cp_async_commit();
  }
  float dk[DKN][4];
#pragma unroll
  for (int n = 0; n < DKN; ++n) dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
  float p[4][2][4], dp[4][2][4];
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < steps) load_a_item(it + STAGES - 1);
    cp_async_commit();
    const int t = it / nch, ch = it - t * nch, q0 = t * QT;
    const bf16* Q = sQa + (t % qs) * QT * ls;
    const float* St = sStat + (t % qs) * 3 * QT;
    if (ch == 0) {  // p of this warp's queries x the block's keys; dp from 0
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (k0 + jp * 16 < N) scores(p[jp], Q, sK, ls, cqp, r0, jp * 16, lane);
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = r0 + gid + 8 * (e >> 1), j = k0 + jp * 16 + tt * 8 + 2 * tig + (e & 1);
            p[jp][tt][e] = k0 + jp * 16 < N
                               ? joint_p(p[jp][tt][e], q0 + il, j, N, a.masked, St[il], St[QT + il])
                               : 0.f;
            dp[jp][tt][e] = 0.f;
          }
        }
      }
    }
    // dp += g_c.v_c^T
    const bf16* G = sRing + (it % STAGES) * (QT + KT) * LC;
    const bf16* V = G + QT * LC;
#pragma unroll
    for (int kk = 0; kk < CH; kk += 16) {
      uint32_t ag[4];
      load_a(ag, G, LC, r0, kk, lane);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (k0 + jp * 16 >= N) continue;
        uint32_t b[4];
        load_b2(b, V, LC, jp * 16, kk, lane);  // B[c][j] = v[j][c]
        mma_2(dp[jp][0], dp[jp][1], ag, b);
      }
    }
    if (ch + 1 == nch) {  // the tile's dp is complete: de, dq's part, dk
      uint32_t de[4][4];  // A fragments of de (queries x keys), bf16
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int il = r0 + gid + 8 * h;
            const float d = St[2 * QT + il];
            de[jp][2 * tt + h] = pack_bf16(p[jp][tt][2 * h] * (dp[jp][tt][2 * h] - d),
                                           p[jp][tt][2 * h + 1] * (dp[jp][tt][2 * h + 1] - d));
            *reinterpret_cast<uint32_t*>(sDE + il * LC + jp * 16 + tt * 8 + 2 * tig) =
                de[jp][2 * tt + h];
          }
        }
      }
      // dq's part from this block's keys: de.k, 64 channels at a time
      for (int c0 = 0; c0 < cqp; c0 += 64) {
        float acc[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (k0 + jp * 16 >= N) continue;
#pragma unroll
          for (int n = 0; n < 64; n += 16) {
            if (c0 + n >= cqp) continue;
            uint32_t b[4];
            load_b2_trans(b, sK, ls, jp * 16, c0 + n, lane);  // B[j][c] = k[j][c]
            mma_2(acc[n / 8], acc[n / 8 + 1], de[jp], b);
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = q0 + r0 + gid + 8 * h, c = c0 + n * 8 + 2 * tig;
            if (i >= N || c >= Cq) continue;
            float* dst = a.dq_part + (((long long)kb * a.lines + line) * N + i) * Cq + c;
            dst[0] = acc[n][2 * h];
            if (c + 1 < Cq) dst[1] = acc[n][2 * h + 1];
          }
        }
      }
      __syncthreads();  // the de tile is complete
      // dk of this warp's keys r0 .. r0 + 15: de^T.q over the tile's queries
#pragma unroll
      for (int kk = 0; kk < QT; kk += 16) {
        if (q0 + kk >= N) continue;
        uint32_t ad[4];
        load_a_trans(ad, sDE, LC, kk, r0, lane);  // A[j][i] = de[i][j]
#pragma unroll
        for (int n = 0; n < DKN * 8; n += 16) {
          if (n >= cqp) continue;
          uint32_t b[4];
          load_b2_trans(b, Q, ls, kk, n, lane);  // B[i][c] = q[i][c]
          mma_2(dk[n / 8], dk[n / 8 + 1], ad, b);
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < DKN; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = k0 + r0 + gid + 8 * h, c = n * 8 + 2 * tig;
      if (j < N) store_pair(a.dk, a.add_dk, (base + j * sn) * Cq + c, c, Cq, dk[n][2 * h],
                            dk[n][2 * h + 1]);
    }
  }
  __syncthreads();  // every warp is done with phase A's memory before phase B reuses it

  // B: dv = p^T.g; item it = (chunk c of CHB channels, query tile t), double buffered
  const int stepsb = ((Cv + CHB - 1) / CHB) * nqt;
  auto load_b_item = [&](int item) {
    const int c = item / nqt, t = item - c * nqt;
    bf16* Qb = sB + (item & 1) * QT * (ls + LB);
    stage(Qb, ls, a.q, base + t * QT * sn, sn, N - t * QT, Cq, 0, QT, cqp);
    stage(Qb + QT * ls, LB, a.g, base + t * QT * sn, sn, N - t * QT, Cv, c * CHB, QT, CHB);
    stage_stats(sStat + (item & 1) * 3 * QT, a, base, t * QT);
  };
  load_b_item(0);
  cp_async_commit();
  float acc[NB][4];
  for (int it = 0; it < stepsb; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < stepsb) load_b_item(it + 1);
    cp_async_commit();
    const int c = it / nqt, t = it - c * nqt, q0 = t * QT;
    if (t == 0) {
#pragma unroll
      for (int n = 0; n < NB; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
    const bf16* Q = sB + (it & 1) * QT * (ls + LB);
    const bf16* G = Q + QT * ls;
    const float* St = sStat + (it & 1) * 3 * QT;
    if (k0 + r0 < N) {  // this warp's keys r0 .. r0 + 15 exist
#pragma unroll
      for (int ip = 0; ip < 4; ++ip) {
        if (q0 + ip * 16 >= N) continue;
        float s[2][4];
        scores(s, sK, Q, ls, cqp, r0, ip * 16, lane);  // s^T[j][i] = k_j.q_i
        uint32_t ap[4];  // A[j][i] = bf16(p[i][j])
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = k0 + r0 + gid + 8 * h, il = ip * 16 + tt * 8 + 2 * tig;
            ap[2 * tt + h] =
                pack_bf16(joint_p(s[tt][2 * h], q0 + il, j, N, a.masked, St[il], St[QT + il]),
                          joint_p(s[tt][2 * h + 1], q0 + il + 1, j, N, a.masked, St[il + 1],
                                  St[QT + il + 1]));
          }
        }
#pragma unroll
        for (int n = 0; n < CHB; n += 16) {
          if (c * CHB + n >= Cv) continue;
          uint32_t b[4];
          load_b2_trans(b, G, LB, ip * 16, n, lane);  // B[i][c] = g[i][c]
          mma_2(acc[n / 8], acc[n / 8 + 1], ap, b);
        }
      }
    }
    if (t + 1 == nqt) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = k0 + r0 + gid + 8 * h, cc = c * CHB + n * 8 + 2 * tig;
          if (j < N) store_pair(a.o, a.add_dv, (base + j * sn) * Cv + cc, cc, Cv, acc[n][2 * h],
                                acc[n][2 * h + 1]);
        }
      }
    }
  }
}

// dq = the sum of the key blocks' parts, in block order (plus add_dq when
// given), written in bf16
__global__ void line_dq_sum_kernel(const LineArgs a, int nkb) {
  const long long total = (long long)a.lines * a.N * a.Cq;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(e % a.Cq);
    const long long li = e / a.Cq;  // line * N + i
    const int line = (int)(li / a.N), i = (int)(li - (long long)line * a.N);
    float s = 0.f;
    for (int kb = 0; kb < nkb; ++kb) s += a.dq_part[kb * total + e];
    const long long o = (line_base(line, a.M, a.sb, a.sm) + i * a.sn) * a.Cq + c;
    if (a.add_dq) s += __bfloat162float(a.add_dq[o]);
    a.dq[o] = __float2bfloat16(s);
  }
}

LineArgs line_args(const void* q, const void* k, const void* v, int B, int M, int N, int Cq,
                   int Cv, long long sb, long long sm, long long sn, int masked) {
  LineArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.lines = B * M;
  a.M = M;
  a.N = N;
  a.Cq = Cq;
  a.Cv = Cv;
  a.sb = sb;
  a.sm = sm;
  a.sn = sn;
  a.masked = masked != 0;
  return a;
}

bool bad_shape(int B, int M, int N, int Cq, int Cv) {
  return B < 1 || M < 1 || N < 1 || Cq < 1 || Cq > MAX_CQ || Cv < 1;
}

}  // namespace

extern "C" {

// K7a on the tensor cores: bf16 q, k, v; o in bf16, m and l in f32, all
// through the pixel strides (sb, sm, sn). With o_col (bf16), m_col and l_col
// (f32) given in the same layout (K2), o, m and l take the joint combine;
// null otherwise. Returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape it does not take: see cca_line_fwd_tc_max_n).
int cca_line_fwd_tc(const void* q, const void* k, const void* v, void* o, void* m, void* l,
                    const void* o_col, const void* m_col, const void* l_col, int B, int M, int N,
                    int Cq, int Cv, long long sb, long long sm, long long sn, int masked,
                    void* stream) {
  if (bad_shape(B, M, N, Cq, Cv)) return (int)cudaErrorInvalidValue;
  LineArgs a = line_args(q, k, v, B, M, N, Cq, Cv, sb, sm, sn, masked);
  a.o = static_cast<bf16*>(o);
  a.m_out = static_cast<float*>(m);
  a.l_out = static_cast<float*>(l);
  a.o_col = static_cast<const bf16*>(o_col);
  a.m_col = static_cast<const float*>(m_col);
  a.l_col = static_cast<const float*>(l_col);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fwd_warps(Cq, N)) {  // warps per block: the p tile must fit
    case 4: return launch_fwd_nwq<4>(a, st);
    case 2: return launch_fwd_nwq<2>(a, st);
    case 1: return launch_fwd_nwq<1>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The longest line K7a's tensor-core kernel takes at Cq q/k channels.
int cca_line_fwd_tc_max_n(int Cq) {
  int n = 16;
  while (fwd_warps(Cq, n + 16)) n += 16;
  return n;
}

// K7b on the tensor cores: bf16 q, k, v, g; f32 m, L, delta; dq, dk, dv in
// bf16, all through the pixel strides. dq_part is f32 scratch of
// ceil(N / 64) * B * M * N * Cq floats. add_dq, add_dk, add_dv (bf16, the
// same layout; K4) are added to the grads in f32 before they are rounded,
// or null. Launches the key-block kernel, then the fixed-order sum of dq.
// Returns cudaGetLastError().
int cca_line_bwd_tc(const void* q, const void* k, const void* v, const void* g, const void* m,
                    const void* L, const void* delta, void* dq_part, void* dq, void* dk, void* dv,
                    const void* add_dq, const void* add_dk, const void* add_dv, int B, int M,
                    int N, int Cq, int Cv, long long sb, long long sm, long long sn, int masked,
                    void* stream) {
  if (bad_shape(B, M, N, Cq, Cv)) return (int)cudaErrorInvalidValue;
  LineArgs a = line_args(q, k, v, B, M, N, Cq, Cv, sb, sm, sn, masked);
  a.g = static_cast<const bf16*>(g);
  a.m = static_cast<const float*>(m);
  a.L = static_cast<const float*>(L);
  a.delta = static_cast<const float*>(delta);
  a.dq_part = static_cast<float*>(dq_part);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.o = static_cast<bf16*>(dv);
  a.add_dq = static_cast<const bf16*>(add_dq);
  a.add_dk = static_cast<const bf16*>(add_dk);
  a.add_dv = static_cast<const bf16*>(add_dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cqp = round16(Cq), nkb = (N + KT - 1) / KT;
  const size_t smem = bwd_smem_bytes(cqp, Cv);
  const auto kernel = cqp > 64 ? line_bwd_tc_kernel<true> : line_bwd_tc_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)(a.lines * (long long)nkb)), 128, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)a.lines * N * Cq;
  const int blocks = (int)((total + 255) / 256 < 132 * 16 ? (total + 255) / 256 : 132 * 16);
  line_dq_sum_kernel<<<blocks, 256, 0, st>>>(a, nkb);
  return (int)cudaGetLastError();
}

}  // extern "C"
