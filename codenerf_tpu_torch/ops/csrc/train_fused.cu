// Single-pass CodeNeRF loss kernel for Hopper (sm_90a), in its modes, and
// the sigma-only forward of the hierarchical coarse pass (sigma_step, at
// the end of this file).
//
// Replaces the TPU kernel codenerf_tpu/ops/fused_train.py::_train_kernel:
// per ray, the in-kernel xyz expansion and 64-lane positional encoding, the
// trunk (bf16 matmuls, f32 accumulation, per-ray latent injection), the
// softplus sigma head and the rgb head, the volume-rendering composite, the
// squared error and its cotangent 2*scale*(rgb - gt), the composite
// backward, and the dx chain down to shape block 0, which yields the
// per-ray code cotangents d_sproj, d_tproj, d_vcontrib. That is mode
// weight_grads=False (test-time code optimization). Mode weight_grads=True
// (category training) also sums every weight's and bias's f32 gradient over
// all points, in the operand order of ops/fused_train.py::weight_shapes.
// Either mode takes the dual composite of hierarchical sampling (the TPU
// kernel's dual=True): z is the union of coarse and fine depths, and the
// head kernel also composites the coarse subset from the same evaluation,
// adding its loss's cotangents before the one backward chain. The pose
// modes (the TPU kernel's input_grads with weight_grads=False, optionally
// want_weights) also return the compositing weights and the exact ray and
// depth cotangents d_ro8, d_vd8, d_z.
//
// Design (see ops/fused_train.py for the bound). The TPU kernel keeps all
// weights and every activation of a 16-ray tile (~6 MB) in VMEM for the
// whole grid, and its dW/db blocks stay resident as accumulators across the
// sequential grid; an H100 block has 227 KB of shared memory and blocks run
// in no order. This design therefore runs as kernels on one stream:
//   (i)   gemm_kernel<PE, false>: tiled bf16 WMMA GEMM (128 x 128 blocks,
//         f32 accumulation) fed by a 3-stage cp.async pipeline; for
//         enc_xyz the A tile is the PE, built from ro/vd/z as it loads.
//         The epilogue (bias, per-ray vector, ReLU) writes the bf16
//         activation and, where the next layer injects a latent, that
//         layer's input bf16(activation + proj[ray]) too. Activations go to
//         a device-memory workspace the wrapper allocates.
//   (ii)  head_kernel: one block per ray. Sigma head (dot with the w_sig
//         row, softplus), rgb_out head, composite with a warp scan over the
//         samples, MSE, composite backward; emits dsig = g_sigma *
//         sigmoid(sig_pre) and the rgb_hidden cotangent (masked, bf16).
//   (iii) gemm_kernel<false, true>: the dx chain g @ W^T with fused
//         epilogues (ReLU mask from the stored bf16 activation, the sigma
//         term dsig * w_sig, per-ray row sums into f32 buffers by atomics),
//         then f32_to_bf16 writes the three cotangent outputs.
// Every epilogue walks its warp's 32 x 64 tile row by row from shared
// memory: coalesced 128-byte rows, ray sums in registers.
// Weight-gradient mode adds:
//   (iv)  pe_kernel: the bf16 PE written once to the workspace, so that
//         enc_xyz's forward reads it as a plain A operand and its dW can
//         read it again (the frozen mode builds it in the A-tile load);
//         the enc_xyz output y0 is stored for the last ReLU mask;
//   (v)   dw_kernel: dW = X^T @ GH, a GEMM whose reduction axis is the
//         points, launched right after the dx step that produces GH while
//         X (the layer's stored bf16 input) is still in the workspace. The
//         points are split over blockIdx.z; each block reduces its slice
//         into an f32 register tile and writes it to a partial buffer, and
//         column sums of the GH tiles it loads give the bias partials.
//         colsum_kernel then adds the partials in a fixed order, so dW and
//         db are the same bits on every run (no atomics);
//   (vi)  head_kernel's phase 4: per ray, sum_s t*dsig (sigma dW),
//         sum_s dsig, sum_s r*gh8 and sum_s gh8 (rgb_out dW, db) into a
//         (R, HEAD_PART) buffer, then colsum_kernel in two fixed-order
//         stages.
// The pose modes add:
//   (vii) head_kernel writes the weights w_s and the composite's z
//         cotangent; the frozen forward keeps y0 and the dx chain runs on
//         through enc_xyz's ReLU mask to gh0;
//   (viii) input_chain_kernel: per point d_pe = gh0 . W_enc^T (CUDA-core
//         f32 dots against W_enc^T in shared memory, 2 * 64 * W FLOP, ~2%
//         of the call), the PE Jacobian, d_z += d_xyz . vd; per ray
//         d_ro8, d_vd8 in a fixed order.
// Rounding points follow the TPU kernel: bf16 activations after each ReLU,
// the latent injection as a bf16 add, sig_pre in f32 from bf16 t, masks on
// the stored bf16 activations, the composite entirely in f32; gh rounded to
// bf16 before both its dx and its dW product, the sigma dW from bf16 t
// times f32 dsig. The per-ray code cotangents are summed with f32 atomics,
// so their last bits may differ from run to run; dW and db do not.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
constexpr int GEMM_THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int LDA = BK + 8;
constexpr int LDB_ROW = BN + 8;
constexpr int LDB_COL = BK + 8;
constexpr int A_STAGE = BM * LDA;                       // bf16 elements
constexpr int B_STAGE = (BK * LDB_ROW > BN * LDB_COL) ? BK * LDB_ROW
                                                      : BN * LDB_COL;
constexpr int LDS = 64 + 4;        // floats per staged epilogue row
constexpr size_t PIPE_BYTES = sizeof(bf16) * STAGES * (A_STAGE + B_STAGE);
constexpr size_t EPI_BYTES = sizeof(float) * (GEMM_THREADS / 32) * 32 * LDS;
constexpr size_t GEMM_SMEM = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
constexpr int HEAD_THREADS = 128;
constexpr int MAX_PER_LANE = 8;    // samples per lane in the head scan
constexpr int MAX_S = 32 * MAX_PER_LANE;
constexpr unsigned FULL = 0xffffffffu;
constexpr int LDA_T = BM + 8;      // dW GEMM: A stage held (BK, BM), k-major
static_assert(BK * LDA_T <= A_STAGE, "dW A stage must fit the A buffer");
// dW GEMM blocks per launch: 2 blocks of GEMM_THREADS on each of the
// H100's 132 SMs. A constant, so the split of the points (and with it the
// order of the sums) does not depend on the card.
constexpr int DW_BLOCKS = 264;
constexpr int COLSUM_GROUPS = 64;  // first-stage row groups of a column sum

struct GemmArgs {
  int M, N, K, S;          // C (M x N) = A (M x K) @ B (K x N); ray = m / S
  const bf16* A;           // M x K row-major (unused in PE mode)
  const float* ro8;        // PE mode: (R, 8), (R, 8), (R, S)
  const float* vd8;
  const float* z;
  int n_freq;
  const bf16* B;           // K x N row-major; transposed mode: N x K row-major
  // Epilogue, in this order: rs_pre += raw; + dsig[m] * wsig[n]; + bias[n];
  // + rowvec[ray][n]; ReLU; * (mask[m][n] > 0); rs_post += value; stores.
  const float* bias;
  const bf16* rowvec;      // per-ray [R][N]
  int relu;
  const float* dsig;
  const float* wsig;
  float* rs_pre;           // per-ray sums [R][ld] (f32, atomics)
  int rs_pre_ld;
  const bf16* mask;        // [M][N]
  float* rs_post;
  int rs_post_ld;
  bf16* out;               // [M][N] bf16(value)
  bf16* out_inj;           // [M][N] bf16(bf16(value) + inj[ray][n]): the
  const bf16* inj;         // next layer's input with its latent injected
  int inj_ld;
};

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Lane k of the positional encoding: [x | sin block | cos block],
// frequency-major, padding lanes 0 (core/encoding.py channel order).
struct PeLane {
  int d;        // coordinate
  float scale;  // 2^i, exact
  int kind;     // 0 identity, 1 sin, 2 cos, 3 padding
};

__device__ __forceinline__ PeLane pe_lane(int k, int F) {
  if (k < 3) return {k, 1.f, 0};
  if (k < 3 + 3 * F) return {(k - 3) % 3, (float)(1 << ((k - 3) / 3)), 1};
  if (k < 3 + 6 * F)
    return {(k - 3 - 3 * F) % 3, (float)(1 << ((k - 3 - 3 * F) / 3)), 2};
  return {0, 0.f, 3};
}

__device__ __forceinline__ float pe_value(const GemmArgs& g, const PeLane& l,
                                          int m) {
  if (l.kind == 3) return 0.f;
  const int ray = m / g.S;
  const float x = __fadd_rn(g.ro8[ray * 8 + l.d],
                            __fmul_rn(g.vd8[ray * 8 + l.d], g.z[m]));
  const float t = x * l.scale;
  return l.kind == 0 ? t : (l.kind == 1 ? sinf(t) : cosf(t));
}

// One pipeline stage: the BM x BK tile of A and the BK x BN tile of B.
template <bool PE, bool BT>
__device__ __forceinline__ void load_stage(const GemmArgs& g, bf16* As,
                                           bf16* Bs, int m0, int n0, int k0,
                                           int tid) {
  if constexpr (PE) {
    // enc_xyz: the A tile is the PE of the tile's points, built here.
    // Each thread keeps one column (PE lane) of the tile.
    const int c = tid % BK;
    const PeLane l = pe_lane(k0 + c, g.n_freq);
#pragma unroll 4
    for (int r = tid / BK; r < BM; r += GEMM_THREADS / BK) {
      const int m = m0 + r;
      As[r * LDA + c] = __float2bfloat16_rn(m < g.M ? pe_value(g, l, m) : 0.f);
    }
  } else {
#pragma unroll
    for (int q = 0; q < (BM * BK) / (8 * GEMM_THREADS); ++q) {
      const int idx = tid + q * GEMM_THREADS;
      const int r = idx / (BK / 8), c8 = (idx % (BK / 8)) * 8;
      const int m = m0 + r;
      const int mc = m < g.M ? m : g.M - 1;   // rows past M read as zeros
      cp_async16(&As[r * LDA + c8], g.A + (size_t)mc * g.K + k0 + c8,
                 m < g.M ? 16 : 0);
    }
  }
  if constexpr (BT) {
#pragma unroll
    for (int q = 0; q < (BK * BN) / (8 * GEMM_THREADS); ++q) {
      const int idx = tid + q * GEMM_THREADS;
      const int n = idx / (BK / 8), k8 = (idx % (BK / 8)) * 8;
      cp_async16(&Bs[n * LDB_COL + k8], g.B + (size_t)(n0 + n) * g.K + k0 + k8,
                 16);
    }
  } else {
#pragma unroll
    for (int q = 0; q < (BK * BN) / (8 * GEMM_THREADS); ++q) {
      const int idx = tid + q * GEMM_THREADS;
      const int r = idx / (BN / 8), c8 = (idx % (BN / 8)) * 8;
      cp_async16(&Bs[r * LDB_ROW + c8], g.B + (size_t)(k0 + r) * g.N + n0 + c8,
                 16);
    }
  }
}

__device__ __forceinline__ void flush_sums(float* dst, int ld, int ray, int n,
                                           float a, float b) {
  atomicAdd(&dst[(size_t)ray * ld + n], a);
  atomicAdd(&dst[(size_t)ray * ld + n + 1], b);
}

// The warp's staged 32 x 64 tile, row by row; this lane owns the global
// columns n, n + 1 (local 2 * lane, 2 * lane + 1). Row writes and mask
// reads are 128 contiguous bytes per warp; the rows' masks and dsig are
// loaded before the loop so their latencies overlap. Ray sums stay in
// registers and go out with one atomic per (ray, column) when the ray
// changes.
__device__ void epilogue_rows(const GemmArgs& g, const float* st, int mrow0,
                              int n, int lane) {
  float b0 = 0.f, b1 = 0.f, w0 = 0.f, w1 = 0.f;
  if (g.bias) { b0 = g.bias[n]; b1 = g.bias[n + 1]; }
  if (g.dsig) { w0 = g.wsig[n]; w1 = g.wsig[n + 1]; }
  const int rows = min(32, g.M - mrow0);
  if (rows <= 0) return;
  __nv_bfloat162 mk[32];
  float ds[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int m = mrow0 + (r < rows ? r : 0);
    if (g.mask)
      mk[r] = *reinterpret_cast<const __nv_bfloat162*>(g.mask + (size_t)m * g.N + n);
    if (g.dsig) ds[r] = g.dsig[m];
  }
  int cur = -1;
  float pre0 = 0.f, pre1 = 0.f, post0 = 0.f, post1 = 0.f;
  float rv0 = 0.f, rv1 = 0.f, pj0 = 0.f, pj1 = 0.f;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    if (r >= rows) break;
    const int m = mrow0 + r;
    const int ray = m / g.S;
    if (ray != cur) {
      if (cur >= 0 && g.rs_pre) flush_sums(g.rs_pre, g.rs_pre_ld, cur, n, pre0, pre1);
      if (cur >= 0 && g.rs_post) flush_sums(g.rs_post, g.rs_post_ld, cur, n, post0, post1);
      cur = ray;
      pre0 = pre1 = post0 = post1 = 0.f;
      if (g.rowvec) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            g.rowvec + (size_t)ray * g.N + n);
        rv0 = __low2float(v); rv1 = __high2float(v);
      }
      if (g.inj) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            g.inj + (size_t)ray * g.inj_ld + n);
        pj0 = __low2float(v); pj1 = __high2float(v);
      }
    }
    const float2 a = *reinterpret_cast<const float2*>(st + r * LDS + 2 * lane);
    float v0 = a.x, v1 = a.y;
    pre0 += v0; pre1 += v1;
    if (g.dsig) {
      v0 = __fadd_rn(v0, __fmul_rn(ds[r], w0));
      v1 = __fadd_rn(v1, __fmul_rn(ds[r], w1));
    }
    if (g.bias) { v0 += b0; v1 += b1; }
    if (g.rowvec) { v0 += rv0; v1 += rv1; }
    if (g.relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
    if (g.mask) {
      v0 = __low2float(mk[r]) > 0.f ? v0 : 0.f;
      v1 = __high2float(mk[r]) > 0.f ? v1 : 0.f;
    }
    post0 += v0; post1 += v1;
    const size_t o = (size_t)m * g.N + n;
    if (g.out)
      *reinterpret_cast<__nv_bfloat162*>(g.out + o) = __floats2bfloat162_rn(v0, v1);
    if (g.out_inj)
      *reinterpret_cast<__nv_bfloat162*>(g.out_inj + o) =
          __floats2bfloat162_rn(round_bf(v0) + pj0, round_bf(v1) + pj1);
  }
  if (cur >= 0 && g.rs_pre) flush_sums(g.rs_pre, g.rs_pre_ld, cur, n, pre0, pre1);
  if (cur >= 0 && g.rs_post) flush_sums(g.rs_post, g.rs_post_ld, cur, n, post0, post1);
}

template <bool PE, bool BT>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs g) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = g.K / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // 3-stage cp.async pipeline: group s carries stage s.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<PE, BT>(g, As + s * A_STAGE, Bs + s * B_STAGE, m0, n0, s * BK,
                         tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pf = kt + STAGES - 1;
    if (pf < nk)
      load_stage<PE, BT>(g, As + (pf % STAGES) * A_STAGE,
                         Bs + (pf % STAGES) * B_STAGE, m0, n0, pf * BK, tid);
    cp_async_commit();
    const bf16* a = As + (kt % STAGES) * A_STAGE;
    const bf16* b = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      using BLayout = typename std::conditional<BT, wmma::col_major,
                                                wmma::row_major>::type;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], a + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (BT)
          wmma::load_matrix_sync(bfr[j], b + (wn * 64 + j * 16) * LDB_COL + kk,
                                 LDB_COL);
        else
          wmma::load_matrix_sync(bfr[j], b + kk * LDB_ROW + wn * 64 + j * 16,
                                 LDB_ROW);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the pipeline buffers become the epilogue stage

  float* st = reinterpret_cast<float*>(smem) + warp * 32 * LDS;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(st + i * 16 * LDS + j * 16, acc[i][j], LDS,
                              wmma::mem_row_major);
  __syncwarp();
  epilogue_rows(g, st, m0 + wm * 32, n0 + wn * 64 + 2 * lane, lane);
}

// The PE of every point, (M, 64) bf16: the values the A-tile load of
// gemm_kernel<true, false> builds, bit for bit.
__global__ void pe_kernel(GemmArgs g, bf16* out) {
  const size_t n = (size_t)g.M * 64;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / 64), k = (int)(i % 64);
    out[i] = __float2bfloat16_rn(pe_value(g, pe_lane(k, g.n_freq), m));
  }
}

struct DwArgs {
  int P, M, N;             // dW (M x N) = X^T @ GH over P points
  const bf16* X;           // (P, M) row-major: the layer's input
  const bf16* G;           // (P, N) row-major: its bf16 output cotangent
  int per_split;           // points per blockIdx.z, a multiple of BK
  float* part_w;           // [splits][M][N] partial dW
  float* part_b;           // [splits][N] partial db (column sums of GH)
};

// One stage of the dW GEMM: A is the (BK points, BM) slice of X, kept
// k-major (the col-major A operand of WMMA); B the (BK, BN) slice of GH.
// Points past the split's end and columns past M load as zeros.
__device__ __forceinline__ void load_stage_dw(const DwArgs& d, bf16* As,
                                              bf16* Bs, int m0, int n0,
                                              int p0, int p_end, int tid) {
#pragma unroll
  for (int q = 0; q < (BK * BM) / (8 * GEMM_THREADS); ++q) {
    const int idx = tid + q * GEMM_THREADS;
    const int r = idx / (BM / 8), c8 = (idx % (BM / 8)) * 8;
    const int p = p0 + r, m = m0 + c8;
    const bool ok = p < p_end && m < d.M;
    cp_async16(&As[r * LDA_T + c8], ok ? d.X + (size_t)p * d.M + m : d.X,
               ok ? 16 : 0);
  }
#pragma unroll
  for (int q = 0; q < (BK * BN) / (8 * GEMM_THREADS); ++q) {
    const int idx = tid + q * GEMM_THREADS;
    const int r = idx / (BN / 8), c8 = (idx % (BN / 8)) * 8;
    const int p = p0 + r;
    const bool ok = p < p_end;
    cp_async16(&Bs[r * LDB_ROW + c8],
               ok ? d.G + (size_t)p * d.N + n0 + c8 : d.G, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(GEMM_THREADS) dw_kernel(DwArgs d) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int p_begin = split * d.per_split;
  const int p_end = min(d.P, p_begin + d.per_split);
  const int nk = p_end > p_begin ? (p_end - p_begin + BK - 1) / BK : 0;
  // The blocks of the first row of M tiles also sum GH's columns: thread
  // tid sums column tid % BN over half tid / BN of each stage's rows.
  const bool do_b = blockIdx.y == 0;
  const int bc = tid % BN, bh = tid / BN;
  float bsum = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage_dw(d, As + s * A_STAGE, Bs + s * B_STAGE, m0, n0,
                    p_begin + s * BK, p_end, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pf = kt + STAGES - 1;
    if (pf < nk)
      load_stage_dw(d, As + (pf % STAGES) * A_STAGE,
                    Bs + (pf % STAGES) * B_STAGE, m0, n0, p_begin + pf * BK,
                    p_end, tid);
    cp_async_commit();
    const bf16* a = As + (kt % STAGES) * A_STAGE;
    const bf16* b = Bs + (kt % STAGES) * B_STAGE;
    if (do_b) {
#pragma unroll
      for (int r = 0; r < BK / 2; ++r)
        bsum += bf(b[(bh * (BK / 2) + r) * LDB_ROW + bc]);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], a + kk * LDA_T + wm * 32 + i * 16, LDA_T);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bfr[j], b + kk * LDB_ROW + wn * 64 + j * 16,
                               LDB_ROW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the pipeline buffers become the bias-sum stage

  float* pw = d.part_w + (size_t)split * d.M * d.N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + wm * 32 + i * 16;   // M % 16 == 0: whole fragments
    if (row >= d.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(pw + (size_t)row * d.N + n0 + wn * 64 + j * 16,
                              acc[i][j], d.N, wmma::mem_row_major);
  }
  if (do_b) {
    float* sb = reinterpret_cast<float*>(smem);
    sb[tid] = bsum;
    __syncthreads();
    if (tid < BN)
      d.part_b[(size_t)split * d.N + n0 + tid] = sb[tid] + sb[tid + BN];
  }
}

// out[g][c] = sum over rows [g * rows_per_group, (g + 1) * rows_per_group)
// of x[row * ld + c], in row order: a deterministic column sum.
__global__ void colsum_kernel(const float* x, int ld, int rows, int cols,
                              int rows_per_group, float* out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * rows_per_group;
  const int r1 = min(rows, r0 + rows_per_group);
  float a = 0.f;
  for (int r = r0; r < r1; ++r) a += x[(size_t)r * ld + c];
  out[(size_t)blockIdx.y * cols + c] = a;
}

struct HeadArgs {
  int R, S, W;             // W: trunk width; the rgb hidden layer is W / 2
  const bf16* t;           // (P, W) enc_shape output
  const bf16* r;           // (P, W/2) rgb_hidden output
  const float* z;          // (R, S)
  const float* gt8;        // (R, 8)
  const float* cmask;      // (R, S) or null: the dual mode's coarse mask
  const float* cdelta;     // (R, S) or null: its consecutive-coarse deltas
  const float* w_sig;      // (W,)
  const float* b_sig;      // (1,)
  const bf16* w_rgb;       // (W/2, 8)
  const float* b_rgb;      // (8,)
  float two_scale;
  int white_bg;
  float* se8;              // (R, 8)
  float* rgb8;             // (R, 8) or null
  float* weights;          // (R, S) or null: the compositing weights
  float* dz;               // (R, S) or null: the composite's own dL/dz
  float* dsig;             // (P,)
  bf16* g_r;               // (P, W/2)
  float* part;             // (R, head_part_cols(W)) or null: per-ray sums
                           // for the sigma and rgb_out dW/db
  // The plane-op backward (all four or none): the outside (R, S) f32
  // cotangents of the sigma and r, g, b planes replace the composite and
  // the loss; gt8, se8, rgb8, weights and dz are then unused.
  const float* gsig;
  const float* gr;
  const float* gg;
  const float* gb;
};

// A ray's row of head-kernel partial sums: [sigma dW (W) | rgb_out dW
// (W/2 x 8) | rgb_out db (8) | sigma db (1) | padding (7)].
__host__ __device__ constexpr int head_part_cols(int W) {
  return W + (W / 2) * 8 + 16;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

struct CompositeOut {
  float rgb[3], dep, acc, se[3];
};

// One composite of a ray and its backward, run by one warp; lane l owns
// the contiguous samples [l*per, l*per + per). ``s_pre`` holds the sigma
// pre-activations (softplus applied here) or, with ``density``, the
// densities themselves. Sample s has the delta ``cdelta[s]`` and the
// cumprod factor e_s + 1e-10 * cmask[s] when the dual mode's coarse planes
// are given; else the union delta z[s+1] - z[s] (1e10 at the last sample)
// and e_s + 1e-10. Without ``backward`` the pass stops at the composited
// ray. The backward takes the per-ray cotangent ``g8`` [r g b depth acc]
// when given (the standalone composite) and otherwise forms the loss's,
// 2 * scale * (rgb - gt) with no depth or acc term, and its squared error.
// The composite's sigma cotangent (before the softplus derivative) goes
// to s_gs and its rgb cotangents w_s * g_k to s_gc, in f32: stored, or
// with ``accumulate`` added to what a previous pass stored there.
// ``w_out`` (global or shared, or null) receives the weights w_s; ``s_dd``
// (shared, or null) the delta cotangents dx_s * sig_s (0 at the last
// sample), from which the caller forms the composite's z cotangent.
__device__ __forceinline__ CompositeOut composite_pass(
    const HeadArgs& h, int ray, int lane, const float* s_pre,
    float (*s_c)[MAX_S], float (*s_gc)[MAX_S], float* s_gs,
    const float* cmask, const float* cdelta, bool accumulate,
    float* w_out, float* s_dd, bool density = false,
    const float* g8 = nullptr, bool backward = true) {
  const int S = h.S;
  const int per = (S + 31) / 32;
  const float* zr = h.z + (size_t)ray * S;
  float e_[MAX_PER_LANE], u_[MAX_PER_LANE], T_[MAX_PER_LANE],
      w_[MAX_PER_LANE], dl_[MAX_PER_LANE], sg_[MAX_PER_LANE];
  float loc = 1.f;
#pragma unroll
  for (int q = 0; q < MAX_PER_LANE; ++q) {
    const int s = lane * per + q;
    e_[q] = 1.f; u_[q] = 1.f; dl_[q] = 0.f; T_[q] = loc; sg_[q] = 0.f;
    if (q < per && s < S) {
      const float x = s_pre[s];
      const float sig = density ? x : fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
      sg_[q] = sig;
      if (cdelta) {
        dl_[q] = cdelta[s];
        e_[q] = expf(-sig * dl_[q]);
        u_[q] = e_[q] + 1e-10f * cmask[s];
      } else {
        dl_[q] = (s < S - 1) ? zr[s + 1] - zr[s] : 1e10f;
        e_[q] = expf(-sig * dl_[q]);
        u_[q] = e_[q] + 1e-10f;
      }
      loc *= u_[q];
    }
  }
  float incl = loc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl *= o;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 1.f;
  float rs0 = 0.f, rs1 = 0.f, rs2 = 0.f, dep = 0.f, acc = 0.f;
#pragma unroll
  for (int q = 0; q < MAX_PER_LANE; ++q) {
    const int s = lane * per + q;
    w_[q] = 0.f;
    if (q < per && s < S) {
      T_[q] *= excl;
      w_[q] = (1.f - e_[q]) * T_[q];
      if (w_out) w_out[s] = w_[q];
      rs0 += w_[q] * s_c[0][s];
      rs1 += w_[q] * s_c[1][s];
      rs2 += w_[q] * s_c[2][s];
      dep += w_[q] * zr[s];
      acc += w_[q];
    }
  }
  rs0 = warp_sum(rs0); rs1 = warp_sum(rs1); rs2 = warp_sum(rs2);
  dep = warp_sum(dep); acc = warp_sum(acc);
  CompositeOut out;
  out.rgb[0] = rs0; out.rgb[1] = rs1; out.rgb[2] = rs2;
  out.dep = dep; out.acc = acc;
  float g[3], gd = 0.f, ga = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (h.white_bg) out.rgb[k] = (out.rgb[k] + 1.f) - acc;
    out.se[k] = 0.f;
    if (g8) {
      g[k] = g8[k];
    } else if (backward) {
      const float diff = out.rgb[k] - h.gt8[(size_t)ray * 8 + k];
      out.se[k] = diff * diff;
      g[k] = h.two_scale * diff;
    }
  }
  if (!backward) return out;
  if (g8) { gd = g8[3]; ga = g8[4]; }
  const float resid = h.white_bg ? ga - ((g[0] + g[1]) + g[2]) : ga;

  // dL_s = sum_{i > s} w_i dw_i: a reverse exclusive scan.
  float wdw[MAX_PER_LANE], dw[MAX_PER_LANE], lsum = 0.f;
#pragma unroll
  for (int q = 0; q < MAX_PER_LANE; ++q) {
    const int s = lane * per + q;
    dw[q] = 0.f; wdw[q] = 0.f;
    if (q < per && s < S) {
      dw[q] = g[0] * s_c[0][s] + g[1] * s_c[1][s] + g[2] * s_c[2][s] + resid;
      if (g8) dw[q] += gd * zr[s];
      wdw[q] = w_[q] * dw[q];
      lsum += wdw[q];
    }
  }
  float suf = lsum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(FULL, suf, off);
    if (lane + off < 32) suf += o;
  }
  float run = __shfl_down_sync(FULL, suf, 1);
  if (lane == 31) run = 0.f;
#pragma unroll
  for (int q = MAX_PER_LANE - 1; q >= 0; --q) {
    const int s = lane * per + q;
    if (q < per && s < S) {
      const float dL = run;
      run += wdw[q];
      const float dx = e_[q] * (T_[q] * dw[q] - dL / u_[q]);
      const float gsig = dx * dl_[q];
      s_gs[s] = accumulate ? s_gs[s] + gsig : gsig;
      if (s_dd) s_dd[s] = (s < S - 1) ? dx * sg_[q] : 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        s_gc[k][s] = accumulate ? s_gc[k][s] + w_[q] * g[k] : w_[q] * g[k];
    }
  }
  return out;
}

__global__ void __launch_bounds__(HEAD_THREADS) head_kernel(HeadArgs h) {
  __shared__ float s_pre[MAX_S];
  __shared__ float s_c[3][MAX_S];
  __shared__ float s_gc[3][MAX_S];
  __shared__ float s_dsig[MAX_S];
  __shared__ float s_dd[MAX_S];
  const int ray = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int S = h.S, W = h.W, Wh = W / 2;
  const size_t p0 = (size_t)ray * S;

  // Phase 1: sigma pre-activation and rgb per sample, one warp per sample.
  for (int s = warp; s < S; s += HEAD_THREADS / 32) {
    const bf16* tp = h.t + (p0 + s) * W;
    const bf16* rp = h.r + (p0 + s) * Wh;
    float a = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int k = lane; k < W; k += 32) a += bf(tp[k]) * h.w_sig[k];
    for (int k = lane; k < Wh; k += 32) {
      const float rv = bf(rp[k]);
      c0 += rv * bf(h.w_rgb[k * 8 + 0]);
      c1 += rv * bf(h.w_rgb[k * 8 + 1]);
      c2 += rv * bf(h.w_rgb[k * 8 + 2]);
    }
    a = warp_sum(a); c0 = warp_sum(c0); c1 = warp_sum(c1); c2 = warp_sum(c2);
    if (lane == 0) {
      s_pre[s] = a + h.b_sig[0];
      s_c[0][s] = c0 + h.b_rgb[0];
      s_c[1][s] = c1 + h.b_rgb[1];
      s_c[2][s] = c2 + h.b_rgb[2];
    }
  }
  __syncthreads();

  // Phase 2 (warp 0): the composite forward, the loss and the composite
  // backward; in the dual mode a second pass over the coarse planes, whose
  // cotangents add to the first's. In the plane-op backward the outside
  // plane cotangents take the composite's place. Then dsig = g_sigma *
  // sigmoid(sig_pre) and the bf16 rgb cotangents, with the same sample
  // ownership. With ``weights`` the pass writes w_s; with ``dz`` the
  // composite's z cotangent dz_s = ddelta_{s-1} - ddelta_s (the loss's
  // depth lane is masked, so the TPU kernel's gd * w_s term is 0).
  if (warp == 0) {
    const int per = (S + 31) / 32;
    CompositeOut f = {};
    float se_c[3] = {0.f, 0.f, 0.f};
    if (h.gsig) {
      for (int q = 0; q < per; ++q) {
        const int s = lane * per + q;
        if (s < S) {
          s_dsig[s] = h.gsig[p0 + s];
          s_gc[0][s] = h.gr[p0 + s];
          s_gc[1][s] = h.gg[p0 + s];
          s_gc[2][s] = h.gb[p0 + s];
        }
      }
    } else {
      f = composite_pass(
          h, ray, lane, s_pre, s_c, s_gc, s_dsig, nullptr, nullptr, false,
          h.weights ? h.weights + p0 : nullptr, h.dz ? s_dd : nullptr);
      if (h.cmask) {
        const CompositeOut c = composite_pass(
            h, ray, lane, s_pre, s_c, s_gc, s_dsig, h.cmask + p0,
            h.cdelta + p0, true, nullptr, nullptr);
        se_c[0] = c.se[0]; se_c[1] = c.se[1]; se_c[2] = c.se[2];
      }
    }
    __syncwarp();
    for (int q = 0; q < per; ++q) {
      const int s = lane * per + q;
      if (s < S) {
        if (h.dz) h.dz[p0 + s] = (s > 0 ? s_dd[s - 1] : 0.f) - s_dd[s];
        const float x = s_pre[s];
        const float ds = s_dsig[s] * (1.f / (1.f + expf(-x)));
        h.dsig[p0 + s] = ds;
        s_dsig[s] = ds;
#pragma unroll
        for (int k = 0; k < 3; ++k) s_gc[k][s] = round_bf(s_gc[k][s]);
      }
    }
    if (lane == 0 && h.se8) {
      // The fine SE in lanes 0..2, the dual mode's coarse SE in 4..6.
      float* se_row = h.se8 + (size_t)ray * 8;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        se_row[k] = f.se[k];
        se_row[4 + k] = se_c[k];
      }
      se_row[3] = 0.f;
      se_row[7] = 0.f;
      if (h.rgb8) {
        float* o = h.rgb8 + (size_t)ray * 8;
        o[0] = f.rgb[0]; o[1] = f.rgb[1]; o[2] = f.rgb[2]; o[3] = f.dep;
        o[4] = f.acc; o[5] = 0.f; o[6] = 0.f; o[7] = 0.f;
      }
    }
  }
  __syncthreads();

  // Phase 3: rgb_out backward and the rgb_hidden ReLU mask.
  for (int idx = tid; idx < S * Wh; idx += HEAD_THREADS) {
    const int s = idx / Wh, c = idx % Wh;
    const float v = s_gc[0][s] * bf(h.w_rgb[c * 8 + 0])
                  + s_gc[1][s] * bf(h.w_rgb[c * 8 + 1])
                  + s_gc[2][s] * bf(h.w_rgb[c * 8 + 2]);
    const size_t o = (p0 + s) * Wh + c;
    h.g_r[o] = __float2bfloat16_rn(bf(h.r[o]) > 0.f ? v : 0.f);
  }
  if (!h.part) return;

  // Phase 4 (weight gradients): this ray's sums over its samples.
  float* row = h.part + (size_t)ray * head_part_cols(W);
  for (int c = tid; c < W; c += HEAD_THREADS) {
    float a = 0.f;
    for (int s = 0; s < S; ++s) a += bf(h.t[(p0 + s) * W + c]) * s_dsig[s];
    row[c] = a;
  }
  for (int c = tid; c < Wh; c += HEAD_THREADS) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float rv = bf(h.r[(p0 + s) * Wh + c]);
      a0 += rv * s_gc[0][s];
      a1 += rv * s_gc[1][s];
      a2 += rv * s_gc[2][s];
    }
    float* o = row + W + c * 8;
    o[0] = a0; o[1] = a1; o[2] = a2;
#pragma unroll
    for (int k = 3; k < 8; ++k) o[k] = 0.f;
  }
  if (tid < 16) {
    float a = 0.f;
    if (tid < 3)
      for (int s = 0; s < S; ++s) a += s_gc[tid][s];
    else if (tid == 8)
      for (int s = 0; s < S; ++s) a += s_dsig[s];
    row[W + Wh * 8 + tid] = a;
  }
}

__global__ void f32_to_bf16_kernel(const float* x, bf16* y, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = __float2bfloat16_rn(x[i]);
}

template <bool PE, bool BT>
int launch_gemm_t(const GemmArgs& g, cudaStream_t stream) {
  const cudaError_t rc = cudaFuncSetAttribute(
      gemm_kernel<PE, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GEMM_SMEM);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid(g.N / BN, (g.M + BM - 1) / BM);
  gemm_kernel<PE, BT><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(g);
  return (int)cudaGetLastError();
}

int launch_gemm(const GemmArgs& g, bool pe, bool bt, cudaStream_t stream) {
  if (g.N % BN != 0 || g.K % BK != 0) return (int)cudaErrorInvalidValue;
  if (pe) return launch_gemm_t<true, false>(g, stream);
  if (bt) return launch_gemm_t<false, true>(g, stream);
  return launch_gemm_t<false, false>(g, stream);
}

int launch_convert(const float* x, bf16* y, size_t n, cudaStream_t stream) {
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  f32_to_bf16_kernel<<<blocks, 256, 0, stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

#define CHECK(call)            \
  do {                         \
    const int rc_ = (call);    \
    if (rc_ != 0) return rc_;  \
  } while (0)

int launch_colsum(const float* x, int ld, int rows, int cols,
                  int rows_per_group, float* out, cudaStream_t stream) {
  const dim3 grid((cols + 255) / 256,
                  (rows + rows_per_group - 1) / rows_per_group);
  colsum_kernel<<<grid, 256, 0, stream>>>(x, ld, rows, cols, rows_per_group,
                                          out);
  return (int)cudaGetLastError();
}

// How the dW GEMM splits the points: about DW_BLOCKS blocks in all, each
// split a whole number of BK-point stages.
struct DwPlan {
  int splits, per_split;
};

DwPlan dw_plan(int M, int N, int P) {
  const int tiles = (N / BN) * ((M + BM - 1) / BM);
  const int ktiles = (P + BK - 1) / BK;
  int splits = (DW_BLOCKS + tiles - 1) / tiles;
  if (splits > ktiles) splits = ktiles;
  if (splits < 1) splits = 1;
  const int per = ((ktiles + splits - 1) / splits) * BK;
  return {(P + per - 1) / per, per};
}

size_t dw_part_elems(int M, int N, int P) {
  return (size_t)dw_plan(M, N, P).splits * ((size_t)M * N + N);
}

// dw (M, N) = X^T @ G and db (N,) = column sums of G, f32, over P points:
// the split GEMM into ``part``, then the fixed-order sum of the splits.
int launch_dw(const bf16* X, const bf16* G, int P, int M, int N, float* part,
              float* dw, float* db, cudaStream_t stream) {
  if (N % BN != 0 || M % 16 != 0) return (int)cudaErrorInvalidValue;
  CHECK((int)cudaFuncSetAttribute(
      dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GEMM_SMEM));
  const DwPlan pl = dw_plan(M, N, P);
  DwArgs d = {P, M, N, X, G, pl.per_split, part,
              part + (size_t)pl.splits * M * N};
  const dim3 grid(N / BN, (M + BM - 1) / BM, pl.splits);
  dw_kernel<<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(d);
  CHECK((int)cudaGetLastError());
  CHECK(launch_colsum(d.part_w, M * N, pl.splits, M * N, pl.splits, dw,
                      stream));
  return launch_colsum(d.part_b, N, pl.splits, N, pl.splits, db, stream);
}


struct InputArgs {
  int S, W, n_freq;
  const bf16* gh0;         // (P, W): enc_xyz's output cotangent, masked
  const bf16* w_enc;       // (64, W): enc_xyz's weight (in, out)
  const float* ro8;        // (R, 8)
  const float* vd8;        // (R, 8)
  const float* z;          // (R, S)
  float* d_z;              // (R, S): holds the composite's dz; += xyz term
  float* d_ro8;            // (R, 8)
  float* d_vd8;            // (R, 8)
};

constexpr int INPUT_THREADS = 256;

__host__ __device__ constexpr size_t input_smem_bytes(int W) {
  return sizeof(bf16) * (size_t)W * 64                      // W_enc^T
         + sizeof(float) * (size_t)(INPUT_THREADS / 32) * W  // gh0 rows
         + sizeof(float) * (size_t)MAX_S * 3;                // d_xyz
}

// The input chain of the pose modes (the TPU kernel's input_grads tail,
// fused_train.py:615-626): per point d_pe = gh0 . W_enc^T (64 lanes, f32
// sums of bf16 products), the PE Jacobian dpe/dt (1, cos t, -sin t) with
// t = xyz * 2^i, and d_xyz = (d_pe * dpe/dt) . A^T; then d_z += d_xyz . vd
// per point, and per ray d_ro = sum_s d_xyz and d_vd = sum_s d_xyz * z_s.
// One block per ray; each warp takes one sample at a time, lane l the PE
// lanes 2l and 2l + 1 against W_enc^T staged in shared memory. Every sum
// runs in a fixed order (the dot over W, a butterfly over the lanes, the
// ray sums over the samples), so d_ro8, d_vd8 and d_z are the same bits
// on every launch.
__global__ void __launch_bounds__(INPUT_THREADS) input_chain_kernel(
    InputArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = a.W, S = a.S;
  __nv_bfloat162* s_wt = reinterpret_cast<__nv_bfloat162*>(smem);  // [W][32]
  float* s_gh = reinterpret_cast<float*>(smem + sizeof(bf16) * W * 64);
  float* s_dxyz = s_gh + (INPUT_THREADS / 32) * W;                  // [S][3]
  const int ray = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  bf16* wt = reinterpret_cast<bf16*>(s_wt);
  for (int i = tid; i < 64 * W; i += INPUT_THREADS) {
    const int k = i % 64, c = i / 64;
    wt[i] = a.w_enc[(size_t)k * W + c];
  }
  __syncthreads();

  const float* ro = a.ro8 + (size_t)ray * 8;
  const float* vd = a.vd8 + (size_t)ray * 8;
  const PeLane l0 = pe_lane(2 * lane, a.n_freq);
  const PeLane l1 = pe_lane(2 * lane + 1, a.n_freq);
  float* gh = s_gh + warp * W;
  for (int s = warp; s < S; s += INPUT_THREADS / 32) {
    const size_t p = (size_t)ray * S + s;
    for (int k0 = 8 * lane; k0 < W; k0 += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(a.gh0 + p * W + k0);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gh[k0 + 2 * i] = __low2float(v2[i]);
        gh[k0 + 2 * i + 1] = __high2float(v2[i]);
      }
    }
    __syncwarp();
    float d0 = 0.f, d1 = 0.f;
#pragma unroll 8
    for (int c = 0; c < W; ++c) {
      const float g = gh[c];
      const __nv_bfloat162 w2 = s_wt[c * 32 + lane];
      d0 += g * __low2float(w2);
      d1 += g * __high2float(w2);
    }
    __syncwarp();     // gh is rewritten by the warp's next sample
    const float zs = a.z[p];
    float dxyz[3] = {0.f, 0.f, 0.f};
    const PeLane ls[2] = {l0, l1};
    const float dpe[2] = {d0, d1};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const PeLane& l = ls[j];
      if (l.kind == 3) continue;
      const float x = __fadd_rn(ro[l.d], __fmul_rn(vd[l.d], zs));
      const float t = x * l.scale;
      const float dt = l.kind == 0 ? 1.f : (l.kind == 1 ? cosf(t) : -sinf(t));
      const float v = (dpe[j] * dt) * l.scale;
#pragma unroll
      for (int d = 0; d < 3; ++d) dxyz[d] += l.d == d ? v : 0.f;
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) dxyz[d] = warp_sum(dxyz[d]);
    if (lane == 0) {
      a.d_z[p] += (dxyz[0] * vd[0] + dxyz[1] * vd[1]) + dxyz[2] * vd[2];
      s_dxyz[s * 3 + 0] = dxyz[0];
      s_dxyz[s * 3 + 1] = dxyz[1];
      s_dxyz[s * 3 + 2] = dxyz[2];
    }
  }
  __syncthreads();
  if (tid < 16) {
    const int d = tid % 8;
    float acc = 0.f;
    if (d < 3) {
      const float* zr = a.z + (size_t)ray * S;
      for (int s = 0; s < S; ++s)
        acc += tid < 8 ? s_dxyz[s * 3 + d] : s_dxyz[s * 3 + d] * zr[s];
    }
    (tid < 8 ? a.d_ro8 : a.d_vd8)[(size_t)ray * 8 + d] = acc;
  }
}

}  // namespace

// Workspace sizes (elements) for one call: bf16 activations and gradients,
// f32 dsig and per-ray cotangent sums; with weight gradients or input
// gradients also y0; in weight-gradient mode also the PE, the dW partials
// and the head kernel's per-ray partials.
extern "C" void fused_workspace(int R, int S, int W, int nb, int nt,
                                int weight_grads, int input_grads,
                                size_t* n_bf16, size_t* n_f32) {
  const size_t P = (size_t)R * S;
  *n_bf16 = (size_t)(2 * nb + 2 * nt + 5) * P * W;
  *n_f32 = P + (size_t)R * (nb + nt + 1) * W;
  if (weight_grads || input_grads) *n_bf16 += P * W;
  if (!weight_grads) return;
  *n_bf16 += P * 64;
  size_t part = dw_part_elems(64, W, (int)P);
  const size_t sq = dw_part_elems(W, W, (int)P);
  const size_t half = dw_part_elems(W, W / 2, (int)P);
  part = part > sq ? part : sq;
  part = part > half ? part : half;
  *n_f32 += part + (size_t)(R + COLSUM_GROUPS) * head_part_cols(W);
}

// One call on R rays x S samples. ``cmask`` and ``cdelta`` ((R, S) f32,
// both or neither) select the dual-composite mode: z is the union of the
// coarse and fine depths, and the coarse composite over the cmask subset
// (deltas cdelta) adds its squared error in se8 lanes 4..6 and its
// cotangents to the fine composite's. ``weights`` ((R, S) f32, or null)
// receives the compositing weights (the TPU kernel's want_weights).
// ``input_grads`` (the pose modes; not with the dual mode) writes the
// exact ray and depth cotangents d_ro8, d_vd8 (R, 8) and d_z (R, S): the
// frozen forward also keeps y0, the dx chain runs on through enc_xyz's
// ReLU mask, and input_chain_kernel finishes the PE Jacobian on top of the
// composite's own dz, which the head kernel writes. ``gplanes`` (a host
// array of four (R, S) f32 device pointers, or null) selects the plane-op
// backward (the TPU's _bwd_kernel): the forward is recomputed as in the
// other modes, the cotangents of the sigma, r, g, b planes take the place
// of the composite and the loss (gt8, se8, rgb8, weights and cmask are
// null), and the chains follow by flag, any of the four flag pairs; d_z
// then holds the input chain's xyz term alone. ``wts`` is a host array of
// the 2*k device pointers of ops/fused_train.py::flatten_params, in its
// order:
// 2-D weights bf16 (in, out), 1-D weights and biases f32. With
// ``weight_grads``, ``dwb`` is a host array of 2*k f32 device pointers in
// the same order, each the shape of its weight or bias, which receive the
// gradients; else it is null. Returns the first nonzero
// cudaGetLastError() after a launch, else 0.
extern "C" int fused_step(
    const float* ro8, const float* vd8, const float* z, const bf16* sproj,
    const bf16* tproj, const bf16* vcontrib, const float* gt8,
    const float* cmask, const float* cdelta, const void* const* gplanes,
    const void* const* wts, bf16* ws, float* ws32, float* se8, float* rgb8,
    float* weights, bf16* d_sproj, bf16* d_tproj, bf16* d_vcontrib,
    float* d_ro8, float* d_vd8, float* d_z, void* const* dwb,
    int weight_grads, int input_grads, int R, int S, int W, int nb, int nt,
    int n_freq, float two_scale, int white_bg, cudaStream_t stream) {
  if (S > MAX_S || W % 256 != 0 || 3 + 6 * n_freq > 64 || nb < 1 || nt < 1
      || (cmask == nullptr) != (cdelta == nullptr)
      || (cmask != nullptr && (weights != nullptr || input_grads))
      || (gplanes != nullptr && (cmask != nullptr || weights != nullptr
                                 || rgb8 != nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t P = (size_t)R * S, PW = P * W;
  auto wb = [&](int i) { return static_cast<const bf16*>(wts[2 * i]); };
  auto wf = [&](int i) { return static_cast<const float*>(wts[2 * i]); };
  auto bias = [&](int i) { return static_cast<const float*>(wts[2 * i + 1]); };
  auto dw = [&](int i) { return static_cast<float*>(dwb[2 * i]); };
  auto db = [&](int i) { return static_cast<float*>(dwb[2 * i + 1]); };
  const int i_encs = nb + 1, i_sig = nb + 2, i_encv = nb + 3;
  const int i_tex = nb + 4, i_rgbh = nb + nt + 4, i_rgbo = nb + nt + 5;

  bf16* xs = ws;                      // nb shape-block inputs (injected)
  bf16* ys = xs + (size_t)nb * PW;    // nb shape-block outputs
  bf16* t = ys + (size_t)nb * PW;
  bf16* yv = t + PW;
  bf16* xt = yv + PW;                 // nt texture-block inputs (injected)
  bf16* yts = xt + (size_t)nt * PW;   // nt texture-block outputs
  bf16* r = yts + (size_t)nt * PW;    // P x W/2
  bf16* g_r = r + PW / 2;             // P x W/2
  bf16* gA = g_r + PW / 2;
  bf16* gB = gA + PW;
  bf16* y0 = gB + PW;                 // weight or input grads: enc_xyz out
  bf16* pe = y0 + PW;                 // weight_grads: P x 64
  float* dsig = ws32;
  float* rs_s = dsig + P;             // (R, nb, W)
  float* rs_t = rs_s + (size_t)R * nb * W;
  float* rs_v = rs_t + (size_t)R * nt * W;
  float* head_part = rs_v + (size_t)R * W;   // weight_grads: (R, HP)
  float* head_tmp = head_part + (size_t)R * head_part_cols(W);
  float* dw_part = head_tmp + (size_t)COLSUM_GROUPS * head_part_cols(W);
  CHECK((int)cudaMemsetAsync(rs_s, 0, sizeof(float) * (size_t)R * (nb + nt + 1) * W,
                             stream));

  GemmArgs base = {};
  base.M = (int)P;
  base.S = S;

  // ---- forward. Each layer's epilogue also writes the next layer's
  // input with its per-ray latent injected (a bf16 add, as on the TPU).
  GemmArgs g = base;
  g.K = 64; g.N = W; g.ro8 = ro8; g.vd8 = vd8; g.z = z; g.n_freq = n_freq;
  g.B = wb(0); g.bias = bias(0); g.relu = 1;
  g.out_inj = xs; g.inj = sproj; g.inj_ld = nb * W;
  if (weight_grads) {
    // The PE goes to the workspace once: enc_xyz reads it as a plain A
    // operand here and again for its dW. y0 is kept for the last mask.
    pe_kernel<<<4096, 256, 0, stream>>>(g, pe);
    CHECK((int)cudaGetLastError());
    g.A = pe; g.out = y0;
    CHECK(launch_gemm(g, false, false, stream));
  } else {
    if (input_grads) g.out = y0;      // for enc_xyz's ReLU mask
    CHECK(launch_gemm(g, true, false, stream));
  }
  for (int j = 0; j < nb; ++j) {
    g = base; g.K = W; g.N = W; g.A = xs + (size_t)j * PW; g.B = wb(1 + j);
    g.bias = bias(1 + j); g.relu = 1; g.out = ys + (size_t)j * PW;
    if (j + 1 < nb) {
      g.out_inj = xs + (size_t)(j + 1) * PW;
      g.inj = sproj + (size_t)(j + 1) * W; g.inj_ld = nb * W;
    }
    CHECK(launch_gemm(g, false, false, stream));
  }
  g = base; g.K = W; g.N = W; g.A = ys + (size_t)(nb - 1) * PW;
  g.B = wb(i_encs); g.bias = bias(i_encs); g.out = t;
  CHECK(launch_gemm(g, false, false, stream));
  g = base; g.K = W; g.N = W; g.A = t; g.B = wb(i_encv); g.rowvec = vcontrib;
  g.relu = 1; g.out = yv; g.out_inj = xt; g.inj = tproj; g.inj_ld = nt * W;
  CHECK(launch_gemm(g, false, false, stream));
  for (int j = 0; j < nt; ++j) {
    g = base; g.K = W; g.N = W; g.A = xt + (size_t)j * PW; g.B = wb(i_tex + j);
    g.bias = bias(i_tex + j); g.relu = 1; g.out = yts + (size_t)j * PW;
    if (j + 1 < nt) {
      g.out_inj = xt + (size_t)(j + 1) * PW;
      g.inj = tproj + (size_t)(j + 1) * W; g.inj_ld = nt * W;
    }
    CHECK(launch_gemm(g, false, false, stream));
  }
  g = base; g.K = W; g.N = W / 2; g.A = yts + (size_t)(nt - 1) * PW;
  g.B = wb(i_rgbh); g.bias = bias(i_rgbh); g.relu = 1; g.out = r;
  CHECK(launch_gemm(g, false, false, stream));

  // ---- heads, composite, loss, composite backward
  HeadArgs h = {};
  h.R = R; h.S = S; h.W = W; h.t = t; h.r = r; h.z = z; h.gt8 = gt8;
  h.cmask = cmask; h.cdelta = cdelta;
  h.w_sig = wf(i_sig); h.b_sig = bias(i_sig); h.w_rgb = wb(i_rgbo);
  h.b_rgb = bias(i_rgbo); h.two_scale = two_scale; h.white_bg = white_bg;
  h.se8 = se8; h.rgb8 = rgb8; h.dsig = dsig; h.g_r = g_r;
  h.weights = weights;
  if (gplanes) {
    h.gsig = static_cast<const float*>(gplanes[0]);
    h.gr = static_cast<const float*>(gplanes[1]);
    h.gg = static_cast<const float*>(gplanes[2]);
    h.gb = static_cast<const float*>(gplanes[3]);
    // No composite here: the input chain adds its xyz term to zeros.
    if (input_grads)
      CHECK((int)cudaMemsetAsync(d_z, 0, sizeof(float) * P, stream));
  } else if (input_grads) {
    h.dz = d_z;
  }
  if (weight_grads) h.part = head_part;
  head_kernel<<<R, HEAD_THREADS, 0, stream>>>(h);
  CHECK((int)cudaGetLastError());

  // ---- the sigma and rgb_out gradients: the head's per-ray partials
  // summed over the rays in two fixed-order stages.
  if (weight_grads) {
    const int HP = head_part_cols(W), Wh = W / 2;
    const int rpg = (R + COLSUM_GROUPS - 1) / COLSUM_GROUPS;
    const int groups = (R + rpg - 1) / rpg;
    CHECK(launch_colsum(head_part, HP, R, HP, rpg, head_tmp, stream));
    CHECK(launch_colsum(head_tmp, HP, groups, W, groups, dw(i_sig), stream));
    CHECK(launch_colsum(head_tmp + W, HP, groups, Wh * 8, groups, dw(i_rgbo),
                        stream));
    CHECK(launch_colsum(head_tmp + W + Wh * 8, HP, groups, 8, groups,
                        db(i_rgbo), stream));
    CHECK(launch_colsum(head_tmp + W + Wh * 8 + 8, HP, groups, 1, groups,
                        db(i_sig), stream));
  }

  // ---- dx chain; in weight-gradient mode each layer's dW GEMM runs as
  // soon as its output cotangent (the bf16 ``cur``) exists.
  const int Pi = (int)P;
  bf16* cur = gA;
  bf16* nxt = gB;
  if (weight_grads)
    CHECK(launch_dw(yts + (size_t)(nt - 1) * PW, g_r, Pi, W, W / 2, dw_part,
                    dw(i_rgbh), db(i_rgbh), stream));
  g = base; g.K = W / 2; g.N = W; g.A = g_r; g.B = wb(i_rgbh);
  g.mask = yts + (size_t)(nt - 1) * PW; g.out = cur;
  CHECK(launch_gemm(g, false, true, stream));
  for (int j = nt - 1; j >= 0; --j) {
    if (weight_grads)
      CHECK(launch_dw(xt + (size_t)j * PW, cur, Pi, W, W, dw_part,
                      dw(i_tex + j), db(i_tex + j), stream));
    g = base; g.K = W; g.N = W; g.A = cur; g.B = wb(i_tex + j);
    g.rs_pre = rs_t + (size_t)j * W; g.rs_pre_ld = nt * W;
    g.mask = j > 0 ? yts + (size_t)(j - 1) * PW : yv;
    if (j == 0) { g.rs_post = rs_v; g.rs_post_ld = W; }
    g.out = nxt;
    CHECK(launch_gemm(g, false, true, stream));
    bf16* tmp = cur; cur = nxt; nxt = tmp;
  }
  if (weight_grads)
    CHECK(launch_dw(t, cur, Pi, W, W, dw_part, dw(i_encv), db(i_encv),
                    stream));
  g = base; g.K = W; g.N = W; g.A = cur; g.B = wb(i_encv);
  g.dsig = dsig; g.wsig = wf(i_sig); g.out = nxt;
  CHECK(launch_gemm(g, false, true, stream));
  { bf16* tmp = cur; cur = nxt; nxt = tmp; }
  if (weight_grads)
    CHECK(launch_dw(ys + (size_t)(nb - 1) * PW, cur, Pi, W, W, dw_part,
                    dw(i_encs), db(i_encs), stream));
  g = base; g.K = W; g.N = W; g.A = cur; g.B = wb(i_encs);
  g.mask = ys + (size_t)(nb - 1) * PW; g.out = nxt;
  CHECK(launch_gemm(g, false, true, stream));
  { bf16* tmp = cur; cur = nxt; nxt = tmp; }
  for (int j = nb - 1; j >= 0; --j) {
    if (weight_grads)
      CHECK(launch_dw(xs + (size_t)j * PW, cur, Pi, W, W, dw_part,
                      dw(1 + j), db(1 + j), stream));
    g = base; g.K = W; g.N = W; g.A = cur; g.B = wb(1 + j);
    g.rs_pre = rs_s + (size_t)j * W; g.rs_pre_ld = nb * W;
    if (j > 0) {
      g.mask = ys + (size_t)(j - 1) * PW; g.out = nxt;
    } else if (weight_grads || input_grads) {
      g.mask = y0; g.out = nxt;       // enc_xyz's output cotangent
    }
    CHECK(launch_gemm(g, false, true, stream));
    bf16* tmp = cur; cur = nxt; nxt = tmp;
  }
  if (weight_grads)
    CHECK(launch_dw(pe, cur, Pi, 64, W, dw_part, dw(0), db(0), stream));
  if (input_grads) {
    const size_t smem = input_smem_bytes(W);
    CHECK((int)cudaFuncSetAttribute(
        input_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem));
    const InputArgs ia = {S, W, n_freq, cur, wb(0), ro8, vd8, z, d_z, d_ro8,
                          d_vd8};
    input_chain_kernel<<<R, INPUT_THREADS, smem, stream>>>(ia);
    CHECK((int)cudaGetLastError());
  }

  CHECK(launch_convert(rs_s, d_sproj, (size_t)R * nb * W, stream));
  CHECK(launch_convert(rs_t, d_tproj, (size_t)R * nt * W, stream));
  CHECK(launch_convert(rs_v, d_vcontrib, (size_t)R * W, stream));
  return 0;
}

namespace {

// Sigma head of the sigma-only forward: one warp per point, each lane 8
// contiguous lanes of t per 256, softplus(sum_k bf16 t_k * w_sig[k] +
// b_sig) in f32.
__global__ void sigma_head_kernel(const bf16* t, const float* w_sig,
                                  const float* b_sig, float* sigma, size_t P,
                                  int W) {
  const int lane = threadIdx.x & 31;
  const size_t warps = (size_t)gridDim.x * (blockDim.x / 32);
  for (size_t p = blockIdx.x * (size_t)(blockDim.x / 32) + threadIdx.x / 32;
       p < P; p += warps) {
    float a = 0.f;
    for (int k0 = 8 * lane; k0 < W; k0 += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(t + p * W + k0);
      const __nv_bfloat162* t2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a += __low2float(t2[i]) * w_sig[k0 + 2 * i];
        a += __high2float(t2[i]) * w_sig[k0 + 2 * i + 1];
      }
    }
    a = warp_sum(a);
    if (lane == 0) {
      const float x = a + b_sig[0];
      sigma[p] = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
    }
  }
}

// Rgb head of the four-plane forward: one warp per point, the raw
// rgb_out channels 0..2 of the bf16 rgb_hidden row (W/2 lanes; bf16
// weights, f32 sums) plus their biases, into three (R, S) planes.
__global__ void rgb_head_kernel(const bf16* r, const bf16* w_rgb,
                                const float* b_rgb, float* c0, float* c1,
                                float* c2, size_t P, int Wh) {
  const int lane = threadIdx.x & 31;
  const size_t warps = (size_t)gridDim.x * (blockDim.x / 32);
  for (size_t p = blockIdx.x * (size_t)(blockDim.x / 32) + threadIdx.x / 32;
       p < P; p += warps) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int k = lane; k < Wh; k += 32) {
      const float rv = bf(r[p * Wh + k]);
      a0 += rv * bf(w_rgb[k * 8 + 0]);
      a1 += rv * bf(w_rgb[k * 8 + 1]);
      a2 += rv * bf(w_rgb[k * 8 + 2]);
    }
    a0 = warp_sum(a0); a1 = warp_sum(a1); a2 = warp_sum(a2);
    if (lane == 0) {
      c0[p] = a0 + b_rgb[0];
      c1[p] = a1 + b_rgb[1];
      c2[p] = a2 + b_rgb[2];
    }
  }
}

unsigned point_blocks(size_t P) {   // 8 warps a block, one point a warp
  const size_t blocks = (P + 7) / 8;
  return (unsigned)(blocks < 8192 ? blocks : 8192);
}

// The forward through enc_shape between the ping-pong (P, W) bf16 buffers
// ``buf``: the enc_xyz GEMM with the PE built in its A-tile loads, each
// shape block's injecting epilogue, enc_shape without activation; the
// GEMMs and epilogues of fused_step's forward, so t is the same bits.
// ``*cur`` receives the index of the buffer that holds t.
int shape_trunk(const float* ro8, const float* vd8, const float* z,
                const bf16* sproj, const void* const* wts, bf16* buf[2],
                int R, int S, int W, int nb, int n_freq, int* cur,
                cudaStream_t stream) {
  auto wb = [&](int i) { return static_cast<const bf16*>(wts[2 * i]); };
  auto bias = [&](int i) { return static_cast<const float*>(wts[2 * i + 1]); };
  GemmArgs base = {};
  base.M = R * S;
  base.S = S;
  GemmArgs g = base;
  g.K = 64; g.N = W; g.ro8 = ro8; g.vd8 = vd8; g.z = z; g.n_freq = n_freq;
  g.B = wb(0); g.bias = bias(0); g.relu = 1;
  g.out_inj = buf[0]; g.inj = sproj; g.inj_ld = nb * W;
  CHECK(launch_gemm(g, true, false, stream));
  int c = 0;
  for (int j = 0; j < nb; ++j) {
    g = base; g.K = W; g.N = W; g.A = buf[c]; g.B = wb(1 + j);
    g.bias = bias(1 + j); g.relu = 1;
    if (j + 1 < nb) {
      g.out_inj = buf[1 - c];
      g.inj = sproj + (size_t)(j + 1) * W; g.inj_ld = nb * W;
    } else {
      g.out = buf[1 - c];
    }
    CHECK(launch_gemm(g, false, false, stream));
    c = 1 - c;
  }
  g = base; g.K = W; g.N = W; g.A = buf[c]; g.B = wb(nb + 1);
  g.bias = bias(nb + 1); g.out = buf[1 - c];
  CHECK(launch_gemm(g, false, false, stream));
  *cur = 1 - c;
  return 0;
}

// The standalone composite and its backward, one warp (block) per ray.
struct CompositeArgs {
  int S, white_bg;
  const float* sig;        // (R, S) densities (softplus applied)
  const float* c0;         // (R, S) raw rgb planes
  const float* c1;
  const float* c2;
  const float* z;          // (R, S)
  const float* g8;         // (R, 8) cotangent, or null: the forward
  float* out8;             // forward: (R, 8) [r g b depth acc 0 0 0]
  float* gsig;             // backward: (R, S) cotangents of the planes
  float* gc0;
  float* gc1;
  float* gc2;
  float* dz;
};

__global__ void __launch_bounds__(32) composite_kernel(CompositeArgs a) {
  __shared__ float s_sig[MAX_S];
  __shared__ float s_c[3][MAX_S];
  __shared__ float s_gc[3][MAX_S];
  __shared__ float s_gs[MAX_S];
  __shared__ float s_dd[MAX_S];
  __shared__ float s_w[MAX_S];
  const int ray = blockIdx.x, lane = threadIdx.x, S = a.S;
  const size_t p0 = (size_t)ray * S;
  for (int s = lane; s < S; s += 32) {
    s_sig[s] = a.sig[p0 + s];
    s_c[0][s] = a.c0[p0 + s];
    s_c[1][s] = a.c1[p0 + s];
    s_c[2][s] = a.c2[p0 + s];
  }
  __syncwarp();
  HeadArgs h = {};
  h.S = S; h.z = a.z; h.white_bg = a.white_bg;
  const bool bwd = a.g8 != nullptr;
  const CompositeOut o = composite_pass(
      h, ray, lane, s_sig, s_c, s_gc, s_gs, nullptr, nullptr, false,
      bwd ? s_w : nullptr, bwd ? s_dd : nullptr, true,
      bwd ? a.g8 + (size_t)ray * 8 : nullptr, bwd);
  if (!bwd) {
    if (lane < 8) {
      const float v[8] = {o.rgb[0], o.rgb[1], o.rgb[2], o.dep, o.acc,
                          0.f, 0.f, 0.f};
      a.out8[(size_t)ray * 8 + lane] = v[lane];
    }
    return;
  }
  __syncwarp();
  const float gd = a.g8[(size_t)ray * 8 + 3];
  for (int s = lane; s < S; s += 32) {
    a.gsig[p0 + s] = s_gs[s];
    a.gc0[p0 + s] = s_gc[0][s];
    a.gc1[p0 + s] = s_gc[1][s];
    a.gc2[p0 + s] = s_gc[2][s];
    a.dz[p0 + s] = gd * s_w[s] + (s > 0 ? s_dd[s - 1] : 0.f) - s_dd[s];
  }
}

}  // namespace

// Sigma-only forward on R rays x S samples: replaces
// codenerf_tpu/ops/fused_mlp.py::_kernel(sigma_only=True), the coarse pass
// of hierarchical sampling, whose compositing weights need sigma alone.
// The shape trunk (shape_trunk) between two ping-pong (P, W) bf16 buffers
// in ``ws`` (2 * R * S * W elements: nothing is kept for a backward), then
// sigma_head_kernel writes ``sigma`` (R, S) f32. ``wts`` as for
// fused_step; only the enc_xyz, shape, enc_shape and sigma entries are
// read. Bound by operations: 2 * W * (64 + W * (nb + 1)) FLOP per point.
extern "C" int sigma_step(const float* ro8, const float* vd8, const float* z,
                          const bf16* sproj, const void* const* wts, bf16* ws,
                          float* sigma, int R, int S, int W, int nb,
                          int n_freq, cudaStream_t stream) {
  if (W % 256 != 0 || 3 + 6 * n_freq > 64 || nb < 1)
    return (int)cudaErrorInvalidValue;
  const size_t P = (size_t)R * S;
  bf16* buf[2] = {ws, ws + P * W};
  int cur = 0;
  CHECK(shape_trunk(ro8, vd8, z, sproj, wts, buf, R, S, W, nb, n_freq, &cur,
                    stream));
  sigma_head_kernel<<<point_blocks(P), 256, 0, stream>>>(
      buf[cur], static_cast<const float*>(wts[2 * (nb + 2)]),
      static_cast<const float*>(wts[2 * (nb + 2) + 1]), sigma, P, W);
  return (int)cudaGetLastError();
}

// Four-plane forward on R rays x S samples: replaces
// codenerf_tpu/ops/fused_mlp.py::_kernel (sigma_only=False), the forward
// of the plane op. sigma_step's trunk and sigma head (so the sigma plane
// is sigma_step's, bit for bit), then the enc_viewdir GEMM (its epilogue
// adds the per-ray vcontrib, applies the ReLU and writes texture block
// 0's injected input), the texture blocks and rgb_hidden on the same
// ping-pong buffers (``ws``: 2 * R * S * W bf16), and rgb_head_kernel
// writes the raw r, g, b planes. Outputs (R, S) f32. Bound by operations:
// 2 * W * (64 + W * (nb + nt + 2) + W / 2) FLOP per point.
extern "C" int planes_step(const float* ro8, const float* vd8, const float* z,
                           const bf16* sproj, const bf16* tproj,
                           const bf16* vcontrib, const void* const* wts,
                           bf16* ws, float* sigma, float* c0, float* c1,
                           float* c2, int R, int S, int W, int nb, int nt,
                           int n_freq, cudaStream_t stream) {
  if (W % 256 != 0 || 3 + 6 * n_freq > 64 || nb < 1 || nt < 1)
    return (int)cudaErrorInvalidValue;
  auto wb = [&](int i) { return static_cast<const bf16*>(wts[2 * i]); };
  auto bias = [&](int i) { return static_cast<const float*>(wts[2 * i + 1]); };
  const int i_sig = nb + 2, i_encv = nb + 3, i_tex = nb + 4;
  const int i_rgbh = nb + nt + 4, i_rgbo = nb + nt + 5;
  const size_t P = (size_t)R * S;
  bf16* buf[2] = {ws, ws + P * W};
  int cur = 0;
  CHECK(shape_trunk(ro8, vd8, z, sproj, wts, buf, R, S, W, nb, n_freq, &cur,
                    stream));
  sigma_head_kernel<<<point_blocks(P), 256, 0, stream>>>(
      buf[cur], static_cast<const float*>(wts[2 * i_sig]), bias(i_sig),
      sigma, P, W);
  CHECK((int)cudaGetLastError());
  GemmArgs base = {};
  base.M = (int)P;
  base.S = S;
  GemmArgs g = base;
  g.K = W; g.N = W; g.A = buf[cur]; g.B = wb(i_encv); g.rowvec = vcontrib;
  g.relu = 1; g.out_inj = buf[1 - cur]; g.inj = tproj; g.inj_ld = nt * W;
  CHECK(launch_gemm(g, false, false, stream));
  cur = 1 - cur;
  for (int j = 0; j < nt; ++j) {
    g = base; g.K = W; g.N = W; g.A = buf[cur]; g.B = wb(i_tex + j);
    g.bias = bias(i_tex + j); g.relu = 1;
    if (j + 1 < nt) {
      g.out_inj = buf[1 - cur];
      g.inj = tproj + (size_t)(j + 1) * W; g.inj_ld = nt * W;
    } else {
      g.out = buf[1 - cur];
    }
    CHECK(launch_gemm(g, false, false, stream));
    cur = 1 - cur;
  }
  g = base; g.K = W; g.N = W / 2; g.A = buf[cur]; g.B = wb(i_rgbh);
  g.bias = bias(i_rgbh); g.relu = 1; g.out = buf[1 - cur];
  CHECK(launch_gemm(g, false, false, stream));
  cur = 1 - cur;
  rgb_head_kernel<<<point_blocks(P), 256, 0, stream>>>(
      buf[cur], wb(i_rgbo), bias(i_rgbo), c0, c1, c2, P, W / 2);
  return (int)cudaGetLastError();
}

// Standalone composite on R rays x S samples: replaces
// codenerf_tpu/ops/pallas_composite.py::_fwd_kernel (launched by _call).
// Five (R, S) f32 planes in (densities, raw r, g, b, depths), ``out8``
// (R, 8) f32 [r g b depth acc 0 0 0] out; white or black background. One
// warp per ray runs composite_pass's scan. Bound by bytes: 5 * R * S * 4
// in, R * 32 out.
extern "C" int composite_fwd(const float* sig, const float* c0,
                             const float* c1, const float* c2,
                             const float* z, float* out8, int R, int S,
                             int white_bg, cudaStream_t stream) {
  if (S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  CompositeArgs a = {};
  a.S = S; a.white_bg = white_bg; a.sig = sig; a.c0 = c0; a.c1 = c1;
  a.c2 = c2; a.z = z; a.out8 = out8;
  composite_kernel<<<R, 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Its backward (pallas_composite.py::_bwd_kernel): recompute the forward,
// then the five plane cotangents for the per-ray cotangent ``g8`` (R, 8),
// depth and acc lanes included: gsig, the rgb cotangents w_s * g_k, and
// dz_s = gd * w_s + ddelta_{s-1} - ddelta_s. Bound by bytes: 5 * R * S * 4
// + R * 32 in, 5 * R * S * 4 out.
extern "C" int composite_bwd(const float* sig, const float* c0,
                             const float* c1, const float* c2,
                             const float* z, const float* g8, float* gsig,
                             float* gc0, float* gc1, float* gc2, float* dz,
                             int R, int S, int white_bg,
                             cudaStream_t stream) {
  if (S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  CompositeArgs a = {};
  a.S = S; a.white_bg = white_bg; a.sig = sig; a.c0 = c0; a.c1 = c1;
  a.c2 = c2; a.z = z; a.g8 = g8; a.gsig = gsig; a.gc0 = gc0; a.gc1 = gc1;
  a.gc2 = gc2; a.dz = dz;
  composite_kernel<<<R, 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
