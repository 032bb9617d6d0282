// Single-pass CodeNeRF loss kernel for Hopper (sm_90a), in its modes, and
// the forwards of the hierarchical coarse pass (sigma_step) and of the
// plane op (planes_step), at the end of this file.
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
// adding its loss's cotangents before the one backward chain. The
// input_grads flag (the pose modes, and with weight gradients the pair no
// path calls) also returns the exact ray and depth cotangents d_ro8,
// d_vd8, d_z; want_weights the compositing weights.
//
// Design. The TPU kernel keeps all weights and every activation of a
// 16-ray tile (~6 MB) in VMEM for the whole grid. An H100 block has 227 KB
// of shared memory and blocks run in no order, so the trunk runs as two
// chained wgmma kernels that keep a 128-point tile's activations on chip
// across layers and stream the weights from L2, and the rest as kernels on
// one stream:
//   (i)   pack_kernel: every trunk weight once per call into the operand
//         layout of wgmma (K-major, 128-byte swizzled, in 64-wide K slices;
//         ops/fused_train.py::wgmma_pack is its plain version): W^T for the
//         forward, W for the dx chain.
//   (ii)  trunk_fwd_kernel: one persistent block per SM walks 128-point
//         tiles. Four consumer warpgroups each own a (64-point row half,
//         128-column half) of every layer's output; a producer warp streams
//         the weight slices (32 KB) into a 4-stage ring with cp.async.bulk
//         and mbarriers. The block builds the PE of its points into shared
//         memory, then runs the layers on the resident (64, 256) bf16 tile
//         of each row half: wgmma m64n128k16 (n64 for rgb_hidden) from
//         shared memory into f32 registers, and an epilogue in registers
//         (bias, per-ray vector, ReLU, bf16 y into the tile, the ReLU mask
//         as bits) and then 16 bytes a thread (the stores, the latent
//         injection as a bf16 add) that leaves the next layer's input in
//         place. Device memory sees only what later kernels read: ReLU-mask bit
//         planes (32 B a point) for the dx chain, t and r for the heads,
//         and in weight-gradient mode each dW GEMM's bf16 input (the PE,
//         the injected inputs, the last shape and texture blocks' outputs).
//   (iii) head_kernel: one block per ray. Sigma head (dot with the w_sig
//         row, softplus), rgb_out head, composite with a warp scan over the
//         samples, MSE, composite backward; emits dsig = g_sigma *
//         sigmoid(sig_pre) and the rgb_hidden cotangent (masked, bf16).
//   (iv)  trunk_dx_kernel: the dx chain gh @ W^T from the rgb_hidden
//         cotangent down to enc_xyz's output in one launch, with the same
//         tiles, warpgroups, ring and wgmma shapes. The epilogue
//         adds the sigma term dsig * w_sig, masks with the prefetched bits,
//         rounds gh to bf16 in place, and reduces the per-ray row sums in
//         registers (a shuffle ladder over the warp's 16 rows) into one f32
//         atomic per (ray, column) and warp; f32_to_bf16 then writes the
//         three cotangent outputs. In weight-gradient mode it also stores
//         every gh plane, 16 bytes a thread.
// Weight-gradient mode adds:
//   (v)   dw_kernel: dW = X^T @ GH per layer after the dx chain, a GEMM
//         whose reduction axis is the points (WMMA tiles, cp.async). The
//         points are split over blockIdx.z; each block reduces its slice
//         into an f32 register tile and writes it to a partial buffer, and
//         column sums of the GH tiles it loads give the bias partials.
//         colsum_kernel then adds the partials in a fixed order, so dW and
//         db are the same bits on every run (no atomics);
//   (vi)  head_kernel's phase 4: per ray, sum_s t*dsig (sigma dW),
//         sum_s dsig, sum_s r*gh8 and sum_s gh8 (rgb_out dW, db) into a
//         (R, HEAD_PART) buffer, then colsum_kernel in two fixed-order
//         stages.
// The input gradients add:
//   (vii) head_kernel writes the composite's z cotangent; the forward keeps
//         y0 and the dx chain runs on through enc_xyz's ReLU mask to gh0;
//   (viii) input_chain_kernel: per point d_pe = gh0 . W_enc^T (CUDA-core
//         f32 dots against W_enc^T in shared memory, 2 * 64 * W FLOP, ~2%
//         of the call), the PE Jacobian, d_z += d_xyz . vd; per ray
//         d_ro8, d_vd8 in a fixed order.
// What bounds the trunk: at W=256 a layer is 131,072 FLOP per point
// against 512 B per stored bf16 plane, so the chain is bound by operations
// once activations stay on chip; the weights (0.9 MB) come from L2 once per
// tile and layer. On the card the epilogues, not the products, take most
// of each layer (PERF.md).
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

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// dw_kernel: 128 x 128 WMMA tiles of 8 warps, a 3-stage cp.async pipeline.
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
constexpr int GEMM_THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int LDA_T = BM + 8;      // A stage held (BK, BM), k-major
constexpr int LDB_ROW = BN + 8;
constexpr int A_STAGE = BK * LDA_T;                     // bf16 elements
constexpr int B_STAGE = BK * LDB_ROW;
constexpr size_t GEMM_SMEM = sizeof(bf16) * STAGES * (A_STAGE + B_STAGE);
constexpr int HEAD_THREADS = 128;
constexpr int MAX_PER_LANE = 8;    // samples per lane in the head scan
constexpr int MAX_S = 32 * MAX_PER_LANE;
constexpr unsigned FULL = 0xffffffffu;
// dW GEMM blocks per launch: 2 blocks of GEMM_THREADS on each of the
// H100's 132 SMs. A constant, so the split of the points (and with it the
// order of the sums) does not depend on the card.
constexpr int DW_BLOCKS = 264;
constexpr int COLSUM_GROUPS = 64;  // first-stage row groups of a column sum

// The trunk kernels.
constexpr int TW = 256;            // the trunk width they take
constexpr int TM = 128;            // points per tile: 2 row halves x 64
// Four consumer warpgroups, one per (64-point row half, 128-column half)
// of the tile's outputs, and a producer warpgroup. Of the block's 640 x 96
// registers the producer gives back all but 24 per thread and the
// consumers take 112.
constexpr int CONSUMERS = 4;
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
constexpr int TRUNK_THREADS = 128 * (CONSUMERS + 1);
constexpr int RING = 4;            // weight slices in flight
constexpr int SLICE_BYTES = TW * 64 * 2;    // one 64-deep K slice of B
constexpr int ACT_BYTES = 64 * TW * 2;      // a row half's (64, 256) tile
constexpr int BLOCK_BYTES = 64 * 128;       // its 64 columns of one K slice
constexpr int MAX_LAYERS = 16;
constexpr size_t DX_SMEM = 1024 + 2 * ACT_BYTES + RING * SLICE_BYTES
                           + 2 * RING * sizeof(uint64_t);
constexpr size_t FWD_SMEM = DX_SMEM + MAX_LAYERS * TW * sizeof(float)
                            + TM * sizeof(int);

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

// ---------------------------------------------------------------- Hopper
// primitives: shared-memory addresses, mbarriers, bulk copies, wgmma.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

// Wait until the barrier's phase of parity ``parity`` has completed. A
// wait of more than ~2^34 cycles (seconds) traps: a pipeline fault then
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// ``bytes`` contiguous bytes from device memory into shared memory; the
// barrier's transaction count takes their arrival.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 256 threads of the two warpgroups that share row half ``rh``
// (named barrier rh + 1).
__device__ __forceinline__ void pair_sync(int rh) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(rh + 1) : "memory");
}

// Keeps the compiler from moving accumulator accesses across wgmma.
__device__ __forceinline__ void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of a K-major, 128-byte-swizzled operand at ``p``
// (1024-byte aligned): rows of 64 bf16 (128 B), 8-row atoms 1024 B apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of element (row, col) of a (64, 256) tile in that layout:
// four 64-column blocks of 8 KB; 16-byte chunk c of row r at c ^ (r % 8).
__device__ __forceinline__ int act_off(int row, int col) {
  return (col >> 6) * BLOCK_BYTES + row * 128
         + ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// D (64 x 128, f32 registers) += A (64 x 16) * B (16 x 128), both bf16
// K-major in shared memory (descriptors); scale_d = 0 overwrites D.
// Element i of d is row 16 * warp + lane / 4 + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (lane % 4) + i % 2 of D.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with B (16 x 64): d[0..31] only.
__device__ __forceinline__ void wgmma_n64(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------- packing

// B (N x K) = transpose ? w^T : w, for w (rows, cols) row-major bf16,
// written to dst in 64-deep K slices of N rows x 128 B, 16-byte chunk c of
// row n at c ^ (n % 8): the byte image each weight slice has in the ring.
struct PackJob {
  const bf16* w;
  bf16* dst;
  int rows, cols, transpose;
};

struct PackArgs {
  int n;
  PackJob j[2 * MAX_LAYERS];
};

__global__ void pack_kernel(const __grid_constant__ PackArgs a) {
  const PackJob& J = a.j[blockIdx.y];
  const int N = J.transpose ? J.cols : J.rows;
  const int K = J.transpose ? J.rows : J.cols;
  const int chunks = N * K / 8;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < chunks;
       q += gridDim.x * blockDim.x) {
    const int s = q / (N * 8), n = (q / 8) % N, p = q % 8;
    const int k0 = s * 64 + ((p ^ (n & 7)) * 8);
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = J.transpose ? J.w[(size_t)(k0 + e) * J.cols + n]
                         : J.w[(size_t)n * J.cols + k0 + e];
    *reinterpret_cast<uint4*>(J.dst + (size_t)q * 8) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// ---------------------------------------------------------------- trunk

// One forward layer: y = act(x @ W + bias + rowvec[ray]); the next layer's
// input is bf16(bf16(y) + inj[ray]) with a latent, else bf16(y).
struct FwdLayer {
  const bf16* w;          // packed W^T (N rows, K deep)
  const float* bias;      // (N,) or null
  const bf16* rowvec;     // per ray [R][rowvec_ld], or null
  const bf16* inj;        // the next layer's latent, per ray [R][inj_ld]
  bf16* out;              // (P, N) bf16(y), or null
  bf16* out_in;           // (P, N) the next layer's input, or null
  uint32_t* mask_out;     // (P, 8) ReLU-mask bits of y, or null
  int K, N, relu, rowvec_ld, inj_ld;
};

struct FwdArgs {
  int P, S, n_freq, n_layers;
  const float* ro8;       // (R, 8)
  const float* vd8;       // (R, 8)
  const float* z;         // (R, S)
  bf16* pe_out;           // (P, 64): the PE, or null
  FwdLayer L[MAX_LAYERS];
};

// A ReLU mask as bits: word w of a point's 8 holds columns 32 w .. 32 w + 31
// (bit b: column 32 w + b set where the stored bf16 activation is > 0),
// 32 B per point in place of a 512 B bf16 plane.
constexpr int MASK_WORDS = TW / 32;

// One dx layer: v = gh @ W^T (+ dsig[m] * wsig[n]), then * mask; rs_pre
// sums the raw products per ray, rs_post the masked values.
struct DxLayer {
  const bf16* w;          // packed W (N = the layer's inputs, K outputs)
  const uint32_t* mask;   // (P, 8) ReLU-mask bits, or null
  float* rs_pre;          // per ray [R][rs_pre_ld], or null
  float* rs_post;
  bf16* out;              // (P, N) bf16 gh, or null
  int K, N, dsig_term, rs_pre_ld, rs_post_ld;
};

struct DxArgs {
  int P, S, n_layers;
  const bf16* g_in;       // (P, L[0].K): the first layer's gh
  const float* dsig;      // (P,)
  const float* wsig;      // (N,)
  DxLayer L[MAX_LAYERS];
};

// The first 1024-byte aligned address of the dynamic shared memory, as an
// offset into it, so that the compiler keeps its address space (shared
// loads and stores rather than generic ones).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The producer warp's lane 0: every K slice of every layer, tile after
// tile, into the ring, each stage reused once the 16 consumer warps freed
// it.
template <class Layer>
__device__ void produce(const Layer* L, int n_layers, int ntiles,
                        unsigned char* ring, uint64_t* full,
                        uint64_t* empty) {
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
    for (int l = 0; l < n_layers; ++l) {
      const uint32_t bytes = (uint32_t)L[l].N * 128;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          L[l].w);
      for (int ks = 0; ks < L[l].K / 64; ++ks) {
        mbar_wait(empty + stage, phase ^ 1);
        mbar_expect_tx(full + stage, bytes);
        bulk_load(ring + stage * SLICE_BYTES, src + (size_t)ks * bytes,
                  bytes, full + stage);
        if (++stage == RING) { stage = 0; phase ^= 1; }
      }
    }
}

// One layer's products for a warpgroup: its row half's resident (64, K)
// tile times column half ``nh`` of each ring slice (N rows in all, N / 2
// here): K/64 slices, four k16 steps each, one commit group per slice; a
// slice is released as soon as the group after it is issued and it has
// completed.
__device__ __forceinline__ void mma_layer(float (&acc)[64], int N, int nks,
                                          int nh, uint64_t da, uint64_t dr,
                                          uint64_t* full, uint64_t* empty,
                                          int& stage, uint32_t& phase,
                                          int lane) {
  int prev = -1;
  const uint64_t half = (uint64_t)((nh * (N / 2) * 128) >> 4);
  for (int ks = 0; ks < nks; ++ks) {
    mbar_wait(full + stage, phase);
    __syncwarp();     // wgmma.*.aligned wants the warp converged
    reg_fence(acc);
    wgmma_fence();
    const uint64_t a = da + (uint64_t)((ks * BLOCK_BYTES) >> 4);
    const uint64_t b = dr + (uint64_t)((stage * SLICE_BYTES) >> 4) + half;
#pragma unroll
    for (int k = 0; k < 4; ++k) {   // +32 B along K per k16 step
      if (N == 256) wgmma_n128(acc, a + 2 * k, b + 2 * k, ks | k);
      else wgmma_n64(acc, a + 2 * k, b + 2 * k, ks | k);
    }
    wgmma_commit();
    reg_fence(acc);
    if (prev >= 0) {
      wgmma_wait<1>();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(empty + prev);
    }
    prev = stage;
    if (++stage == RING) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  reg_fence(acc);
  if (lane == 0) mbar_arrive(empty + prev);
}

// The bf16 PE of a row half's 64 points into lanes 0..63 of its tile: the
// 4 threads of a point (t2 = 0..255 over the pair of warpgroups) split its
// 3F (coordinate, frequency) pairs, one sincosf each for the pair's sin and
// cos lanes; it also records each row's ray in ``rays``.
__device__ __forceinline__ void build_pe(const FwdArgs& a, unsigned char* A,
                                         int* rays, int m0, int t2) {
  const int row = t2 >> 2, part = t2 & 3, m = m0 + row, F = a.n_freq;
  const bool ok = m < a.P;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  if (part == 0) rays[row] = ok ? m / a.S : 0;
  if (ok) {
    const int ray = m / a.S;
    const float zz = a.z[m];
    const float* ro = a.ro8 + (size_t)ray * 8;
    const float* vd = a.vd8 + (size_t)ray * 8;
    x0 = __fadd_rn(ro[0], __fmul_rn(vd[0], zz));
    x1 = __fadd_rn(ro[1], __fmul_rn(vd[1], zz));
    x2 = __fadd_rn(ro[2], __fmul_rn(vd[2], zz));
  }
  auto put = [&](int lane, float v) {
    *reinterpret_cast<bf16*>(A + act_off(row, lane)) = __float2bfloat16_rn(v);
  };
  if (part == 0) {
    put(0, x0); put(1, x1); put(2, x2);
  } else if (part == 3) {
    for (int k = 3 + 6 * F; k < 64; ++k) put(k, 0.f);
  }
  const int per = (3 * F + 3) / 4, end = min(3 * F, (part + 1) * per);
#pragma unroll 1
  for (int k = part * per; k < end; ++k) {
    const int d = k % 3;
    const float s = (d == 0 ? x0 : (d == 1 ? x1 : x2)) * (float)(1 << (k / 3));
    float sv, cv;
    sincosf(s, &sv, &cv);
    put(3 + k, ok ? sv : 0.f);
    put(3 + 3 * F + k, ok ? cv : 0.f);
  }
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Epilogue operands (latents, per-ray vectors, dsig) are read-only for
// the kernel: loaded through the non-coherent path, so that the compiler
// may batch them ahead of the epilogue's stores.
__device__ __forceinline__ __nv_bfloat162 ld_bf2(const bf16* p) {
  return as_bf2(__ldg(reinterpret_cast<const unsigned int*>(p)));
}

__device__ __forceinline__ float2 ld_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// A forward layer's epilogue, in registers, on this thread's two rows of
// its warpgroup's column half: bias (from shared memory), per-ray vector,
// ReLU, bf16 y into the tile; with mask_out the ReLU mask as bits (the 4
// lanes of a quad hold the row's 128 columns of the half between them).
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[64],
                                             const FwdLayer& L,
                                             const float* __restrict__ bias,
                                             unsigned char* __restrict__ A,
                                             int nh, int m0, int P, int S,
                                             int wl, int lane) {
  const int q = lane & 3, jn = L.N / 16, c0 = nh * 8 * jn;
  const bool relu = L.relu;
  const bf16* rv[2] = {nullptr, nullptr};
  int rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = wl * 16 + (lane >> 2) + 8 * h;
    const int m = m0 + rows[h];
    if (L.rowvec)
      rv[h] = L.rowvec + (size_t)(m < P ? m / S : 0) * L.rowvec_ld;
  }
  uint32_t bits[2][4] = {};
#pragma unroll
  for (int j = 0; j < TW / 16; ++j) {
    if (j >= jn) break;
    const int col = c0 + 8 * j + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h] + b.x, v1 = acc[4 * j + 2 * h + 1] + b.y;
      if (rv[h]) {
        const __nv_bfloat162 r = ld_bf2(rv[h] + col);
        v0 += __low2float(r); v1 += __high2float(r);
      }
      if (relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
      const uint32_t y = as_u32(__floats2bfloat162_rn(v0, v1));
      *reinterpret_cast<uint32_t*>(A + act_off(rows[h], col)) = y;
      bits[h][j / 4] |= (((y & 0x7fffu) ? 1u : 0u)
                         | ((y & 0x7fff0000u) ? 2u : 0u))
                        << (8 * (j % 4) + 2 * q);
    }
  }
  uint32_t* mask_out = L.mask_out;
  if (!mask_out) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      bits[h][w] |= __shfl_xor_sync(FULL, bits[h][w], 1);
      bits[h][w] |= __shfl_xor_sync(FULL, bits[h][w], 2);
    }
    const int m = m0 + rows[h];
    if (m < P && q == 0)
      *reinterpret_cast<uint4*>(mask_out + (size_t)m * MASK_WORDS + 4 * nh) =
          make_uint4(bits[h][0], bits[h][1], bits[h][2], bits[h][3]);
  }
}

// A row half's (64, N) tile, 16 bytes a thread at a time over the pair of
// warpgroups (t2 = 0..255): the stores of y (out) and, with a latent, the
// injected next input into the tile (and out_in). Rows are consecutive
// points, so a warp stores 512 contiguous bytes; ``rays`` holds each row's
// ray.
__device__ __forceinline__ void fwd_vector_pass(const FwdLayer& L,
                                                unsigned char* A,
                                                const int* rays, bool to_smem,
                                                int m0, int P, int t2) {
  const int per_row = L.N / 8;
  for (int idx = t2; idx < 64 * per_row; idx += 256) {
    const int row = idx / per_row, c = idx % per_row, m = m0 + row;
    const bool ok = m < P;
    uint4* p = reinterpret_cast<uint4*>(A + act_off(row, c * 8));
    const uint4 y = *p;
    if (ok && L.out)
      *reinterpret_cast<uint4*>(L.out + (size_t)m * L.N + c * 8) = y;
    if (!L.inj) continue;
    uint4 pj = make_uint4(0u, 0u, 0u, 0u);
    if (ok)
      pj = __ldg(reinterpret_cast<const uint4*>(
          L.inj + (size_t)rays[row] * L.inj_ld + c * 8));
    uint4 x;
    uint32_t* xs = reinterpret_cast<uint32_t*>(&x);
    const uint32_t* ys = reinterpret_cast<const uint32_t*>(&y);
    const uint32_t* ps = reinterpret_cast<const uint32_t*>(&pj);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 a2 = as_bf2(ys[i]), b2 = as_bf2(ps[i]);
      xs[i] = as_u32(__floats2bfloat162_rn(
          __low2float(a2) + __low2float(b2),
          __high2float(a2) + __high2float(b2)));
    }
    if (to_smem) *p = x;
    if (ok && L.out_in)
      *reinterpret_cast<uint4*>(L.out_in + (size_t)m * L.N + c * 8) = x;
  }
}

// Copies a row half's (64, cols) tile to ``dst`` (P, cols), 16 bytes a
// thread at a time over the pair of warpgroups.
__device__ __forceinline__ void store_tile(bf16* dst, const unsigned char* A,
                                           int cols, int m0, int P, int t2) {
  const int per_row = cols / 8;
  for (int idx = t2; idx < 64 * per_row; idx += 256) {
    const int row = idx / per_row, c = idx % per_row, m = m0 + row;
    if (m < P)
      *reinterpret_cast<uint4*>(dst + (size_t)m * cols + c * 8) =
          *reinterpret_cast<const uint4*>(A + act_off(row, c * 8));
  }
}

// 64 rows of ``src`` (P, K) bf16 from row m0 into a (64, K) tile in the
// swizzled layout by cp.async over the pair of warpgroups; rows past P
// read as zeros.
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src,
                                          int K, int m0, int P, int t2) {
  const int per_row = K / 8;
  for (int q = t2; q < 64 * per_row; q += 256) {
    const int row = q / per_row, c = q % per_row, m = m0 + row;
    const bool ok = m < P;
    cp_async16(dst + act_off(row, c * 8),
               ok ? src + (size_t)m * K + c * 8 : src, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(TRUNK_THREADS, 1) trunk_fwd_kernel(
    const __grid_constant__ FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* act = align1024(smem_raw);
  unsigned char* ring = act + 2 * ACT_BYTES;
  float* biases = reinterpret_cast<float*>(ring + RING * SLICE_BYTES);
  int* row_rays = reinterpret_cast<int*>(biases + MAX_LAYERS * TW);
  uint64_t* full = reinterpret_cast<uint64_t*>(row_rays + TM);
  uint64_t* empty = full + RING;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (a.P + TM - 1) / TM;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < a.n_layers * TW; i += TRUNK_THREADS) {
    const FwdLayer& L = a.L[i / TW];
    biases[i] = (L.bias && i % TW < L.N) ? L.bias[i % TW] : 0.f;
  }
  __syncthreads();
  if (warp >= CONSUMER_WARPS) {      // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == CONSUMER_WARPS && lane == 0)
      produce(a.L, a.n_layers, ntiles, ring, full, empty);
  } else {                           // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n");
    const int wg = warp >> 2, wl = warp & 3, rh = wg >> 1, nh = wg & 1;
    const int t2 = tid & 255;        // thread in the row half's pair
    unsigned char* A = act + rh * ACT_BYTES;
    const uint64_t da = sw128_desc(A), dr = sw128_desc(ring);
    int stage = 0;
    uint32_t phase = 0;
    float acc[64];
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int m0 = tile * TM + rh * 64;
      int* rays = row_rays + rh * 64;
      build_pe(a, A, rays, m0, t2);
      pair_sync(rh);
      if (a.pe_out) store_tile(a.pe_out, A, 64, m0, a.P, t2);
      fence_async_smem();
      pair_sync(rh);
      for (int l = 0; l < a.n_layers; ++l) {
        const FwdLayer& L = a.L[l];
        mma_layer(acc, L.N, L.K / 64, nh, da, dr, full, empty, stage, phase,
                  lane);
        pair_sync(rh);  // both halves' products are done: A may be rewritten
        fwd_epilogue(acc, L, biases + l * TW, A, nh, m0, a.P, a.S, wl, lane);
        pair_sync(rh);
        fwd_vector_pass(L, A, rays, l + 1 < a.n_layers, m0, a.P, t2);
        fence_async_smem();
        pair_sync(rh);
      }
    }
  }
}

// One ladder step of the warp's row reduction: the lanes whose ``mask``
// bit is clear keep x[0, half) and those with it set x[half, 2 half), each
// adding its partner's copy of the half it keeps.
template <int HALF>
__device__ __forceinline__ void reduce_step(float (&x)[16], int mask,
                                            int lane) {
  const bool hi = lane & mask;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = hi ? x[i] : x[i + HALF];
    const float keep = hi ? x[i + HALF] : x[i];
    x[i] = keep + __shfl_xor_sync(FULL, send, mask);
  }
}

// Per-ray sums of this warp's 16 rows and 128 columns (from column c0)
// into rs [ray][ld] (+= by f32 atomics), one atomic per (ray, column): for
// each ray the rows touch and each quarter of the columns, a reduction
// over the 8 lanes that share lane % 4, laddered so that every lane ends
// with 2 of the quarter's columns.
__device__ __forceinline__ void ray_sums(const float (&acc)[64], float* rs,
                                         int ld, int c0, int mw, int P,
                                         int S, int ray0, int ray1,
                                         int lane) {
  if (mw >= P) return;
  const int last = min(mw + 15, P - 1) / S;
  const int jj = 4 * ((lane >> 2) & 1) + 2 * ((lane >> 3) & 1)
                 + ((lane >> 4) & 1);
  for (int ray = mw / S; ray <= last; ++ray) {
    float* dst = rs + (size_t)ray * ld + c0 + 2 * (lane & 3);
#pragma unroll
    for (int qt = 0; qt < 2; ++qt) {
      float x[16];   // x[2 i + e]: column c0 + 8 (8 qt + i) + 2 (lane % 4) + e
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = 8 * qt + i / 2, e = i % 2;
        x[i] = (ray0 == ray ? acc[4 * j + e] : 0.f)
               + (ray1 == ray ? acc[4 * j + 2 + e] : 0.f);
      }
      reduce_step<8>(x, 4, lane);
      reduce_step<4>(x, 8, lane);
      reduce_step<2>(x, 16, lane);
      atomicAdd(dst + 8 * (8 * qt + jj), x[0]);
      atomicAdd(dst + 8 * (8 * qt + jj) + 1, x[1]);
    }
  }
}

// A dx layer's epilogue on this thread's two rows of its warpgroup's
// column half (N = 256), in the order of the TPU kernel: the raw sums, the
// sigma term, the mask (its bits ``mk`` prefetched per row), the masked
// sums; then with ``store`` bf16 gh into the tile.
__device__ __forceinline__ void dx_epilogue(float (&acc)[64],
                                            const DxLayer& L,
                                            const DxArgs& a, unsigned char* A,
                                            const uint4 (&mk)[2], bool store,
                                            int nh, int m0, int wl,
                                            int lane) {
  const int q = lane & 3, c0 = nh * (TW / 2);
  int rows[2], ms[2], rays[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = wl * 16 + (lane >> 2) + 8 * h;
    ms[h] = m0 + rows[h];
    rays[h] = ms[h] < a.P ? ms[h] / a.S : -1;
  }
  const int mw = m0 + wl * 16;
  if (L.rs_pre)
    ray_sums(acc, L.rs_pre, L.rs_pre_ld, c0, mw, a.P, a.S, rays[0], rays[1],
             lane);
  if (L.dsig_term || L.mask) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float ds = (L.dsig_term && rays[h] >= 0) ? __ldg(a.dsig + ms[h])
                                                     : 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (L.dsig_term) {
          const float2 w = ld_f2(a.wsig + c0 + 8 * j + 2 * q);
          v0 = __fadd_rn(v0, __fmul_rn(ds, w.x));
          v1 = __fadd_rn(v1, __fmul_rn(ds, w.y));
        }
        if (L.mask) {
          const uint32_t wd = word_of(mk[h], j / 4) >> (8 * (j % 4) + 2 * q);
          v0 = (wd & 1u) ? v0 : 0.f;
          v1 = (wd & 2u) ? v1 : 0.f;
        }
        acc[4 * j + 2 * h] = v0;
        acc[4 * j + 2 * h + 1] = v1;
      }
    }
  }
  if (L.rs_post)
    ray_sums(acc, L.rs_post, L.rs_post_ld, c0, mw, a.P, a.S, rays[0],
             rays[1], lane);
  if (!store) return;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(A + act_off(rows[h], c0 + 8 * j + 2 * q)) =
          as_u32(__floats2bfloat162_rn(acc[4 * j + 2 * h],
                                       acc[4 * j + 2 * h + 1]));
}

__global__ void __launch_bounds__(TRUNK_THREADS, 1) trunk_dx_kernel(
    const __grid_constant__ DxArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* act = align1024(smem_raw);
  unsigned char* ring = act + 2 * ACT_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING * SLICE_BYTES);
  uint64_t* empty = full + RING;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (a.P + TM - 1) / TM;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= CONSUMER_WARPS) {      // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == CONSUMER_WARPS && lane == 0)
      produce(a.L, a.n_layers, ntiles, ring, full, empty);
  } else {                           // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n");
    const int wg = warp >> 2, wl = warp & 3, rh = wg >> 1, nh = wg & 1;
    const int t2 = tid & 255;
    unsigned char* A = act + rh * ACT_BYTES;
    const uint64_t da = sw128_desc(A), dr = sw128_desc(ring);
    int stage = 0;
    uint32_t phase = 0;
    float acc[64];
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int m0 = tile * TM + rh * 64;
      load_tile(A, a.g_in, a.L[0].K, m0, a.P, t2);
      cp_async_commit();
      cp_async_wait<0>();
      fence_async_smem();
      pair_sync(rh);
      for (int l = 0; l < a.n_layers; ++l) {
        const DxLayer& L = a.L[l];
        uint4 mk[2] = {};
        if (L.mask) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wl * 16 + (lane >> 2) + 8 * h;
            if (m < a.P)
              mk[h] = __ldg(reinterpret_cast<const uint4*>(
                  L.mask + (size_t)m * MASK_WORDS + 4 * nh));
          }
        }
        mma_layer(acc, TW, L.K / 64, nh, da, dr, full, empty, stage, phase,
                  lane);
        pair_sync(rh);  // both halves' products are done: A may be rewritten
        const bool to_smem = l + 1 < a.n_layers;
        dx_epilogue(acc, L, a, A, mk, to_smem || L.out, nh, m0, wl, lane);
        if (L.out) {
          pair_sync(rh);
          store_tile(L.out, A, TW, m0, a.P, t2);
        }
        fence_async_smem();
        pair_sync(rh);
      }
    }
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

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Trunk layer j's operand index in flatten_params order (forward order:
// enc_xyz, the nb shape blocks, enc_shape, enc_viewdir, the nt texture
// blocks, rgb_hidden).
int trunk_index(int j, int nb) {
  if (j <= nb + 1) return j;          // enc_xyz, shape blocks, enc_shape
  return j + 1;                       // skips the sigma row
}

int trunk_layers(int nb, int nt) { return nb + nt + 4; }

size_t packed_elems(int W, int nb, int nt, bool dx) {
  const size_t body = (size_t)(nb + nt + 2) * W * W + (size_t)W * W / 2;
  return (size_t)64 * W + body + (dx ? body : 0);
}

// Every trunk weight into ``dst`` in the wgmma operand layout: the forward
// B operands (W^T, forward order), then with ``dx`` the dx chain's (W of
// every layer but enc_xyz, forward order). ``fwd`` and ``dxw`` (or null)
// receive each layer's packed pointer, in forward order.
int launch_pack(const void* const* wts, int W, int nb, int nt, bool dx,
                bf16* dst, const bf16** fwd, const bf16** dxw,
                cudaStream_t stream) {
  PackArgs a = {};
  bf16* p = dst;
  const int n = trunk_layers(nb, nt);
  for (int pass = 0; pass < (dx ? 2 : 1); ++pass)
    for (int j = pass; j < n; ++j) {
      const int rows = j == 0 ? 64 : W, cols = j == n - 1 ? W / 2 : W;
      a.j[a.n++] = {static_cast<const bf16*>(wts[2 * trunk_index(j, nb)]), p,
                    rows, cols, pass == 0};
      (pass == 0 ? fwd : dxw)[j] = p;
      p += (size_t)rows * cols;
    }
  pack_kernel<<<dim3(32, a.n), 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// What the forward stores (each pointer or null): bf16 planes (P, W) for
// the heads and the dW GEMMs, ReLU-mask bit planes (P, 8) for the dx chain.
struct FwdOut {
  bf16* pe;         // (P, 64)
  bf16* xs;         // nb shape-block inputs (latent injected)
  bf16* ys_last;    // the last shape block's output (enc_shape's input)
  bf16* t;          // enc_shape's output
  bf16* xt;         // nt texture-block inputs (latent injected)
  bf16* yts_last;   // the last texture block's output (rgb_hidden's input)
  bf16* r;          // rgb_hidden's output, (P, W/2)
  uint32_t* m0;     // enc_xyz's mask
  uint32_t* ms;     // nb shape-block masks
  uint32_t* mv;     // enc_viewdir's mask
  uint32_t* mt;     // nt texture-block masks
};

// The forward chain from the PE through enc_shape (``full`` false) or
// through rgb_hidden, with the stores ``o`` asks for.
FwdArgs fwd_args(const float* ro8, const float* vd8, const float* z,
                 const bf16* sproj, const bf16* tproj, const bf16* vcontrib,
                 const void* const* wts, const bf16* const* packed, int R,
                 int S, int W, int nb, int nt, int n_freq, bool full,
                 const FwdOut& o) {
  const size_t P = (size_t)R * S, PW = P * W;
  auto bias = [&](int i) { return static_cast<const float*>(wts[2 * i + 1]); };
  auto at = [&](bf16* base, int j) { return base ? base + j * PW : nullptr; };
  auto bits = [&](uint32_t* base, int j) {
    return base ? base + j * P * MASK_WORDS : nullptr;
  };
  FwdArgs a = {};
  a.P = (int)P; a.S = S; a.n_freq = n_freq;
  a.ro8 = ro8; a.vd8 = vd8; a.z = z; a.pe_out = o.pe;
  a.n_layers = full ? trunk_layers(nb, nt) : nb + 2;
  for (int j = 0; j < a.n_layers; ++j) {
    FwdLayer& L = a.L[j];
    L.w = packed[j];
    L.K = j == 0 ? 64 : W;
    L.N = j == trunk_layers(nb, nt) - 1 ? W / 2 : W;
    L.relu = j != nb + 1;                       // enc_shape has none
    if (j != nb + 2) L.bias = bias(trunk_index(j, nb));
    if (j <= nb) {                              // enc_xyz and shape blocks
      L.mask_out = j == 0 ? o.m0 : bits(o.ms, j - 1);
      if (j == nb) L.out = o.ys_last;
      if (j < nb) {
        L.inj = sproj + (size_t)j * W; L.inj_ld = nb * W;
        L.out_in = at(o.xs, j);
      }
    } else if (j == nb + 1) {
      L.out = o.t;
    } else if (j == nb + 2) {                   // enc_viewdir's trunk rows
      L.rowvec = vcontrib; L.rowvec_ld = W;
      L.mask_out = o.mv;
      L.inj = tproj; L.inj_ld = nt * W;
      L.out_in = at(o.xt, 0);
    } else if (j < nb + nt + 3) {               // texture block j - nb - 3
      const int k = j - nb - 3;
      L.mask_out = bits(o.mt, k);
      if (k + 1 < nt) {
        L.inj = tproj + (size_t)(k + 1) * W; L.inj_ld = nt * W;
        L.out_in = at(o.xt, k + 1);
      } else {
        L.out = o.yts_last;
      }
    } else {
      L.out = o.r;
    }
  }
  return a;
}

int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  if (a.P == 0) return 0;
  CHECK((int)cudaFuncSetAttribute(trunk_fwd_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)FWD_SMEM));
  const int tiles = (a.P + TM - 1) / TM, sms = sm_count();
  const int grid = tiles < sms ? tiles : sms;   // persistent: one per SM
  trunk_fwd_kernel<<<grid, TRUNK_THREADS, FWD_SMEM,
                     stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_dx(const DxArgs& a, cudaStream_t stream) {
  if (a.P == 0) return 0;
  CHECK((int)cudaFuncSetAttribute(trunk_dx_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)DX_SMEM));
  const int tiles = (a.P + TM - 1) / TM, sms = sm_count();
  const int grid = tiles < sms ? tiles : sms;   // persistent: one per SM
  trunk_dx_kernel<<<grid, TRUNK_THREADS, DX_SMEM,
                    stream>>>(a);
  return (int)cudaGetLastError();
}

bool trunk_shapes_ok(int W, int nb, int nt, int n_freq) {
  return W == TW && 3 + 6 * n_freq <= 64 && nb >= 1 && nt >= 1
         && trunk_layers(nb, nt) <= MAX_LAYERS;
}

}  // namespace

// Workspace sizes (elements) for one call: the packed weights; the bf16
// planes the heads read (t, r) and the rgb_hidden cotangent; the ReLU-mask
// bit planes of the dx chain (P x 32 B each: the shape blocks, enc_viewdir,
// the texture blocks, and with weight or input gradients enc_xyz); f32
// dsig and the per-ray cotangent sums. Weight-gradient mode adds every dW
// GEMM's bf16 input (the PE, the injected inputs, the last shape and
// texture blocks' outputs) and gh plane (nb + nt + 3), the dW partials and
// the head kernel's per-ray partials; input gradients alone add gh0.
extern "C" void fused_workspace(int R, int S, int W, int nb, int nt,
                                int weight_grads, int input_grads,
                                size_t* n_bf16, size_t* n_f32) {
  const size_t P = (size_t)R * S, PW = P * W;
  const size_t mask_planes = nb + nt + 1 + (weight_grads || input_grads);
  *n_bf16 = packed_elems(W, nb, nt, true) + 2 * PW
            + mask_planes * P * MASK_WORDS * 2;
  *n_f32 = P + (size_t)R * (nb + nt + 1) * W;
  if (input_grads && !weight_grads) *n_bf16 += PW;
  if (!weight_grads) return;
  *n_bf16 += P * 64 + (size_t)(nb + nt + 2) * PW
             + (size_t)(nb + nt + 3) * PW;
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
// ``input_grads`` (not with the dual mode) writes the exact ray and depth
// cotangents d_ro8, d_vd8 (R, 8) and d_z (R, S): the forward also keeps
// y0, the dx chain runs on through enc_xyz's ReLU mask, and
// input_chain_kernel finishes the PE Jacobian on top of the composite's
// own dz, which the head kernel writes. ``gplanes`` (a host array of four
// (R, S) f32 device pointers, or null) selects the plane-op backward (the
// TPU's _bwd_kernel): the forward is recomputed as in the other modes, the
// cotangents of the sigma, r, g, b planes take the place of the composite
// and the loss (gt8, se8, rgb8, weights and cmask are null), and the
// chains follow by flag, any of the four flag pairs; d_z then holds the
// input chain's xyz term alone. ``wts`` is a host array of the 2*k device
// pointers of ops/fused_train.py::flatten_params, in its order: 2-D
// weights bf16 (in, out), 1-D weights and biases f32. With
// ``weight_grads``, ``dwb`` is a host array of 2*k f32 device pointers in
// the same order, each the shape of its weight or bias, which receive the
// gradients; else it is null. The trunk takes W = 256. Returns the first
// nonzero cudaGetLastError() after a launch, else 0.
extern "C" int fused_step(
    const float* ro8, const float* vd8, const float* z, const bf16* sproj,
    const bf16* tproj, const bf16* vcontrib, const float* gt8,
    const float* cmask, const float* cdelta, const void* const* gplanes,
    const void* const* wts, bf16* ws, float* ws32, float* se8, float* rgb8,
    float* weights, bf16* d_sproj, bf16* d_tproj, bf16* d_vcontrib,
    float* d_ro8, float* d_vd8, float* d_z, void* const* dwb,
    int weight_grads, int input_grads, int R, int S, int W, int nb, int nt,
    int n_freq, float two_scale, int white_bg, cudaStream_t stream) {
  if (S > MAX_S || !trunk_shapes_ok(W, nb, nt, n_freq)
      || (cmask == nullptr) != (cdelta == nullptr)
      || (cmask != nullptr && (weights != nullptr || input_grads))
      || (gplanes != nullptr && (cmask != nullptr || weights != nullptr
                                 || rgb8 != nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t P = (size_t)R * S, PW = P * W;
  auto wf = [&](int i) { return static_cast<const float*>(wts[2 * i]); };
  auto bias = [&](int i) { return static_cast<const float*>(wts[2 * i + 1]); };
  auto dw = [&](int i) { return static_cast<float*>(dwb[2 * i]); };
  auto db = [&](int i) { return static_cast<float*>(dwb[2 * i + 1]); };
  const int i_encs = nb + 1, i_sig = nb + 2, i_encv = nb + 3;
  const int i_tex = nb + 4, i_rgbh = nb + nt + 4, i_rgbo = nb + nt + 5;

  bf16* p = ws + packed_elems(W, nb, nt, true);
  auto take = [&](size_t n) { bf16* q = p; p += n; return q; };
  auto take_bits = [&](size_t planes) {
    return reinterpret_cast<uint32_t*>(take(planes * P * MASK_WORDS * 2));
  };
  FwdOut o = {};
  o.t = take(PW);
  o.r = take(PW / 2);
  bf16* g_r = take(PW / 2);
  if (weight_grads || input_grads) o.m0 = take_bits(1);
  o.ms = take_bits(nb);
  o.mv = take_bits(1);
  o.mt = take_bits(nt);
  // gh planes, each the cotangent of a layer's output: texture blocks
  // 0..nt-1, enc_viewdir, enc_shape, shape blocks 0..nb-1, enc_xyz (gh0).
  bf16 *gh_tex = nullptr, *gh_encv = nullptr, *gh_encs = nullptr;
  bf16 *gh_shape = nullptr, *gh0 = nullptr;
  if (weight_grads) {
    o.pe = take(P * 64);
    o.xs = take(nb * PW);
    o.ys_last = take(PW);
    o.xt = take(nt * PW);
    o.yts_last = take(PW);
    gh_tex = take(nt * PW);
    gh_encv = take(PW);
    gh_encs = take(PW);
    gh_shape = take(nb * PW);
    gh0 = take(PW);
  } else if (input_grads) {
    gh0 = take(PW);
  }
  auto plane = [&](bf16* base, int k) {
    return base ? base + (size_t)k * PW : nullptr;
  };
  float* dsig = ws32;
  float* rs_s = dsig + P;             // (R, nb, W)
  float* rs_t = rs_s + (size_t)R * nb * W;
  float* rs_v = rs_t + (size_t)R * nt * W;
  float* head_part = rs_v + (size_t)R * W;   // weight_grads: (R, HP)
  float* head_tmp = head_part + (size_t)R * head_part_cols(W);
  float* dw_part = head_tmp + (size_t)COLSUM_GROUPS * head_part_cols(W);
  CHECK((int)cudaMemsetAsync(rs_s, 0, sizeof(float) * (size_t)R * (nb + nt + 1) * W,
                             stream));

  const bf16* fwd_w[MAX_LAYERS];
  const bf16* dx_w[MAX_LAYERS];
  CHECK(launch_pack(wts, W, nb, nt, true, ws, fwd_w, dx_w, stream));

  // ---- forward: the whole trunk in one launch.
  CHECK(launch_fwd(fwd_args(ro8, vd8, z, sproj, tproj, vcontrib, wts, fwd_w,
                            R, S, W, nb, nt, n_freq, true, o),
                   stream));

  // ---- heads, composite, loss, composite backward
  HeadArgs h = {};
  h.R = R; h.S = S; h.W = W; h.t = o.t; h.r = o.r; h.z = z; h.gt8 = gt8;
  h.cmask = cmask; h.cdelta = cdelta;
  h.w_sig = wf(i_sig); h.b_sig = bias(i_sig);
  h.w_rgb = static_cast<const bf16*>(wts[2 * i_rgbo]);
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

  // ---- dx chain: one launch from the rgb_hidden cotangent down to shape
  // block 0 (enc_xyz's output cotangent with weight or input gradients).
  DxArgs d = {};
  d.P = (int)P; d.S = S; d.g_in = g_r; d.dsig = dsig; d.wsig = wf(i_sig);
  const int n_tr = trunk_layers(nb, nt);
  for (int l = 0; l < n_tr - 1; ++l) {
    DxLayer& L = d.L[d.n_layers++];
    const int j = n_tr - 1 - l;       // the forward layer it differentiates
    L.w = dx_w[j];
    L.K = j == n_tr - 1 ? W / 2 : W;
    L.N = W;
    if (j == n_tr - 1) {                            // rgb_hidden
      L.mask = o.mt + (size_t)(nt - 1) * P * MASK_WORDS;
      L.out = plane(gh_tex, nt - 1);
    } else if (j > nb + 2) {                        // texture block k
      const int k = j - nb - 3;
      L.rs_pre = rs_t + (size_t)k * W; L.rs_pre_ld = nt * W;
      L.mask = k > 0 ? o.mt + (size_t)(k - 1) * P * MASK_WORDS : o.mv;
      if (k == 0) { L.rs_post = rs_v; L.rs_post_ld = W; }
      L.out = k > 0 ? plane(gh_tex, k - 1) : gh_encv;
    } else if (j == nb + 2) {                       // enc_viewdir
      L.dsig_term = 1;
      L.out = gh_encs;
    } else if (j == nb + 1) {                       // enc_shape
      L.mask = o.ms + (size_t)(nb - 1) * P * MASK_WORDS;
      L.out = plane(gh_shape, nb - 1);
    } else {                                        // shape block j - 1
      const int k = j - 1;
      L.rs_pre = rs_s + (size_t)k * W; L.rs_pre_ld = nb * W;
      if (k > 0) {
        L.mask = o.ms + (size_t)(k - 1) * P * MASK_WORDS;
        L.out = plane(gh_shape, k - 1);
      } else if (weight_grads || input_grads) {
        L.mask = o.m0;
        L.out = gh0;
      }
    }
  }
  CHECK(launch_dx(d, stream));

  // ---- dW/db of every trunk layer from its stored input and gh plane.
  if (weight_grads) {
    const int Pi = (int)P;
    CHECK(launch_dw(o.yts_last, g_r, Pi, W, W / 2, dw_part,
                    dw(i_rgbh), db(i_rgbh), stream));
    for (int k = 0; k < nt; ++k)
      CHECK(launch_dw(o.xt + (size_t)k * PW, gh_tex + (size_t)k * PW, Pi, W,
                      W, dw_part, dw(i_tex + k), db(i_tex + k), stream));
    CHECK(launch_dw(o.t, gh_encv, Pi, W, W, dw_part, dw(i_encv), db(i_encv),
                    stream));
    CHECK(launch_dw(o.ys_last, gh_encs, Pi, W, W, dw_part,
                    dw(i_encs), db(i_encs), stream));
    for (int k = 0; k < nb; ++k)
      CHECK(launch_dw(o.xs + (size_t)k * PW, gh_shape + (size_t)k * PW, Pi, W,
                      W, dw_part, dw(1 + k), db(1 + k), stream));
    CHECK(launch_dw(o.pe, gh0, Pi, 64, W, dw_part, dw(0), db(0), stream));
  }
  if (input_grads) {
    const size_t smem = input_smem_bytes(W);
    CHECK((int)cudaFuncSetAttribute(
        input_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem));
    const InputArgs ia = {S, W, n_freq, gh0,
                          static_cast<const bf16*>(wts[0]), ro8, vd8, z, d_z,
                          d_ro8, d_vd8};
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

// Workspace (bf16 elements) of sigma_step (``planes`` 0) and planes_step
// (``planes`` 1): the packed forward weights, t, and for planes_step r.
extern "C" size_t forward_workspace(int R, int S, int W, int nb, int nt,
                                    int planes) {
  const size_t PW = (size_t)R * S * W;
  return packed_elems(W, nb, nt, false) + PW + (planes ? PW / 2 : 0);
}

// Sigma-only forward on R rays x S samples: replaces
// codenerf_tpu/ops/fused_mlp.py::_kernel(sigma_only=True), the coarse pass
// of hierarchical sampling, whose compositing weights need sigma alone.
// trunk_fwd_kernel from the PE through enc_shape, storing t alone (in
// ``ws``, forward_workspace(..., 0) elements: nothing is kept for a
// backward), then sigma_head_kernel writes ``sigma`` (R, S) f32. ``wts``
// as for fused_step; only the enc_xyz, shape, enc_shape and sigma entries
// are read (and the packing reads the rest). Bound by operations:
// 2 * W * (64 + W * (nb + 1)) FLOP per point.
extern "C" int sigma_step(const float* ro8, const float* vd8, const float* z,
                          const bf16* sproj, const void* const* wts, bf16* ws,
                          float* sigma, int R, int S, int W, int nb, int nt,
                          int n_freq, cudaStream_t stream) {
  if (!trunk_shapes_ok(W, nb, nt, n_freq)) return (int)cudaErrorInvalidValue;
  const size_t P = (size_t)R * S;
  const bf16* fwd_w[MAX_LAYERS];
  CHECK(launch_pack(wts, W, nb, nt, false, ws, fwd_w, nullptr, stream));
  FwdOut o = {};
  o.t = ws + packed_elems(W, nb, nt, false);
  CHECK(launch_fwd(fwd_args(ro8, vd8, z, sproj, nullptr, nullptr, wts, fwd_w,
                            R, S, W, nb, nt, n_freq, false, o),
                   stream));
  sigma_head_kernel<<<point_blocks(P), 256, 0, stream>>>(
      o.t, static_cast<const float*>(wts[2 * (nb + 2)]),
      static_cast<const float*>(wts[2 * (nb + 2) + 1]), sigma, P, W);
  return (int)cudaGetLastError();
}

// Four-plane forward on R rays x S samples: replaces
// codenerf_tpu/ops/fused_mlp.py::_kernel (sigma_only=False), the forward
// of the plane op. trunk_fwd_kernel through rgb_hidden in one launch,
// storing t and r (``ws``: forward_workspace(..., 1) elements); t is
// computed as sigma_step computes it, so the sigma plane from
// sigma_head_kernel is sigma_step's, bit for bit; rgb_head_kernel writes
// the raw r, g, b planes. Outputs (R, S) f32. Bound by operations:
// 2 * W * (64 + W * (nb + nt + 2) + W / 2) FLOP per point.
extern "C" int planes_step(const float* ro8, const float* vd8, const float* z,
                           const bf16* sproj, const bf16* tproj,
                           const bf16* vcontrib, const void* const* wts,
                           bf16* ws, float* sigma, float* c0, float* c1,
                           float* c2, int R, int S, int W, int nb, int nt,
                           int n_freq, cudaStream_t stream) {
  if (!trunk_shapes_ok(W, nb, nt, n_freq)) return (int)cudaErrorInvalidValue;
  const int i_sig = nb + 2, i_rgbo = nb + nt + 5;
  const size_t P = (size_t)R * S;
  const bf16* fwd_w[MAX_LAYERS];
  CHECK(launch_pack(wts, W, nb, nt, false, ws, fwd_w, nullptr, stream));
  FwdOut o = {};
  o.t = ws + packed_elems(W, nb, nt, false);
  o.r = o.t + P * W;
  CHECK(launch_fwd(fwd_args(ro8, vd8, z, sproj, tproj, vcontrib, wts, fwd_w,
                            R, S, W, nb, nt, n_freq, true, o),
                   stream));
  sigma_head_kernel<<<point_blocks(P), 256, 0, stream>>>(
      o.t, static_cast<const float*>(wts[2 * i_sig]),
      static_cast<const float*>(wts[2 * i_sig + 1]), sigma, P, W);
  CHECK((int)cudaGetLastError());
  rgb_head_kernel<<<point_blocks(P), 256, 0, stream>>>(
      o.r, static_cast<const bf16*>(wts[2 * i_rgbo]),
      static_cast<const float*>(wts[2 * i_rgbo + 1]), c0, c1, c2, P, W / 2);
  return (int)cudaGetLastError();
}

// The trunk weights packed as fused_step packs them (``dst``:
// packed_elems(W, nb, nt, true) bf16): the forward operands W^T, then the
// dx chain's W. For the check of the packing against its plain version.
extern "C" int pack_trunk_weights(const void* const* wts, int W, int nb,
                                  int nt, bf16* dst, cudaStream_t stream) {
  if (!trunk_shapes_ok(W, nb, nt, 0)) return (int)cudaErrorInvalidValue;
  const bf16* fwd_w[MAX_LAYERS];
  const bf16* dx_w[MAX_LAYERS];
  return launch_pack(wts, W, nb, nt, true, dst, fwd_w, dx_w, stream);
}

extern "C" size_t packed_trunk_elems(int W, int nb, int nt) {
  return packed_elems(W, nb, nt, true);
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
