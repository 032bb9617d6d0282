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
//   (i)   pack_kernel: every trunk weight into the operand layout of
//         wgmma (K-major, 128-byte swizzled, in 64-wide K slices;
//         ops/fused_train.py::wgmma_pack is its plain version): W^T for the
//         forward, W for the dx chain, a 64 x 64 tile a block. Once per
//         weight version (pack_trunk_weights, called by
//         ops/fused_train.py::trunk_operands), not once per call: the
//         entry points take the packed buffer.
//   (ii)  trunk_fwd_kernel: one persistent block per SM walks 128-point
//         tiles. Four consumer warpgroups each own a (64-point row half,
//         128-column half) of every layer's output; a producer warp streams
//         the weight slices (32 KB) into a 4-stage ring with cp.async.bulk
//         and mbarriers. The block stages the per-ray rows of its tile's
//         rays (every latent and per-ray vector the layers add, a few KB a
//         ray) in shared memory by cp.async and builds the PE of its
//         points into shared memory meanwhile, then runs the layers on the
//         resident (64, 256) bf16 tile of each row half: wgmma m64n128k16
//         (n64 for rgb_hidden) from shared memory into f32 registers, then
//         one epilogue in registers (bias, per-ray vector, ReLU, the ReLU
//         mask of y as bits, the latent injection as a bf16 add) that
//         writes the next layer's input into the tile once. A 128-point
//         tile spans at most 3 rays at S >= 32, yet each element pair
//         needs its ray's row: from the stage they are shared-memory
//         reads, 16 bytes a thread per four column pairs, not device
//         loads on the epilogue's path (below S ~ 32, where the rays do
//         not fit, the epilogue reads them from device memory). The tile
//         is 64-column slices of 64 rows x 128 B in the 128-byte swizzle,
//         a TMA box, so a plane leaves it by cp.async.bulk.tensor stores,
//         one thread of the row half issuing them after the epilogue's
//         barrier; the next layer's products only read the tile and run
//         beside the stores, which that thread waits for (reads done)
//         before the next epilogue rewrites it. Rows past P are clipped by
//         the tensor map. Each layer: products, barrier, epilogue, barrier.
//         Device memory sees only what later kernels read: ReLU-mask bit
//         planes (32 B a point) for the dx chain, t and r for the heads,
//         and in weight-gradient mode each dW GEMM's bf16 input (the PE,
//         the injected inputs, the last shape and texture blocks' outputs).
//   (iii) head_kernel: one warp per ray, 8 rays a block. Sigma head (dot
//         with the w_sig row, softplus) and rgb_out head from 16-byte rows
//         of t and r, the composite with a warp scan over the samples,
//         MSE, composite backward; emits dsig = g_sigma * sigmoid(sig_pre)
//         and the rgb_hidden cotangent (masked by r's ReLU bits kept in
//         shared memory, bf16, 16-byte stores).
//   (iv)  trunk_dx_kernel: the dx chain gh @ W^T from the rgb_hidden
//         cotangent down to enc_xyz's output in one launch, with the same
//         tiles, warpgroups, ring and wgmma shapes. The epilogue
//         adds the sigma term dsig * w_sig, masks with the prefetched bits,
//         rounds gh to bf16 in place, and reduces the per-ray row sums in
//         registers (a shuffle ladder over the warp's 16 rows) into one
//         partial row per ray and slice, without atomics (ray_sums); one
//         ray_sum_fold_kernel launch then adds each ray's rows in a
//         fixed order and rounds the three cotangent outputs to bf16. In
//         weight-gradient mode it also stores every gh plane, 16 bytes a
//         thread.
// Weight-gradient mode adds:
//   (v)   wgrad_kernel: dW = X^T @ GH and db = sum GH of every trunk
//         layer in one launch after the dx chain: a static list of
//         (output tile, point split) items walked by persistent blocks,
//         wgmma from TMA-loaded boxes of the stored planes (both operands
//         MN-major), each item's f32 partial tile written without atomics;
//   (vi)  head_kernel's phase 4: per ray, sum_s t*dsig (sigma dW),
//         sum_s dsig, sum_s r*gh8 and sum_s gh8 (rgb_out dW, db), added
//         over the block's rays in order into one row per block;
//         fixed_sum_kernel then adds the splits of (v) and the rows of
//         (vi) in a fixed order in one launch, so dW and db are the same
//         bits on every run.
// The input gradients add:
//   (vii) head_kernel writes the composite's z cotangent; the forward keeps
//         y0 and the dx chain runs on through enc_xyz's ReLU mask to gh0;
//   (viii) input_chain_kernel: per point d_pe = gh0 . W_enc^T, the PE
//         Jacobian, d_z += d_xyz . vd; per ray d_ro8, d_vd8 in a fixed
//         order. Bound by gh0's bytes: persistent blocks stage W_enc once
//         and stream a contiguous range of whole rays in 64-row chunks
//         through a two-stage cp.async ring; mma.sync m16n8k16 bf16 on
//         the tensor cores, the Jacobian a row per lane with one sincosf
//         per (coordinate, frequency), a warp per ray for the sums.
// The forwards at the end of this file reuse (i)'s operands and (ii) with
// one head pass, two instances of one loop (16-byte loads, several
// points a warp, weights in registers): sigma_step's sigma_head_kernel
// (sigma alone, 8 points a warp) and planes_step's plane_head_kernel
// (sigma and the raw r, g, b over t and r, 4 points a warp). Their sigma
// lanes are the same code, so both sigma planes are the same bits.
// What bounds the trunk: at W=256 a layer is 131,072 FLOP per point
// against 512 B per stored bf16 plane, so the chain is bound by operations
// once activations stay on chip; the weights (0.9 MB) come from L2 once per
// tile and layer. On the card the epilogues, not the products, take most
// of each layer (PERF.md).
// Rounding points follow the TPU kernel: bf16 activations after each ReLU,
// the latent injection as a bf16 add, sig_pre in f32 from bf16 t, masks on
// the stored bf16 activations, the composite entirely in f32; gh rounded to
// bf16 before both its dx and its dW product, the sigma dW from bf16 t
// times f32 dsig. Every sum is taken in a fixed order, so the code
// cotangents, dW and db are the same bits on every run.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_PER_LANE = 8;    // samples per lane in the head scan
constexpr int MAX_S = 32 * MAX_PER_LANE;
constexpr unsigned FULL = 0xffffffffu;

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
// The forward's per-ray rows on chip: a row half's stage holds whole rays'
// records of latents and per-ray vectors (trunk_fwd_kernel).
constexpr int STAGE_BYTES = 8192;
constexpr size_t FWD_SMEM = DX_SMEM + MAX_LAYERS * TW * sizeof(float)
                            + 2 * STAGE_BYTES;

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

// A (64, 64) box of shared memory at ``src`` (1024-byte aligned, in the
// tensor map's 128-byte swizzle) to column c0, row p0 of the map's tensor,
// in the thread's current bulk group; rows past the tensor's end are not
// written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int p0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
      "r"(p0)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the thread's bulk stores have read their shared memory (it may be
// rewritten); with ``all``, until they have completed.
template <bool all>
__device__ __forceinline__ void bulk_wait() {
  if (all) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices into shared memory, one 16-byte row each at
// the address lane 8 i + r gives for row r of matrix i; the thread's word
// of matrix i (its row lane / 4, columns 2 (lane % 4), +1: an mma
// fragment) in the i-th register.
__device__ __forceinline__ void stsm_x4(void* p, uint32_t a, uint32_t b,
                                        uint32_t c, uint32_t d) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(smem_u32(p)), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
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

// D (64 x 256, f32) += A (64 x 16) * B (16 x 256), both bf16 MN-major in
// shared memory (imm-trans-a = imm-trans-b = 1); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tt_n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------- packing

// B (N x K) = transpose ? w^T : w, for w (rows, cols) row-major bf16,
// written to dst in 64-deep K slices of N rows x 128 B, 16-byte chunk c of
// row n at c ^ (n % 8): the byte image each weight slice has in the ring.
// N and K are multiples of 64; ``first`` is the job's first tile in the
// grid.
struct PackJob {
  const bf16* w;
  bf16* dst;
  int rows, cols, transpose, first;
};

struct PackArgs {
  int n;
  PackJob j[2 * MAX_LAYERS];
};

constexpr int PACK_THREADS = 256;

// One block per 64 (K) x 64 (N) tile of one job: the tile's 128 B rows of
// slice s are 8 KB of dst in one piece. W is read in 16-byte chunks of
// its rows, coalesced; for W^T the tile goes through shared memory
// (rows padded by one word) and each thread gathers its output chunk's
// 8 values from a column there. Every store is a whole 16-byte chunk,
// coalesced within its 128 B row. Bound by bytes (~2 MB at W = 256, so
// at this size by its launch).
__global__ void __launch_bounds__(PACK_THREADS) pack_kernel(
    const __grid_constant__ PackArgs a) {
  __shared__ __align__(16) bf16 tile[64][64 + 2];      // [k][n]
  int jb = 0;
  while (jb + 1 < a.n && a.j[jb + 1].first <= (int)blockIdx.x) ++jb;
  const PackJob& J = a.j[jb];
  const int N = J.transpose ? J.cols : J.rows;
  const int t = (int)blockIdx.x - J.first, s = t / (N / 64);
  const int n0 = t % (N / 64) * 64;
  bf16* out = J.dst + ((size_t)s * N + n0) * 64;
  if (!J.transpose) {                 // B = W: permute each row's chunks
    for (int q = threadIdx.x; q < 512; q += PACK_THREADS) {
      const int n = q >> 3, c = q & 7;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          J.w + (size_t)(n0 + n) * J.cols + s * 64 + c * 8));
      *reinterpret_cast<uint4*>(out + n * 64 + (c ^ (n & 7)) * 8) = v;
    }
    return;
  }
  for (int q = threadIdx.x; q < 512; q += PACK_THREADS) {   // rows k of W
    const int k = q >> 3, c = q & 7;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        J.w + (size_t)(s * 64 + k) * J.cols + n0 + c * 8));
    uint32_t* d = reinterpret_cast<uint32_t*>(&tile[k][c * 8]);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 512; q += PACK_THREADS) {   // rows n of B
    const int n = q >> 3, p = q & 7, c = p ^ (n & 7);
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = tile[c * 8 + e][n];
    *reinterpret_cast<uint4*>(out + n * 64 + p * 8) =
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
  bf16* dst;              // (P, N): the next layer's input (y, or with a
                          // latent the injected x), stored by TMA; or null
  uint32_t* mask_out;     // (P, 8) ReLU-mask bits of y, or null
  int K, N, relu, rowvec_ld, inj_ld;
  int rowvec_at, inj_at;  // their rows' offsets in a ray's staged record
};

struct FwdArgs {
  CUtensorMap map[MAX_LAYERS];    // layer l's dst (P, N), 64 x 64 boxes
  CUtensorMap pe_map;             // pe_out (P, 64)
  int P, S, n_freq, n_layers;
  int rec;                // bf16 elements of a ray's staged record; 0:
                          // the epilogues read the rows from device memory
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
  float* sl_pre;          // per 16-point slice [slices][rs_pre_ld]: ray_sums
  float* sl_post;
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
// cos lanes.
__device__ __forceinline__ void build_pe(const FwdArgs& a, unsigned char* A,
                                         int m0, int t2) {
  const int row = t2 >> 2, part = t2 & 3, m = m0 + row, F = a.n_freq;
  const bool ok = m < a.P;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
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
__device__ __forceinline__ float2 ld_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// The records of rays ray0 .. ray0 + nrays - 1 into a row half's stage
// ``st`` (a.rec elements apart), 16 bytes a cp.async over the pair of
// warpgroups (t2 = 0..255); the caller commits the group. A ray's record
// holds, layer by layer, the layer's per-ray vector row and its latent row
// (N bf16 each, where it has them).
__device__ __forceinline__ void stage_rows(const FwdArgs& a, bf16* st,
                                           int ray0, int nrays, int t2) {
  for (int l = 0; l < a.n_layers; ++l) {
    const FwdLayer& L = a.L[l];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const bf16* src = v ? L.inj : L.rowvec;
      if (!src) continue;
      const int ld = v ? L.inj_ld : L.rowvec_ld;
      const int at = v ? L.inj_at : L.rowvec_at, chunks = L.N / 8;
      for (int i = t2; i < nrays * chunks; i += 256) {
        const int s = i / chunks, c = i - s * chunks;
        cp_async16(st + (size_t)s * a.rec + at + 8 * c,
                   src + (size_t)(ray0 + s) * ld + 8 * c, 16);
      }
    }
  }
}

// A forward layer's epilogue, in registers, on this thread's two rows of
// its warpgroup's column half: bias (from shared memory), per-ray vector,
// ReLU, bf16 y; with mask_out the ReLU mask of y as bits (the 4 lanes of
// a quad hold the row's 128 columns of the half between them); with a
// latent the injection x = bf16(y + inj) as a bf16 add. The next layer's
// input (x, else y) goes into the tile, once. The per-ray rows come from
// the row half's stage ``st`` (with ``rec``: records ``rec`` elements
// apart from ray ``ray0``), else from device memory. The tile takes two
// column octets of both rows at a time by stmatrix.
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[64],
                                             const FwdLayer& L,
                                             const float* __restrict__ bias,
                                             unsigned char* __restrict__ A,
                                             const bf16* __restrict__ st,
                                             int rec, int ray0, int nh,
                                             int m0, int P, int S, int wl,
                                             int lane) {
  const int q = lane & 3, jn = L.N / 16, c0 = nh * 8 * jn;
  const bool relu = L.relu;
  // Each row's per-ray vector and latent at its first column pair.
  const bf16* rv[2] = {nullptr, nullptr};
  const bf16* pj[2] = {nullptr, nullptr};
  int rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = wl * 16 + (lane >> 2) + 8 * h;
    const int m = m0 + rows[h], ray = m < P ? m / S : 0;
    if (rec) {
      const bf16* r = st + (size_t)(m < P ? ray - ray0 : 0) * rec + c0
                      + 2 * q;
      if (L.rowvec) rv[h] = r + L.rowvec_at;
      if (L.inj) pj[h] = r + L.inj_at;
    } else {
      if (L.rowvec)
        rv[h] = L.rowvec + (size_t)ray * L.rowvec_ld + c0 + 2 * q;
      if (L.inj) pj[h] = L.inj + (size_t)ray * L.inj_ld + c0 + 2 * q;
    }
  }
  // A row's four words of column group k: columns c0 + 32 k + 8 i + 2 q.
  auto words = [&](const bf16* p, int k) {
    const unsigned* g = reinterpret_cast<const unsigned*>(p + 32 * k);
    if (rec) return make_uint4(g[0], g[4], g[8], g[12]);
    return make_uint4(__ldg(g), __ldg(g + 4), __ldg(g + 8), __ldg(g + 12));
  };
  uint32_t bits[2][4] = {};
#pragma unroll
  for (int k = 0; k < TW / 64; ++k) {
    if (4 * k >= jn) break;
    uint4 rw[2] = {}, pw[2] = {};
    uint32_t xs[4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rv[h]) rw[h] = words(rv[h], k);
      if (pj[h]) pw[h] = words(pj[h], k);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * k + i, col = c0 + 8 * j + 2 * q;
      const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h] + b.x;
        float v1 = acc[4 * j + 2 * h + 1] + b.y;
        if (rv[h]) {
          const __nv_bfloat162 r = as_bf2(word_of(rw[h], i));
          v0 += __low2float(r); v1 += __high2float(r);
        }
        if (relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
        const uint32_t y = as_u32(__floats2bfloat162_rn(v0, v1));
        uint32_t x = y;
        if (pj[h]) {
          const __nv_bfloat162 y2 = as_bf2(y), p2 = as_bf2(word_of(pw[h], i));
          x = as_u32(__floats2bfloat162_rn(
              __low2float(y2) + __low2float(p2),
              __high2float(y2) + __high2float(p2)));
        }
        xs[i][h] = x;
        bits[h][k] |= (((y & 0x7fffu) ? 1u : 0u)
                       | ((y & 0x7fff0000u) ? 2u : 0u))
                      << (8 * i + 2 * q);
      }
    }
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int g = lane >> 3, row = wl * 16 + (lane & 7) + 8 * (g & 1);
      const int col = c0 + 8 * (4 * k + 2 * pr + (g >> 1));
      stsm_x4(A + act_off(row, col), xs[2 * pr][0], xs[2 * pr][1],
              xs[2 * pr + 1][0], xs[2 * pr + 1][1]);
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
  unsigned char* stages = reinterpret_cast<unsigned char*>(
      biases + MAX_LAYERS * TW);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + 2 * STAGE_BYTES);
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
    const bool elected = t2 == 0;    // issues the row half's TMA stores
    unsigned char* A = act + rh * ACT_BYTES;
    bf16* st = reinterpret_cast<bf16*>(stages + rh * STAGE_BYTES);
    const uint64_t da = sw128_desc(A), dr = sw128_desc(ring);
    int stage = 0;
    uint32_t phase = 0;
    float acc[64];
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int m0 = tile * TM + rh * 64, ray0 = m0 / a.S;
      // The tile's per-ray rows, under the PE's build (the last tile's
      // epilogues, which read the stage, ended at a pair_sync).
      if (a.rec) {
        const int nrays =
            m0 < a.P ? min(m0 + 63, a.P - 1) / a.S - ray0 + 1 : 0;
        stage_rows(a, st, ray0, nrays, t2);
        cp_async_commit();
      }
      if (tile != (int)blockIdx.x) {  // the last tile's stores read A
        if (elected) bulk_wait<false>();
        pair_sync(rh);
      }
      build_pe(a, A, m0, t2);
      cp_async_wait<0>();
      fence_async_smem();
      pair_sync(rh);
      if (elected && a.pe_out) {
        tma_store(&a.pe_map, A, 0, m0);
        bulk_commit();
      }
      for (int l = 0; l < a.n_layers; ++l) {
        const FwdLayer& L = a.L[l];
        mma_layer(acc, L.N, L.K / 64, nh, da, dr, full, empty, stage, phase,
                  lane);
        if (elected) bulk_wait<false>();
        pair_sync(rh);  // both halves' products are done, and the stores
                        // have read the tile: A may be rewritten
        fwd_epilogue(acc, L, biases + l * TW, A, st, a.rec, ray0, nh, m0,
                     a.P, a.S, wl, lane);
        fence_async_smem();
        pair_sync(rh);
        if (elected && L.dst) {
          for (int b = 0; b < L.N / 64; ++b)
            tma_store(&a.map[l], A + b * BLOCK_BYTES, 64 * b, m0);
          bulk_commit();
        }
      }
    }
    if (elected) bulk_wait<true>();
  }
}

// One ladder step of the warp's row reduction: the lanes whose ``mask``
// bit is clear keep x[0, half) and those with it set x[half, 2 half), each
// adding its partner's copy of the half it keeps.
template <int HALF, int N>
__device__ __forceinline__ void reduce_step(float (&x)[N], int mask,
                                            int lane) {
  const bool hi = lane & mask;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = hi ? x[i] : x[i + HALF];
    const float keep = hi ? x[i + HALF] : x[i];
    x[i] = keep + __shfl_xor_sync(FULL, send, mask);
  }
}

// Per-ray sums of this warp's 16 rows (a slice, from point mw) and its
// warpgroup's 128 columns (from column c0), without atomics: for each ray
// the rows touch and each quarter of the columns, a reduction over the 8
// lanes that share lane % 4 (rows k and k + 8 added first, then a
// pairwise tree over k = 0..7), laddered so that every lane ends with 2
// of the quarter's columns, stored as the ray's partial of this slice:
// to rs [ray][ld] in the slice where the ray starts (its whole sum if it
// ends there too), else to sl [mw / 16][ld], the row of the slice (one
// ray a slice started before it). ray_sum_fold_kernel then adds a ray's
// rows left to right, so the sum's order follows the ray's place against
// the 16-point slices alone: the same bits on every launch of the same
// (R, S), whatever block took which tile. With S a multiple of 16 (96,
// 64, 32 on the main paths) every ray starts a slice, so its sums do not
// depend on where in the launch it lies; for other S, code fitting still
// launches one chunk of one object at a time at the standalone shape and
// ray order, fitted alone or in a group (--opt_group). (Adding the
// slices of a tile in the kernel, through shared memory, and leaving only
// the rays that cross a tile edge to the last pass moved fewer bytes but
// took longer on an H100: the extra step before each layer's products
// delayed them.)
__device__ __forceinline__ void ray_sums(const float (&acc)[64], float* rs,
                                         float* sl, int ld, int c0, int mw,
                                         int P, int S, int ray0, int ray1,
                                         int lane) {
  if (mw >= P) return;
  const int last = min(mw + 15, P - 1) / S;
  const int jj = 4 * ((lane >> 2) & 1) + 2 * ((lane >> 3) & 1)
                 + ((lane >> 4) & 1);
  for (int ray = mw / S; ray <= last; ++ray) {
    float* dst = (ray * S >= mw ? rs + (size_t)ray * ld
                                : sl + (size_t)(mw >> 4) * ld)
                 + c0 + 2 * (lane & 3);
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
      *reinterpret_cast<float2*>(dst + 8 * (8 * qt + jj)) =
          make_float2(x[0], x[1]);
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
    ray_sums(acc, L.rs_pre, L.sl_pre, L.rs_pre_ld, c0, mw, a.P, a.S, rays[0],
             rays[1], lane);
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
    ray_sums(acc, L.rs_post, L.sl_post, L.rs_post_ld, c0, mw, a.P, a.S,
             rays[0], rays[1], lane);
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

// ---------------------------------------------------------------- dW
//
// The weight gradients of every trunk layer in one launch: dW = X^T @ GH
// and db = sum GH over all points, X (P, M) a layer's stored bf16 input
// and GH (P, N) its bf16 output cotangent, as the dx chain wrote them.
// Replaces the TPU kernel's dW/db accumulators (_tile_backward's ``acc``,
// codenerf_tpu/ops/fused_train.py:297-302), which stay resident in VMEM
// over its sequential grid. Here the reduction axis is the points: a
// static list of (layer, point split) items, walked by persistent
// clusters of two blocks. Each block's two consumer warpgroups hold 128
// rows of the item's 256 x 256 f32 tile in registers, one wgmma
// m64n256k16 a warpgroup and 16 points, both operands MN-major (X^T and
// GH as stored: the instruction's transpose bits; one instruction shape,
// so that the accumulators fit the 168 registers a thread of a
// 384-thread block without spills), from a ring of 4 stages that a
// producer thread fills by TMA: per 64 points, 64-column boxes with the
// 128-byte swizzle of the block's rows of one plane and of the whole
// other plane, which both blocks need: each block loads half of those
// boxes and multicasts them to both, so every plane byte is read once
// from HBM. Three more warps of the producer group take the column sums
// for db from the GH boxes in shared memory. Each item writes its f32
// partial tile without atomics and fixed_sum_kernel adds the splits in
// a fixed order, so dW and db are the same bits on every run.
// What bounds it: bytes. dW reads the stored planes, 7,552 B a point at
// W=256, nb=3, nt=1 (768 for rgb_hidden, 1,024 for each square layer, 640
// for enc_xyz) against 884,736 FLOP: 3.55 ms at 3.35 TB/s for the
// training step's 1,572,864 points, 1.41 ms at 989 TFLOP/s.

constexpr int DW_CONSUMERS = 2;
constexpr int DW_THREADS = 128 * (DW_CONSUMERS + 1);
constexpr int DW_RING = 4;                  // stages of 64 points
constexpr int DW_BOX = 64 * 128;            // 64 points x 64 bf16 columns
constexpr int DW_B0 = 2;                    // first B box of a stage
constexpr int DW_STAGE = 6 * DW_BOX;        // 2 A boxes, 4 B boxes
// Point splits (at most): at nb=3, nt=1 the 8 tiles make 528 items, 8
// rounds of the 66 two-block clusters of an H100's 132 SMs.
constexpr int DW_SPLITS = 66;
constexpr int DW_DB_THREADS = 96;           // the producer group's warps 1-3
constexpr int DW_RED = 12 * 256;            // db row groups x columns
constexpr size_t DW_SMEM = 1024 + DW_RING * DW_STAGE + DW_RED * sizeof(float)
                           + 2 * DW_RING * sizeof(uint64_t);

// One item's output tile, 256 rows by up to 256 columns, computed by a
// cluster of two blocks: block r of the pair takes rows 128 r .. 128 r +
// 127 (two 64-column boxes of the A plane from column a0 + 128 r, a
// warpgroup each, wgmma m64n256) and both read the same four 64-column
// boxes of the B plane from column b0, which each block loads half of
// and multicasts to both (boxes past the plane's columns read as
// zeros). A is X and B is GH (dW), or with ``a_gh`` A is GH and B is X
// (dW^T: enc_xyz, whose X has 64 columns). The partial tile is stored
// with rows ``ld`` floats apart, its first ``nj`` column octets valid.
// Block r sums the db columns of its share: with GH in B, columns
// db_n r .. db_n (r + 1) - 1; with GH in A, its 128.
struct DwTile {
  int layer, a_gh, a0, b0, ld, nj, db_n;
};

struct DwArgs {
  CUtensorMap xmap[MAX_LAYERS];   // (P, M) bf16, 64 x 64 boxes, 128B swizzle
  CUtensorMap gmap[MAX_LAYERS];   // (P, N)
  int P, per_split, splits, ntiles;
  size_t split_elems;             // floats of one split's partials
  float* part;                    // [splits][split_elems]
  size_t off[MAX_LAYERS];         // a layer's partial tile in a split's
                                  // row: dW (M, N), dW^T for M = 64
  size_t off_b[MAX_LAYERS];       // and its db (N,)
  DwTile tile[2 * MAX_LAYERS];
};

// wgmma descriptor of an MN-major, 128-byte-swizzled operand at ``p``
// (1024-byte aligned): rows of 64 bf16 along M or N (128 B), one row per
// point; 8-point groups 1024 B apart (stride byte offset), 64-column
// blocks one box (8 KB) apart (leading byte offset).
__device__ __forceinline__ uint64_t mn_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)
         | ((uint64_t)(DW_BOX >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32)
         | ((uint64_t)1 << 62);
}

// A (64, 64) box at column c0, row (point) p0 of the tensor map into
// shared memory; the barrier's transaction count takes its arrival. Rows
// past the tensor's end read as zeros.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int p0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(p0), "r"(smem_u32(bar))
      : "memory");
}

// tma_box into the same offset of the shared memory of every block of
// the cluster in ``mask``, each block's barrier at ``bar``'s offset
// taking the bytes it receives.
__device__ __forceinline__ void tma_box_multicast(void* dst,
                                                  const CUtensorMap* map,
                                                  int c0, int p0,
                                                  uint64_t* bar,
                                                  uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(p0), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of both blocks of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// An arrival on the barrier at ``bar``'s offset in block ``rank`` of the
// cluster.
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      ::"r"(smem_u32(bar)), "r"(rank) : "memory");
}

// A warp's release of a stage: its lane 0 arrives on the stage's empty
// barrier in both blocks, which refill it together.
__device__ __forceinline__ void release_stage(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) {
    mbar_arrive_at(empty, 0);
    mbar_arrive_at(empty, 1);
  }
}

template <int NREG>
__device__ __forceinline__ void acc_fence(float (&d)[NREG]) {
#pragma unroll
  for (int i = 0; i < NREG; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ int dw_points(const DwArgs& a, int split,
                                         int* p0) {
  *p0 = split * a.per_split;
  const int p1 = min(a.P, *p0 + a.per_split);
  return (p1 - *p0 + 63) / 64;
}

// A consumer warpgroup's share of one item: the products over the split's
// points, then its 64 rows of the partial tile to ``part``.
__device__ __forceinline__ void dw_item(
    const DwArgs& a, const DwTile& T, int split, uint32_t rank,
    unsigned char* ring, uint64_t* full, uint64_t* empty, int& stage,
    uint32_t& phase, int wg, int warp, int lane) {
  float acc[128];
  int p0;
  const int nk = dw_points(a, split, &p0);
  int prev = -1;
  for (int ks = 0; ks < nk; ++ks) {
    mbar_wait(full + stage, phase);
    __syncwarp();
    const unsigned char* st = ring + stage * DW_STAGE;
    acc_fence(acc);
    wgmma_fence();
    const uint64_t da = mn_desc(st + wg * DW_BOX);
    const uint64_t db = mn_desc(st + DW_B0 * DW_BOX);
#pragma unroll
    for (int k = 0; k < 4; ++k)   // +16 points (2048 B) per k16 step
      wgmma_tt_n256(acc, da + 128 * k, db + 128 * k, ks | k);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();            // the previous stage's group is done
      release_stage(empty + prev, lane);
    }
    prev = stage;
    if (++stage == DW_RING) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  acc_fence(acc);
  if (prev >= 0) release_stage(empty + prev, lane);
  // Element i: row 16 w + l/4 + 8 (i/2 % 2), column 8 (i/4) + 2 (l % 4) +
  // i % 2 of the warpgroup's 64 x 256 tile.
  const int row = T.a0 + 128 * rank + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  float* dst = a.part + (size_t)split * a.split_elems + a.off[T.layer]
               + (size_t)row * T.ld + T.b0 + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float2* d2 = reinterpret_cast<float2*>(dst + 8 * T.ld * h);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (j < T.nj)
        d2[4 * j] = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// The db warps' share of one item: thread u (0..95) sums eight GH columns
// (octet u % n8 of the block's db_n, n8 = db_n / 8) over the rows r with
// r % g = u / n8 (g = 96 / n8 row groups) of every stage, in order, 16
// bytes a row; then the groups' sums are added in group order through
// ``red`` (named barrier 2) and written to ``part``.
__device__ __forceinline__ void db_item(const DwArgs& a, const DwTile& T,
                                        int split, uint32_t rank,
                                        unsigned char* ring, float* red,
                                        uint64_t* full, uint64_t* empty,
                                        int& stage, uint32_t& phase, int u,
                                        int lane) {
  int p0;
  const int nk = dw_points(a, split, &p0);
  const int dbn = T.a_gh ? 128 : T.db_n;
  const int n8 = dbn / 8, groups = DW_DB_THREADS / n8;
  const int oct = u % n8, grp = u / n8;
  // The share's first column in the stage's boxes, and its GH column.
  const int c0 = T.a_gh ? 0 : dbn * rank;
  const int g0 = T.a_gh ? T.a0 + 128 * rank : T.b0 + c0;
  const int c = c0 + 8 * oct;
  const int box = (T.a_gh ? 0 : DW_B0) + (c >> 6), chunk = (c & 63) >> 3;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int ks = 0; ks < nk; ++ks) {
    mbar_wait(full + stage, phase);
    const unsigned char* g = ring + stage * DW_STAGE + box * DW_BOX;
    for (int r = grp; r < 64; r += groups) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          g + r * 128 + ((chunk ^ (r & 7)) << 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 b2 = as_bf2(word_of(v, i));
        s[2 * i] += __low2float(b2);
        s[2 * i + 1] += __high2float(b2);
      }
    }
    release_stage(empty + stage, lane);
    if (++stage == DW_RING) { stage = 0; phase ^= 1; }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[grp * 256 + 8 * oct + i] = s[i];
  asm volatile("bar.sync 2, %0;\n" ::"n"(DW_DB_THREADS) : "memory");
  float* dst = a.part + (size_t)split * a.split_elems + a.off_b[T.layer] + g0;
  for (int col = u; col < dbn; col += DW_DB_THREADS) {
    float t = red[col];
    for (int q = 1; q < groups; ++q) t += red[q * 256 + col];
    dst[col] = t;
  }
  asm volatile("bar.sync 2, %0;\n" ::"n"(DW_DB_THREADS) : "memory");
}

// Launched in clusters of two blocks: cluster c walks items c, c + the
// number of clusters, ... (item = split * ntiles + tile), both blocks in
// step: a stage is refilled only when the consumers of both have released
// it (its empty barrier counts the warps of both), because each block's
// producer multicasts half of the B boxes into both.
__global__ void __launch_bounds__(DW_THREADS, 1) wgrad_kernel(
    const __grid_constant__ DwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* red = reinterpret_cast<float*>(ring + DW_RING * DW_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + DW_RED);
  uint64_t* empty = full + DW_RING;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = cluster_rank();
  const int items = a.splits * a.ntiles;
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;
  if (tid == 0) {
    for (int s = 0; s < DW_RING; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * (4 * DW_CONSUMERS + DW_DB_THREADS / 32));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();                    // both blocks' barriers are ready
  int stage = 0;
  uint32_t phase = 0;
  if (warp >= 4 * DW_CONSUMERS) {    // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pw = warp - 4 * DW_CONSUMERS;
    if (pw > 0) {                    // the db warps
      for (int it = cluster; it < items; it += clusters)
        db_item(a, a.tile[it % a.ntiles], it / a.ntiles, rank, ring, red,
                full, empty, stage, phase, 32 * (pw - 1) + lane, lane);
    } else if (lane == 0) {          // the TMA thread
      for (int it = cluster; it < items; it += clusters) {
        const int split = it / a.ntiles;
        const DwTile& T = a.tile[it % a.ntiles];
        int p0;
        const int nk = dw_points(a, split, &p0);
        const CUtensorMap* am =
            T.a_gh ? &a.gmap[T.layer] : &a.xmap[T.layer];
        const CUtensorMap* bm =
            T.a_gh ? &a.xmap[T.layer] : &a.gmap[T.layer];
        for (int ks = 0; ks < nk; ++ks) {
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect_tx(full + stage, 6 * DW_BOX);
          unsigned char* st = ring + stage * DW_STAGE;
          const int p = p0 + 64 * ks;
          for (int b = 0; b < 2; ++b)
            tma_box(st + b * DW_BOX, am, T.a0 + 128 * rank + 64 * b, p,
                    full + stage);
          for (int b = 2 * rank; b < 2 * rank + 2; ++b)
            tma_box_multicast(st + (DW_B0 + b) * DW_BOX, bm, T.b0 + 64 * b,
                              p, full + stage, 0x3);
          if (++stage == DW_RING) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {                            // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    for (int it = cluster; it < items; it += clusters)
      dw_item(a, a.tile[it % a.ntiles], it / a.ntiles, rank, ring, full,
              empty, stage, phase, warp >> 2, warp, lane);
  }
  __syncwarp();
  cluster_sync();   // no block leaves while its peer may still signal it
}

// dst[c] = sum over rows r of src[r * stride + c] (c transposed with
// ``tr``), for every segment in one launch: a block takes 32 columns of one segment, warp g the rows of
// its g-th eighth in order, then warp 0 adds the eight partial sums in
// order. A fixed order: the same bits on every run.
struct SumSeg {
  const float* src;
  float* dst;
  long long stride;
  int rows, cols;
  int tr;   // 0, or the columns of a row-major src matrix that dst holds
            // transposed
};

constexpr int MAX_SEGS = 2 * MAX_LAYERS + 4;

struct SumArgs {
  int n;
  int first[MAX_SEGS + 1];   // the segment's first block; first[n] = grid
  SumSeg s[MAX_SEGS];
};

__global__ void __launch_bounds__(256) fixed_sum_kernel(
    const __grid_constant__ SumArgs a) {
  __shared__ float part[8][32];
  int i = 0;
  while (i + 1 < a.n && a.first[i + 1] <= (int)blockIdx.x) ++i;
  const SumSeg& g = a.s[i];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int col = ((int)blockIdx.x - a.first[i]) * 32 + lane;
  const int per = (g.rows + 7) / 8, r0 = grp * per;
  const int r1 = min(g.rows, r0 + per);
  float s = 0.f;
  if (col < g.cols)
    for (int r = r0; r < r1; ++r) s += g.src[(size_t)r * g.stride + col];
  part[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && col < g.cols) {
    float t = part[0][lane];
#pragma unroll
    for (int q = 1; q < 8; ++q) t += part[q][lane];
    g.dst[g.tr ? (col % g.tr) * (g.cols / g.tr) + col / g.tr : col] = t;
  }
}

struct HeadArgs {
  int R, S;                // the trunk width is TW, rgb_hidden's TW / 2
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
  float* part;             // (head_blocks(R), head_part_cols(W)) or null:
                           // each block's sums for the sigma and rgb_out
                           // dW/db
  // The plane-op backward (all four or none): the outside (R, S) f32
  // cotangents of the sigma and r, g, b planes replace the composite and
  // the loss; gt8, se8, rgb8, weights and dz are then unused.
  const float* gsig;
  const float* gr;
  const float* gg;
  const float* gb;
};

// A row of head-kernel partial sums: [sigma dW (W) | rgb_out dW
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

// Where composite_pass reads a ray's planes and puts what its backward
// gives, sample s being slot q of its lane. ShRay: the head kernel's
// planes in shared memory, by s; its weights (global or shared) and delta
// cotangents (shared) where given; with ``accumulate`` the cotangents add
// to what a previous pass stored. RegRay<PL>: the standalone composite's,
// in registers, by q (the loops over q are unrolled; the arrays are the
// kernel's locals, each small enough to stay in registers).
struct ShRay {
  const float* pre;        // sigma pre-activations (or densities)
  const float* c;          // the three raw rgb planes, plane k at c[k * ld]
  float* gc;               // their cotangents, the same layout
  float* gs;               // the sigma cotangent
  float* w_out;            // or null
  float* dd;               // or null
  const float* z;          // the ray's depths (global)
  int ld;
  bool accumulate;
  __device__ __forceinline__ float sig(int, int s) const {
    return pre[s];
  }
  __device__ __forceinline__ float col(int k, int, int s) const {
    return c[k * ld + s];
  }
  __device__ __forceinline__ float depth(int, int s) const { return z[s]; }
  __device__ __forceinline__ float next_depth(int, int s) const {
    return z[s + 1];
  }
  __device__ __forceinline__ void weight(int, int s, float w) const {
    if (w_out) w_out[s] = w;
  }
  __device__ __forceinline__ void grads(int, int s, float gsig,
                                        float ddelta, float w,
                                        const float* g) const {
    gs[s] = accumulate ? gs[s] + gsig : gsig;
    if (dd) dd[s] = ddelta;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gc[k * ld + s] = accumulate ? gc[k * ld + s] + w * g[k] : w * g[k];
  }
};

template <int PL>
struct RegRay {            // references to the kernel's own arrays
  float (&sg)[PL];
  float (&c)[3][PL];
  float (&z)[PL];
  float (&w)[PL];
  float (&gs)[PL];
  float (&gc)[3][PL];
  float (&dd)[PL];
  float zn;                // the next lane's first depth
  int per;                 // the lane's samples, (S + 31) / 32 <= PL
  __device__ __forceinline__ float sig(int q, int) const { return sg[q]; }
  __device__ __forceinline__ float col(int k, int q, int) const {
    return c[k][q];
  }
  __device__ __forceinline__ float depth(int q, int) const { return z[q]; }
  __device__ __forceinline__ float next_depth(int q, int) const {
    return q + 1 < per ? z[q + 1 < PL ? q + 1 : q] : zn;
  }
  __device__ __forceinline__ void weight(int q, int, float v) { w[q] = v; }
  __device__ __forceinline__ void grads(int q, int, float gsig,
                                        float ddelta, float wq,
                                        const float* g) {
    gs[q] = gsig;
    dd[q] = ddelta;
#pragma unroll
    for (int k = 0; k < 3; ++k) gc[k][q] = wq * g[k];
  }
};

// One composite of a ray and its backward, run by one warp; lane l owns
// the contiguous samples [l*per, l*per + per), per <= PL, read and written
// through ``io`` (ShRay or RegRay). ``io.sig`` gives the sigma
// pre-activations (softplus applied here) or, with ``density``, the
// densities themselves; ``io.col`` the three raw rgb planes. Sample s has
// the delta ``cdelta[s]`` and the cumprod factor e_s + 1e-10 * cmask[s]
// when the dual mode's coarse planes are given; else the union delta
// z[s+1] - z[s] (1e10 at the last sample) and e_s + 1e-10. Without
// ``backward`` the pass stops at the composited ray. The backward takes
// the per-ray cotangent ``g8`` [r g b depth acc] when given (the
// standalone composite) and otherwise forms the loss's, 2 * scale * (rgb -
// gt) with no depth or acc term, and its squared error. It hands
// ``io.grads`` each sample's sigma cotangent (before the softplus
// derivative), its delta cotangent dx_s * sig_s (0 at the last sample),
// from which the caller forms the composite's z cotangent, and its rgb
// cotangents w_s * g_k; ``io.weight`` each weight w_s. The association
// order (a per-lane product, the warp scan, the per-lane sums, warp_sum)
// is the same for every ``io``, so both give the same bits.
template <int PL, class Ray>
__device__ __forceinline__ CompositeOut composite_pass(
    const HeadArgs& h, int ray, int lane, Ray& io, const float* cmask,
    const float* cdelta, bool density = false, const float* g8 = nullptr,
    bool backward = true) {
  const int S = h.S;
  const int per = (S + 31) / 32;
  float e_[PL], u_[PL], T_[PL], w_[PL], dl_[PL], sg_[PL];
  float loc = 1.f;
#pragma unroll
  for (int q = 0; q < PL; ++q) {
    const int s = lane * per + q;
    e_[q] = 1.f; u_[q] = 1.f; dl_[q] = 0.f; T_[q] = loc; sg_[q] = 0.f;
    if (q < per && s < S) {
      const float x = io.sig(q, s);
      const float sig = density ? x : fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
      sg_[q] = sig;
      if (cdelta) {
        dl_[q] = cdelta[s];
        e_[q] = expf(-sig * dl_[q]);
        u_[q] = e_[q] + 1e-10f * cmask[s];
      } else {
        dl_[q] = (s < S - 1) ? io.next_depth(q, s) - io.depth(q, s)
                             : 1e10f;
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
  for (int q = 0; q < PL; ++q) {
    const int s = lane * per + q;
    w_[q] = 0.f;
    if (q < per && s < S) {
      T_[q] *= excl;
      w_[q] = (1.f - e_[q]) * T_[q];
      io.weight(q, s, w_[q]);
      rs0 += w_[q] * io.col(0, q, s);
      rs1 += w_[q] * io.col(1, q, s);
      rs2 += w_[q] * io.col(2, q, s);
      dep += w_[q] * io.depth(q, s);
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
  float wdw[PL], dw[PL], lsum = 0.f;
#pragma unroll
  for (int q = 0; q < PL; ++q) {
    const int s = lane * per + q;
    dw[q] = 0.f; wdw[q] = 0.f;
    if (q < per && s < S) {
      dw[q] = g[0] * io.col(0, q, s) + g[1] * io.col(1, q, s)
              + g[2] * io.col(2, q, s) + resid;
      if (g8) dw[q] += gd * io.depth(q, s);
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
  for (int q = PL - 1; q >= 0; --q) {
    const int s = lane * per + q;
    if (q < per && s < S) {
      const float dL = run;
      run += wdw[q];
      const float dx = e_[q] * (T_[q] * dw[q] - dL / u_[q]);
      io.grads(q, s, dx * dl_[q], (s < S - 1) ? dx * sg_[q] : 0.f, w_[q],
               g);
    }
  }
  return out;
}

// The head kernel: one warp per ray, HEAD_WARPS rays per block. Replaces
// the TPU kernel's head (_train_kernel, codenerf_tpu/ops/fused_train.py:
// 560-612: the sigma and rgb heads, fused_mlp.composite_fwd_in_kernel and
// composite_bwd_in_kernel, and the sigma dW of _tile_backward, :331-336).
// What bounds it: bytes. It reads t and r once (768 B a point at W=256)
// and writes g_r and dsig (260 B): 0.48 ms at 3.35 TB/s for 16,384 x 96.
//   1. Per group of 8 samples each lane loads its 8 columns of t and 4 of
//      r (16 and 8 bytes) and forms its parts of the sigma and rgb dots
//      against the w_sig and w_rgb columns it keeps in registers; a
//      shuffle ladder leaves the warp's 32 sums one per lane. The ReLU
//      mask of r goes to shared memory as bits (16 B a sample).
//   2. The composite, loss and composite backward (composite_pass), then
//      dsig = g_sigma * sigmoid(sig_pre) and the bf16-rounded rgb
//      cotangents.
//   3. g_r = mask * (gc . w_rgb^T), rounded to bf16: half a warp per
//      sample, 16-byte stores.
//   4. With ``part`` (weight gradients): the ray's sums over its samples,
//      in sample order (the sigma dW from t and dsig, the rgb_out dW from
//      r and the rounded rgb cotangents, both db), which take the second
//      pass over t and r; the block adds its warps' rows in warp order
//      into one row of ``part``.
constexpr int HEAD_WARPS = 8;
constexpr int HEAD_THREADS = 32 * HEAD_WARPS;

__host__ __device__ constexpr int head_ld(int S) { return (S + 3) & ~3; }

// Per warp: s_mask [S][4] words, s_pre, s_c[3], s_gc[3], s_dsig, s_dd
// (planes head_ld(S) floats apart), or with weight gradients, after the
// rays, the block's HEAD_WARPS partial rows.
__host__ __device__ constexpr size_t head_smem(int S, int W, bool part) {
  const size_t rays = sizeof(float) * HEAD_WARPS * 13 * (size_t)head_ld(S);
  const size_t rows = sizeof(float) * HEAD_WARPS * (size_t)head_part_cols(W);
  return part && rows > rays ? rows : rays;
}

__host__ __device__ constexpr int head_blocks(int R) {
  return (R + HEAD_WARPS - 1) / HEAD_WARPS;
}

__global__ void __launch_bounds__(HEAD_THREADS, 2) head_kernel(HeadArgs h) {
  extern __shared__ float4 head_smem_raw[];
  float* hs = reinterpret_cast<float*>(head_smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = h.S, ld = head_ld(S);
  constexpr int W = TW, Wh = TW / 2;
  const int ray = blockIdx.x * HEAD_WARPS + warp;
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(hs + (size_t)warp * 13 * ld);
  float* s_pre = hs + (size_t)warp * 13 * ld + 4 * ld;
  float* s_c = s_pre + ld;           // 3 planes
  float* s_gc = s_c + 3 * ld;        // 3 planes
  float* s_dsig = s_gc + 3 * ld;
  float* s_dd = s_dsig + ld;
  float pt[8] = {}, pr[12] = {}, pb = 0.f;   // phase 4's sums
  if (ray < h.R) {
    const size_t p0 = (size_t)ray * S;
    const bf16* tr = h.t + p0 * W + 8 * lane;
    const bf16* rr = h.r + p0 * Wh + 4 * lane;

    // Phase 1: sigma pre-activation and raw rgb of every sample.
    float ws[8], wr[12];
#pragma unroll
    for (int i = 0; i < 8; ++i) ws[i] = h.w_sig[8 * lane + i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        wr[3 * i + k] = bf(h.w_rgb[(4 * lane + i) * 8 + k]);
    for (int s0 = 0; s0 < S; s0 += 8) {
      uint4 tv[8];
      uint2 rv[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const bool ok = s0 + q < S;
        const size_t s = (size_t)(s0 + q);
        tv[q] = ok ? __ldg(reinterpret_cast<const uint4*>(tr + s * W))
                   : make_uint4(0u, 0u, 0u, 0u);
        rv[q] = ok ? __ldg(reinterpret_cast<const uint2*>(rr + s * Wh))
                   : make_uint2(0u, 0u);
      }
      float x[32];   // x[4 q + u]: sample s0 + q; u 0 sigma, 1..3 rgb
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float a = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 t2 = as_bf2(word_of(tv[q], i));
          a += __low2float(t2) * ws[2 * i];
          a += __high2float(t2) * ws[2 * i + 1];
        }
        const __nv_bfloat162 r01 = as_bf2(rv[q].x), r23 = as_bf2(rv[q].y);
        const float rvals[4] = {__low2float(r01), __high2float(r01),
                                __low2float(r23), __high2float(r23)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          c0 += rvals[i] * wr[3 * i];
          c1 += rvals[i] * wr[3 * i + 1];
          c2 += rvals[i] * wr[3 * i + 2];
          const uint32_t b = __ballot_sync(FULL, rvals[i] > 0.f);
          if (lane == i && s0 + q < S) s_mask[4 * (s0 + q) + i] = b;
        }
        x[4 * q] = a; x[4 * q + 1] = c0; x[4 * q + 2] = c1; x[4 * q + 3] = c2;
      }
      reduce_step<16>(x, 16, lane);
      reduce_step<8>(x, 8, lane);
      reduce_step<4>(x, 4, lane);
      reduce_step<2>(x, 2, lane);
      reduce_step<1>(x, 1, lane);
      const int s = s0 + (lane >> 2), u = lane & 3;
      if (s < S) {
        if (u == 0) s_pre[s] = x[0] + h.b_sig[0];
        else s_c[(u - 1) * ld + s] = x[0] + h.b_rgb[u - 1];
      }
    }
    __syncwarp();

    // Phase 2: the composite forward, the loss and the composite
    // backward; in the dual mode a second pass over the coarse planes,
    // whose cotangents add to the first's. In the plane-op backward the
    // outside plane cotangents take the composite's place. Then dsig =
    // g_sigma * sigmoid(sig_pre) and the bf16 rgb cotangents, with the
    // same sample ownership. With ``weights`` the pass writes w_s; with
    // ``dz`` the composite's z cotangent dz_s = ddelta_{s-1} - ddelta_s
    // (the loss's depth lane is masked, so the TPU kernel's gd * w_s term
    // is 0).
    const int per = (S + 31) / 32;
    CompositeOut f = {};
    float se_c[3] = {0.f, 0.f, 0.f};
    if (h.gsig) {
      for (int q = 0; q < per; ++q) {
        const int s = lane * per + q;
        if (s < S) {
          s_dsig[s] = h.gsig[p0 + s];
          s_gc[s] = h.gr[p0 + s];
          s_gc[ld + s] = h.gg[p0 + s];
          s_gc[2 * ld + s] = h.gb[p0 + s];
        }
      }
    } else {
      ShRay io = {s_pre, s_c, s_gc, s_dsig,
                  h.weights ? h.weights + p0 : nullptr,
                  h.dz ? s_dd : nullptr, h.z + p0, ld, false};
      f = composite_pass<MAX_PER_LANE>(h, ray, lane, io, nullptr, nullptr);
      if (h.cmask) {
        ShRay io_c = {s_pre, s_c, s_gc, s_dsig, nullptr, nullptr, h.z + p0,
                      ld, true};
        const CompositeOut c = composite_pass<MAX_PER_LANE>(
            h, ray, lane, io_c, h.cmask + p0, h.cdelta + p0);
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
        for (int k = 0; k < 3; ++k)
          s_gc[k * ld + s] = round_bf(s_gc[k * ld + s]);
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
    __syncwarp();

    // Phase 3: rgb_out backward and the rgb_hidden ReLU mask. Lane l
    // writes columns 8 j .. 8 j + 7 (j = l % 16) of sample s: column c's
    // mask bit is bit c / 4 of the sample's word c % 4.
    {
      const int j = lane & 15;
      float w3[8][3];
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int k = 0; k < 3; ++k) w3[e][k] = bf(h.w_rgb[(8 * j + e) * 8 + k]);
      for (int s = lane >> 4; s < S; s += 2) {
        const float g0 = s_gc[s], g1 = s_gc[ld + s], g2 = s_gc[2 * ld + s];
        const uint4 m = *reinterpret_cast<const uint4*>(s_mask + 4 * s);
        uint32_t out[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float v[2];
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const int c = e + d;
            const float val = g0 * w3[c][0] + g1 * w3[c][1] + g2 * w3[c][2];
            const uint32_t bit = (word_of(m, c & 3) >> (2 * j + (c >> 2))) & 1u;
            v[d] = bit ? val : 0.f;
          }
          out[e / 2] = as_u32(__floats2bfloat162_rn(v[0], v[1]));
        }
        *reinterpret_cast<uint4*>(h.g_r + (p0 + s) * Wh + 8 * j) =
            make_uint4(out[0], out[1], out[2], out[3]);
      }
    }

    // Phase 4 (weight gradients): this ray's sums over its samples.
    if (h.part) {
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const uint4 tv =
            __ldg(reinterpret_cast<const uint4*>(tr + (size_t)s * W));
        const uint2 rv =
            __ldg(reinterpret_cast<const uint2*>(rr + (size_t)s * Wh));
        const float ds = s_dsig[s];
        const float g[3] = {s_gc[s], s_gc[ld + s], s_gc[2 * ld + s]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 t2 = as_bf2(word_of(tv, i));
          pt[2 * i] += __low2float(t2) * ds;
          pt[2 * i + 1] += __high2float(t2) * ds;
        }
        const __nv_bfloat162 r01 = as_bf2(rv.x), r23 = as_bf2(rv.y);
        const float rvals[4] = {__low2float(r01), __high2float(r01),
                                __low2float(r23), __high2float(r23)};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 3; ++k) pr[3 * i + k] += rvals[i] * g[k];
      }
      if (lane < 4)
        for (int s = 0; s < S; ++s)
          pb += lane < 3 ? s_gc[lane * ld + s] : s_dsig[s];
    }
  }
  if (!h.part) return;

  // The block's rows: [sigma dW (W) | rgb_out dW (W/2 x 8) | rgb_out db
  // (8) | sigma db (1) | 0 (7)], warps added in order.
  const int HP = head_part_cols(W);
  __syncthreads();   // every warp is done with its arrays
  float* row = hs + (size_t)warp * HP;
#pragma unroll
  for (int i = 0; i < 8; ++i) row[8 * lane + i] = pt[i];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      row[W + (4 * lane + i) * 8 + k] = k < 3 ? pr[3 * i + k] : 0.f;
  const float b = __shfl_sync(FULL, pb, lane < 3 ? lane : 3);
  if (lane < 16)
    row[W + Wh * 8 + lane] = (lane < 3 || lane == 8) ? b : 0.f;
  __syncthreads();
  for (int c = threadIdx.x; c < HP; c += HEAD_THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < HEAD_WARPS; ++w) a += hs[(size_t)w * HP + c];
    h.part[(size_t)blockIdx.x * HP + c] = a;
  }
}

#define CHECK(call)            \
  do {                         \
    const int rc_ = (call);    \
    if (rc_ != 0) return rc_;  \
  } while (0)

struct InputArgs {
  int R, S, n_freq;
  const bf16* gh0;         // (P, TW): enc_xyz's output cotangent, masked
  const bf16* w_enc;       // (64, TW): enc_xyz's weight (in, out)
  const float* ro8;        // (R, 8)
  const float* vd8;        // (R, 8)
  const float* z;          // (R, S)
  float* d_z;              // (R, S): holds the composite's dz; += xyz term
  float* d_ro8;            // (R, 8)
  float* d_vd8;            // (R, 8)
};

// The input chain's tiling: 4 warps a block (a 16-row tile each), two
// blocks an SM; W_enc (32 KB) once per block, a ring of two stages of 64
// gh0 rows (32 KB each), and a ring of the points' (d_xyz, z) rows for
// the per-ray sums, long enough for a chunk, the next one and a ray.
constexpr int IC_THREADS = 128;
constexpr int IC_BLOCKS_PER_SM = 2;
constexpr int IC_ROWS = 64;
constexpr int IC_ROW_BYTES = TW * 2;
constexpr int IC_STAGE_BYTES = IC_ROWS * IC_ROW_BYTES;
constexpr int IC_W_BYTES = 64 * IC_ROW_BYTES;
constexpr int IC_RING = 2 * IC_ROWS + MAX_S;
constexpr int IC_PE_LD = 72;      // floats a row of a warp's d_pe tile
constexpr size_t IC_SMEM = IC_W_BYTES + 2 * IC_STAGE_BYTES
                           + IC_RING * sizeof(float4);
static_assert(16 * IC_PE_LD * 4 <= 16 * IC_ROW_BYTES,
              "a warp's d_pe tile fits in its own gh0 rows");

// Byte offset of 16-byte chunk c of row r in a staged (rows, 256) bf16
// tile: the chunk index XOR (r mod 8), so that the 8 row addresses of
// one ldmatrix fall in 8 different bank groups.
__device__ __forceinline__ uint32_t ic_swz(int r, int c) {
  return (uint32_t)(r * IC_ROW_BYTES + ((c ^ (r & 7)) << 4));
}

// cp.async of ``rows`` contiguous (TW,) bf16 rows into a swizzled tile.
__device__ __forceinline__ void ic_stage_rows(unsigned char* dst,
                                              const bf16* src, int rows) {
  for (int i = threadIdx.x; i < rows * (IC_ROW_BYTES / 16);
       i += IC_THREADS) {
    const int r = i / (IC_ROW_BYTES / 16), c = i % (IC_ROW_BYTES / 16);
    cp_async16(dst + ic_swz(r, c), src + (size_t)r * TW + c * 8, 16);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The input chain of the pose modes (the TPU kernel's input_grads tail,
// codenerf_tpu/ops/fused_train.py:615-626 in _train_kernel, :434-443 in
// _bwd_kernel): per point d_pe = gh0 . W_enc^T (64 lanes, f32 sums of
// bf16 products), the PE Jacobian dpe/dt (1, cos t, -sin t) with
// t = xyz * 2^i, and d_xyz = (d_pe * dpe/dt) . A^T; then d_z += d_xyz . vd
// per point, and per ray d_ro = sum_s d_xyz and d_vd = sum_s d_xyz * z_s.
//
// Bound by bytes: gh0 is 512 B a point of the ~525 B it must move (z,
// d_z read and written, the per-ray rows), 0.031 ms at 2048 x 96 on an
// H100 at 3.35 TB/s; the product is 32,768 FLOP a point, a fifth of that
// time on the tensor cores. The design streams gh0 once:
// - persistent blocks, two per SM, each staging W_enc once (32 KB,
//   cp.async, in its stored (64, W) layout: that is the "col" B operand
//   of d_pe = gh0 . W_enc^T as it lies, no transpose);
// - each block owns a contiguous range of whole rays and streams their
//   gh0 rows in 64-row chunks through a two-stage ring, the next chunk
//   loading while this one computes (a ragged last chunk is masked);
// - the product on tensor cores, mma.sync m16n8k16 bf16 with f32
//   accumulators from ldmatrix of XOR-swizzled tiles: 16 rows x 64
//   columns a warp, 32 accumulators a thread; the row's z, d_z, ro and vd
//   load before it, so their latency hides behind the products;
// - the PE Jacobian in registers: the warp's d_pe tile goes to shared
//   memory (over its own dead gh0 rows), then each lane takes one row and
//   half the frequencies, and one precise sincosf per (coordinate,
//   frequency) serves both the sin and the cos lane (never __sinf: at
//   t = x * 2^9 the fast versions are wrong in the leading digits); the
//   two halves meet with one shuffle;
// - each point's d_xyz updates d_z and goes, with its z, into the ring;
//   a warp per ray sums d_ro8 and d_vd8 over its samples (lane-strided,
//   then a butterfly) once the chunk that ends the ray is done.
// Every sum runs in a fixed order and there are no atomics, so d_ro8,
// d_vd8 and d_z are the same bits on every launch.
__global__ void __launch_bounds__(IC_THREADS, IC_BLOCKS_PER_SM)
    input_chain_kernel(InputArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_w = smem;
  auto s_stage = [&](int q) {       // ring stage of chunk q
    return smem + IC_W_BYTES + (q & 1) * IC_STAGE_BYTES;
  };
  float4* s_ring = reinterpret_cast<float4*>(smem + IC_W_BYTES
                                             + 2 * IC_STAGE_BYTES);
  const int S = a.S, F = a.n_freq;
  const size_t ray_lo = (size_t)a.R * blockIdx.x / gridDim.x;
  const size_t ray_hi = (size_t)a.R * (blockIdx.x + 1) / gridDim.x;
  const size_t row_lo = ray_lo * S, row_hi = ray_hi * S;
  const int nq = (int)((row_hi - row_lo + IC_ROWS - 1) / IC_ROWS);
  if (nq == 0) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto chunk_row0 = [&](int q) { return row_lo + (size_t)q * IC_ROWS; };
  auto chunk_rows = [&](int q) {
    const size_t left = row_hi - chunk_row0(q);
    return left < (size_t)IC_ROWS ? (int)left : IC_ROWS;
  };
  // The rays whose last sample lies in chunk q: a warp each.
  auto ray_sums = [&](int q) {
    const size_t a0 = chunk_row0(q), b0 = a0 + chunk_rows(q);
    for (size_t ray = a0 / S + warp; ray < b0 / S; ray += IC_THREADS / 32) {
      float sro[3] = {0.f, 0.f, 0.f}, svd[3] = {0.f, 0.f, 0.f};
      for (int s = lane; s < S; s += 32) {
        const float4 v = s_ring[(ray * S + s) % IC_RING];
        sro[0] += v.x; sro[1] += v.y; sro[2] += v.z;
        svd[0] += v.x * v.w; svd[1] += v.y * v.w; svd[2] += v.z * v.w;
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        sro[d] = warp_sum(sro[d]);
        svd[d] = warp_sum(svd[d]);
      }
      if (lane < 16) {
        const int d = lane & 7;
        const float v = d == 0 ? (lane < 8 ? sro[0] : svd[0])
                      : d == 1 ? (lane < 8 ? sro[1] : svd[1])
                      : d == 2 ? (lane < 8 ? sro[2] : svd[2]) : 0.f;
        (lane < 8 ? a.d_ro8 : a.d_vd8)[ray * 8 + d] = v;
      }
    }
  };

  ic_stage_rows(s_w, a.w_enc, 64);
  ic_stage_rows(s_stage(0), a.gh0 + row_lo * TW, chunk_rows(0));
  cp_async_commit();
  const int grp = lane >> 2, tig = lane & 3;
  const int r = lane & 15, h = lane >> 4;     // the Jacobian's row, half
  const int H = (F + 1) / 2;                  // frequencies a half takes
  const uint32_t w_base = smem_u32(s_w);
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<0>();
    __syncthreads();         // chunk q landed; chunk q - 1 fully done
    if (q + 1 < nq) {
      ic_stage_rows(s_stage(q + 1), a.gh0 + chunk_row0(q + 1) * TW,
                    chunk_rows(q + 1));
      cp_async_commit();
    }
    if (q > 0) ray_sums(q - 1);
    const int rows = chunk_rows(q);
    if (16 * warp >= rows) continue;
    const int lr = 16 * warp + r;
    const bool valid = lr < rows;
    const size_t p = chunk_row0(q) + (valid ? lr : 0);
    const size_t ray = p / S;
    const float zs = a.z[p], dz_old = a.d_z[p];
    float ro[3], vd[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      ro[d] = a.ro8[ray * 8 + d];
      vd[d] = a.vd8[ray * 8 + d];
    }

    unsigned char* tile = s_stage(q) + 16 * warp * IC_ROW_BYTES;
    const uint32_t a_base = smem_u32(tile);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const int m = lane >> 3;
#pragma unroll 4
    for (int ks = 0; ks < TW / 16; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, a_base + ic_swz(r, 2 * ks + h));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int brow = 16 * np + 8 * (m >> 1) + (lane & 7);
        uint32_t bf4[4];
        ldmatrix_x4(bf4, w_base + ic_swz(brow, 2 * ks + (m & 1)));
        mma_bf16_16816(acc[2 * np], af, bf4[0], bf4[1]);
        mma_bf16_16816(acc[2 * np + 1], af, bf4[2], bf4[3]);
      }
    }
    // d_pe (16, 64) f32 over the warp's own gh0 rows, which are dead now.
    __syncwarp();
    float* pe = reinterpret_cast<float*>(tile);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(pe + grp * IC_PE_LD + col) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(pe + (grp + 8) * IC_PE_LD + col) =
          make_float2(acc[j][2], acc[j][3]);
    }
    __syncwarp();
    // Row r, frequencies [h H, h H + H): the sin lane 3 + 3i + d takes
    // dt = cos t, the cos lane 3 + 3F + 3i + d dt = -sin t; half 0 also
    // the identity lanes.
    const float* row = pe + r * IC_PE_LD;
    float x[3], dxyz[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      x[d] = __fadd_rn(ro[d], __fmul_rn(vd[d], zs));
      dxyz[d] = h == 0 ? row[d] : 0.f;
    }
#pragma unroll
    for (int f = 0; f < 5; ++f) {
      const int i = h * H + f;
      if (f < H && i < F) {
        const float scale = (float)(1 << i);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float sn, cs;
          sincosf(x[d] * scale, &sn, &cs);
          dxyz[d] += (row[3 + 3 * i + d] * cs) * scale;
          dxyz[d] += (row[3 + 3 * F + 3 * i + d] * -sn) * scale;
        }
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d)
      dxyz[d] += __shfl_xor_sync(FULL, dxyz[d], 16);
    if (valid && h == 0) {
      a.d_z[p] = dz_old
                 + ((dxyz[0] * vd[0] + dxyz[1] * vd[1]) + dxyz[2] * vd[2]);
      s_ring[p % IC_RING] = make_float4(dxyz[0], dxyz[1], dxyz[2], zs);
    }
  }
  __syncthreads();
  ray_sums(nq - 1);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// The code cotangents' last pass: replaces the ``.astype(bf16)`` of the
// per-ray sums in codenerf_tpu/ops/fused_train.py::_train_kernel and
// _bwd_kernel (:321, :323, :345). The dx chain's ray_sums leave the three
// cotangents in two f32 spans, each laid out s | t | v: ``x``, R rows of
// (nb + nt + 1) x W, each ray's partial sum over the 16-point slice where
// it starts, and ``sl``, a row a slice, the partial of the ray that
// started before the slice. This pass adds a ray's rows left to right
// (its own row, then the row of each later slice it touches), so every
// launch gives the same bits, and rounds each sum to bf16. Bound by
// bytes: 4 B a value of each row read, 2 B a value out. A thread takes 8
// values of one ray's row: 16-byte loads (the read-only path),
// round-to-nearest-even pair conversions (x.to(torch.bfloat16)'s and
// jnp.astype's rounding), one 16-byte store into the output its offset
// falls in; W is a multiple of 8, so no group straddles two outputs.
constexpr int RS_THREADS = 256;
constexpr int RS_BLOCKS_PER_SM = 8;   // 2048 threads, 32 B in flight each

__device__ __forceinline__ void add8(float4& lo, float4& hi, const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  lo.x += a.x; lo.y += a.y; lo.z += a.z; lo.w += a.w;
  hi.x += b.x; hi.y += b.y; hi.z += b.z; hi.w += b.w;
}

__global__ void __launch_bounds__(RS_THREADS, RS_BLOCKS_PER_SM)
    ray_sum_fold_kernel(const float* __restrict__ x,
                        const float* __restrict__ sl, bf16* d_s, bf16* d_t,
                        bf16* d_v, int R, int S, int nb, int nt, int W) {
  // 32-bit offsets: launch_fold checks that both spans fit.
  const unsigned rows = ((unsigned)R * S + 15) / 16;
  const unsigned n_s = (unsigned)R * nb * W, n_st = n_s + (unsigned)R * nt * W;
  const unsigned n = n_st + (unsigned)R * W;
  for (unsigned i = 8 * (blockIdx.x * RS_THREADS + threadIdx.x); i < n;
       i += 8 * gridDim.x * RS_THREADS) {
    unsigned k = i, row = nb * W, base_sl = 0;
    bf16* out = d_s;
    if (i >= n_st) {
      k = i - n_st; row = W; base_sl = rows * (nb + nt) * W; out = d_v;
    } else if (i >= n_s) {
      k = i - n_s; row = nt * W; base_sl = rows * nb * W; out = d_t;
    }
    const unsigned ray = k / row, col = k - ray * row;
    const unsigned s1 = (ray * S + S - 1) / 16;
    float4 lo = __ldg(reinterpret_cast<const float4*>(x + i));
    float4 hi = __ldg(reinterpret_cast<const float4*>(x + i + 4));
    for (unsigned t = ray * S / 16 + 1; t <= s1; ++t)
      add8(lo, hi, sl + base_sl + t * row + col);
    __align__(16) __nv_bfloat162 y[4] = {
        __float22bfloat162_rn(make_float2(lo.x, lo.y)),
        __float22bfloat162_rn(make_float2(lo.z, lo.w)),
        __float22bfloat162_rn(make_float2(hi.x, hi.y)),
        __float22bfloat162_rn(make_float2(hi.z, hi.w))};
    *reinterpret_cast<uint4*>(out + k) = *reinterpret_cast<const uint4*>(y);
  }
}

// One ray_sum_fold_kernel launch over ``x`` (R x (nb + nt + 1) x W f32)
// and ``sl`` (slices x (nb + nt + 1) x W, slices = ceil(R S / 16))
// into d_s (R, nb, W), d_t (R, nt, W) and d_v (R, W) bf16, all 16-byte
// aligned; at most four waves of resident blocks, which then stride.
int launch_fold(const float* x, const float* sl, bf16* d_s, bf16* d_t,
                bf16* d_v, int R, int S, int nb, int nt, int W,
                cudaStream_t stream) {
  auto misaligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 != 0;
  };
  if (R < 1 || S < 1 || nb < 1 || nt < 1 || W < 8 || W % 8
      || misaligned(x) || misaligned(sl) || misaligned(d_s)
      || misaligned(d_t) || misaligned(d_v))
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)R * (nb + nt + 1) * W;
  const size_t n_sl = (((size_t)R * S + 15) / 16) * (nb + nt + 1) * W;
  if (n_sl >= (1ull << 32) || n >= (1ull << 31))
    return (int)cudaErrorInvalidValue;
  const size_t need = (n / 8 + RS_THREADS - 1) / RS_THREADS;
  const size_t cap = (size_t)sm_count() * RS_BLOCKS_PER_SM * 4;
  ray_sum_fold_kernel<<<(unsigned)(need < cap ? need : cap), RS_THREADS, 0,
                        stream>>>(x, sl, d_s, d_t, d_v, R, S, nb, nt, W);
  return (int)cudaGetLastError();
}

// One input_chain_kernel launch: two persistent blocks an SM (at most
// one a ray), W_enc and the rings in dynamic shared memory.
int launch_input_chain(const InputArgs& a, cudaStream_t stream) {
  if (a.R < 1 || a.S < 1 || a.S > MAX_S || a.n_freq < 0
      || 3 + 6 * a.n_freq > 64)
    return (int)cudaErrorInvalidValue;
  CHECK((int)cudaFuncSetAttribute(
      input_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)IC_SMEM));
  const int most = IC_BLOCKS_PER_SM * sm_count();
  const int blocks = a.R < most ? a.R : most;
  input_chain_kernel<<<blocks, IC_THREADS, IC_SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- dW host

// A tensor map of a (P, C) row-major bf16 plane in 64-point x 64-column
// boxes with the 128-byte swizzle. cuTensorMapEncodeTiled is looked up
// through the CUDA runtime's entry-point query, so the library needs no
// -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int plane_map(CUtensorMap* m, const bf16* base, int P, int C) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)P};
  const cuuint64_t strides[1] = {(cuuint64_t)C * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64}, step[2] = {1, 1};
  const CUresult rc = fn(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// One layer's weight gradient: dw (M, N) = x^T @ g and db (N,) = column
// sums of g over P points; x (P, M) and g (P, N) bf16.
struct DwPair {
  const bf16* x;
  const bf16* g;
  int M, N;
  float* dw;
  float* db;
};

// The shapes of the trunk at W = 256: square layers, rgb_hidden
// (256, 128), enc_xyz (64, 256).
bool dw_shape_ok(int M, int N) {
  return (M == 256 && (N == 256 || N == 128)) || (M == 64 && N == 256);
}

// How the points split: at most DW_SPLITS splits of whole 64-point
// slices, from P alone (never from the card), so the order of the sums
// is fixed.
struct DwPlan {
  int splits, per_split;
};

DwPlan dw_plan(int P) {
  const int slices = (P + 63) / 64;
  const int per = (slices + DW_SPLITS - 1) / DW_SPLITS;
  return {per > 0 ? (slices + per - 1) / per : 0, 64 * per};
}

size_t dw_row_elems(const DwPair* L, int n) {
  size_t e = 0;
  for (int l = 0; l < n; ++l) e += (size_t)L[l].M * L[l].N + L[l].N;
  return e;
}

// Workspace (f32 elements) of launch_wgrad: one partial row per split.
size_t dw_part_elems(const DwPair* L, int n, int P) {
  return (size_t)dw_plan(P).splits * dw_row_elems(L, n);
}

// Every pair's dW and db in one wgrad_kernel launch (partials in
// ``part``) and one fixed_sum_kernel launch, which also sums the
// ``extra`` segments (the head kernel's rows).
int launch_wgrad(const DwPair* L, int n, int P, float* part,
                 const SumSeg* extra, int n_extra, cudaStream_t stream) {
  if (n < 1 || n > MAX_LAYERS || P < 1 || n_extra < 0
      || 2 * n + n_extra > MAX_SEGS)
    return (int)cudaErrorInvalidValue;
  const DwPlan pl = dw_plan(P);
  DwArgs a = {};
  a.P = P; a.per_split = pl.per_split; a.splits = pl.splits;
  a.split_elems = dw_row_elems(L, n);
  a.part = part;
  size_t off = 0;
  for (int l = 0; l < n; ++l) {
    const int M = L[l].M, N = L[l].N;
    if (!dw_shape_ok(M, N)) return (int)cudaErrorInvalidValue;
    CHECK(plane_map(&a.xmap[l], L[l].x, P, M));
    CHECK(plane_map(&a.gmap[l], L[l].g, P, N));
    a.off[l] = off;
    a.off_b[l] = off + (size_t)M * N;
    off += (size_t)M * N + N;
    if (M == 64)        // dW^T: GH's 256 columns by X's 64
      a.tile[a.ntiles++] = {l, 1, 0, 0, 64, 8, 128};
    else                // dW: X's 256 columns by GH's N
      a.tile[a.ntiles++] = {l, 0, 0, 0, N, N / 8, N / 2};
  }
  CHECK((int)cudaFuncSetAttribute(wgrad_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)DW_SMEM));
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute pair[1];
  pair[0].id = cudaLaunchAttributeClusterDimension;
  pair[0].val.clusterDim.x = 2;
  pair[0].val.clusterDim.y = 1;
  pair[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(DW_THREADS);
  cfg.dynamicSmemBytes = DW_SMEM;
  cfg.stream = stream;
  cfg.attrs = pair;
  cfg.numAttrs = 1;
  // As many clusters as run at once (a persistent grid), asked of the
  // runtime once per device; the items, and with them the order of every
  // sum, do not depend on it.
  static int fits[64] = {};
  int dev = 0;
  CHECK((int)cudaGetDevice(&dev));
  int& fit = fits[dev & 63];
  if (fit == 0) {
    cfg.gridDim = dim3(2 * (sm_count() / 2));
    CHECK((int)cudaOccupancyMaxActiveClusters(&fit, wgrad_kernel, &cfg));
  }
  const int items = a.splits * a.ntiles;
  const int clusters = fit < 1 ? 1 : (fit < items ? fit : items);
  cfg.gridDim = dim3(2 * clusters);
  CHECK((int)cudaLaunchKernelEx(&cfg, wgrad_kernel, a));

  SumArgs s = {};
  auto add = [&](const SumSeg& g) {
    s.first[s.n + 1] = s.first[s.n] + (g.cols + 31) / 32;
    s.s[s.n++] = g;
  };
  for (int l = 0; l < n; ++l) {
    const long long st = (long long)a.split_elems;
    const int M = L[l].M, N = L[l].N;
    add({part + a.off[l], L[l].dw, st, a.splits, M * N, M == 64 ? M : 0});
    add({part + a.off_b[l], L[l].db, st, a.splits, N, 0});
  }
  for (int i = 0; i < n_extra; ++i) add(extra[i]);
  fixed_sum_kernel<<<s.first[s.n], 256, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

// Trunk layer j's operand index in flatten_params order (forward order:
// enc_xyz, the nb shape blocks, enc_shape, enc_viewdir, the nt texture
// blocks, rgb_hidden).
int trunk_index(int j, int nb) {
  if (j <= nb + 1) return j;          // enc_xyz, shape blocks, enc_shape
  return j + 1;                       // skips the sigma row
}

int trunk_layers(int nb, int nt) { return nb + nt + 4; }

// The packed trunk operands in one buffer, as pack_trunk_weights lays
// them out: the forward's B operands (W^T of every trunk layer, forward
// order), then the dx chain's (W of every layer but enc_xyz, forward
// order). ``f(pass, j, rows, cols, offset)`` for each, pass 0 the
// forward's; ``rows`` x ``cols`` is W's shape.
template <class F>
size_t packed_layout(int W, int nb, int nt, F f) {
  const int n = trunk_layers(nb, nt);
  size_t off = 0;
  for (int pass = 0; pass < 2; ++pass)
    for (int j = pass; j < n; ++j) {
      const int rows = j == 0 ? 64 : W, cols = j == n - 1 ? W / 2 : W;
      f(pass, j, rows, cols, off);
      off += (size_t)rows * cols;
    }
  return off;
}

size_t packed_elems(int W, int nb, int nt) {
  return packed_layout(W, nb, nt, [](int, int, int, int, size_t) {});
}

// Each trunk layer's packed forward and dx operand in ``packed``, in
// forward order (dxw[0] is unused).
void packed_ptrs(const bf16* packed, int W, int nb, int nt,
                 const bf16** fwd, const bf16** dxw) {
  packed_layout(W, nb, nt, [&](int pass, int j, int, int, size_t off) {
    (pass == 0 ? fwd : dxw)[j] = packed + off;
  });
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
      if (j == nb) L.dst = o.ys_last;
      if (j < nb) {
        L.inj = sproj + (size_t)j * W; L.inj_ld = nb * W;
        L.dst = at(o.xs, j);
      }
    } else if (j == nb + 1) {
      L.dst = o.t;
    } else if (j == nb + 2) {                   // enc_viewdir's trunk rows
      L.rowvec = vcontrib; L.rowvec_ld = W;
      L.mask_out = o.mv;
      L.inj = tproj; L.inj_ld = nt * W;
      L.dst = at(o.xt, 0);
    } else if (j < nb + nt + 3) {               // texture block j - nb - 3
      const int k = j - nb - 3;
      L.mask_out = bits(o.mt, k);
      if (k + 1 < nt) {
        L.inj = tproj + (size_t)(k + 1) * W; L.inj_ld = nt * W;
        L.dst = at(o.xt, k + 1);
      } else {
        L.dst = o.yts_last;
      }
    } else {
      L.dst = o.r;
    }
  }
  return a;
}

// The planes the calling thread's last launch_fwd stored by TMA (the PE
// and each layer's dst), for the wrappers' counters.
thread_local int last_bulk_planes = 0;

// One trunk_fwd_kernel launch: the tensor maps of the planes it stores,
// and each per-ray row's place in a ray's staged record. The stage takes
// the records when a row half's 64 points, which span at most
// (S + 62) / S + 1 rays, fit in STAGE_BYTES; else the epilogues read the
// rows from device memory.
int launch_fwd(FwdArgs a, cudaStream_t stream) {
  last_bulk_planes = 0;
  if (a.P == 0) return 0;
  int rec = 0, n = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    FwdLayer& L = a.L[l];
    if (L.rowvec) { L.rowvec_at = rec; rec += L.N; }
    if (L.inj) { L.inj_at = rec; rec += L.N; }
    if (L.dst) { CHECK(plane_map(&a.map[l], L.dst, a.P, L.N)); ++n; }
  }
  if (a.pe_out) { CHECK(plane_map(&a.pe_map, a.pe_out, a.P, 64)); ++n; }
  const int rays = (a.S + 62) / a.S + 1;
  a.rec = (size_t)rays * rec * sizeof(bf16) <= STAGE_BYTES ? rec : 0;
  CHECK((int)cudaFuncSetAttribute(trunk_fwd_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)FWD_SMEM));
  const int tiles = (a.P + TM - 1) / TM, sms = sm_count();
  const int grid = tiles < sms ? tiles : sms;   // persistent: one per SM
  trunk_fwd_kernel<<<grid, TRUNK_THREADS, FWD_SMEM,
                     stream>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc == 0) last_bulk_planes = n;
  return rc;
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

// The trunk's dW pairs in fused_step, in weight_shapes order reversed
// (the order the dx chain writes them): rgb_hidden, the texture blocks,
// enc_viewdir, enc_shape, the shape blocks, enc_xyz. With null planes
// (sizes only) when ``o`` is null.
int trunk_pairs(const FwdOut* o, const bf16* g_r, const bf16* gh_tex,
                const bf16* gh_encv, const bf16* gh_encs,
                const bf16* gh_shape, const bf16* gh0, void* const* dwb,
                size_t PW, int W, int nb, int nt, DwPair* L) {
  auto at = [&](const bf16* base, int k) {
    return base ? base + (size_t)k * PW : nullptr;
  };
  auto dw = [&](int i) {
    return dwb ? static_cast<float*>(dwb[2 * i]) : nullptr;
  };
  auto db = [&](int i) {
    return dwb ? static_cast<float*>(dwb[2 * i + 1]) : nullptr;
  };
  const int i_encs = nb + 1, i_encv = nb + 3, i_tex = nb + 4;
  const int i_rgbh = nb + nt + 4;
  int n = 0;
  L[n++] = {o ? o->yts_last : nullptr, g_r, W, W / 2, dw(i_rgbh),
            db(i_rgbh)};
  for (int k = 0; k < nt; ++k)
    L[n++] = {o ? at(o->xt, k) : nullptr, at(gh_tex, k), W, W, dw(i_tex + k),
              db(i_tex + k)};
  L[n++] = {o ? o->t : nullptr, gh_encv, W, W, dw(i_encv), db(i_encv)};
  L[n++] = {o ? o->ys_last : nullptr, gh_encs, W, W, dw(i_encs),
            db(i_encs)};
  for (int k = 0; k < nb; ++k)
    L[n++] = {o ? at(o->xs, k) : nullptr, at(gh_shape, k), W, W, dw(1 + k),
              db(1 + k)};
  L[n++] = {o ? o->pe : nullptr, gh0, 64, W, dw(0), db(0)};
  return n;
}

}  // namespace

// Workspace sizes (elements) for one call: the bf16 planes the heads
// read (t, r) and the rgb_hidden cotangent; the ReLU-mask
// bit planes of the dx chain (P x 32 B each: the shape blocks, enc_viewdir,
// the texture blocks, and with weight or input gradients enc_xyz); f32
// dsig and the per-ray cotangent sums. Weight-gradient mode adds every dW
// GEMM's bf16 input (the PE, the injected inputs, the last shape and
// texture blocks' outputs) and gh plane (nb + nt + 3), the dW partials (one
// row per point split, in the place of the mask planes, which are dead by
// then) and the head kernel's rows (one per block); input gradients alone
// add gh0.
extern "C" void fused_workspace(int R, int S, int W, int nb, int nt,
                                int weight_grads, int input_grads,
                                size_t* n_bf16, size_t* n_f32) {
  const size_t P = (size_t)R * S, PW = P * W;
  const size_t mask_planes = nb + nt + 1 + (weight_grads || input_grads);
  size_t masks = mask_planes * P * MASK_WORDS * 2;
  *n_bf16 = 2 * PW;
  *n_f32 = P + (R + (P + 15) / 16) * (nb + nt + 1) * W;
  if (input_grads && !weight_grads) *n_bf16 += PW;
  if (weight_grads) {
    *n_bf16 += P * 64 + (size_t)(nb + nt + 2) * PW
               + (size_t)(nb + nt + 3) * PW;
    DwPair L[MAX_LAYERS];
    const int n = trunk_pairs(nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, PW, W, nb, nt, L);
    const size_t part = 2 * dw_part_elems(L, n, (int)P);   // in bf16
    masks = masks > part ? masks : part;
    *n_f32 += (size_t)head_blocks(R) * head_part_cols(W);
  }
  *n_bf16 += masks;
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
// weights bf16 (in, out), 1-D weights and biases f32; ``packed`` the
// same weights' trunk operands as pack_trunk_weights lays them out
// (packed_trunk_elems bf16), which the caller packs once per weight
// version. With
// ``weight_grads``, ``dwb`` is a host array of 2*k f32 device pointers in
// the same order, each the shape of its weight or bias, which receive the
// gradients; else it is null. The trunk takes W = 256. Returns the first
// nonzero cudaGetLastError() after a launch, else 0.
extern "C" int fused_step(
    const float* ro8, const float* vd8, const float* z, const bf16* sproj,
    const bf16* tproj, const bf16* vcontrib, const float* gt8,
    const float* cmask, const float* cdelta, const void* const* gplanes,
    const void* const* wts, const bf16* packed, bf16* ws, float* ws32,
    float* se8, float* rgb8,
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
  const int i_sig = nb + 2, i_rgbo = nb + nt + 5;

  bf16* p = ws;
  auto take = [&](size_t n) { bf16* q = p; p += n; return q; };
  auto take_bits = [&](size_t planes) {
    return reinterpret_cast<uint32_t*>(take(planes * P * MASK_WORDS * 2));
  };
  FwdOut o = {};
  o.t = take(PW);
  o.r = take(PW / 2);
  bf16* g_r = take(PW / 2);
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
  // The mask bit planes last: once the dx chain has read them, the dW
  // partials take their place (and what they need beyond it).
  float* dw_part = reinterpret_cast<float*>(p);
  if (weight_grads || input_grads) o.m0 = take_bits(1);
  o.ms = take_bits(nb);
  o.mv = take_bits(1);
  o.mt = take_bits(nt);
  auto plane = [&](bf16* base, int k) {
    return base ? base + (size_t)k * PW : nullptr;
  };
  float* dsig = ws32;
  float* rs_s = dsig + P;             // (R, nb, W)
  float* rs_t = rs_s + (size_t)R * nb * W;
  float* rs_v = rs_t + (size_t)R * nt * W;
  // ray_sums' slice rows, one a 16-point slice, in the same s | t | v
  // layout; every value that ray_sum_fold_kernel reads is written first,
  // so neither span is cleared.
  const size_t sl_rows = (P + 15) / 16;
  float* sl_s = rs_v + (size_t)R * W;
  float* sl_t = sl_s + sl_rows * nb * W;
  float* sl_v = sl_t + sl_rows * nt * W;
  float* head_part = sl_v + sl_rows * W;   // weight_grads: (blocks, HP)

  const bf16* fwd_w[MAX_LAYERS];
  const bf16* dx_w[MAX_LAYERS];
  packed_ptrs(packed, W, nb, nt, fwd_w, dx_w);

  // ---- forward: the whole trunk in one launch.
  CHECK(launch_fwd(fwd_args(ro8, vd8, z, sproj, tproj, vcontrib, wts, fwd_w,
                            R, S, W, nb, nt, n_freq, true, o),
                   stream));

  // ---- heads, composite, loss, composite backward
  HeadArgs h = {};
  h.R = R; h.S = S; h.t = o.t; h.r = o.r; h.z = z; h.gt8 = gt8;
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
  const size_t hsm = head_smem(S, W, weight_grads);
  CHECK((int)cudaFuncSetAttribute(
      head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)hsm));
  head_kernel<<<head_blocks(R), HEAD_THREADS, hsm, stream>>>(h);
  CHECK((int)cudaGetLastError());

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
      L.sl_pre = sl_t + (size_t)k * W;
      L.mask = k > 0 ? o.mt + (size_t)(k - 1) * P * MASK_WORDS : o.mv;
      if (k == 0) { L.rs_post = rs_v; L.sl_post = sl_v; L.rs_post_ld = W; }
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
      L.sl_pre = sl_s + (size_t)k * W;
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

  // ---- dW/db of every trunk layer from its stored input and gh plane in
  // one launch, then one fixed-order sum of its splits and of the head's
  // rows (the sigma and rgb_out dW/db).
  if (weight_grads) {
    DwPair L[MAX_LAYERS];
    const int n = trunk_pairs(&o, g_r, gh_tex, gh_encv, gh_encs, gh_shape,
                              gh0, dwb, PW, W, nb, nt, L);
    const int HP = head_part_cols(W), Wh = W / 2, rows = head_blocks(R);
    const SumSeg head[4] = {
        {head_part, dw(i_sig), HP, rows, W, 0},
        {head_part + W, dw(i_rgbo), HP, rows, Wh * 8, 0},
        {head_part + W + Wh * 8, db(i_rgbo), HP, rows, 8, 0},
        {head_part + W + Wh * 8 + 8, db(i_sig), HP, rows, 1, 0}};
    CHECK(launch_wgrad(L, n, (int)P, dw_part, head, 4, stream));
  }
  if (input_grads) {
    const InputArgs ia = {R, S, n_freq, gh0,
                          static_cast<const bf16*>(wts[0]), ro8, vd8, z, d_z,
                          d_ro8, d_vd8};
    CHECK(launch_input_chain(ia, stream));
  }

  return launch_fold(rs_s, sl_s, d_sproj, d_tproj, d_vcontrib, R, S, nb, nt,
                     W, stream);
}

// The code cotangents' last pass alone (fused_step launches it last), for
// its check against its plain version: the rays' span ``x`` (R x (nb + nt
// + 1) x W f32) and the slice rows ``sl`` (ceil(R S / 16) x (nb + nt + 1)
// x W f32), as ray_sums leaves them, added and rounded into d_sproj
// (R, nb, W), d_tproj (R, nt, W) and d_vcontrib (R, W) bf16, all 16-byte
// aligned; W a multiple of 8. One ray_sum_fold_kernel launch.
extern "C" int ray_sum_fold_step(const float* x, const float* sl,
                                 bf16* d_sproj, bf16* d_tproj,
                                 bf16* d_vcontrib, int R, int S, int nb,
                                 int nt, int W, cudaStream_t stream) {
  return launch_fold(x, sl, d_sproj, d_tproj, d_vcontrib, R, S, nb, nt, W,
                     stream);
}

namespace {

// The sigma head's arithmetic, which both instances of head_pass run so
// that their sigma planes are the same bits: a lane's 8 contiguous bf16
// values of t against its 8 f32 weights, in order, then warp_sum over the
// lanes, the bias and softplus.
__device__ __forceinline__ float sigma_lane_dot(const uint4& v,
                                                const float* w, float a) {
  const __nv_bfloat162* t2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a += __low2float(t2[i]) * w[2 * i];
    a += __high2float(t2[i]) * w[2 * i + 1];
  }
  return a;
}

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

struct PlaneHeadArgs {
  const bf16* t;           // (P, TW): enc_shape's output
  const bf16* r;           // (P, TW / 2): rgb_hidden's output, or null
  const float* w_sig;      // (TW,)
  const float* b_sig;      // (1,)
  const bf16* w_rgb;       // (TW / 2, 8): rgb_out's weight, zero-padded
  const float* b_rgb;      // (8,)
  float* sigma;            // (P,) each
  float* c0;
  float* c1;
  float* c2;
  size_t P;
};

constexpr int PH_THREADS = 256;
constexpr int PH_BLOCKS_PER_SM = 3;  // the launch bounds' residency
constexpr int PH_POINTS = 4;       // points a warp takes an iteration
constexpr int SH_POINTS = 8;       // the same, sigma alone

// The heads of the TPU's fused_mlp.py::_kernel (:362-382) after the
// trunk: per point the sigma plane softplus(t . w_sig + b_sig) and, with
// RGB, the raw r, g, b planes r . w_rgb[:, 0:3] + b_rgb, f32 sums of bf16
// values. Bound by bytes: t (512 B) read once and sigma written, 516 B a
// point, and with RGB r (256 B) and three more planes, 784 B; on an H100
// at 3.35 TB/s 0.0808 ms for sigma alone at 16,384 x 32, 0.245 ms for the
// four planes at 16,384 x 64. The design: every load is 16 bytes a lane;
// a warp takes NP points an iteration (NP t rows, a lane's 8 values each,
// and with RGB NP / 2 r rows' worth, half a warp a row), all issued
// before the first shuffle; w_sig (and w_rgb[:, 0:3]) for the lane's
// columns sit in registers, converted once; lane q writes point q's
// sigma, so a group's stores are one coalesced NP-float row. The sigma
// lane is sigma_lane_dot, warp_sum, + b_sig, softplus_f in both
// instances, so sigma_step's and planes_step's sigma planes are the same
// bits; the rgb sums are 8 values in order and a 16-lane butterfly.
template <bool RGB, int NP>
__device__ __forceinline__ void head_pass(const PlaneHeadArgs& a) {
  static_assert(NP <= 32 && NP % 2 == 0, "a lane per point, r rows paired");
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4, kr = 8 * (lane & 15);
  float ws[8], wr[3][8], b_rgb[3];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ws[i] = a.w_sig[8 * lane + i];
    if constexpr (RGB) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        wr[ch][i] = bf(a.w_rgb[(kr + i) * 8 + ch]);
    }
  }
  if constexpr (RGB) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) b_rgb[ch] = a.b_rgb[ch];
  }
  const float b_sig = a.b_sig[0];
  const size_t P = a.P;
  const size_t step = (size_t)gridDim.x * (PH_THREADS / 32) * NP;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (size_t p0 = ((size_t)blockIdx.x * (PH_THREADS / 32)
                    + threadIdx.x / 32) * NP;
       p0 < P; p0 += step) {
    uint4 tv[NP], rv[NP / 2];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const size_t p = p0 + q;
      tv[q] = p < P ? __ldg(reinterpret_cast<const uint4*>(
                          a.t + p * TW + 8 * lane))
                    : zero;
    }
    if constexpr (RGB) {
#pragma unroll
      for (int h = 0; h < NP / 2; ++h) {
        const size_t p = p0 + 2 * h + half;
        rv[h] = p < P ? __ldg(reinterpret_cast<const uint4*>(
                            a.r + p * (TW / 2) + kr))
                      : zero;
      }
    }
    float sg[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q)
      sg[q] = warp_sum(sigma_lane_dot(tv[q], ws, 0.f));
    float mine = sg[0];
#pragma unroll
    for (int q = 1; q < NP; ++q) mine = lane == q ? sg[q] : mine;
    if (lane < NP && p0 + lane < P)
      a.sigma[p0 + lane] = softplus_f(mine + b_sig);
    if constexpr (RGB) {
#pragma unroll
      for (int h = 0; h < NP / 2; ++h) {
        const __nv_bfloat162* r2 =
            reinterpret_cast<const __nv_bfloat162*>(&rv[h]);
        float c[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float lo = __low2float(r2[i]), hi = __high2float(r2[i]);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            c[ch] += lo * wr[ch][2 * i];
            c[ch] += hi * wr[ch][2 * i + 1];
          }
        }
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            c[ch] += __shfl_xor_sync(FULL, c[ch], off);
        const size_t p = p0 + 2 * h + half;
        if ((lane & 15) == 0 && p < P) {
          a.c0[p] = c[0] + b_rgb[0];
          a.c1[p] = c[1] + b_rgb[1];
          a.c2[p] = c[2] + b_rgb[2];
        }
      }
    }
  }
}

// The two instances under names of their own, which the profiles count.
__global__ void __launch_bounds__(PH_THREADS, PH_BLOCKS_PER_SM)
    plane_head_kernel(PlaneHeadArgs a) {
  head_pass<true, PH_POINTS>(a);
}

__global__ void __launch_bounds__(PH_THREADS, PH_BLOCKS_PER_SM)
    sigma_head_kernel(PlaneHeadArgs a) {
  head_pass<false, SH_POINTS>(a);
}

// One head launch (with RGB plane_head_kernel, else sigma_head_kernel): a
// warp per group of points, at most four waves of resident blocks, which
// then stride over the rest.
template <bool RGB>
int launch_head(const PlaneHeadArgs& a, cudaStream_t stream) {
  constexpr int NP = RGB ? PH_POINTS : SH_POINTS;
  const size_t groups = (a.P + NP - 1) / NP;
  const size_t need = (groups + PH_THREADS / 32 - 1) / (PH_THREADS / 32);
  const size_t cap = (size_t)sm_count() * PH_BLOCKS_PER_SM * 4;
  const unsigned blocks = (unsigned)(need < cap ? need : cap);
  if (blocks == 0) return 0;
  if (RGB)
    plane_head_kernel<<<blocks, PH_THREADS, 0, stream>>>(a);
  else
    sigma_head_kernel<<<blocks, PH_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The standalone composite and its backward, COMP_WARPS rays a block, a
// warp each.
struct CompositeArgs {
  int R, S, white_bg;
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

constexpr int COMP_WARPS = 8;
constexpr int COMP_THREADS = 32 * COMP_WARPS;

// V consecutive floats of a ray's plane at ``i`` into x[q .. q + V - 1]
// (V = 4: one 16-byte load), and back; q a multiple of V (a constant once
// the caller's loop is unrolled, so x stays in registers).
template <int V, int PL>
__device__ __forceinline__ void load_v(const float* p, size_t i,
                                       float (&x)[PL], int q) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
    x[q] = v.x; x[q + 1] = v.y; x[q + 2] = v.z; x[q + 3] = v.w;
  } else {
    x[q] = __ldg(p + i);
  }
}

template <int PL>
__device__ __forceinline__ void store_v4(float* p, size_t i,
                                         const float (&x)[PL], int q) {
  *reinterpret_cast<float4*>(p + i) =
      make_float4(x[q], x[q + 1], x[q + 2], x[q + 3]);
}

// A ray's plane ``row`` (S floats) from lane-blocked registers (lane l
// holds samples l*per .. l*per + per - 1 in x[0 .. per - 1]) with
// coalesced scalar stores: store k writes samples 32 k + lane, each
// gathered from its owner's slot by PL shuffles. Scalar stores of the
// blocked layout would write every 32-byte sector in per partial pieces.
template <int PL>
__device__ __forceinline__ void store_cyclic(float* row, const float (&x)[PL],
                                             int per, int S, int lane) {
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    if (k < per) {                       // the same for the whole warp
      const int s = 32 * k + lane, src = s / per, slot = s - src * per;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < PL; ++q) {
        const float t = __shfl_sync(FULL, x[q], src < 32 ? src : 31);
        if (q == slot) v = t;
      }
      if (s < S) row[s] = v;
    }
  }
}

// Lane l of a ray's warp loads its own samples [l*per, l*per + per) of the
// five planes into registers (V at a time: 16-byte loads where per and S
// are multiples of 4, else scalar ones, whose sectors L1 serves to the
// per loads that share them), takes its last sample's next depth from
// lane l + 1 by a shuffle, and runs composite_pass on them: the head
// kernel's lane mapping and order of association. The backward keeps
// every cotangent in registers, dz_s = gd * w_s + ddelta_{s-1} - ddelta_s
// with the previous lane's last ddelta by a shuffle, and writes the five
// planes with 16-byte stores (V = 4) or coalesced scalar ones through
// shuffles (store_cyclic). No shared memory: residency is set by
// registers (PL slots a lane; PL <= 3, S <= 96, keeps four blocks, 32
// warps, on an SM; PL = 4 three without spilling).
template <int PL, int V>
__global__ void __launch_bounds__(COMP_THREADS,
                                  PL <= 3 ? 4 : PL == 4 ? 3 : 1)
    composite_kernel(CompositeArgs a) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * COMP_WARPS + (threadIdx.x >> 5);
  if (ray >= a.R) return;              // the whole warp: one ray each
  const int S = a.S, per = (S + 31) / 32, s0 = lane * per;
  const size_t p0 = (size_t)ray * S;
  float sg[PL] = {}, c[3][PL] = {}, z[PL] = {}, w[PL] = {}, gs[PL] = {},
      gc[3][PL] = {}, dd[PL] = {}, dz[PL];
  RegRay<PL> io = {sg, c, z, w, gs, gc, dd, 0.f, per};
#pragma unroll
  for (int q = 0; q < PL; q += V) {
    if (q < per && s0 + q < S) {
      const size_t i = p0 + s0 + q;
      load_v<V>(a.sig, i, sg, q);
      load_v<V>(a.c0, i, c[0], q);
      load_v<V>(a.c1, i, c[1], q);
      load_v<V>(a.c2, i, c[2], q);
      load_v<V>(a.z, i, z, q);
    }
  }
  io.zn = __shfl_down_sync(FULL, z[0], 1);
  HeadArgs h = {};
  h.S = S; h.white_bg = a.white_bg;
  const bool bwd = a.g8 != nullptr;
  const float* g8 = bwd ? a.g8 + (size_t)ray * 8 : nullptr;
  const CompositeOut o = composite_pass<PL>(h, ray, lane, io, nullptr,
                                            nullptr, true, g8, bwd);
  if (!bwd) {
    if (lane < 8)
      a.out8[(size_t)ray * 8 + lane] =
          lane < 3 ? (lane == 0 ? o.rgb[0] : lane == 1 ? o.rgb[1] : o.rgb[2])
                   : lane == 3 ? o.dep : lane == 4 ? o.acc : 0.f;
    return;
  }
  float last = 0.f;
#pragma unroll
  for (int q = 0; q < PL; ++q)
    if (q == per - 1) last = dd[q];
  const float prev = __shfl_up_sync(FULL, last, 1);
  const float gd = g8[3];
#pragma unroll
  for (int q = 0; q < PL; ++q) {
    const int s = s0 + q;
    dz[q] = gd * w[q] + (s > 0 ? (q > 0 ? dd[q > 0 ? q - 1 : 0] : prev)
                               : 0.f) - dd[q];
  }
  if constexpr (V == 4) {
#pragma unroll
    for (int q = 0; q < PL; q += V) {
      if (q < per && s0 + q < S) {
        const size_t i = p0 + s0 + q;
        store_v4(a.gsig, i, gs, q);
        store_v4(a.gc0, i, gc[0], q);
        store_v4(a.gc1, i, gc[1], q);
        store_v4(a.gc2, i, gc[2], q);
        store_v4(a.dz, i, dz, q);
      }
    }
  } else {
    store_cyclic(a.gsig + p0, gs, per, S, lane);
    store_cyclic(a.gc0 + p0, gc[0], per, S, lane);
    store_cyclic(a.gc1 + p0, gc[1], per, S, lane);
    store_cyclic(a.gc2 + p0, gc[2], per, S, lane);
    store_cyclic(a.dz + p0, dz, per, S, lane);
  }
}

template <int PL>
int launch_composite(const CompositeArgs& a, cudaStream_t stream) {
  const unsigned grid = (a.R + COMP_WARPS - 1) / COMP_WARPS;
  const int per = (a.S + 31) / 32;
  const void* ptrs[] = {a.sig, a.c0, a.c1, a.c2, a.z, a.gsig, a.gc0, a.gc1,
                        a.gc2, a.dz};
  bool vec = PL % 4 == 0 && per % 4 == 0 && a.S % 4 == 0;
  for (const void* p : ptrs) vec = vec && (uintptr_t)p % 16 == 0;
  if constexpr (PL % 4 == 0) {
    if (vec) {
      composite_kernel<PL, 4><<<grid, COMP_THREADS, 0, stream>>>(a);
      return (int)cudaGetLastError();
    }
  }
  composite_kernel<PL, 1><<<grid, COMP_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The smallest instance whose PL slots hold a lane's (S + 31) / 32
// samples.
int launch_composite(const CompositeArgs& a, cudaStream_t stream) {
  if (a.R < 1 || a.S < 1 || a.S > MAX_S) return (int)cudaErrorInvalidValue;
  const int per = (a.S + 31) / 32;
  if (per <= 1) return launch_composite<1>(a, stream);
  if (per <= 2) return launch_composite<2>(a, stream);
  if (per <= 3) return launch_composite<3>(a, stream);
  if (per <= 4) return launch_composite<4>(a, stream);
  return launch_composite<MAX_PER_LANE>(a, stream);
}

}  // namespace

// The planes the calling thread's last fused_step, sigma_step or
// planes_step stored from trunk_fwd_kernel's tile by TMA: the PE, the
// injected inputs, the last blocks' outputs, t and r, as the mode keeps
// them (planes_step 2: t and r).
extern "C" int forward_bulk_planes() { return last_bulk_planes; }

// Workspace (bf16 elements) of sigma_step (``planes`` 0) and planes_step
// (``planes`` 1): t, and for planes_step r.
extern "C" size_t forward_workspace(int R, int S, int W, int nb, int nt,
                                    int planes) {
  const size_t PW = (size_t)R * S * W;
  return PW + (planes ? PW / 2 : 0);
}

// Sigma-only forward on R rays x S samples: replaces
// codenerf_tpu/ops/fused_mlp.py::_kernel(sigma_only=True), the coarse pass
// of hierarchical sampling, whose compositing weights need sigma alone.
// trunk_fwd_kernel from the PE through enc_shape, storing t alone (in
// ``ws``, forward_workspace(..., 0) elements: nothing is kept for a
// backward), then sigma_head_kernel writes ``sigma`` (R, S) f32. ``wts``
// and ``packed`` as for fused_step; only the enc_xyz, shape, enc_shape
// and sigma entries and the forward operands are read. Bound by
// operations: 2 * W * (64 + W * (nb + 1)) FLOP per point.
extern "C" int sigma_step(const float* ro8, const float* vd8, const float* z,
                          const bf16* sproj, const void* const* wts,
                          const bf16* packed, bf16* ws, float* sigma, int R,
                          int S, int W, int nb, int nt, int n_freq,
                          cudaStream_t stream) {
  if (!trunk_shapes_ok(W, nb, nt, n_freq)) return (int)cudaErrorInvalidValue;
  const size_t P = (size_t)R * S;
  const bf16* fwd_w[MAX_LAYERS];
  const bf16* dx_w[MAX_LAYERS];
  packed_ptrs(packed, W, nb, nt, fwd_w, dx_w);
  FwdOut o = {};
  o.t = ws;
  CHECK(launch_fwd(fwd_args(ro8, vd8, z, sproj, nullptr, nullptr, wts, fwd_w,
                            R, S, W, nb, nt, n_freq, false, o),
                   stream));
  PlaneHeadArgs h = {};
  h.t = o.t;
  h.w_sig = static_cast<const float*>(wts[2 * (nb + 2)]);
  h.b_sig = static_cast<const float*>(wts[2 * (nb + 2) + 1]);
  h.sigma = sigma;
  h.P = P;
  return launch_head<false>(h, stream);
}

// Four-plane forward on R rays x S samples: replaces
// codenerf_tpu/ops/fused_mlp.py::_kernel (sigma_only=False), the forward
// of the plane op. trunk_fwd_kernel through rgb_hidden in one launch,
// storing t and r (``ws``: forward_workspace(..., 1) elements); t is
// computed as sigma_step computes it, and plane_head_kernel's sigma lane
// is sigma_head_kernel's code, so the sigma plane is sigma_step's, bit
// for bit; the same pass writes the raw r, g, b planes. Outputs
// (R, S) f32. Bound by operations: 2 * W * (64 + W * (nb + nt + 2) +
// W / 2) FLOP per point.
extern "C" int planes_step(const float* ro8, const float* vd8, const float* z,
                           const bf16* sproj, const bf16* tproj,
                           const bf16* vcontrib, const void* const* wts,
                           const bf16* packed, bf16* ws, float* sigma,
                           float* c0, float* c1, float* c2, int R, int S,
                           int W, int nb, int nt, int n_freq,
                           cudaStream_t stream) {
  if (!trunk_shapes_ok(W, nb, nt, n_freq)) return (int)cudaErrorInvalidValue;
  const int i_sig = nb + 2, i_rgbo = nb + nt + 5;
  const size_t P = (size_t)R * S;
  const bf16* fwd_w[MAX_LAYERS];
  const bf16* dx_w[MAX_LAYERS];
  packed_ptrs(packed, W, nb, nt, fwd_w, dx_w);
  FwdOut o = {};
  o.t = ws;
  o.r = o.t + P * W;
  CHECK(launch_fwd(fwd_args(ro8, vd8, z, sproj, tproj, vcontrib, wts, fwd_w,
                            R, S, W, nb, nt, n_freq, true, o),
                   stream));
  const PlaneHeadArgs h = {
      o.t, o.r, static_cast<const float*>(wts[2 * i_sig]),
      static_cast<const float*>(wts[2 * i_sig + 1]),
      static_cast<const bf16*>(wts[2 * i_rgbo]),
      static_cast<const float*>(wts[2 * i_rgbo + 1]), sigma, c0, c1, c2, P};
  return launch_head<true>(h, stream);
}

// The four-plane head alone (planes_step launches it after the trunk),
// for its check against its plain version: from t (R*S, W) and r
// (R*S, W/2) bf16, the sigma and raw r, g, b planes (R*S,) f32 each;
// w_sig (W,), b_sig (1,), b_rgb (8,) f32, w_rgb (W/2, 8) bf16. W = 256.
// One plane_head_kernel launch.
extern "C" int plane_head_step(const bf16* t, const bf16* r,
                               const float* w_sig, const float* b_sig,
                               const bf16* w_rgb, const float* b_rgb,
                               float* sigma, float* c0, float* c1, float* c2,
                               int R, int S, int W, cudaStream_t stream) {
  if (W != TW || R < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const PlaneHeadArgs h = {t, r, w_sig, b_sig, w_rgb, b_rgb, sigma, c0, c1,
                           c2, (size_t)R * S};
  return launch_head<true>(h, stream);
}

// The sigma-only forward's head alone (sigma_step launches it after the
// trunk), for its check against its plain version: from t (R*S, W) bf16,
// w_sig (W,) and b_sig (1,) f32, the sigma plane (R*S,) f32. W = 256. One
// sigma_head_kernel launch.
extern "C" int sigma_head_step(const bf16* t, const float* w_sig,
                               const float* b_sig, float* sigma, int R,
                               int S, int W, cudaStream_t stream) {
  if (W != TW || R < 1 || S < 1) return (int)cudaErrorInvalidValue;
  PlaneHeadArgs h = {};
  h.t = t; h.w_sig = w_sig; h.b_sig = b_sig; h.sigma = sigma;
  h.P = (size_t)R * S;
  return launch_head<false>(h, stream);
}

// The input chain alone (fused_step launches it after the dx chain), for
// its check against its plain version: from gh0 (R*S, W) and w_enc
// (64, W) bf16, ro8, vd8 (R, 8) and z (R, S) f32, adds the PE Jacobian's
// z term to ``d_z`` (R, S) f32 in place and writes d_ro8, d_vd8 (R, 8)
// f32. W = 256, S <= MAX_S, 3 + 6 * n_freq <= 64. One input_chain_kernel
// launch.
extern "C" int input_chain_step(const bf16* gh0, const bf16* w_enc,
                                const float* ro8, const float* vd8,
                                const float* z, float* d_z, float* d_ro8,
                                float* d_vd8, int R, int S, int W,
                                int n_freq, cudaStream_t stream) {
  if (W != TW) return (int)cudaErrorInvalidValue;
  const InputArgs ia = {R, S, n_freq, gh0, w_enc, ro8, vd8, z, d_z, d_ro8,
                        d_vd8};
  return launch_input_chain(ia, stream);
}

// The trunk weights in the wgmma operand layout that fused_step,
// sigma_step and planes_step take as ``packed`` (``dst``:
// packed_trunk_elems(W, nb, nt) bf16): the forward operands W^T, then the
// dx chain's W (packed_layout). ``wts`` as for fused_step. One
// pack_kernel launch, the only one: ops/fused_train.py::trunk_operands
// packs once per weight version.
extern "C" int pack_trunk_weights(const void* const* wts, int W, int nb,
                                  int nt, bf16* dst, cudaStream_t stream) {
  if (!trunk_shapes_ok(W, nb, nt, 0)) return (int)cudaErrorInvalidValue;
  PackArgs a = {};
  int tiles = 0;
  packed_layout(W, nb, nt, [&](int pass, int j, int rows, int cols,
                               size_t off) {
    a.j[a.n++] = {static_cast<const bf16*>(wts[2 * trunk_index(j, nb)]),
                  dst + off, rows, cols, pass == 0, tiles};
    tiles += rows / 64 * (cols / 64);
  });
  pack_kernel<<<tiles, PACK_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" size_t packed_trunk_elems(int W, int nb, int nt) {
  return packed_elems(W, nb, nt);
}

namespace {

int dw_pairs(const void* const* xs, const void* const* gs, const int* ms,
             const int* ns, int n, void* const* dws, void* const* dbs,
             DwPair* L) {
  if (n < 1 || n > MAX_LAYERS) return -1;
  for (int l = 0; l < n; ++l) {
    if (!dw_shape_ok(ms[l], ns[l])) return -1;
    L[l] = {xs ? static_cast<const bf16*>(xs[l]) : nullptr,
            gs ? static_cast<const bf16*>(gs[l]) : nullptr, ms[l], ns[l],
            dws ? static_cast<float*>(dws[l]) : nullptr,
            dbs ? static_cast<float*>(dbs[l]) : nullptr};
  }
  return n;
}

}  // namespace

// The weight-gradient kernel alone (fused_step launches it for the trunk),
// for its check against its plain version: for each of the ``n`` pairs,
// dws[l] (M, N) = xs[l]^T @ gs[l] and dbs[l] (N,) = the column sums of
// gs[l], f32, over P points; xs[l] (P, M) and gs[l] (P, N) bf16, (M, N)
// one of (256, 256), (256, 128), (64, 256) (``ms``, ``ns``). Host arrays
// of device pointers. ``part``: weight_grads_workspace(...) f32 elements.
// One wgrad_kernel and one fixed_sum_kernel launch.
extern "C" size_t weight_grads_workspace(const int* ms, const int* ns, int n,
                                         int P) {
  DwPair L[MAX_LAYERS];
  if (dw_pairs(nullptr, nullptr, ms, ns, n, nullptr, nullptr, L) < 0)
    return 0;
  return dw_part_elems(L, n, P);
}

extern "C" int weight_grads_step(const void* const* xs,
                                 const void* const* gs, const int* ms,
                                 const int* ns, int n, int P,
                                 void* const* dws, void* const* dbs,
                                 float* part, cudaStream_t stream) {
  DwPair L[MAX_LAYERS];
  if (dw_pairs(xs, gs, ms, ns, n, dws, dbs, L) < 0)
    return (int)cudaErrorInvalidValue;
  return launch_wgrad(L, n, P, part, nullptr, 0, stream);
}

// Standalone composite on R rays x S samples: replaces
// codenerf_tpu/ops/pallas_composite.py::_fwd_kernel (launched by _call).
// Five (R, S) f32 planes in (densities, raw r, g, b, depths), ``out8``
// (R, 8) f32 [r g b depth acc 0 0 0] out; white or black background. A
// warp per ray runs composite_pass's scan on the planes in its registers,
// COMP_WARPS rays a block. Bound by bytes: 5 * R * S * 4 in, R * 32 out.
extern "C" int composite_fwd(const float* sig, const float* c0,
                             const float* c1, const float* c2,
                             const float* z, float* out8, int R, int S,
                             int white_bg, cudaStream_t stream) {
  CompositeArgs a = {};
  a.R = R; a.S = S; a.white_bg = white_bg; a.sig = sig; a.c0 = c0;
  a.c1 = c1; a.c2 = c2; a.z = z; a.out8 = out8;
  return launch_composite(a, stream);
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
  CompositeArgs a = {};
  a.R = R; a.S = S; a.white_bg = white_bg; a.sig = sig; a.c0 = c0;
  a.c1 = c1; a.c2 = c2; a.z = z; a.g8 = g8; a.gsig = gsig; a.gc0 = gc0;
  a.gc1 = gc1; a.gc2 = gc2; a.dz = dz;
  return launch_composite(a, stream);
}
