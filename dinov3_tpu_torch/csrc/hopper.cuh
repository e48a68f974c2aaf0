// Hopper (sm_90a) building blocks shared by the TMA + wgmma bodies of the
// flash-attention kernels (csrc/flash_fwd.cu, csrc/flash_bwd_dq.cu,
// csrc/flash_bwd_dkv.cu).
//
// - mbarriers: init, arrive (optionally with an expected transaction byte
//   count) and a parity wait;
// - TMA: one 64-row box of a [B, N, H, 64] bf16 tensor into shared memory,
//   through a 4-D tensor map encoded on the host per call (`make_map`:
//   the tensor's own strides, 128-byte swizzle, rows past N read as zeros)
//   with cuTensorMapEncodeTiled looked up through the CUDA runtime, so a
//   library that includes this header links no -lcuda;
// - wgmma m64n64k16 bf16 -> fp32 on 64 x 64 tiles laid out by that TMA
//   box: `issue_qk` (D = A B^T, both tiles in shared memory, contracting
//   over their 64 columns: K-major, +32 bytes a k-step in the swizzled
//   128-byte rows) and `issue_pv` (D += A B, A from registers in the
//   accumulator layout, B's 64 rows contracted: MN-major in the
//   transposed-B mode, +2 KB a k-step), and `pack_frags`, which rounds an
//   accumulator to that A layout;
// - the register fences an asynchronous wgmma needs around its wait;
// - for the backward kernels: a row of K1's 64 x 64 tile schedule as a
//   list of tiles (`schedule_row`), and the work items of a persistent grid
//   (`Items`, sized by `persistent_grid`).
//
// In the wgmma layouts warp w of the warpgroup owns rows [16w, 16w + 16) of
// a 64-row result; lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8
// of them and, in each 8-column chunk c, columns 8c + 2t and 8c + 2t + 1:
// d[4c + e] is (row g, column 8c + 2t + e), d[4c + 2 + e] is row g + 8.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kRows = 64;                  // rows of a TMA box and of a tile
constexpr int kHd = 64;                    // head_dim of the wgmma bodies
constexpr int kTileBytes = kRows * kHd * 2;  // one bf16 tile: 8 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64-row box of a [B, N, H, D] map at (d = 0, h, n0, b) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int n0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h), "r"(n0), "r"(b)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving uses of registers that an asynchronous
// wgmma reads or writes across its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_ACC32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_ACC32_OPS(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),        \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),     \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (+)= A B for a 64x16 A and a 16x64 B, both K-major in shared memory;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_ACC32_OPS(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B with A (64x16) from registers and B (16x64) MN-major in shared
// memory (the transposed-B mode).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_ACC32_OPS(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef WG_ACC32
#undef WG_ACC32_OPS

// d = A B^T for 64-row tiles A (at s_a) and B (at s_b), both stored as
// TMA boxes (rows of 64 bf16, K-major): four k-steps of 16 along the
// columns, 32 bytes apart in the swizzled 128-byte rows; one commit group.
// The forward's S = Q K^T; the backward's S^T = K Q^T and dP^T = V dO^T.
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t s_a, uint32_t s_b) {
#pragma unroll
  for (int kc = 0; kc < kHd / 16; ++kc)
    wgmma_ss(sc, smem_desc(s_a + 32 * kc, 16, 1024), smem_desc(s_b + 32 * kc, 16, 1024), kc);
  wgmma_commit();
}

// d += A B for A (64 x 64) from registers in the A-fragment layout (k-step
// kk in pa[4kk .. 4kk + 3]) and a B tile (at s_b) stored as a TMA box whose
// 64 rows are contracted: B's k-step kk is its rows [16kk, 16kk + 16), 2 KB
// apart, with 8-row groups 1 KB apart; one commit group. The forward's
// O += P V; the backward's dV += P^T dO and dK += dS^T Q.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[16], uint32_t s_b) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk)
    wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
             smem_desc(s_b + 2048 * kk, 1024, 1024));
  wgmma_commit();
}

// fp32 accumulators of a 64 x 64 result, rounded to bf16, as the A
// fragments of an `issue_pv` product contracting over the result's columns:
// columns [16kk, 16kk + 16) of the accumulator are exactly the A fragment
// of k-step kk. The forward's P; the backward's P^T, dS^T and dS.
__device__ __forceinline__ void pack_frags(uint32_t (&a)[16], const float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    a[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

// 2^x by the special-function unit alone (denormal results flush to 0,
// which the softmax cannot tell from 0); exp2f adds a denormal path.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The tiles a backward CTA walks for tile i of batch row b: row i of K1's
// 64 x 64 schedule (tiles [B, nt, nt], counts [B, nt]), or all nt tiles
// without one.
struct TileList {
  const int* list;
  int count;
  __device__ __forceinline__ int operator[](int i) const { return list ? list[i] : i; }
};

__device__ __forceinline__ TileList schedule_row(const int* tiles, const int* counts, int nt,
                                                 int i, int b) {
  if (!tiles) return TileList{nullptr, nt};
  const long long row = static_cast<long long>(b) * nt + i;
  return TileList{tiles + row * nt, counts[row]};
}

// One work item of a persistent grid: 64-row tile `tile` of head h of batch
// row b.
struct Item {
  int tile, h, b;
};

// A CTA's items in order: blockIdx.x, blockIdx.x + gridDim.x, ... of all
// nt * H * B, the tile index fastest, so that the tiles of one (b, h) run
// at about the same time and share the other operand's tiles in L2.
struct Items {
  int next, total, nt, H;
  __device__ __forceinline__ Items(int n_tiles, int heads, int batch)
      : next(blockIdx.x), total(n_tiles * heads * batch), nt(n_tiles), H(heads) {}
  __device__ __forceinline__ bool get(Item& it) {
    if (next >= total) return false;
    it = Item{next % nt, (next / nt) % H, next / (nt * H)};
    next += gridDim.x;
    return true;
  }
};

// The grid of a persistent kernel over `items` work items: as many CTAs as
// fit on the SMs, at most one an item. The first call (ctas_per_sm == 0,
// the caller's static) sets the kernel's dynamic shared memory and reads
// its occupancy.
template <typename Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, int smem_bytes, long long items,
                                   int& ctas_per_sm, int& grid) {
  if (!ctas_per_sm) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas_per_sm, kernel, threads,
                                                          smem_bytes);
    if (err != cudaSuccess) return err;
    if (ctas_per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long cap = static_cast<long long>(sms) * ctas_per_sm;
  grid = static_cast<int>(items < cap ? items : cap);
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so that the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over one [B, N, H, 64] bf16 tensor (element strides sb, sn, sh;
// last dim contiguous), boxes of 64 rows of one head, 128-byte swizzle,
// rows past N read as zeros.
inline bool make_map(CUtensorMap* map, const void* base, int B, int N, int H, long long sb,
                     long long sn, long long sh) {
  EncodeTiledFn encode = encode_fn();
  if (!encode) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHd), static_cast<cuuint64_t>(H),
                        static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(sn) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(kHd), 1, static_cast<cuuint32_t>(kRows), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
