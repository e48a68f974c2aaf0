// Flash-attention forward with segment ids, for Hopper (sm_90a).
//
// Replaces the TPU kernel dinov3_tpu/ops/flash_attention.py `_flash_fwd`
// (body `_fwd_kernel`): non-causal attention with an online softmax that
// writes O in the input dtype and the row log-sum-exp (LSE) in fp32.
// Token q attends token k iff k < N and, when segment ids are given,
// seg[b, q] == seg[b, k]. Masked logits take -1e30, as in the reference,
// and the running max starts there, so a row whose first key tiles are all
// masked is wiped by the first real logit (every real token matches itself).
//
// What bounds it: at the serve shape ([4 rows x 16 heads, 2050, 64] bf16)
// the segments need 24 % of the 68.9 GFLOP of dense work, against 2 MB of
// q/k/v per head-row: tensor-core operations and, once masked work is
// skipped, the latency of short key loops. At the training shapes
// (N = 197) it is bound by the bytes of q/k/v/O.
//
// What the design does about it:
// - A tile schedule. A first small kernel reduces seg [B, N] to one list
//   per (batch row, q tile) of the key tiles that can hold a key whose id
//   equals some query's id in the tile, and the list's length; one list
//   serves every head of the row. Per tile it keeps the min and max of the
//   ids >= 0 and a flag for "holds a negative id"; two tiles meet if their
//   non-negative ranges overlap or both hold a negative id. That is
//   conservative for any int32 ids: a tile in which no pair meets may be
//   listed, one in which a pair meets never left out. A skipped tile adds
//   exactly 0 to the softmax sums and to O (every logit in it is masked),
//   so skipping changes no result. Without segment ids every tile is
//   visited and no schedule runs.
// - bf16, head_dim 64 (every ViT up to ViT-L): one CTA of one consumer
//   warpgroup and one producer warp per (64-row q tile, head, batch row).
//   The producer issues TMA loads (4-D tensor maps over [B, N, h, d]
//   through the tensors' strides, 128-byte swizzle; rows past N arrive as
//   zeros) of the Q tile once and of the listed K and V tiles into a
//   three-stage ring, each stage with its own mbarriers. The consumer
//   computes S = Q K^T with `wgmma` m64n64k16 from shared memory, the
//   masked online softmax in fp32 registers (logits scaled into log2
//   units, so one `ex2.approx` a logit), and O += P V with `wgmma` taking P
//   (rounded to bf16) from registers, where the fp32 accumulator layout of
//   S is the A-fragment layout, and V from shared memory in the
//   transposed-B mode. S of the next tile is issued before P V of this
//   one, so the softmax overlaps the tensor cores' P V. O is written from
//   registers as [B, N, h, d] bf16, LSE as [B, h, N] fp32; no atomics, so
//   two runs give the same bits.
// - bf16, head_dim 128 (no caller on the main path): the FlashAttention-2
//   body on `mma.sync.m16n8k16` with synchronous loads through padded
//   shared memory, walking the same schedule.
// - fp32 (edge shapes only): one thread per q row with the row of q and
//   the accumulator in registers, K/V tiles of 32 keys in shared memory,
//   scalar FMAs; it keeps the reference's order (q scaled in fp32 before
//   the dot product) and walks the schedule built for 32-key tiles.
// Segment ids are read as [B, N] int32 per batch row, not as a per-head
// broadcast copy; the ragged edge (N not a multiple of the tile) is masked
// in the kernels; nothing is padded on the host.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;     // [B, N] int32, or nullptr
  const int* tiles;   // [B, nQ, nK] key-tile lists, or nullptr (visit all)
  const int* counts;  // [B, nQ] list lengths, or nullptr
  void* o;            // [B, N, H, D] contiguous, input dtype
  float* lse;         // [B, H, N] contiguous fp32
  int B, N, H;
  long long q_sb, q_sn, q_sh;  // element strides of q, k, v (last dim 1)
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  float scale;
};

// The key tiles a CTA visits: its schedule list, or all of them.
struct TileList {
  const int* list;
  int count;
  __device__ __forceinline__ int operator[](int i) const { return list ? list[i] : i; }
};

__device__ __forceinline__ TileList tile_list(const Args& a, int qt, int b, int block_k) {
  const int nk = (a.N + block_k - 1) / block_k;
  if (!a.tiles) return TileList{nullptr, nk};
  const long long row = static_cast<long long>(b) * gridDim.x + qt;
  return TileList{a.tiles + row * nk, a.counts[row]};
}

// ------------------------------------------------------------ tile schedule

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One CTA per batch row b. Summaries of the q tiles (block_q rows) and key
// tiles (block_k rows) go to shared memory: min and max of the ids >= 0
// (INT_MAX and -1 when there are none) and whether a negative id occurs.
// Then one warp per q tile writes the ascending list of the key tiles it
// meets, -1 after the last, and the list's length.
__global__ void __launch_bounds__(256)
    flash_tile_schedule_kernel(const int* __restrict__ seg, int* __restrict__ tiles,
                               int* __restrict__ counts, int N, int block_q, int block_k,
                               int nq, int nk) {
  extern __shared__ int sm[];
  int* lo = sm;                     // [nq + nk]: q tiles first, then key tiles
  int* hi = lo + nq + nk;
  int* neg = hi + nq + nk;
  const int b = blockIdx.x;
  const int* s = seg + static_cast<long long>(b) * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int t = warp; t < nq + nk; t += n_warps) {
    const int block = t < nq ? block_q : block_k;
    const int r0 = (t < nq ? t : t - nq) * block;
    const int r1 = min(r0 + block, N);
    int l = INT_MAX, h = -1, ng = 0;
    for (int r = r0 + lane; r < r1; r += 32) {
      const int id = s[r];
      if (id < 0) {
        ng = 1;
      } else {
        l = min(l, id);
        h = max(h, id);
      }
    }
    l = warp_min(l);
    h = warp_max(h);
    ng = __any_sync(0xffffffffu, ng);
    if (lane == 0) {
      lo[t] = l;
      hi[t] = h;
      neg[t] = ng;
    }
  }
  __syncthreads();
  for (int i = warp; i < nq; i += n_warps) {
    int* out = tiles + (static_cast<long long>(b) * nq + i) * nk;
    int n = 0;
    for (int j0 = 0; j0 < nk; j0 += 32) {
      const int j = j0 + lane;
      bool meet = false;
      if (j < nk) {
        const int kt = nq + j;
        meet = (neg[i] && neg[kt]) || max(lo[i], lo[kt]) <= min(hi[i], hi[kt]);
      }
      const unsigned m = __ballot_sync(0xffffffffu, meet);
      if (meet) out[n + __popc(m & ((1u << lane) - 1u))] = j;
      n += __popc(m);
    }
    for (int j = n + lane; j < nk; j += 32) out[j] = -1;
    if (lane == 0) counts[static_cast<long long>(b) * nq + i] = n;
  }
}

cudaError_t launch_schedule(const int* seg, int* tiles, int* counts, int B, int N,
                            int block_q, int block_k, cudaStream_t st) {
  const int nq = (N + block_q - 1) / block_q, nk = (N + block_k - 1) / block_k;
  const size_t smem = 3 * sizeof(int) * static_cast<size_t>(nq + nk);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  flash_tile_schedule_kernel<<<B, 256, smem, st>>>(seg, tiles, counts, N, block_q, block_k,
                                                   nq, nk);
  return cudaGetLastError();
}

// -------------------------------------------- bf16 helpers (both bf16 bodies)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------ bf16, head_dim 64: TMA + wgmma body

namespace wg {

using namespace hopper;

constexpr int kBQ = 64, kBK = 64, kD = 64;
constexpr int kStages = 3;
constexpr int kTileBytes = 64 * kD * 2;  // one 64-row bf16 tile: 8 KB
constexpr int kThreads = 160;            // consumer warpgroup + producer warp
// Q, then the K and V rings, each tile 1024-byte aligned (the 128-byte
// swizzle repeats every 8 rows of 128 bytes), then the mbarriers
constexpr int kBarOffset = kTileBytes * (1 + 2 * kStages);
constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (1 + 3 * kStages);

// The ids of this thread's 16 key columns of the tile at k0 (keys past N
// get -3, which matches nothing).
__device__ __forceinline__ void load_key_ids(int (&sk)[16], const int* segb, int k0, int t,
                                             int N) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = k0 + 8 * c + 2 * t + e;
      sk[2 * c + e] = n < N ? __ldg(segb + n) : -3;
    }
  }
}

// The online softmax over one S tile, in place: masks, scales into log2
// units (sl2 = scale * log2 e), updates the running max m and sum l of
// rows g (lo) and g + 8 (hi), leaves P = exp2(x - m) in fp32 in sc and
// returns the factors that rescale O.
struct Rows {
  float m_lo, m_hi, l_lo, l_hi;
};

__device__ __forceinline__ void softmax_tile(float (&sc)[32], Rows& r, float& alpha_lo,
                                             float& alpha_hi, const int (&sk)[16], bool has_seg,
                                             int sq_lo, int sq_hi, int k0, int t, int N,
                                             float sl2) {
  const bool masked = has_seg || k0 + kBK > N;
  float mx_lo = r.m_lo, mx_hi = r.m_hi;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x_lo = sc[4 * c + e] * sl2, x_hi = sc[4 * c + 2 + e] * sl2;
      if (masked) {
        const bool in = k0 + 8 * c + 2 * t + e < N;
        if (!in || (has_seg && sk[2 * c + e] != sq_lo)) x_lo = kNegInf;
        if (!in || (has_seg && sk[2 * c + e] != sq_hi)) x_hi = kNegInf;
      }
      sc[4 * c + e] = x_lo;
      sc[4 * c + 2 + e] = x_hi;
      mx_lo = fmaxf(mx_lo, x_lo);
      mx_hi = fmaxf(mx_hi, x_hi);
    }
  }
  // the four threads of a quad share rows g and g + 8
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  alpha_lo = fast_exp2(r.m_lo - mx_lo);
  alpha_hi = fast_exp2(r.m_hi - mx_hi);
  r.m_lo = mx_lo;
  r.m_hi = mx_hi;
  float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * c + e] = fast_exp2(sc[4 * c + e] - mx_lo);
      sc[4 * c + 2 + e] = fast_exp2(sc[4 * c + 2 + e] - mx_hi);
      rs_lo += sc[4 * c + e];
      rs_hi += sc[4 * c + 2 + e];
    }
  }
  rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 1);
  rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 2);
  rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 1);
  rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 2);
  r.l_lo = r.l_lo * alpha_lo + rs_lo;
  r.l_hi = r.l_hi * alpha_hi + rs_hi;
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned base in the shared window
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + kTileBytes;                 // stage s at + s * kTileBytes
  const uint32_t s_v = s_k + kStages * kTileBytes;
  const uint32_t bar = s_q + kBarOffset;                 // q_full, then per stage:
  const uint32_t bar_q = bar;                            //   k_full, v_full, empty
  auto bar_k = [&](int s) { return bar + 8 * (1 + 3 * s); };
  auto bar_v = [&](int s) { return bar + 8 * (2 + 3 * s); };
  auto bar_e = [&](int s) { return bar + 8 * (3 + 3 * s); };

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int N = a.N;
  const TileList tl = tile_list(a, qt, b, kBK);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_e(s), 128);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(bar_q, kTileBytes);
      tma_load(s_q, &map_q, bar_q, h, q0, b);
      for (int it = 0; it < tl.count; ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        // the stage's previous tile (it - kStages) has been released
        if (it >= kStages) mbar_wait(bar_e(s), ph ^ 1);
        const int k0 = tl[it] * kBK;
        mbar_expect_tx(bar_k(s), kTileBytes);
        tma_load(s_k + s * kTileBytes, &map_k, bar_k(s), h, k0, b);
        mbar_expect_tx(bar_v(s), kTileBytes);
        tma_load(s_v + s * kTileBytes, &map_v, bar_v(s), h, k0, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: warp w owns q rows [16w, 16w + 16) of the tile;
  // in the wgmma layouts lane (g, t) = (lane / 4, lane % 4) holds rows g and
  // g + 8 of them and, in each 8-column chunk c, columns 8c + 2t and + 1.
  // The loop overlaps the softmax of tile it + 1 with the tensor cores'
  // P V of tile it: S(it + 1) is issued before P V(it), and the softmax
  // waits only for S(it + 1).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_lo = q0 + warp * 16 + g, n_hi = n_lo + 8;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;
  const bool has_seg = segb != nullptr;
  const float sl2 = a.scale * kLog2e;
  // rows past N get id -2 and keys past N -3: they match nothing
  int sq_lo = -2, sq_hi = -2;
  if (has_seg) {
    if (n_lo < N) sq_lo = __ldg(segb + n_lo);
    if (n_hi < N) sq_hi = __ldg(segb + n_hi);
  }
  Rows r{kNegInf, kNegInf, 0.f, 0.f};
  float o[32], sc[32];
  uint32_t pa[16];
  int sk[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  if (tl.count > 0) {
    int k0 = tl[0] * kBK;
    if (has_seg) load_key_ids(sk, segb, k0, t, N);
    mbar_wait(bar_q, 0);
    mbar_wait(bar_k(0), 0);
    wgmma_fence();
    issue_qk(sc, s_q, s_k);
    wgmma_wait<0>();
    fence_regs(sc);
    float alpha_lo, alpha_hi;
    softmax_tile(sc, r, alpha_lo, alpha_hi, sk, has_seg, sq_lo, sq_hi, k0, t, N, sl2);
    pack_frags(pa, sc);
  }
  for (int it = 0; it < tl.count; ++it) {
    const int s = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const bool next = it + 1 < tl.count;
    const int sn = (it + 1) % kStages;
    int k0 = 0;
    if (next) {
      k0 = tl[it + 1] * kBK;
      if (has_seg) load_key_ids(sk, segb, k0, t, N);
      mbar_wait(bar_k(sn), ((it + 1) / kStages) & 1);
    }
    wgmma_fence();
    if (next) issue_qk(sc, s_q, s_k + sn * kTileBytes);
    mbar_wait(bar_v(s), ph);
    issue_pv(o, pa, s_v + s * kTileBytes);
    float alpha_lo = 1.f, alpha_hi = 1.f;
    if (next) {
      wgmma_wait<1>();  // S(it + 1) is done; P V(it) may still run
      fence_regs(sc);
      softmax_tile(sc, r, alpha_lo, alpha_hi, sk, has_seg, sq_lo, sq_hi, k0, t, N, sl2);
    }
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(bar_e(s));
    if (next) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        o[4 * c] *= alpha_lo;
        o[4 * c + 1] *= alpha_lo;
        o[4 * c + 2] *= alpha_hi;
        o[4 * c + 3] *= alpha_hi;
      }
      pack_frags(pa, sc);
    }
  }

  const int HD = a.H * kD;
  uint16_t* ob = static_cast<uint16_t*>(a.o) + static_cast<long long>(b) * N * HD + h * kD;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * t;
    if (n_lo < N)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(n_lo) * HD + col) =
          pack_bf16(o[4 * c] / r.l_lo, o[4 * c + 1] / r.l_lo);
    if (n_hi < N)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(n_hi) * HD + col) =
          pack_bf16(o[4 * c + 2] / r.l_hi, o[4 * c + 3] / r.l_hi);
  }
  if (t == 0) {
    // LSE in natural units: the running max is in log2 units
    float* lb = a.lse + (static_cast<long long>(b) * a.H + h) * N;
    if (n_lo < N) lb[n_lo] = r.m_lo * kLn2 + logf(r.l_lo);
    if (n_hi < N) lb[n_hi] = r.m_hi * kLn2 + logf(r.l_hi);
  }
}

cudaError_t launch(const Args& a, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, a.q, a.B, a.N, a.H, a.q_sb, a.q_sn, a.q_sh) ||
      !make_map(&mk, a.k, a.B, a.N, a.H, a.k_sb, a.k_sn, a.k_sh) ||
      !make_map(&mv, a.v, a.B, a.N, a.H, a.v_sb, a.v_sn, a.v_sh))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.N + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_wgmma<<<grid, kThreads, kSmemBytes, st>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

}  // namespace wg

// ------------------------------- bf16, head_dim 128: mma.sync body

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + 64) of one head of a [*, N, *, D] bf16 tensor into
// shared memory with row pitch LD; rows past N are zero.
template <int D, int LD>
__device__ __forceinline__ void load_tile(uint16_t* s, const uint16_t* base,
                                          long long sn, int row0, int N) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int n = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) val = *reinterpret_cast<const uint4*>(base + n * sn + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16(Args a) {
  constexpr int kBQ = 64, kBK = 64, LD = D + 8;
  __shared__ __align__(16) uint16_t sK[kBK * LD];
  __shared__ __align__(16) uint16_t sV[kBK * LD];
  __shared__ int sSeg[kBK];

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = a.N;
  const uint16_t* qb = static_cast<const uint16_t*>(a.q) + b * a.q_sb + h * a.q_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(a.k) + b * a.k_sb + h * a.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;
  const TileList tl = tile_list(a, blockIdx.x, b, kBK);

  // Q tile staged through sK, then kept as A fragments in registers.
  load_tile<D, LD>(sK, qb, a.q_sn, q0, N);
  __syncthreads();
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint16_t* p = sK + kc * 16 + 2 * t;
    qf[kc][0] = ld_pair(p + r_lo * LD);
    qf[kc][1] = ld_pair(p + r_hi * LD);
    qf[kc][2] = ld_pair(p + r_lo * LD + 8);
    qf[kc][3] = ld_pair(p + r_hi * LD + 8);
  }
  __syncthreads();

  const int n_lo = q0 + r_lo, n_hi = q0 + r_hi;
  // rows past N get id -2, which matches no key (keys carry >= -1)
  int sq_lo = -2, sq_hi = -2;
  if (segb) {
    if (n_lo < N) sq_lo = segb[n_lo];
    if (n_hi < N) sq_hi = segb[n_hi];
  }
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < tl.count; ++it) {
    const int k0 = tl[it] * kBK;
    load_tile<D, LD>(sK, kb, a.k_sn, k0, N);
    load_tile<D, LD>(sV, vb, a.v_sn, k0, N);
    if (threadIdx.x < kBK) {
      const int n = k0 + threadIdx.x;
      sSeg[threadIdx.x] = n < N ? (segb ? segb[n] : 0) : 0;
    }
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const uint16_t* p = sK + (j * 8 + g) * LD + kc * 16 + 2 * t;
        mma_bf16(s[j], qf[kc], ld_pair(p), ld_pair(p + 8));
      }
    }

    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const bool in = k0 + col < N;
        const int sk = sSeg[col];
        float x_lo = s[j][e] * a.scale, x_hi = s[j][2 + e] * a.scale;
        if (!in || (segb && sk != sq_lo)) x_lo = kNegInf;
        if (!in || (segb && sk != sq_hi)) x_hi = kNegInf;
        s[j][e] = x_lo;
        s[j][2 + e] = x_hi;
        mx_lo = fmaxf(mx_lo, x_lo);
        mx_hi = fmaxf(mx_hi, x_hi);
      }
    }
    // the four threads of a quad share rows g and g + 8
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float alpha_lo = exp2f((m_lo - mx_lo) * kLog2e);
    const float alpha_hi = exp2f((m_hi - mx_hi) * kLog2e);
    m_lo = mx_lo;
    m_hi = mx_hi;

    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f((s[j][e] - m_lo) * kLog2e);
        s[j][2 + e] = exp2f((s[j][2 + e] - m_hi) * kLog2e);
        rs_lo += s[j][e];
        rs_hi += s[j][2 + e];
      }
    }
    rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 1);
    rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 2);
    rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 1);
    rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 2);
    l_lo = l_lo * alpha_lo + rs_lo;
    l_hi = l_hi * alpha_hi + rs_hi;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha_lo;
      acc[i][1] *= alpha_lo;
      acc[i][2] *= alpha_hi;
      acc[i][3] *= alpha_hi;
    }

    // O += P V: the S accumulators of key columns [16kk, 16kk + 16) are
    // exactly the A fragment of P for that k-step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        // B[k][n] = V[16kk + k][8i + n]: keys 2t, 2t+1 and 2t+8, 2t+9
        const uint16_t* p = sV + (kk * 16 + 2 * t) * LD + i * 8 + g;
        const uint32_t b0 = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[LD]) << 16);
        const uint32_t b1 =
            static_cast<uint32_t>(p[8 * LD]) | (static_cast<uint32_t>(p[9 * LD]) << 16);
        mma_bf16(acc[i], pa, b0, b1);
      }
    }
    __syncthreads();
  }

  const int HD = a.H * D;
  uint16_t* ob = static_cast<uint16_t*>(a.o) + static_cast<long long>(b) * N * HD + h * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (n_lo < N)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(n_lo) * HD + col) =
          pack_bf16(acc[i][0] / l_lo, acc[i][1] / l_lo);
    if (n_hi < N)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(n_hi) * HD + col) =
          pack_bf16(acc[i][2] / l_hi, acc[i][3] / l_hi);
  }
  if (t == 0) {
    float* lb = a.lse + (static_cast<long long>(b) * a.H + h) * N;
    if (n_lo < N) lb[n_lo] = m_lo + logf(l_lo);
    if (n_hi < N) lb[n_hi] = m_hi + logf(l_hi);
  }
}

// ---------------------------------------------------------------- fp32 path

constexpr int kF32BK = 32;  // key tile of the fp32 path

template <int D>
__global__ void __launch_bounds__(64) flash_fwd_f32(Args a) {
  constexpr int kBQ = 64, kBK = kF32BK;
  __shared__ float sK[kBK][D];
  __shared__ float sV[kBK][D];
  __shared__ int sSeg[kBK];

  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int n_q = blockIdx.x * kBQ + threadIdx.x;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;
  const TileList tl = tile_list(a, blockIdx.x, b, kBK);

  float q[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = n_q < N ? qb[n_q * a.q_sn + d] * a.scale : 0.f;
    acc[d] = 0.f;
  }
  const int sq = (segb && n_q < N) ? segb[n_q] : -2;
  float m = kNegInf, l = 0.f;

  for (int it = 0; it < tl.count; ++it) {
    const int k0 = tl[it] * kBK;
    for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
      const int r = i / D, c = i % D, n = k0 + r;
      sK[r][c] = n < N ? kb[n * a.k_sn + c] : 0.f;
      sV[r][c] = n < N ? vb[n * a.v_sn + c] : 0.f;
    }
    if (threadIdx.x < kBK) {
      const int n = k0 + threadIdx.x;
      sSeg[threadIdx.x] = n < N ? (segb ? segb[n] : 0) : 0;
    }
    __syncthreads();

    float s[kBK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(q[d], sK[j][d], dot);
      const bool ok = (k0 + j < N) && (!segb || sSeg[j] == sq);
      s[j] = ok ? dot : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m);
      rs += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, sV[j][d], acc[d]);
    }
    l = l * alpha + rs;
    __syncthreads();
  }

  if (n_q < N) {
    float* orow = static_cast<float*>(a.o) + (static_cast<long long>(b) * N + n_q) * a.H * D + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / l;
    a.lse[(static_cast<long long>(b) * a.H + h) * N + n_q] = m + logf(l);
  }
}

}  // namespace

extern "C" {

// Launches one forward on `stream` and returns cudaGetLastError() (0 when
// the launches were accepted). dtype: 0 = fp32, 1 = bf16; D must be 64 or
// 128. With segment ids, `tiles` [B, nQ, nK] and `counts` [B, nQ] int32
// receive the tile schedule (nQ = ceil(N / block_q), nK = ceil(N / block_k))
// built first by the schedule kernel; block_q and block_k must be the
// instance's tiles: 64 x 64 for bf16, 64 x 32 for fp32. Without segment ids
// `seg`, `tiles` and `counts` are null and every key tile is visited.
int dinov3_flash_fwd(const void* q, const void* k, const void* v, const int* seg, int* tiles,
                     int* counts, int block_q, int block_k, void* o, float* lse, int B, int N,
                     int H, int D, int dtype, long long q_sb, long long q_sn, long long q_sh,
                     long long k_sb, long long k_sn, long long k_sh, long long v_sb,
                     long long v_sn, long long v_sh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int want_bk = dtype == 1 ? 64 : kF32BK;
  if ((D != 64 && D != 128) || (dtype != 0 && dtype != 1) || block_q != 64 ||
      block_k != want_bk || (seg != nullptr) != (tiles != nullptr && counts != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (seg) {
    const cudaError_t err = launch_schedule(seg, tiles, counts, B, N, block_q, block_k, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args a{q, k, v, seg, tiles, counts, o, lse, B, N, H,
         q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, scale};
  const dim3 grid((N + 63) / 64, H, B);
  if (dtype == 1 && D == 64) {
    return static_cast<int>(wg::launch(a, st));
  } else if (dtype == 1) {
    flash_fwd_bf16<128><<<grid, 128, 0, st>>>(a);
  } else if (D == 64) {
    flash_fwd_f32<64><<<grid, 64, 0, st>>>(a);
  } else {
    flash_fwd_f32<128><<<grid, 64, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dinov3_flash_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The tile schedule alone: `tiles` [B, nQ, nK] and `counts` [B, nQ] int32
// from seg [B, N] int32, as dinov3_flash_fwd builds it before its main
// kernel. Returns cudaGetLastError().
int dinov3_flash_tile_schedule(const int* seg, int* tiles, int* counts, int B, int N,
                               int block_q, int block_k, void* stream) {
  if (block_q < 1 || block_k < 1 || B < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_schedule(seg, tiles, counts, B, N, block_q, block_k,
                                          static_cast<cudaStream_t>(stream)));
}

const char* dinov3_flash_tile_schedule_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
