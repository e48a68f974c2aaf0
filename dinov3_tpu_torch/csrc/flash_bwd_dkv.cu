// Flash-attention backward, dK/dV part, for Hopper (sm_90a).
//
// Replaces the TPU kernel dinov3_tpu/ops/flash_attention.py `_bwd_pallas`'s
// second pallas_call (body `_dkv_kernel`). For each key, over every q row
// that may attend it:
//   P  = exp(S * scale - LSE), S = Q K^T               (masked: P = 0)
//   dV = sum_q P^T dO
//   dS = P * (dO V^T - Delta)
//   dK = scale * sum_q dS^T Q
// LSE comes from the forward (csrc/flash_fwd.cu) and Delta = sum_d dO * O
// from the dQ kernel (csrc/flash_bwd_dq.cu), launched before this one. A
// pair is masked when the q row lies past N (the reference's out-of-range
// row mask) or, with segment ids, when the ids differ. A pad token (id -1)
// meets its own pad segment, so every softmax row is non-empty and P stays
// finite; exp(-1e30 - LSE) of the forward's masked logits is exactly the 0
// written here.
//
// What bounds it: the four products over the segment pairs (S, dO V^T,
// P^T dO and dS^T Q: 8 * d * pairs a head) against the bytes of q, k, v,
// dO, LSE, Delta, dK and dV. At a student block of the training step
// ([81 x 16, 197, 64] bf16 with the packed ids) the bytes bound it (0.059
// ms, against ~0.02 ms of tensor-core work); what held the first port of
// this kernel far above that was the latency of its synchronous tile loads
// and short loops (a key tile meets 3-4 q tiles at N = 197) and the masked
// q tiles it walked.
//
// What the design does:
// - Skipping. With segment ids a CTA walks only the q tiles on its key
//   tile's list in K1's tile schedule (64-row q tiles, 64-key tiles), which
//   the forward built and the caller keeps. The schedule lists, per q tile
//   i, the key tiles j that meet it, and meet(i, j) reads only the two
//   tiles' summaries (min and max of the ids >= 0 over positions < N, and
//   whether a negative id occurs), computed alike for q and key tiles of
//   one seg row. With both tiles 64 wide the summaries of q tile j and key
//   tile j are the same, so meet is symmetric and row j of the schedule,
//   the key tiles that meet q tile j, is exactly the list of q tiles that
//   meet key tile j. The schedule is conservative, so every q row whose id
//   equals the id of a key of the tile lies in a listed q tile, and a
//   skipped q tile would add exactly 0 (all its P are masked). Without
//   segment ids every q tile is walked.
// - bf16, head_dim 64 (every ViT up to ViT-L): TMA + wgmma, with the
//   building blocks of K1's body (csrc/hopper.cuh). A CTA of one consumer
//   warpgroup and one producer warp takes (64-key tile, head, batch row)
//   items on a persistent grid (as many CTAs as fit on the SMs: two an
//   SM), so that the producer loads the next item's K and V (two slots)
//   and first q tiles while the consumers finish this one (one CTA an
//   item was slower). The producer loads an item's K and V tiles once,
//   then streams its listed Q and dO tiles (4-D tensor maps over [B, N, h,
//   d] through the tensors' strides, 128-byte swizzle; rows past N arrive
//   as zeros) through a three-stage mbarrier ring; its
//   32 lanes copy each q tile's LSE (in log2 units, +inf past N so that P
//   is 0 there), Delta and ids beside them. Per q tile the consumer issues
//   S^T = K Q^T and dP^T = V dO^T (wgmma from shared memory, contracting
//   over d: both K-major), forms P^T = exp2(S^T scale log2(e) - LSE) with
//   the masks (`ex2.approx`) and dS^T = P^T (dP^T - Delta) in fp32
//   registers, and issues dV += P^T dO and dK += dS^T Q with A from
//   registers (the accumulator layout of S^T is the A-fragment layout; P^T
//   and dS^T are rounded to bf16) and B the same Q and dO tiles read
//   MN-major (the transposed-B mode, contracting over the q rows). The
//   CTA does not overlap its own products with forming P^T: that needs
//   S^T and dP^T of the next tile live beside P^T, dS^T, dK and dV (160
//   accumulator registers, over the 168 that two CTAs an SM allow), and
//   the other CTA on the SM keeps the tensor cores busy instead. dK and dV
//   stay in fp32 registers for the whole walk and are written once: no
//   atomics, so two runs give the same bits.
// - bf16, head_dim 128 (no caller on the main path): `mma.sync.m16n8k16`
//   (fp32 accumulate), one CTA of 4 warps per (64-key tile, head, batch
//   row), each warp owning 16 keys. K and V stay in registers as A
//   fragments; the listed q tiles of 64 rows of Q and dO, with their LSE,
//   Delta and segment ids, are staged through padded shared memory. S^T =
//   K Q^T and dP^T = V dO^T come out in the accumulator layout, which is
//   the A-fragment layout of the next products, so P^T and dS^T are
//   rounded to bf16 in registers and fed straight into dV += P^T dO and
//   dK += dS^T Q; the sums stay in fp32 registers.
// - fp32: one thread per key, k, v and both sums in registers, q/dO tiles of
//   32 rows in shared memory, scalar FMAs, fp32 throughout; every q tile.
// - q, k, v and dO are read through their strides in the [B, N, h, d]
//   layout; dK and dV are written as contiguous [B, N, h, d].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* seg;      // [B, N] int32, or nullptr
  const int* tiles;    // [B, nT, nT] K1's schedule (64 x 64), or nullptr
  const int* counts;   // [B, nT] its list lengths, or nullptr
  const float* lse;    // [B, H, N] fp32
  const float* delta;  // [B, H, N] fp32
  void* dk;            // [B, N, H, D] contiguous, input dtype
  void* dv;
  int B, N, H;
  long long q_sb, q_sn, q_sh;  // element strides (last dim 1)
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long d_sb, d_sn, d_sh;
  float scale;
};

// The q tiles a CTA of key tile kt visits: row kt of K1's schedule (see the
// note above: the 64 x 64 schedule is symmetric), or every 64-row q tile.
__device__ __forceinline__ hopper::TileList q_tile_list(const Args& a, int kt, int b) {
  return hopper::schedule_row(a.tiles, a.counts, (a.N + 63) / 64, kt, b);
}

// ------------------------------- bf16 helpers, and the head_dim-128 body

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// A fragments of a warp's 16 rows (r_lo and r_lo + 8) of a staged tile.
template <int D, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const uint16_t* s,
                                             int r_lo, int t) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint16_t* p = s + kc * 16 + 2 * t;
    f[kc][0] = ld_pair(p + r_lo * LD);
    f[kc][1] = ld_pair(p + (r_lo + 8) * LD);
    f[kc][2] = ld_pair(p + r_lo * LD + 8);
    f[kc][3] = ld_pair(p + (r_lo + 8) * LD + 8);
  }
}

// acc[j] += A (16 x D) . Bt^T over the 64 staged rows of Bt.
template <int D, int LD>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const uint32_t (&a)[D / 16][4],
                                         const uint16_t* sB, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint16_t* p = sB + (j * 8 + g) * LD + kc * 16 + 2 * t;
      mma_bf16(acc[j], a[kc], ld_pair(p), ld_pair(p + 8));
    }
  }
}

// acc[i] += A (16 x 64, x rounded to bf16) . Bm over the staged [64, D] Bm.
template <int D, int LD>
__device__ __forceinline__ void mma_cols(float (&acc)[D / 8][4], const float (&x)[8][4],
                                         const uint16_t* sB, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const uint16_t* p = sB + (kk * 16 + 2 * t) * LD + i * 8 + g;
      const uint32_t b0 = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[LD]) << 16);
      const uint32_t b1 =
          static_cast<uint32_t>(p[8 * LD]) | (static_cast<uint32_t>(p[9 * LD]) << 16);
      mma_bf16(acc[i], pa, b0, b1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16(Args a) {
  constexpr int kBQ = 64, LD = D + 8;
  __shared__ __align__(16) uint16_t sQ[kBQ * LD];
  __shared__ __align__(16) uint16_t sD[kBQ * LD];
  __shared__ float sLse[kBQ], sDelta[kBQ];
  __shared__ int sSeg[kBQ];

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = a.N;
  const uint16_t* qb = static_cast<const uint16_t*>(a.q) + b * a.q_sb + h * a.q_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(a.k) + b * a.k_sb + h * a.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(a.v) + b * a.v_sb + h * a.v_sh;
  const uint16_t* db = static_cast<const uint16_t*>(a.dout) + b * a.d_sb + h * a.d_sh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;
  const long long bh = static_cast<long long>(b) * a.H + h;

  // K and V tiles staged through sQ and sD, then kept as A fragments
  load_tile<D, LD>(sQ, kb, a.k_sn, k0, N);
  load_tile<D, LD>(sD, vb, a.v_sn, k0, N);
  __syncthreads();
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D, LD>(kf, sQ, r_lo, t);
  load_a_frags<D, LD>(vf, sD, r_lo, t);
  __syncthreads();

  const int n_lo = k0 + r_lo, n_hi = k0 + r_hi;
  // keys past N get id -3, which matches no q row (rows carry >= -2); their
  // sums are never written
  int sk_lo = -3, sk_hi = -3;
  if (n_lo < N) sk_lo = segb ? segb[n_lo] : 0;
  if (n_hi < N) sk_hi = segb ? segb[n_hi] : 0;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  const hopper::TileList tl = q_tile_list(a, blockIdx.x, b);
  for (int it = 0; it < tl.count; ++it) {
    const int q0 = tl[it] * kBQ;
    load_tile<D, LD>(sQ, qb, a.q_sn, q0, N);
    load_tile<D, LD>(sD, db, a.d_sn, q0, N);
    if (threadIdx.x < kBQ) {
      const int n = q0 + threadIdx.x;
      const bool in = n < N;
      sLse[threadIdx.x] = in ? a.lse[bh * N + n] : 0.f;
      sDelta[threadIdx.x] = in ? a.delta[bh * N + n] : 0.f;
      // q rows past N carry -2: masked against every key below
      sSeg[threadIdx.x] = in ? (segb ? segb[n] : 0) : -2;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_rows<D, LD>(s, kf, sQ, g, t);   // S^T = K Q^T
    mma_rows<D, LD>(dp, vf, sD, g, t);  // dP^T = V dO^T

    // P^T in s, dS^T in dp
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const int sq = sSeg[col];
        const float ls = sLse[col], dl = sDelta[col];
        const float p_lo = sq == sk_lo ? exp2f((s[j][e] * a.scale - ls) * kLog2e) : 0.f;
        const float p_hi = sq == sk_hi ? exp2f((s[j][2 + e] * a.scale - ls) * kLog2e) : 0.f;
        s[j][e] = p_lo;
        s[j][2 + e] = p_hi;
        dp[j][e] = p_lo * (dp[j][e] - dl);
        dp[j][2 + e] = p_hi * (dp[j][2 + e] - dl);
      }
    }
    mma_cols<D, LD>(dv, s, sD, g, t);   // dV += P^T dO
    mma_cols<D, LD>(dk, dp, sQ, g, t);  // dK += dS^T Q
    __syncthreads();
  }

  const int HD = a.H * D;
  const long long base = static_cast<long long>(b) * N * HD + h * D;
  uint16_t* dkb = static_cast<uint16_t*>(a.dk) + base;
  uint16_t* dvb = static_cast<uint16_t*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (n_lo < N) {
      const long long o = static_cast<long long>(n_lo) * HD + col;
      *reinterpret_cast<uint32_t*>(dkb + o) = pack_bf16(dk[i][0] * a.scale, dk[i][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + o) = pack_bf16(dv[i][0], dv[i][1]);
    }
    if (n_hi < N) {
      const long long o = static_cast<long long>(n_hi) * HD + col;
      *reinterpret_cast<uint32_t*>(dkb + o) = pack_bf16(dk[i][2] * a.scale, dk[i][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + o) = pack_bf16(dv[i][2], dv[i][3]);
    }
  }
}

// ------------------------------------ bf16, head_dim 64: TMA + wgmma body

namespace wg {

using namespace hopper;

constexpr int kStages = 3;
constexpr int kThreads = 160;  // consumer warpgroup + producer warp

constexpr int kKv = 2;         // K/V slots: this item's and the next one's
// Shared memory: the K/V slots, the Q ring and the dO ring (each tile
// 1024-byte aligned: the 128-byte swizzle repeats every 8 rows of 128
// bytes), then per stage the q rows' LSE (log2 units), Delta and ids, then
// the mbarriers
constexpr int kRowOffset = kTileBytes * (2 * kKv + 2 * kStages);
constexpr int kBarOffset = kRowOffset + 3 * kStages * kRows * 4;
constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (2 * kKv + 2 * kStages);

// P^T and dS^T of one q tile in place of S^T (sc) and dP^T (dp), for this
// thread's keys (ids sk_lo, sk_hi) and q columns 8c + 2t + e: lse2 holds
// the q rows' LSE in log2 units (+inf past N), delta their Delta, seg their
// ids.
__device__ __forceinline__ void form_p_ds(float (&sc)[32], float (&dp)[32], const float* lse2,
                                          const float* delta, const int* seg, int sk_lo,
                                          int sk_hi, int t, float sl2) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * c + 2 * t + e;
      const float l = lse2[col], d = delta[col];
      const int id = seg[col];
      const float p_lo = id == sk_lo ? fast_exp2(sc[4 * c + e] * sl2 - l) : 0.f;
      const float p_hi = id == sk_hi ? fast_exp2(sc[4 * c + 2 + e] * sl2 - l) : 0.f;
      sc[4 * c + e] = p_lo;
      sc[4 * c + 2 + e] = p_hi;
      dp[4 * c + e] = p_lo * (dp[4 * c + e] - d);
      dp[4 * c + 2 + e] = p_hi * (dp[4 * c + 2 + e] - d);
    }
  }
}

// A persistent grid (as many CTAs as fit on the SMs) walks the items; the
// producer loads the next item's K and V (the other slot) and q tiles
// while the consumers finish this one.
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned base in the shared window
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t s_k = smem_u32(smem);                // slot j at + j * kTileBytes
  const uint32_t s_v = s_k + kKv * kTileBytes;
  const uint32_t s_q = s_v + kKv * kTileBytes;        // stage s at + s * kTileBytes
  const uint32_t s_do = s_q + kStages * kTileBytes;
  float* row_lse = reinterpret_cast<float*>(smem + kRowOffset);  // [kStages][64] each
  float* row_delta = row_lse + kStages * kRows;
  int* row_seg = reinterpret_cast<int*>(row_delta + kStages * kRows);
  // per K/V slot: full, empty; then per ring stage: full, empty
  const uint32_t bar = s_k + kBarOffset;
  auto bar_kvf = [&](int j) { return bar + 8 * (2 * j); };
  auto bar_kve = [&](int j) { return bar + 8 * (2 * j + 1); };
  auto bar_f = [&](int s) { return bar + 8 * (2 * kKv + 2 * s); };
  auto bar_e = [&](int s) { return bar + 8 * (2 * kKv + 2 * s + 1); };
  const int N = a.N;

  if (threadIdx.x == 0) {
    for (int j = 0; j < kKv; ++j) {
      mbar_init(bar_kvf(j), 1);
      mbar_init(bar_kve(j), 128);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f(s), 1 + 32);  // the copy's expect_tx, then the 32 row copiers
      mbar_init(bar_e(s), 128);     // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Items items((N + kRows - 1) / kRows, a.H, a.B);
  Item item;
  if (threadIdx.x >= 128) {
    // ---- producer warp: lane 0 issues the copies, all 32 lanes copy the
    // q rows' LSE, Delta and ids. gi counts q tiles over all items (the
    // ring's position), j the items (the K/V slots').
    const int lane = threadIdx.x - 128;
    int gi = 0;
    for (int j = 0; items.get(item); ++j) {
      const int slot = j % kKv;
      const int k0 = item.tile * kRows;
      // the slot's previous item (j - kKv) has been released
      if (j >= kKv) mbar_wait(bar_kve(slot), ((j / kKv) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar_kvf(slot), 2 * kTileBytes);
        tma_load(s_k + slot * kTileBytes, &map_k, bar_kvf(slot), item.h, k0, item.b);
        tma_load(s_v + slot * kTileBytes, &map_v, bar_kvf(slot), item.h, k0, item.b);
      }
      const TileList tl = q_tile_list(a, item.tile, item.b);
      const int* segb = a.seg ? a.seg + static_cast<long long>(item.b) * N : nullptr;
      const long long bh = static_cast<long long>(item.b) * a.H + item.h;
      for (int it = 0; it < tl.count; ++it, ++gi) {
        const int s = gi % kStages;
        // the stage's previous q tile (gi - kStages) has been released
        if (gi >= kStages) mbar_wait(bar_e(s), ((gi / kStages) & 1) ^ 1);
        const int q0 = tl[it] * kRows;
        if (lane == 0) {
          mbar_expect_tx(bar_f(s), 2 * kTileBytes);
          tma_load(s_q + s * kTileBytes, &map_q, bar_f(s), item.h, q0, item.b);
          tma_load(s_do + s * kTileBytes, &map_do, bar_f(s), item.h, q0, item.b);
        }
        for (int r = lane; r < kRows; r += 32) {
          const int n = q0 + r;
          const bool in = n < N;
          row_lse[s * kRows + r] = in ? a.lse[bh * N + n] * kLog2e : __int_as_float(0x7f800000);
          row_delta[s * kRows + r] = in ? a.delta[bh * N + n] : 0.f;
          row_seg[s * kRows + r] = in && segb ? segb[n] : 0;
        }
        mbar_arrive(bar_f(s));
      }
    }
    return;
  }

  // ---- consumer warpgroup: warp w owns keys [16w, 16w + 16) of the tile;
  // lane (g, t) holds keys g and g + 8 of them and, in each 8-column chunk
  // c of a q tile, q rows 8c + 2t and + 1 (csrc/hopper.cuh). Per q tile:
  // S^T and dP^T, then P^T and dS^T in registers, then dV and dK; the
  // other CTA on the SM fills the tensor cores while this one forms P^T.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = a.scale * kLog2e;
  const int HD = a.H * kHd;
  int gi = 0;
  for (int j = 0; items.get(item); ++j) {
    const int slot = j % kKv;
    const uint32_t k_tile = s_k + slot * kTileBytes, v_tile = s_v + slot * kTileBytes;
    const int n_lo = item.tile * kRows + warp * 16 + g, n_hi = n_lo + 8;
    const TileList tl = q_tile_list(a, item.tile, item.b);
    // without ids every key and q row carries 0; keys past N are never
    // written, so their ids do not matter
    int sk_lo = 0, sk_hi = 0;
    if (a.seg) {
      const int* segb = a.seg + static_cast<long long>(item.b) * N;
      if (n_lo < N) sk_lo = __ldg(segb + n_lo);
      if (n_hi < N) sk_hi = __ldg(segb + n_hi);
    }
    float dk[32], dv[32], sc[32], dp[32];
    uint32_t pa[16], dsa[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(bar_kvf(slot), (j / kKv) & 1);
    for (int it = 0; it < tl.count; ++it, ++gi) {
      const int s = gi % kStages;
      mbar_wait(bar_f(s), (gi / kStages) & 1);
      wgmma_fence();
      issue_qk(sc, k_tile, s_q + s * kTileBytes);
      issue_qk(dp, v_tile, s_do + s * kTileBytes);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      form_p_ds(sc, dp, row_lse + s * kRows, row_delta + s * kRows, row_seg + s * kRows, sk_lo,
                sk_hi, t, sl2);
      pack_frags(pa, sc);
      pack_frags(dsa, dp);
      wgmma_fence();
      issue_pv(dv, pa, s_do + s * kTileBytes);
      issue_pv(dk, dsa, s_q + s * kTileBytes);
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(dsa);
      mbar_arrive(bar_e(s));
    }
    // every product that read this slot's K and V has completed
    mbar_arrive(bar_kve(slot));

    const long long base = static_cast<long long>(item.b) * N * HD + item.h * kHd;
    uint16_t* dkb = static_cast<uint16_t*>(a.dk) + base;
    uint16_t* dvb = static_cast<uint16_t*>(a.dv) + base;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * t;
      if (n_lo < N) {
        const long long o = static_cast<long long>(n_lo) * HD + col;
        *reinterpret_cast<uint32_t*>(dkb + o) =
            pack_bf16(dk[4 * c] * a.scale, dk[4 * c + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvb + o) = pack_bf16(dv[4 * c], dv[4 * c + 1]);
      }
      if (n_hi < N) {
        const long long o = static_cast<long long>(n_hi) * HD + col;
        *reinterpret_cast<uint32_t*>(dkb + o) =
            pack_bf16(dk[4 * c + 2] * a.scale, dk[4 * c + 3] * a.scale);
        *reinterpret_cast<uint32_t*>(dvb + o) = pack_bf16(dv[4 * c + 2], dv[4 * c + 3]);
      }
    }
  }
}

cudaError_t launch(const Args& a, cudaStream_t st) {
  CUtensorMap mq, mk, mv, md;
  if (!make_map(&mq, a.q, a.B, a.N, a.H, a.q_sb, a.q_sn, a.q_sh) ||
      !make_map(&mk, a.k, a.B, a.N, a.H, a.k_sb, a.k_sn, a.k_sh) ||
      !make_map(&mv, a.v, a.B, a.N, a.H, a.v_sb, a.v_sn, a.v_sh) ||
      !make_map(&md, a.dout, a.B, a.N, a.H, a.d_sb, a.d_sn, a.d_sh))
    return cudaErrorInvalidValue;
  static int ctas_per_sm = 0;
  const long long items = static_cast<long long>((a.N + kRows - 1) / kRows) * a.H * a.B;
  int grid = 0;
  const cudaError_t err =
      persistent_grid(flash_bwd_dkv_wgmma, kThreads, kSmemBytes, items, ctas_per_sm, grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wgmma<<<grid, kThreads, kSmemBytes, st>>>(mq, mk, mv, md, a);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------- fp32 path

template <int D>
__global__ void __launch_bounds__(64) flash_bwd_dkv_f32(Args a) {
  constexpr int kBQ = 32;
  __shared__ float sQ[kBQ][D];
  __shared__ float sD[kBQ][D];
  __shared__ float sLse[kBQ], sDelta[kBQ];
  __shared__ int sSeg[kBQ];

  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int n_k = blockIdx.x * 64 + threadIdx.x;
  const bool key_in = n_k < N;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* db = static_cast<const float*>(a.dout) + b * a.d_sb + h * a.d_sh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;
  const long long bh = static_cast<long long>(b) * a.H + h;

  float kr[D], vr[D], dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = key_in ? kb[n_k * a.k_sn + d] : 0.f;
    vr[d] = key_in ? vb[n_k * a.v_sn + d] : 0.f;
    dk[d] = dv[d] = 0.f;
  }
  const int sk = key_in ? (segb ? segb[n_k] : 0) : -3;

  for (int q0 = 0; q0 < N; q0 += kBQ) {
    for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
      const int r = i / D, c = i % D, n = q0 + r;
      sQ[r][c] = n < N ? qb[n * a.q_sn + c] : 0.f;
      sD[r][c] = n < N ? db[n * a.d_sn + c] : 0.f;
    }
    if (threadIdx.x < kBQ) {
      const int n = q0 + threadIdx.x;
      const bool in = n < N;
      sLse[threadIdx.x] = in ? a.lse[bh * N + n] : 0.f;
      sDelta[threadIdx.x] = in ? a.delta[bh * N + n] : 0.f;
      sSeg[threadIdx.x] = in ? (segb ? segb[n] : 0) : -2;
    }
    __syncthreads();
    for (int j = 0; j < kBQ; ++j) {
      if (sSeg[j] != sk) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(sQ[j][d], kr[d], s);
        dp = fmaf(sD[j][d], vr[d], dp);
      }
      const float p = expf(s * a.scale - sLse[j]);
      const float ds = p * (dp - sDelta[j]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(p, sD[j][d], dv[d]);
        dk[d] = fmaf(ds, sQ[j][d], dk[d]);
      }
    }
    __syncthreads();
  }

  if (key_in) {
    const long long o = (static_cast<long long>(b) * N + n_k) * a.H * D + h * D;
    float* dkr = static_cast<float*>(a.dk) + o;
    float* dvr = static_cast<float*>(a.dv) + o;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dkr[d] = dk[d] * a.scale;
      dvr[d] = dv[d];
    }
  }
}

}  // namespace

extern "C" {

// Launches the dK/dV backward on `stream` and returns cudaGetLastError().
// dtype: 0 = fp32, 1 = bf16. D must be 64 or 128. Writes dk, dv [B, N, H, D].
// With segment ids, the bf16 kernels take `tiles` [B, nT, nT] and `counts`
// [B, nT] int32, K1's tile schedule for 64-row q tiles and 64-key tiles
// (nT = ceil(N / 64)), and walk row kt of it for key tile kt; null tiles
// and counts walk every q tile (always so for fp32).
int dinov3_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const int* seg, const int* tiles, const int* counts,
                         const float* lse, const float* delta, void* dk,
                         void* dv, int B, int N, int H, int D, int dtype,
                         long long q_sb, long long q_sn, long long q_sh,
                         long long k_sb, long long k_sn, long long k_sh,
                         long long v_sb, long long v_sn, long long v_sh,
                         long long d_sb, long long d_sn, long long d_sh,
                         float scale, void* stream) {
  if ((tiles != nullptr) != (counts != nullptr) ||
      (tiles != nullptr && (seg == nullptr || dtype != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, dout, seg, tiles, counts, lse, delta, dk, dv, B, N, H,
         q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
         d_sb, d_sn, d_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + 63) / 64, H, B);
  if (dtype == 1 && D == 64) {
    return static_cast<int>(wg::launch(a, st));
  } else if (dtype == 1 && D == 128) {
    flash_bwd_dkv_bf16<128><<<grid, 128, 0, st>>>(a);
  } else if (dtype == 0 && D == 64) {
    flash_bwd_dkv_f32<64><<<grid, 64, 0, st>>>(a);
  } else if (dtype == 0 && D == 128) {
    flash_bwd_dkv_f32<128><<<grid, 64, 0, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dinov3_flash_bwd_dkv_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
