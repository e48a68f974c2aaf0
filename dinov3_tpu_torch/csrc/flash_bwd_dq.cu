// Flash-attention backward, dQ part (and the row term Delta), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dinov3_tpu/ops/flash_attention.py `_bwd_pallas`'s
// first pallas_call (body `_dq_kernel`), together with the Delta it takes as
// an input (`jnp.sum(do * o, -1)` in `_bwd_pallas`). For each q row:
//   Delta = sum_d dO * O                               (fp32)
//   P     = exp(S * scale - LSE), S = Q K^T            (masked keys: P = 0)
//   dS    = P * (dO V^T - Delta)
//   dQ    = scale * dS K
// A key is masked when it lies past N or, with segment ids, when its id is
// not the q row's (the forward's -1e30 logits, whose exp(-1e30 - LSE) is 0);
// a pad token (id -1) meets its own pad segment. Delta is written to a
// [B, H, N] fp32 buffer for the dK/dV kernel (csrc/flash_bwd_dkv.cu), which
// runs after this one on the same stream.
//
// What bounds it: the three products over the segment pairs (S, dO V^T and
// dS K: 6 * d * pairs a head) against the bytes of q, k, v, O, dO, LSE, dQ
// and Delta. At a student block of the training step ([81 x 16, 197, 64]
// bf16 with the packed ids) the bytes bound it (0.059 ms, against ~0.015
// ms of tensor-core work). What held the first port of this kernel far
// above that: synchronous tile loads that nothing overlapped, a prologue
// (Q and dO staged, O read for Delta) that ran alone in each short-lived
// CTA (4 key tiles at N = 197), and the masked key tiles it walked. What
// is left is latency: a key tile's products and its dS depend on each
// other in turn, so the SM hides one CTA's waits behind the other CTAs'
// work, and the design packs three CTAs onto each SM.
//
// What the design does:
// - Skipping. With segment ids a q tile walks only the key tiles on its
//   row of K1's 64 x 64 tile schedule, which the forward built and the
//   caller keeps: row i is, by construction, the list of the key tiles
//   that can hold a key whose id equals the id of a query in q tile i, so
//   a skipped key tile would add exactly 0 (all its P are masked). Without
//   segment ids every key tile is walked.
// - bf16, head_dim 64 (every ViT up to ViT-L): TMA + wgmma, on the
//   building blocks of csrc/hopper.cuh, the mirror of K3's body. A CTA of
//   one consumer warpgroup and one producer warp takes (64-row q tile,
//   head, batch row) items on a persistent grid, q tile fastest, so that
//   the q tiles of one (b, h) run together and find its K and V in L2. The
//   producer loads an item's Q and dO into one of two slots and its O
//   into one tile that is free again as soon as Delta is formed, so the
//   next item's arrive while the consumers finish this one, then streams
//   the listed K and V tiles through a two-stage mbarrier ring (4-D tensor
//   maps over [B, N, h, d] through the tensors' strides, 128-byte swizzle;
//   rows past N arrive as zeros). Its 32 lanes copy the q rows' LSE (in
//   log2 units, +inf past N so that P is 0 there) and ids beside the slot,
//   and each key tile's ids beside the tile. The consumer first forms
//   Delta from the dO and O boxes in shared memory (two threads a row, so
//   no load of the prologue is exposed), writes it once for the rows < N
//   and hands each row's Delta to the threads that own the row in the
//   wgmma layout by shuffles. Per key tile it issues S = Q K^T and dP =
//   dO V^T (wgmma from shared memory, both K-major), forms P = exp2(S
//   scale log2(e) - LSE) with the masks (`ex2.approx`) and dS = P (dP -
//   Delta) in fp32 registers, rounds dS to bf16 in the accumulator layout,
//   which is the A-fragment layout, and issues dQ += dS K with the same K
//   box read MN-major (the transposed-B mode). The CTA does not overlap
//   its own products: issuing the next tile's S and dP before this tile's
//   dQ product held the body at the 168-register cap of two CTAs an SM and
//   was slower. Instead the body fits 128 registers and its shared memory
//   75 KB, so three CTAs share each SM and fill each other's waits. Keys
//   past N arrive as zeros, so S = 0 there and exp2(0 - LSE) is not 0: the
//   mask tests the key's index against N, never a sentinel id (the ids may
//   take every int32 value). dQ stays in fp32 registers for the whole walk
//   and is written once: no atomics, so two runs give the same bits.
// - bf16, head_dim 128 (no caller on the main path): `mma.sync.m16n8k16`
//   (fp32 accumulate), one CTA of 4 warps per (64-row q tile, head, batch
//   row), each warp owning 16 q rows, walking the same list. Q and dO stay
//   in registers as A fragments; K and V tiles of 64 keys are staged
//   through padded shared memory (row pitch d + 8 halves). The masked
//   softmax and dS stay in registers, and dS is rounded to bf16 to be the
//   A operand of dS K. Delta comes from the dO fragments times O read
//   once, reduced over the quad of threads that holds a row.
// - fp32: one thread per q row, q, dO and the dQ accumulator in registers,
//   K/V tiles of 32 keys in shared memory, scalar FMAs, fp32 throughout;
//   every key tile.
// - q, k, v, O and dO are read through their strides in the [B, N, h, d]
//   layout (v may be a view of the fused qkv output); dQ is written as a
//   contiguous [B, N, h, d]. Segment ids are read as [B, N] int32.
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
  const void* o;
  const void* dout;
  const int* seg;     // [B, N] int32, or nullptr
  const int* tiles;   // [B, nT, nT] K1's schedule (64 x 64), or nullptr
  const int* counts;  // [B, nT] its list lengths, or nullptr
  const float* lse;   // [B, H, N] fp32
  float* delta;       // [B, H, N] fp32, written
  void* dq;           // [B, N, H, D] contiguous, input dtype
  int B, N, H;
  long long q_sb, q_sn, q_sh;  // element strides (last dim 1)
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  long long d_sb, d_sn, d_sh;
  float scale;
};

// The key tiles a CTA of q tile qt walks: row qt of K1's schedule, or
// every 64-key tile.
__device__ __forceinline__ hopper::TileList key_tile_list(const Args& a, int qt, int b) {
  return hopper::schedule_row(a.tiles, a.counts, (a.N + 63) / 64, qt, b);
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

__device__ __forceinline__ float2 bf16_pair(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
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

// A fragments of a warp's 16 rows (r_lo = warp*16 + g, r_hi = r_lo + 8) of
// a staged [64, D] tile.
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

// acc[j] += A (16 x D) . Bt^T for the 64 rows of Bt staged in shared memory:
// B[k][n] = Bt[8j + n][k] (the K-of-S = Q K^T pattern).
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

// acc[i] += A (16 x 64, the fp32 values x[8][4] rounded to bf16) . Bm, with
// Bm [64, D] staged in shared memory (the V-of-P V pattern).
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
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(Args a) {
  constexpr int kBK = 64, LD = D + 8;
  __shared__ __align__(16) uint16_t sK[kBK * LD];
  __shared__ __align__(16) uint16_t sV[kBK * LD];
  __shared__ int sSeg[kBK];

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = a.N;
  const uint16_t* qb = static_cast<const uint16_t*>(a.q) + b * a.q_sb + h * a.q_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(a.k) + b * a.k_sb + h * a.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(a.v) + b * a.v_sb + h * a.v_sh;
  const uint16_t* ob = static_cast<const uint16_t*>(a.o) + b * a.o_sb + h * a.o_sh;
  const uint16_t* db = static_cast<const uint16_t*>(a.dout) + b * a.d_sb + h * a.d_sh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;
  const long long bh = static_cast<long long>(b) * a.H + h;

  // Q and dO tiles staged through sK and sV, then kept as A fragments
  load_tile<D, LD>(sK, qb, a.q_sn, q0, N);
  load_tile<D, LD>(sV, db, a.d_sn, q0, N);
  __syncthreads();
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a_frags<D, LD>(qf, sK, r_lo, t);
  load_a_frags<D, LD>(df, sV, r_lo, t);
  __syncthreads();

  const int n_lo = q0 + r_lo, n_hi = q0 + r_hi;
  // Delta of the two rows: this thread's dO columns times O, summed over
  // the quad that holds the row
  float dl_lo = 0.f, dl_hi = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    if (n_lo < N) {
      const uint16_t* orow = ob + n_lo * a.o_sn + c;
      const float2 o0 = bf16_pair(ld_pair(orow)), o1 = bf16_pair(ld_pair(orow + 8));
      const float2 d0 = bf16_pair(df[kc][0]), d1 = bf16_pair(df[kc][2]);
      dl_lo += d0.x * o0.x + d0.y * o0.y + d1.x * o1.x + d1.y * o1.y;
    }
    if (n_hi < N) {
      const uint16_t* orow = ob + n_hi * a.o_sn + c;
      const float2 o0 = bf16_pair(ld_pair(orow)), o1 = bf16_pair(ld_pair(orow + 8));
      const float2 d0 = bf16_pair(df[kc][1]), d1 = bf16_pair(df[kc][3]);
      dl_hi += d0.x * o0.x + d0.y * o0.y + d1.x * o1.x + d1.y * o1.y;
    }
  }
  dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 1);
  dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 2);
  dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 1);
  dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 2);
  if (t == 0) {
    if (n_lo < N) a.delta[bh * N + n_lo] = dl_lo;
    if (n_hi < N) a.delta[bh * N + n_hi] = dl_hi;
  }
  const float ls_lo = n_lo < N ? a.lse[bh * N + n_lo] : 0.f;
  const float ls_hi = n_hi < N ? a.lse[bh * N + n_hi] : 0.f;
  // rows past N get id -2, which matches no key (keys carry >= -1)
  int sq_lo = -2, sq_hi = -2;
  if (segb) {
    if (n_lo < N) sq_lo = segb[n_lo];
    if (n_hi < N) sq_hi = segb[n_hi];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const hopper::TileList tl = key_tile_list(a, blockIdx.x, b);
  for (int it = 0; it < tl.count; ++it) {
    const int k0 = tl[it] * kBK;
    load_tile<D, LD>(sK, kb, a.k_sn, k0, N);
    load_tile<D, LD>(sV, vb, a.v_sn, k0, N);
    if (threadIdx.x < kBK) {
      const int n = k0 + threadIdx.x;
      sSeg[threadIdx.x] = n < N ? (segb ? segb[n] : 0) : 0;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_rows<D, LD>(s, qf, sK, g, t);   // S = Q K^T
    mma_rows<D, LD>(dp, df, sV, g, t);  // dP = dO V^T

    // dS = P * (dP - Delta), in place of s
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const bool in = k0 + col < N;
        const int sk = sSeg[col];
        const bool ok_lo = in && (!segb || sk == sq_lo);
        const bool ok_hi = in && (!segb || sk == sq_hi);
        const float p_lo = ok_lo ? exp2f((s[j][e] * a.scale - ls_lo) * kLog2e) : 0.f;
        const float p_hi = ok_hi ? exp2f((s[j][2 + e] * a.scale - ls_hi) * kLog2e) : 0.f;
        s[j][e] = p_lo * (dp[j][e] - dl_lo);
        s[j][2 + e] = p_hi * (dp[j][2 + e] - dl_hi);
      }
    }
    mma_cols<D, LD>(acc, s, sK, g, t);  // dQ += dS K
    __syncthreads();
  }

  const int HD = a.H * D;
  uint16_t* out = static_cast<uint16_t*>(a.dq) + static_cast<long long>(b) * N * HD + h * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (n_lo < N)
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(n_lo) * HD + col) =
          pack_bf16(acc[i][0] * a.scale, acc[i][1] * a.scale);
    if (n_hi < N)
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(n_hi) * HD + col) =
          pack_bf16(acc[i][2] * a.scale, acc[i][3] * a.scale);
  }
}

// ------------------------------------ bf16, head_dim 64: TMA + wgmma body

namespace wg {

using namespace hopper;

constexpr int kStages = 2;     // K/V ring
constexpr int kSlots = 2;      // Q/dO slots: this item's and the next one's
constexpr int kThreads = 160;  // consumer warpgroup + producer warp
// Shared memory: the Q and dO slots, one O tile (free once Delta is
// formed) and the K and V rings (each tile 1024-byte aligned: the 128-byte
// swizzle repeats every 8 rows of 128 bytes), then per slot the q rows' LSE
// (log2 units) and ids, per stage the keys' ids, then the mbarriers. 75 KB:
// three CTAs an SM.
constexpr int kRowOffset = kTileBytes * (2 * kSlots + 1 + 2 * kStages);
constexpr int kBarOffset = kRowOffset + (2 * kSlots + kStages) * kRows * 4;
constexpr int kSmemBytes = 1024 + kBarOffset + 8 * 2 * (kSlots + 1 + kStages);

// acc + the dot product of 8 bf16 pairs held in two 16-byte vectors
__device__ __forceinline__ float dot8(const uint4& x, const uint4& y, float acc) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = bf16_pair(xs[i]), b = bf16_pair(ys[i]);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
  return acc;
}

// Delta = sum_d dO * O of row r of the TMA boxes at dO and O: this thread
// sums half `half` of the row, its neighbour (lane ^ 1) the other half.
// The 128-byte swizzle stores 16-byte chunk c of row r at chunk c ^ (r % 8)
// (the boxes are 1024-byte aligned).
__device__ __forceinline__ float row_delta(const uint8_t* dO, const uint8_t* o, int r, int half) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int off = r * 128 + (((4 * half + i) ^ (r & 7)) << 4);
    acc = dot8(*reinterpret_cast<const uint4*>(dO + off), *reinterpret_cast<const uint4*>(o + off),
               acc);
  }
  return acc + __shfl_xor_sync(0xffffffffu, acc, 1);
}

// What a consumer thread knows of its two q rows (g and g + 8 of its warp's
// 16): LSE in log2 units (+inf past N), Delta and id.
struct Rows {
  float l_lo, l_hi, d_lo, d_hi;
  int id_lo, id_hi;
};

// P = exp2(S scale log2(e) - LSE) of one key tile (its first key k0, its
// keys' ids kid) in place of S (sc), for this thread's q rows and key
// columns 8c + 2t + e; masked pairs get 0. Keys past N arrive as zeros and
// are masked by their index.
__device__ __forceinline__ void form_p(float (&sc)[32], const int* kid, int k0, int N, int t,
                                       float sl2, const Rows& r) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * t;
    const int2 id = *reinterpret_cast<const int2*>(kid + col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = k0 + col + e < N;
      const int ke = e ? id.y : id.x;
      sc[4 * c + e] = in && ke == r.id_lo ? fast_exp2(sc[4 * c + e] * sl2 - r.l_lo) : 0.f;
      sc[4 * c + 2 + e] = in && ke == r.id_hi ? fast_exp2(sc[4 * c + 2 + e] * sl2 - r.l_hi) : 0.f;
    }
  }
}

// dS = P * (dP - Delta) in place of P.
__device__ __forceinline__ void form_ds(float (&p)[32], const float (&dp)[32], const Rows& r) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[4 * c + e] *= dp[4 * c + e] - r.d_lo;
      p[4 * c + 2 + e] *= dp[4 * c + 2 + e] - r.d_hi;
    }
  }
}

// A persistent grid (as many CTAs as fit on the SMs: three, at 128
// registers a thread) walks the items; the producer loads the next item's
// Q and dO (the other slot), O and first key tiles while the consumers
// finish this one.
__global__ void __launch_bounds__(kThreads, 3)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o,
                       const __grid_constant__ CUtensorMap map_do, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned base in the shared window
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t s_q = smem_u32(smem);                // slot j at + j * kTileBytes
  const uint32_t s_do = s_q + kSlots * kTileBytes;
  const uint32_t s_o = s_do + kSlots * kTileBytes;
  const uint32_t s_k = s_o + kTileBytes;              // stage s at + s * kTileBytes
  const uint32_t s_v = s_k + kStages * kTileBytes;
  float* row_lse = reinterpret_cast<float*>(smem + kRowOffset);  // [kSlots][64]
  int* row_seg = reinterpret_cast<int*>(row_lse + kSlots * kRows);  // [kSlots][64]
  int* key_seg = row_seg + kSlots * kRows;                          // [kStages][64]
  // per Q/dO slot, for the O tile, then per ring stage: full, empty
  const uint32_t bar = s_q + kBarOffset;
  auto bar_qf = [&](int j) { return bar + 8 * (2 * j); };
  auto bar_qe = [&](int j) { return bar + 8 * (2 * j + 1); };
  const uint32_t bar_of = bar + 8 * (2 * kSlots), bar_oe = bar_of + 8;
  auto bar_f = [&](int s) { return bar + 8 * (2 * (kSlots + 1) + 2 * s); };
  auto bar_e = [&](int s) { return bar + 8 * (2 * (kSlots + 1) + 2 * s + 1); };
  const int N = a.N;

  if (threadIdx.x == 0) {
    for (int j = 0; j < kSlots; ++j) {
      mbar_init(bar_qf(j), 1 + 32);  // the copies' expect_tx, then the 32 row copiers
      mbar_init(bar_qe(j), 128);     // every consumer thread releases the slot
    }
    mbar_init(bar_of, 1);
    mbar_init(bar_oe, 128);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f(s), 1 + 32);
      mbar_init(bar_e(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Items items((N + kRows - 1) / kRows, a.H, a.B);
  Item item;
  if (threadIdx.x >= 128) {
    // ---- producer warp: lane 0 issues the copies, all 32 lanes copy the
    // q rows' LSE and ids and the keys' ids. j counts items (the slots'
    // position), gi key tiles over all items (the ring's).
    const int lane = threadIdx.x - 128;
    int gi = 0;
    for (int j = 0; items.get(item); ++j) {
      const int slot = j % kSlots;
      const int q0 = item.tile * kRows;
      const int* segb = a.seg ? a.seg + static_cast<long long>(item.b) * N : nullptr;
      const long long bh = static_cast<long long>(item.b) * a.H + item.h;
      // the slot's previous item (j - kSlots) has been released, and the
      // previous item's O has been read
      if (j >= kSlots) mbar_wait(bar_qe(slot), ((j / kSlots) & 1) ^ 1);
      if (j >= 1) mbar_wait(bar_oe, (j & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar_qf(slot), 2 * kTileBytes);
        tma_load(s_q + slot * kTileBytes, &map_q, bar_qf(slot), item.h, q0, item.b);
        tma_load(s_do + slot * kTileBytes, &map_do, bar_qf(slot), item.h, q0, item.b);
        mbar_expect_tx(bar_of, kTileBytes);
        tma_load(s_o, &map_o, bar_of, item.h, q0, item.b);
      }
      for (int r = lane; r < kRows; r += 32) {
        const int n = q0 + r;
        const bool in = n < N;
        row_lse[slot * kRows + r] = in ? a.lse[bh * N + n] * kLog2e : __int_as_float(0x7f800000);
        row_seg[slot * kRows + r] = in && segb ? segb[n] : 0;
      }
      mbar_arrive(bar_qf(slot));
      const TileList tl = key_tile_list(a, item.tile, item.b);
      for (int it = 0; it < tl.count; ++it, ++gi) {
        const int s = gi % kStages;
        // the stage's previous key tile (gi - kStages) has been released
        if (gi >= kStages) mbar_wait(bar_e(s), ((gi / kStages) & 1) ^ 1);
        const int k0 = tl[it] * kRows;
        if (lane == 0) {
          mbar_expect_tx(bar_f(s), 2 * kTileBytes);
          tma_load(s_k + s * kTileBytes, &map_k, bar_f(s), item.h, k0, item.b);
          tma_load(s_v + s * kTileBytes, &map_v, bar_f(s), item.h, k0, item.b);
        }
        // keys past N are masked by their index: their ids do not matter
        for (int r = lane; r < kRows; r += 32) {
          const int n = k0 + r;
          key_seg[s * kRows + r] = n < N && segb ? segb[n] : 0;
        }
        mbar_arrive(bar_f(s));
      }
    }
    return;
  }

  // ---- consumer warpgroup: warp w owns q rows [16w, 16w + 16) of the
  // tile; lane (g, t) holds rows g and g + 8 of them and, in each 8-column
  // chunk c, columns 8c + 2t and + 1 (csrc/hopper.cuh). Per key tile: S
  // and dP, then dS in registers, then dQ += dS K; the other CTAs on the
  // SM fill the tensor cores while this one forms dS.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = a.scale * kLog2e;
  const int HD = a.H * kHd;
  int gi = 0;
  for (int j = 0; items.get(item); ++j) {
    const int slot = j % kSlots;
    const int q0 = item.tile * kRows;
    const uint32_t q_tile = s_q + slot * kTileBytes, do_tile = s_do + slot * kTileBytes;
    const TileList tl = key_tile_list(a, item.tile, item.b);
    mbar_wait(bar_qf(slot), (j / kSlots) & 1);
    mbar_wait(bar_of, j & 1);

    // Delta of row 16w + lane / 2 (rows past N read zeros and are not
    // written), then the rows g and g + 8 of this lane from their owners;
    // the O tile is free once every thread has read its half row
    const int rd = warp * 16 + (lane >> 1);
    const float dl = row_delta(smem + (do_tile - s_q), smem + (s_o - s_q), rd, lane & 1);
    mbar_arrive(bar_oe);
    if (!(lane & 1) && q0 + rd < N)
      a.delta[(static_cast<long long>(item.b) * a.H + item.h) * N + q0 + rd] = dl;
    const int r_lo = warp * 16 + g;
    Rows rows;
    rows.d_lo = __shfl_sync(0xffffffffu, dl, 2 * g);
    rows.d_hi = __shfl_sync(0xffffffffu, dl, 2 * g + 16);
    rows.l_lo = row_lse[slot * kRows + r_lo];
    rows.l_hi = row_lse[slot * kRows + r_lo + 8];
    rows.id_lo = row_seg[slot * kRows + r_lo];
    rows.id_hi = row_seg[slot * kRows + r_lo + 8];

    float dq[32], sc[32], dp[32];
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    for (int it = 0; it < tl.count; ++it) {
      const int s = (gi + it) % kStages;
      mbar_wait(bar_f(s), ((gi + it) / kStages) & 1);
      wgmma_fence();
      issue_qk(sc, q_tile, s_k + s * kTileBytes);
      issue_qk(dp, do_tile, s_v + s * kTileBytes);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      form_p(sc, key_seg + s * kRows, tl[it] * kRows, N, t, sl2, rows);
      form_ds(sc, dp, rows);
      pack_frags(pa, sc);
      wgmma_fence();
      issue_pv(dq, pa, s_k + s * kTileBytes);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(pa);
      // every product that read this stage's K and V has completed
      mbar_arrive(bar_e(s));
    }
    gi += tl.count;
    // every read of this slot's Q and dO has completed
    mbar_arrive(bar_qe(slot));

    const int n_lo = q0 + r_lo, n_hi = n_lo + 8;
    uint16_t* out = static_cast<uint16_t*>(a.dq) + static_cast<long long>(item.b) * N * HD +
                    item.h * kHd;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * t;
      if (n_lo < N)
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(n_lo) * HD + col) =
            pack_bf16(dq[4 * c] * a.scale, dq[4 * c + 1] * a.scale);
      if (n_hi < N)
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(n_hi) * HD + col) =
            pack_bf16(dq[4 * c + 2] * a.scale, dq[4 * c + 3] * a.scale);
    }
  }
}

cudaError_t launch(const Args& a, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mo, md;
  if (!make_map(&mq, a.q, a.B, a.N, a.H, a.q_sb, a.q_sn, a.q_sh) ||
      !make_map(&mk, a.k, a.B, a.N, a.H, a.k_sb, a.k_sn, a.k_sh) ||
      !make_map(&mv, a.v, a.B, a.N, a.H, a.v_sb, a.v_sn, a.v_sh) ||
      !make_map(&mo, a.o, a.B, a.N, a.H, a.o_sb, a.o_sn, a.o_sh) ||
      !make_map(&md, a.dout, a.B, a.N, a.H, a.d_sb, a.d_sn, a.d_sh))
    return cudaErrorInvalidValue;
  static int ctas_per_sm = 0;
  const long long items = static_cast<long long>((a.N + kRows - 1) / kRows) * a.H * a.B;
  int grid = 0;
  const cudaError_t err =
      persistent_grid(flash_bwd_dq_wgmma, kThreads, kSmemBytes, items, ctas_per_sm, grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma<<<grid, kThreads, kSmemBytes, st>>>(mq, mk, mv, mo, md, a);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------- fp32 path

template <int D>
__global__ void __launch_bounds__(64) flash_bwd_dq_f32(Args a) {
  constexpr int kBK = 32;
  __shared__ float sK[kBK][D];
  __shared__ float sV[kBK][D];
  __shared__ int sSeg[kBK];

  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int n_q = blockIdx.x * 64 + threadIdx.x;
  const bool row_in = n_q < N;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* ob = static_cast<const float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* db = static_cast<const float*>(a.dout) + b * a.d_sb + h * a.d_sh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;
  const long long bh = static_cast<long long>(b) * a.H + h;

  float q[D], dout[D], dq[D];
  float delta = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = row_in ? qb[n_q * a.q_sn + d] : 0.f;
    dout[d] = row_in ? db[n_q * a.d_sn + d] : 0.f;
    if (row_in) delta = fmaf(dout[d], ob[n_q * a.o_sn + d], delta);
    dq[d] = 0.f;
  }
  if (row_in) a.delta[bh * N + n_q] = delta;
  const float lse = row_in ? a.lse[bh * N + n_q] : 0.f;
  const int sq = (segb && row_in) ? segb[n_q] : -2;

  for (int k0 = 0; k0 < N; k0 += kBK) {
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
    for (int j = 0; j < kBK; ++j) {
      const bool ok = row_in && (k0 + j < N) && (!segb || sSeg[j] == sq);
      if (!ok) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(q[d], sK[j][d], s);
        dp = fmaf(dout[d], sV[j][d], dp);
      }
      const float ds = expf(s * a.scale - lse) * (dp - delta);
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, sK[j][d], dq[d]);
    }
    __syncthreads();
  }

  if (row_in) {
    float* out = static_cast<float*>(a.dq) + (static_cast<long long>(b) * N + n_q) * a.H * D + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = dq[d] * a.scale;
  }
}

}  // namespace

extern "C" {

// Launches the dQ backward on `stream` and returns cudaGetLastError() (0
// when the launch was accepted). dtype: 0 = fp32, 1 = bf16. D must be 64 or
// 128. Writes dq [B, N, H, D] and delta [B, H, N]. With segment ids, the
// bf16 kernels take `tiles` [B, nT, nT] and `counts` [B, nT] int32, K1's
// tile schedule for 64-row q tiles and 64-key tiles (nT = ceil(N / 64)),
// and walk row qt of it for q tile qt; null tiles and counts walk every key
// tile (always so for fp32).
int dinov3_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const int* seg, const int* tiles, const int* counts,
                        const float* lse, float* delta, void* dq, int B, int N, int H, int D,
                        int dtype,
                        long long q_sb, long long q_sn, long long q_sh,
                        long long k_sb, long long k_sn, long long k_sh,
                        long long v_sb, long long v_sn, long long v_sh,
                        long long o_sb, long long o_sn, long long o_sh,
                        long long d_sb, long long d_sn, long long d_sh,
                        float scale, void* stream) {
  if ((tiles != nullptr) != (counts != nullptr) ||
      (tiles != nullptr && (seg == nullptr || dtype != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, dout, seg, tiles, counts, lse, delta, dq, B, N, H,
         q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
         o_sb, o_sn, o_sh, d_sb, d_sn, d_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + 63) / 64, H, B);
  if (dtype == 1 && D == 64) {
    return static_cast<int>(wg::launch(a, st));
  } else if (dtype == 1 && D == 128) {
    flash_bwd_dq_bf16<128><<<grid, 128, 0, st>>>(a);
  } else if (dtype == 0 && D == 64) {
    flash_bwd_dq_f32<64><<<grid, 64, 0, st>>>(a);
  } else if (dtype == 0 && D == 128) {
    flash_bwd_dq_f32<128><<<grid, 64, 0, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dinov3_flash_bwd_dq_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
