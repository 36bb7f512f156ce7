// B6's backward for Hopper at the shapes ClusterKV trains at: bf16, tiles
// of 128, (dh, dv) in {(64, 64), (128, 128), (96, 64)}. The other instances
// (float32, bf16 at tiles of 32 and 64) are block_attention_bwd.cu's, which
// also holds the key-tile lists, their order and the entries; the
// arithmetic and its contract are stated there.
//
// What bounds it: operations. A selected (query tile, key tile) pair costs
// 2 bq bk (2 dh + dv) in dQ (S, dP, dQ) and 2 bq bk (2 dh + 2 dv) in dK/dV,
// and p and dS enter the tensor cores as hi + lo, so dQ, dK and dV are
// issued twice: 2 bq bk (4 dh + 3 dv) a pair executed, 1.20 TFLOP at
// Qwen2-0.5B's training microbatch (8 x 14 / 2 heads, S 4096, 16 of 32
// tiles). Only wgmma reaches the card's bf16 rate, so both kernels are
// built around it:
//
// * warp specialisation: two consumer warpgroups (64 rows of the tile
//   each) and a producer warpgroup whose one thread issues TMA copies into
//   a ring of 2-4 stages, with full / empty mbarriers; setmaxnreg gives
//   the consumers 232 registers a thread and the producer 32, so that the
//   accumulators (128 floats a thread at dh 128 in dK/dV) stay in
//   registers beside a chunk of S^T and dP^T (32 or 64 query rows);
// * operands in shared memory as TMA writes them: boxes of 128 rows x 64
//   bf16 with the 128-byte swizzle, which the wgmma descriptors name
//   directly (K-major for S and dP, MN-major for the products that
//   contract over the tile's rows); dh 96 is read as two boxes, the second
//   half zero-filled by TMA past the row's end;
// * S = Q.K^T and dP = dO.V^T (S^T and dP^T in dK/dV) by wgmma with both
//   operands in shared memory; p and dS formed in the accumulators'
//   registers, split hi + lo and fed back as the A operand from registers
//   (the m64 accumulator of 16 columns is the A fragment of one k-step):
//   dQ += dS.K, dV += p^T.dO, dK += dS^T.Q;
// * the dK/dV block keeps its key tile's K and V in shared memory for its
//   whole life and streams the visits (query tile x head of the group) of
//   its key-tile list through the ring: Q and dO tiles plus the rows' m,
//   1 / l, D and positions (D and 1 / l written by the dQ kernel). The dQ block keeps Q and dO and streams the
//   selected K, V tiles and their positions. D = rowsum(dO o O) is summed
//   by the four lanes that share a row, in registers.
// * blocks of unequal work: a dK/dV block walks its key tile's list times
//   g heads. The grid is one block per (key tile, kv head, b) as before,
//   but its blocks are numbered heaviest first (the order kernel in
//   block_attention_bwd.cu), so that the card's block scheduler, which
//   hands out blocks in index order as SMs free up, starts the longest
//   walks first.
//
// No atomics: each block owns its outputs and sums in a fixed order, so
// two runs are bit-equal. S is recomputed by wgmma in the forward's k-step
// order (16 deep, ascending) from zero.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_attention_bwd.cuh"
#include "mma_bf16.cuh"
#include "smem.cuh"
#include "wgmma.cuh"

namespace {

using repro::desc_sw128;
using repro::fence_regs;
using repro::mbar_arrive;
using repro::mbar_expect;
using repro::mbar_wait;
using repro::smem_u32;
using repro::split_bf16;
using repro::unroll;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_rs;
using repro::wgmma_ss;
using repro::wgmma_wait;

constexpr int kTile = 128;                  // bq = bk
constexpr int kThreads = 384;               // 2 consumer warpgroups + producer
constexpr int kConsumerThreads = 256;
constexpr uint32_t kBox = 128 * 64 * 2;     // one TMA box: 128 rows x 64 bf16
constexpr uint32_t kRow = 128;              // bytes of one box row
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;
// setmaxnreg moves registers within the block's own allocation (168 a
// thread at 384 threads): the producer's 4 warps give back 136 each, of
// which the 8 consumer warps take 64 each
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 32;
static_assert(2 * 128 * (kConsumerRegs - 168) <= 128 * (168 - kProducerRegs),
              "setmaxnreg asks for more registers than the producer frees");

template <int DK, int DV>
struct Shape {
  static constexpr int NCK = (DK + 63) / 64;  // boxes across a q/k row
  static constexpr int NCV = (DV + 63) / 64;  // boxes across a v/dO row
  static constexpr int DKP = 64 * NCK;
  static constexpr int DVP = 64 * NCV;
  static constexpr int KD = DK / 16;          // k-steps over dh
  static constexpr int KV = DV / 16;          // k-steps over dv
  // the q|k and dO|v tiles of one query or key tile
  static constexpr uint32_t kTiles = (NCK + NCV) * kBox;
  // a dK/dV stage: Q, dO, then m, 1 / l, D (float) and qpos (int) of 128
  // rows
  static constexpr uint32_t kStageKv = kTiles + 4 * kTile * 4;
  // a dQ stage: K, V, then kpos (512 bytes, padded to keep 1024 alignment)
  static constexpr uint32_t kStageQ = kTiles + 1024;
  // 1024 bytes to align the base, the resident tiles, the ring, 512 bytes
  // of positions and 1024 of barriers
  static constexpr int stages(uint32_t stage) {
    const int fit = (int)((kMaxSmem - 3 * 1024 - 512 - kTiles) / stage);
    return fit < 4 ? fit : 4;
  }
  static constexpr int NSKV = stages(kStageKv);
  static constexpr int NSQ = stages(kStageQ);
  static constexpr size_t smem(int ns, uint32_t stage) {
    return 3 * 1024 + 512 + kTiles + (size_t)ns * stage;
  }
  // query rows of one S^T chunk in dK/dV (S^T and dP^T take QC floats a
  // thread, their hi + lo fragments QC more, beside the DKP / 2 + DVP / 2
  // accumulators); keys of one S chunk in dQ
  static constexpr int QC = DKP + DVP <= 128 ? 64 : 32;
  static constexpr int KC = DKP == 64 ? 128 : 64;
  static_assert(DK % 16 == 0 && DV % 16 == 0 && NCK <= 2 && NCV <= 2,
                "head dims up to 128");
};

// the 1024-aligned base of dynamic shared memory, as a shared address
__device__ __forceinline__ uint32_t aligned_base(const unsigned char* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do,
              const int* __restrict__ kpos, const int* __restrict__ qpos,
              const float* __restrict__ stats,
              const float* __restrict__ dsum, const int* __restrict__ off,
              const int* __restrict__ ent, const int* __restrict__ order,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              int nb, int hq, int hkv, int s, int s_k, int n_sel, int causal,
              float scale_log2, float scale) {
  using Sh = Shape<DK, DV>;
  constexpr int NS = Sh::NSKV;
  constexpr int QC = Sh::QC;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base;                       // resident K boxes
  const uint32_t sV = sK + Sh::NCK * kBox;        // resident V boxes
  const uint32_t ring = sV + Sh::NCV * kBox;
  const uint32_t sKpos = ring + NS * Sh::kStageKv;
  const uint32_t bars = sKpos + 512;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (NS + st); };
  const uint32_t res = bars + 16 * NS;

  const int nkb = s_k / kTile;
  const int nqb = s / kTile;
  const int item = order[blockIdx.x];            // heaviest first
  const int bh = item / nkb;
  const int t = item % nkb;
  const int b = bh / hkv;
  const int kvh = bh % hkv;
  const int g = hq / hkv;
  const long long plane = (long long)nb * hq * s;
  const long long kb = (long long)bh * s_k + (long long)t * kTile;
  const int* o = off + (long long)bh * (nkb + 1);
  const int* e = ent + (long long)bh * nqb * n_sel;
  const int first = o[t];
  const int visits = (o[t + 1] - first) * g;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      repro::mbar_init(full(i), 1);
      repro::mbar_init(empty(i), kConsumerThreads);
    }
    repro::mbar_init(res, 1);
    repro::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every copy
    repro::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads && visits > 0) {
      mbar_expect(res, Sh::kTiles + 512);
      for (int c = 0; c < Sh::NCK; ++c)
        repro::tma_load_2d(sK + c * kBox, &tm_k, 64 * c, (int)kb, res);
      for (int c = 0; c < Sh::NCV; ++c)
        repro::tma_load_2d(sV + c * kBox, &tm_v, 64 * c, (int)kb, res);
      repro::bulk_load(sKpos, kpos + kb, 512, res);
      int st = 0;
      uint32_t ph = 0;
      for (int vi = 0; vi < visits; ++vi) {
        const int qt = e[first + vi / g] / n_sel;
        const int h = kvh * g + vi % g;
        const long long rb = ((long long)b * hq + h) * s + (long long)qt * kTile;
        mbar_wait(empty(st), ph ^ 1);
        const uint32_t sq = ring + st * Sh::kStageKv;
        const uint32_t vec = sq + Sh::kTiles;
        mbar_expect(full(st), Sh::kStageKv);
        for (int c = 0; c < Sh::NCK; ++c)
          repro::tma_load_2d(sq + c * kBox, &tm_q, 64 * c, (int)rb, full(st));
        for (int c = 0; c < Sh::NCV; ++c)
          repro::tma_load_2d(sq + (Sh::NCK + c) * kBox, &tm_do, 64 * c,
                             (int)rb, full(st));
        repro::bulk_load(vec, stats + rb, 512, full(st));
        repro::bulk_load(vec + 512, dsum + plane + rb, 512, full(st));
        repro::bulk_load(vec + 1024, dsum + rb, 512, full(st));
        repro::bulk_load(vec + 1536, qpos + (long long)qt * kTile, 512,
                         full(st));
        if (++st == NS) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns keys 64 wg .. 64 wg + 63 of the tile
    repro::setmaxnreg_inc<kConsumerRegs>();
    const int tw = threadIdx.x % 128;
    const int lane = tw % 32;
    const int gr = lane / 4;
    const int tg = lane % 4;
    const int r0 = 64 * wg + 16 * (tw / 32) + gr;   // keys r0 and r0 + 8
    float gk[Sh::DKP / 2], gv[Sh::DVP / 2];
#pragma unroll
    for (int i = 0; i < Sh::DKP / 2; ++i) gk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < Sh::DVP / 2; ++i) gv[i] = 0.f;

    if (visits > 0) {
      mbar_wait(res, 0);
      const int* kps = reinterpret_cast<const int*>(gbase + (sKpos - base));
      const int kp0 = kps[r0];
      const int kp1 = kps[r0 + 8];
      // this warpgroup's keys of K and V, the A operands of S^T and dP^T
      const uint64_t aK = desc_sw128(sK + wg * 64 * kRow);
      const uint64_t aV = desc_sw128(sV + wg * 64 * kRow);
      int st = 0;
      uint32_t ph = 0;
      for (int vi = 0; vi < visits; ++vi) {
        mbar_wait(full(st), ph);
        const uint32_t sq = ring + st * Sh::kStageKv;
        const uint32_t sdo = sq + Sh::NCK * kBox;
        const float* ms = reinterpret_cast<const float*>(
            gbase + (sq + Sh::kTiles - base));
        const float* ivs = ms + kTile;
        const float* Ds = ms + 2 * kTile;
        const int* qps = reinterpret_cast<const int*>(ms + 3 * kTile);
#pragma unroll 1
        for (int qc = 0; qc < kTile / QC; ++qc) {
          // S^T = K.Q^T and dP^T = V.dO^T for keys r0.., queries of chunk qc
          float sc[QC / 2], dp[QC / 2];
          const uint64_t bQ = desc_sw128(sq + qc * QC * kRow);
          const uint64_t bdO = desc_sw128(sdo + qc * QC * kRow);
          wgmma_fence();
          // k-step kk: box kk / 4, 32 bytes a step within its 128-byte rows
          unroll<Sh::KD>([&](auto kk) {
            constexpr int k = decltype(kk)::value;
            constexpr uint32_t o = (k / 4) * kBox + (k % 4) * 32;
            wgmma_ss<QC, o, o>(sc, aK, bQ, k > 0);
          });
          unroll<Sh::KV>([&](auto kk) {
            constexpr int k = decltype(kk)::value;
            constexpr uint32_t o = (k / 4) * kBox + (k % 4) * 32;
            wgmma_ss<QC, o, o>(dp, aV, bdO, k > 0);
          });
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);
          // p^T into sc, dS^T into dp: accumulator 4j + x sits at key
          // r0 (+ 8 for x >= 2), query c + (x & 1)
#pragma unroll
          for (int j = 0; j < QC / 8; ++j) {
            const int c = qc * QC + 8 * j + 2 * tg;
            const float2 m2 = *reinterpret_cast<const float2*>(ms + c);
            const float2 iv = *reinterpret_cast<const float2*>(ivs + c);
            const float2 d2 = *reinterpret_cast<const float2*>(Ds + c);
            const int2 q2 = *reinterpret_cast<const int2*>(qps + c);
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const bool odd = x & 1;
              const bool mk = causal && (x < 2 ? kp0 : kp1) > (odd ? q2.y : q2.x);
              const float lg = mk ? kNegInf : sc[4 * j + x] * scale_log2;
              const float p = exp2f(lg - (odd ? m2.y : m2.x)) * (odd ? iv.y : iv.x);
              sc[4 * j + x] = p;
              dp[4 * j + x] = mk ? 0.f : p * (dp[4 * j + x] - (odd ? d2.y : d2.x));
            }
          }
          // dV += p^T.dO and dK += dS^T.Q over the chunk's query rows, 16
          // a k-step: accumulators 8u .. 8u + 7 are the A fragment of step u
          uint32_t ph_[QC / 16][4], pl_[QC / 16][4], sh_[QC / 16][4],
              sl_[QC / 16][4];
#pragma unroll
          for (int u = 0; u < QC / 16; ++u)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              split_bf16(sc[8 * u + 2 * r], sc[8 * u + 2 * r + 1], ph_[u][r],
                         pl_[u][r]);
              split_bf16(dp[8 * u + 2 * r], dp[8 * u + 2 * r + 1], sh_[u][r],
                         sl_[u][r]);
            }
          // dO and Q rows of the chunk, MN-major: 16 rows a k-step
          const uint64_t mdO = desc_sw128(sdo + qc * QC * kRow, kBox);
          const uint64_t mQ = desc_sw128(sq + qc * QC * kRow, kBox);
          wgmma_fence();
          unroll<QC / 16>([&](auto uu) {
            constexpr int u = decltype(uu)::value;
            constexpr uint32_t o = u * 16 * kRow;
            wgmma_rs<Sh::DVP, o>(gv, ph_[u], mdO);
            wgmma_rs<Sh::DVP, o>(gv, pl_[u], mdO);
            wgmma_rs<Sh::DKP, o>(gk, sh_[u], mQ);
            wgmma_rs<Sh::DKP, o>(gk, sl_[u], mQ);
          });
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(gk);
        fence_regs(gv);
        mbar_arrive(empty(st));
        if (++st == NS) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    __nv_bfloat16* k0 = dk + (kb + r0) * DK + 2 * tg;
    __nv_bfloat16* v0 = dv + (kb + r0) * DV + 2 * tg;
#pragma unroll
    for (int j = 0; j < DK / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(k0 + 8 * j) =
          __floats2bfloat162_rn(gk[4 * j] * scale, gk[4 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(k0 + 8 * DK + 8 * j) =
          __floats2bfloat162_rn(gk[4 * j + 2] * scale, gk[4 * j + 3] * scale);
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(v0 + 8 * j) =
          __floats2bfloat162_rn(gv[4 * j], gv[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(v0 + 8 * DV + 8 * j) =
          __floats2bfloat162_rn(gv[4 * j + 2], gv[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ (and D)
// ---------------------------------------------------------------------------

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_do,
             const int* __restrict__ kpos, const int* __restrict__ qpos,
             const int* __restrict__ idx,
             const __nv_bfloat16* __restrict__ out,
             const float* __restrict__ stats,
             const __nv_bfloat16* __restrict__ dout,
             __nv_bfloat16* __restrict__ dq, float* __restrict__ dsum,
             int hq, int hkv, int s, int s_k, int n_sel, int causal,
             float scale_log2, float scale) {
  using Sh = Shape<DK, DV>;
  constexpr int NS = Sh::NSQ;
  constexpr int KC = Sh::KC;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base;                       // resident Q boxes
  const uint32_t sdO = sQ + Sh::NCK * kBox;       // resident dO boxes
  const uint32_t ring = sdO + Sh::NCV * kBox;
  const uint32_t bars = ring + NS * Sh::kStageQ;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (NS + st); };
  const uint32_t res = bars + 16 * NS;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int kvh = h / g;
  const int nqb = s / kTile;
  const int nkb = s_k / kTile;
  const long long plane = (long long)gridDim.z * hq * s;
  const long long rbase = ((long long)b * hq + h) * s + (long long)qt * kTile;
  const long long kvbase = ((long long)b * hkv + kvh) * s_k;
  const int* ib = idx + (((long long)b * hkv + kvh) * nqb + qt) * n_sel;
  int live = 0;                                   // tiles the forward visited
  for (int j = 0; j < n_sel; ++j) live += ib[j] >= 0 && ib[j] < nkb;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      repro::mbar_init(full(i), 1);
      repro::mbar_init(empty(i), kConsumerThreads);
    }
    repro::mbar_init(res, 1);
    repro::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    repro::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads && live > 0) {
      mbar_expect(res, Sh::kTiles);
      for (int c = 0; c < Sh::NCK; ++c)
        repro::tma_load_2d(sQ + c * kBox, &tm_q, 64 * c, (int)rbase, res);
      for (int c = 0; c < Sh::NCV; ++c)
        repro::tma_load_2d(sdO + c * kBox, &tm_do, 64 * c, (int)rbase, res);
      int st = 0;
      uint32_t ph = 0;
      for (int j = 0; j < n_sel; ++j) {
        const int t = ib[j];
        if (t < 0 || t >= nkb) continue;          // as the forward
        const long long kr = kvbase + (long long)t * kTile;
        mbar_wait(empty(st), ph ^ 1);
        const uint32_t sk = ring + st * Sh::kStageQ;
        mbar_expect(full(st), Sh::kTiles + 512);
        for (int c = 0; c < Sh::NCK; ++c)
          repro::tma_load_2d(sk + c * kBox, &tm_k, 64 * c, (int)kr, full(st));
        for (int c = 0; c < Sh::NCV; ++c)
          repro::tma_load_2d(sk + (Sh::NCK + c) * kBox, &tm_v, 64 * c,
                             (int)kr, full(st));
        repro::bulk_load(sk + Sh::kTiles, kpos + kr, 512, full(st));
        if (++st == NS) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63
    repro::setmaxnreg_inc<kConsumerRegs>();
    const int tw = threadIdx.x % 128;
    const int lane = tw % 32;
    const int gr = lane / 4;
    const int tg = lane % 4;
    const int r0 = 64 * wg + 16 * (tw / 32) + gr;   // rows r0 and r0 + 8
    const long long R0 = rbase + r0;
    const long long R1 = R0 + 8;
    // D = rowsum(dO o O): the four lanes of a row take every fourth 16-byte
    // piece of it, then sum across the four
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int c = tg; c < DV / 8; c += 4) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(dout + R0 * DV + 8 * c);
      const uint4 o0 = *reinterpret_cast<const uint4*>(out + R0 * DV + 8 * c);
      const uint4 a1 = *reinterpret_cast<const uint4*>(dout + R1 * DV + 8 * c);
      const uint4 o1 = *reinterpret_cast<const uint4*>(out + R1 * DV + 8 * c);
      const __nv_bfloat162* pa0 = reinterpret_cast<const __nv_bfloat162*>(&a0);
      const __nv_bfloat162* po0 = reinterpret_cast<const __nv_bfloat162*>(&o0);
      const __nv_bfloat162* pa1 = reinterpret_cast<const __nv_bfloat162*>(&a1);
      const __nv_bfloat162* po1 = reinterpret_cast<const __nv_bfloat162*>(&o1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x0 = __bfloat1622float2(pa0[i]);
        const float2 y0 = __bfloat1622float2(po0[i]);
        const float2 x1 = __bfloat1622float2(pa1[i]);
        const float2 y1 = __bfloat1622float2(po1[i]);
        d0 += x0.x * y0.x + x0.y * y0.y;
        d1 += x1.x * y1.x + x1.y * y1.y;
      }
    }
    d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
    d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
    const float m0 = stats[R0];
    const float m1 = stats[R1];
    const float inv0 = 1.f / fmaxf(stats[plane + R0], 1e-30f);
    const float inv1 = 1.f / fmaxf(stats[plane + R1], 1e-30f);
    // D and 1 / l of each row, for the dK/dV kernel
    if (tg == 0) {
      dsum[R0] = d0;
      dsum[R1] = d1;
      dsum[plane + R0] = inv0;
      dsum[plane + R1] = inv1;
    }
    const int qp0 = qpos[qt * kTile + r0];
    const int qp1 = qpos[qt * kTile + r0 + 8];
    float acc[Sh::DKP / 2];
#pragma unroll
    for (int i = 0; i < Sh::DKP / 2; ++i) acc[i] = 0.f;

    if (live > 0) {
      mbar_wait(res, 0);
      // this warpgroup's rows of Q and dO, the A operands of S and dP
      const uint64_t aQ = desc_sw128(sQ + wg * 64 * kRow);
      const uint64_t adO = desc_sw128(sdO + wg * 64 * kRow);
      int st = 0;
      uint32_t ph = 0;
      for (int v = 0; v < live; ++v) {
        mbar_wait(full(st), ph);
        const uint32_t sk = ring + st * Sh::kStageQ;
        const uint32_t sv = sk + Sh::NCK * kBox;
        const int* kps =
            reinterpret_cast<const int*>(gbase + (sk + Sh::kTiles - base));
#pragma unroll 1
        for (int kc = 0; kc < kTile / KC; ++kc) {
          // S = Q.K^T and dP = dO.V^T for rows r0.., keys of chunk kc
          float sc[KC / 2], dp[KC / 2];
          const uint64_t bK = desc_sw128(sk + kc * KC * kRow);
          const uint64_t bV = desc_sw128(sv + kc * KC * kRow);
          wgmma_fence();
          unroll<Sh::KD>([&](auto kk) {
            constexpr int k = decltype(kk)::value;
            constexpr uint32_t o = (k / 4) * kBox + (k % 4) * 32;
            wgmma_ss<KC, o, o>(sc, aQ, bK, k > 0);
          });
          unroll<Sh::KV>([&](auto kk) {
            constexpr int k = decltype(kk)::value;
            constexpr uint32_t o = (k / 4) * kBox + (k % 4) * 32;
            wgmma_ss<KC, o, o>(dp, adO, bV, k > 0);
          });
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);
          // dS in place of S: accumulator 4j + x sits at row r0 (+ 8 for
          // x >= 2), key c + (x & 1)
#pragma unroll
          for (int j = 0; j < KC / 8; ++j) {
            const int2 kp =
                *reinterpret_cast<const int2*>(kps + kc * KC + 8 * j + 2 * tg);
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const bool lo = x < 2;
              const bool mk = causal && ((x & 1) ? kp.y : kp.x) > (lo ? qp0 : qp1);
              const float lg = mk ? kNegInf : sc[4 * j + x] * scale_log2;
              const float p = exp2f(lg - (lo ? m0 : m1)) * (lo ? inv0 : inv1);
              sc[4 * j + x] = mk ? 0.f : p * (dp[4 * j + x] - (lo ? d0 : d1));
            }
          }
          // dQ += dS.K over the chunk's keys, 16 a k-step
          uint32_t sh_[KC / 16][4], sl_[KC / 16][4];
#pragma unroll
          for (int u = 0; u < KC / 16; ++u)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              split_bf16(sc[8 * u + 2 * r], sc[8 * u + 2 * r + 1], sh_[u][r],
                         sl_[u][r]);
          // K rows of the chunk, MN-major: 16 keys a k-step
          const uint64_t mK = desc_sw128(sk + kc * KC * kRow, kBox);
          wgmma_fence();
          unroll<KC / 16>([&](auto uu) {
            constexpr int u = decltype(uu)::value;
            constexpr uint32_t o = u * 16 * kRow;
            wgmma_rs<Sh::DKP, o>(acc, sh_[u], mK);
            wgmma_rs<Sh::DKP, o>(acc, sl_[u], mK);
          });
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty(st));
        if (++st == NS) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    __nv_bfloat16* q0 = dq + R0 * DK + 2 * tg;
#pragma unroll
    for (int j = 0; j < DK / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(q0 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(q0 + 8 * DK + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// S two ways (a check, not a path's kernel)
// ---------------------------------------------------------------------------

// S = Q.K^T of one (128 x 64) x (128 x 64) bf16 tile pair, float32, by the
// forward's mma.sync.m16n8k16 in its order (block_attention.cu: 8 keys at a
// time, k-steps of 16 ascending from zero) into s_mma and by this file's
// wgmma (k-steps ascending, the first overwriting) into s_wgmma, from the
// same TMA-written shared tiles: whether the backward's recomputed S is
// bit for bit the forward's.
__global__ void __launch_bounds__(256, 1)
    logits_two_ways(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    float* __restrict__ s_mma, float* __restrict__ s_wgmma) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t sQ = base, sK = base + kBox, bar = base + 2 * kBox;
  if (threadIdx.x == 0) {
    repro::mbar_init(bar, 1);
    repro::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(bar, 2 * kBox);
    repro::tma_load_2d(sQ, &tm_q, 0, 0, bar);
    repro::tma_load_2d(sK, &tm_k, 0, 0, bar);
  }
  mbar_wait(bar, 0);
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int tg = lane % 4;
  // wgmma: warpgroup wg takes rows 64 wg ..
  float acc[64];
  wgmma_fence();
  const uint64_t aQ = desc_sw128(sQ + wg * 64 * kRow);
  const uint64_t bK = desc_sw128(sK);
  unroll<4>([&](auto kk) {
    constexpr int k = decltype(kk)::value;
    wgmma_ss<128, k * 32, k * 32>(acc, aQ, bK, k > 0);
  });
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int r0 = 64 * wg + 16 * (warp % 4) + gr;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * tg;
    s_wgmma[r0 * 128 + c] = acc[4 * j];
    s_wgmma[r0 * 128 + c + 1] = acc[4 * j + 1];
    s_wgmma[(r0 + 8) * 128 + c] = acc[4 * j + 2];
    s_wgmma[(r0 + 8) * 128 + c + 1] = acc[4 * j + 3];
  }
  // mma.sync: warp w takes rows 16 w .. as the forward does; row r's
  // 16-byte piece c sits at piece c ^ (r % 8) of its 128-byte row
  auto at = [&](uint32_t tile, int r, int col) {
    return tile + r * kRow + ((((col / 8) ^ (r % 8)) * 16) | ((col % 8) * 2));
  };
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r = warp * 16 + lane % 16;
    const uint32_t a = at(sQ, r, kk * 16 + (lane / 16) * 8);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(qf[kk][0]), "=r"(qf[kk][1]), "=r"(qf[kk][2]), "=r"(qf[kk][3])
        : "r"(a));
  }
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; kk += 2) {
      uint32_t kf[4];
      const int r = j * 8 + lane % 8;
      const uint32_t a = at(sK, r, kk * 16 + (lane / 8) * 8);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
          : "=r"(kf[0]), "=r"(kf[1]), "=r"(kf[2]), "=r"(kf[3])
          : "r"(a));
      repro::mma_bf16(sc, qf[kk], kf[0], kf[1]);
      repro::mma_bf16(sc, qf[kk + 1], kf[2], kf[3]);
    }
    const int row = warp * 16 + gr;
    const int c = 8 * j + 2 * tg;
    s_mma[row * 128 + c] = sc[0];
    s_mma[row * 128 + c + 1] = sc[1];
    s_mma[(row + 8) * 128 + c] = sc[2];
    s_mma[(row + 8) * 128 + c + 1] = sc[3];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime, so that nothing
// new is linked
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major (rows, cols) bf16 tensor in boxes of 128 rows x 64 columns
// with the 128-byte swizzle; columns past `cols` read as zeros
cudaError_t box_map(CUtensorMap* map, const void* ptr, long long rows,
                    int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 128};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int DK, int DV>
cudaError_t make_maps(const repro::BwdArgs& a, Maps* m) {
  const long long rq = (long long)a.b * a.hq * a.s;
  const long long rk = (long long)a.b * a.hkv * a.s_k;
  cudaError_t err = box_map(&m->q, a.q, rq, DK);
  if (err == cudaSuccess) err = box_map(&m->k, a.k, rk, DK);
  if (err == cudaSuccess) err = box_map(&m->v, a.v, rk, DV);
  if (err == cudaSuccess) err = box_map(&m->dout, a.dout, rq, DV);
  return err;
}

constexpr float kLog2e = 1.4426950408889634f;

template <int DK, int DV>
int dq_launch(const repro::BwdArgs& a) {
  using Sh = Shape<DK, DV>;
  constexpr size_t smem = Sh::smem(Sh::NSQ, Sh::kStageQ);
  static_assert(Sh::NSQ >= 2 && smem <= kMaxSmem, "dQ ring");
  static repro::SmemOptin opt;
  auto kern = dq_wgmma<DK, DV>;
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err == cudaSuccess) err = repro::allow_smem(kern, dev, smem, opt);
  Maps m;
  if (err == cudaSuccess) err = make_maps<DK, DV>(a, &m);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.s / kTile, a.hq, a.b), kThreads, smem, a.stream>>>(
      m.q, m.k, m.v, m.dout, (const int*)a.kpos, (const int*)a.qpos,
      (const int*)a.idx, (const __nv_bfloat16*)a.out, (const float*)a.stats,
      (const __nv_bfloat16*)a.dout, (__nv_bfloat16*)a.dq, (float*)a.dsum_out,
      a.hq, a.hkv, a.s, a.s_k, a.n_sel, a.causal, kLog2e / sqrtf((float)DK),
      1.f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

template <int DK, int DV>
int dkv_launch(const repro::BwdArgs& a) {
  using Sh = Shape<DK, DV>;
  constexpr size_t smem = Sh::smem(Sh::NSKV, Sh::kStageKv);
  static_assert(Sh::NSKV >= 2 && smem <= kMaxSmem, "dK/dV ring");
  static repro::SmemOptin opt;
  auto kern = dkv_wgmma<DK, DV>;
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err == cudaSuccess) err = repro::allow_smem(kern, dev, smem, opt);
  Maps m;
  if (err == cudaSuccess) err = make_maps<DK, DV>(a, &m);
  if (err != cudaSuccess) return (int)err;
  const int blocks = a.b * a.hkv * (a.s_k / kTile);
  kern<<<blocks, kThreads, smem, a.stream>>>(
      m.q, m.k, m.v, m.dout, (const int*)a.kpos, (const int*)a.qpos,
      (const float*)a.stats, (const float*)a.dsum, (const int*)a.off,
      (const int*)a.ent, (const int*)a.order, (__nv_bfloat16*)a.dk,
      (__nv_bfloat16*)a.dv, a.b, a.hq, a.hkv, a.s, a.s_k, a.n_sel, a.causal,
      kLog2e / sqrtf((float)DK), 1.f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

}  // namespace

// S = q.k^T of one tile pair, q and k (128, 64) bf16, into s_mma and
// s_wgmma (128, 128) float32: the forward's mma.sync and the backward's
// wgmma on the same shared tiles (a check of the recomputation; no path
// launches it)
extern "C" int repro_b6_logits_two_ways(const void* q, const void* k,
                                        void* s_mma, void* s_wgmma,
                                        void* stream) {
  constexpr size_t smem = 1024 + 2 * kBox + 64;
  static repro::SmemOptin opt;
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err == cudaSuccess) err = repro::allow_smem(logits_two_ways, dev, smem, opt);
  CUtensorMap tq, tk;
  if (err == cudaSuccess) err = box_map(&tq, q, 128, 64);
  if (err == cudaSuccess) err = box_map(&tk, k, 128, 64);
  if (err != cudaSuccess) return (int)err;
  logits_two_ways<<<1, 256, smem, (cudaStream_t)stream>>>(
      tq, tk, (float*)s_mma, (float*)s_wgmma);
  return (int)cudaGetLastError();
}

namespace repro {

int bwd_dq_sm90(const BwdArgs& a, int dh, int dv) {
  if (dh == 64 && dv == 64) return dq_launch<64, 64>(a);
  if (dh == 128 && dv == 128) return dq_launch<128, 128>(a);
  if (dh == 96 && dv == 64) return dq_launch<96, 64>(a);
  return (int)cudaErrorInvalidValue;
}

int bwd_dkv_sm90(const BwdArgs& a, int dh, int dv) {
  if (dh == 64 && dv == 64) return dkv_launch<64, 64>(a);
  if (dh == 128 && dv == 128) return dkv_launch<128, 128>(a);
  if (dh == 96 && dv == 64) return dkv_launch<96, 64>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro
