// Backward of cluster-block-sparse attention (ClusterKV training) for
// Hopper (sm_90a).
//
// Replaces no TPU kernel of its own: the reference trains ClusterKV by
// jax.grad through the XLA path core.clusterkv.sparse_block_attention
// (src/repro/core/clusterkv.py), since its Pallas kernel block_attention
// (src/repro/kernels/block_attention.py, B6) has no backward. This is the
// gradient of B6's forward (block_attention.cu) as hand-written kernels, so
// that a ClusterKV train step runs on the card through kernels only.
//
// What it computes, for the forward's
//   s = q.k^T * scale (masked to -1e30 where kpos > qpos), p = exp(s - m) / l
// with m and l the forward's own row statistics (its stats output, in its
// own units: exp2 of log2-scaled logits in bf16, so p is bit for bit the
// forward's p), and the output's cotangent dO:
//   D  = rowsum(dO o O)                     (O the forward's output)
//   dP = dO . V^T,  dS = p o (dP - D), and dS = 0 where the mask replaced
//        the logit (the reference's jnp.where passes no gradient there; in
//        a row whose selected keys are all masked p = 1 / l, so dV still
//        receives it and dQ / dK nothing)
//   dQ = dS . K * scale,  dK = dS^T . Q * scale,  dV = p^T . dO
// over exactly the (query tile, key tile) pairs the forward visited: a
// tile id outside [0, S_k/bk) is skipped, a duplicate id counts twice.
//
// Kernels (no atomics anywhere: every block owns its outputs and sums in a
// fixed order, so the result is bit-equal run to run):
//
// * key_tile_lists: for each (b, kv head) the transpose of idx as CSR, by
//   a counting sort: one thread per key tile counts its occurrences, one
//   thread scans the counts, then each key tile's thread lists the flat
//   positions qt * n_sel + slot that selected it, in ascending order (a
//   duplicate once per occurrence, the rest of the list -1). No host sync:
//   the lists stay on the device.
// * key_tile_order: every (b, kv head, key tile) ranked by its list's
//   length, longest first (each thread ranks its own item against all):
//   the dK/dV blocks are numbered in this order. A key tile's work is its
//   list times g, unequal by 1.5-2x between tiles (Qwen2-0.5B's own
//   selections: 224 visits against a mean of 112), and the card's block
//   scheduler hands out blocks in index order as SMs free up, so the
//   longest walks start first and the last wave is short ones.
// * dQ: one block per (query tile, query head, b), as the forward; it also
//   writes D (and, at bf16 tiles of 128, 1 / l) for the dK/dV kernel.
// * dK/dV: one block per (key tile, kv head, b); it walks the tile's list
//   and, for each entry, the g query heads of the group, so the GQA sum
//   and the sum over query tiles stay in the block's registers.
//
// What bounds dQ and dK/dV: operations. A selected (query tile, key tile)
// pair costs 2 bq bk (2 dh + dv) in dQ (S, dP, dQ) and 2 bq bk (2 dh +
// 2 dv) in dK/dV (S, dP, dV, dK). The float32 operands that enter a bf16
// product (p and dS) are split into hi + lo, two products each:
// |x - hi - lo| <= 2^-17 |x|, within the forward's bound of the plain
// version. Three designs:
//
// * bf16 at tiles of 128 (every ClusterKV train step):
//   block_attention_bwd_sm90.cu, wgmma fed by a TMA ring, warp-specialised
//   (its note says how);
// * bf16 at tiles of 32 and 64: dq_mma / dkv_mma below, the forward's
//   design: mma.sync.m16n8k16 with float32 accumulators, one warp per 16
//   rows (query rows in dQ, keys in dK/dV), operand tiles through a
//   2-stage cp.async ring with rows padded by 16 bytes for ldmatrix, one
//   block an SM;
// * float32 on the CUDA cores (dq_kernel / dkv_kernel), the covering
//   checks' dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_attention_bwd.cuh"
#include "mma_bf16.cuh"
#include "smem.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait_all;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::split_bf16;

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
// dynamic shared memory one block may opt in to on sm_90
constexpr size_t kMaxSmem = 232448;

// ---------------------------------------------------------------------------
// the key-tile lists
// ---------------------------------------------------------------------------

constexpr int kListThreads = 128;

__global__ void __launch_bounds__(kListThreads)
    key_tile_lists_kernel(const int* __restrict__ idx, int* __restrict__ off,
                          int* __restrict__ ent, int n, int nkb) {
  const long long bh = blockIdx.x;
  const int* ib = idx + bh * n;
  int* o = off + bh * (nkb + 1);
  int* e = ent + bh * n;
  for (int t = threadIdx.x; t < nkb; t += kListThreads) {
    int c = 0;
    for (int j = 0; j < n; ++j) c += ib[j] == t;
    o[t + 1] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    o[0] = 0;
    for (int t = 0; t < nkb; ++t) o[t + 1] += o[t];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nkb; t += kListThreads) {
    int w = o[t];
    for (int j = 0; j < n; ++j)
      if (ib[j] == t) e[w++] = j;
  }
  for (int j = o[nkb] + threadIdx.x; j < n; j += kListThreads) e[j] = -1;
}

// the key tiles of all (b, kv head) heaviest first: item i = bh * nkb + t
// weighs its list's length; order[rank] = i, rank = the items that weigh
// more, or as much at a lower index (no atomics: each thread ranks its own
// item against all, the weights staged through shared memory)
constexpr int kOrderThreads = 256;

__global__ void __launch_bounds__(kOrderThreads)
    key_tile_order_kernel(const int* __restrict__ off, int* __restrict__ order,
                          int n, int nkb) {
  __shared__ int w[kOrderThreads];
  auto weight = [&](int i) {
    const int* o = off + (long long)(i / nkb) * (nkb + 1) + i % nkb;
    return o[1] - o[0];
  };
  const int i = blockIdx.x * kOrderThreads + threadIdx.x;
  const int wi = i < n ? weight(i) : 0;
  int rank = 0;
  for (int j0 = 0; j0 < n; j0 += kOrderThreads) {
    __syncthreads();
    if (j0 + threadIdx.x < n) w[threadIdx.x] = weight(j0 + threadIdx.x);
    __syncthreads();
    const int m = n - j0 < kOrderThreads ? n - j0 : kOrderThreads;
    for (int j = 0; j < m; ++j)
      rank += w[j] > wi || (w[j] == wi && j0 + j < i);
  }
  if (i < n) order[rank] = i;
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

template <int QR, int BK, int DK, int DV>
constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)QR * (DK + 1) + (size_t)QR * (DV + 1) +
                          (size_t)BK * (DK + 1) + (size_t)BK * (DV + 1) +
                          (size_t)QR * (BK + 1)) +
         sizeof(int) * BK;
}

// query rows of a dQ block: the whole tile, a half or a quarter, at most
// 64 (registers) and within shared memory
template <int BQ, int BK, int DK, int DV>
constexpr int dq_rows() {
  return (BQ <= 64 && dq_smem<BQ, BK, DK, DV>() <= kMaxSmem) ? BQ
         : (BQ / 2 <= 64 && dq_smem<BQ / 2, BK, DK, DV>() <= kMaxSmem)
             ? BQ / 2
             : BQ / 4;
}

template <int KR, int BQ, int DK, int DV>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((size_t)KR * (DK + 1) + (size_t)KR * (DV + 1) +
                          (size_t)BQ * (DK + 1) + (size_t)BQ * (DV + 1) +
                          2 * (size_t)KR * (BQ + 1) + 3 * (size_t)BQ) +
         sizeof(int) * ((size_t)KR + BQ);
}

// keys of a dK/dV block, chosen as dq_rows; the blocks of one key tile
// walk the same list
template <int BQ, int BK, int DK, int DV>
constexpr int dkv_rows() {
  return (BK <= 64 && dkv_smem<BK, BQ, DK, DV>() <= kMaxSmem) ? BK
         : (BK / 2 <= 64 && dkv_smem<BK / 2, BQ, DK, DV>() <= kMaxSmem)
             ? BK / 2
             : BK / 4;
}

template <int BQ, int BK, int DK, int DV, int QR>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ kpos,
              const int* __restrict__ qpos, const int* __restrict__ idx,
              const float* __restrict__ out, const float* __restrict__ stats,
              const float* __restrict__ dout, float* __restrict__ dq,
              float* __restrict__ dsum, int hq, int hkv, int s, int s_k,
              int n_sel, int causal, float scale) {
  constexpr int RQ = QR / 16;
  constexpr int RK = BK / 16;
  constexpr int RD = DK / 16;
  constexpr int LDQ = DK + 1;
  constexpr int LDO = DV + 1;
  constexpr int LDS = BK + 1;
  static_assert(BQ % QR == 0 && QR % 16 == 0 && DK % 16 == 0, "tile shape");

  extern __shared__ float smem[];
  float* Qs = smem;                       // QR x LDQ
  float* dOs = Qs + QR * LDQ;             // QR x LDO
  float* Ks = dOs + QR * LDO;             // BK x LDQ
  float* Vs = Ks + BK * LDQ;              // BK x LDO
  float* dSs = Vs + BK * LDO;             // QR x LDS
  int* kps = reinterpret_cast<int*>(dSs + QR * LDS);   // BK

  const int row0 = blockIdx.x * QR;
  const int qt = row0 / BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int kvh = h / g;
  const int nqb = s / BQ;
  const int nkb = s_k / BK;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long plane = (long long)gridDim.z * hq * s;
  const long long rbase = ((long long)b * hq + h) * s + row0;

  const long long kvbase = ((long long)b * hkv + kvh) * s_k;
  const float* kb = k + kvbase * DK;
  const float* vb = v + kvbase * DV;
  const int* pb = kpos + kvbase;
  const int* ib = idx + (((long long)b * hkv + kvh) * nqb + qt) * n_sel;

  for (int e = tid; e < QR * DK; e += kThreads)
    Qs[(e / DK) * LDQ + e % DK] = q[rbase * DK + e];
  for (int e = tid; e < QR * DV; e += kThreads)
    dOs[(e / DV) * LDO + e % DV] = dout[rbase * DV + e];
  __syncthreads();

  float dd[RQ], mr[RQ], inv[RQ];
  int qp[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    float part = 0.f;
    for (int c = tx; c < DV; c += 16)
      part += dOs[r * LDO + c] * out[(rbase + r) * DV + c];
    // the 16 lanes of one row are one half warp
    for (int off = 8; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    dd[i] = part;
    if (tx == 0) dsum[rbase + r] = part;
    mr[i] = stats[rbase + r];
    inv[i] = 1.f / fmaxf(stats[plane + rbase + r], 1e-30f);
    qp[i] = qpos[row0 + r];
  }
  float acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  for (int js = 0; js < n_sel; ++js) {
    const long long t = ib[js];
    if (t < 0 || t >= nkb) continue;      // as the forward
    __syncthreads();                      // previous tile consumed
    const float* kt = kb + t * BK * DK;
    const float* vt = vb + t * BK * DV;
    for (int e = tid; e < BK * DK; e += kThreads)
      Ks[(e / DK) * LDQ + e % DK] = kt[e];
    for (int e = tid; e < BK * DV; e += kThreads)
      Vs[(e / DV) * LDO + e % DV] = vt[e];
    for (int e = tid; e < BK; e += kThreads) kps[e] = pb[t * BK + e];
    __syncthreads();

    float sc[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) sc[i][j] = dp[i][j] = 0.f;
    // the forward's logits, summed in the forward's order
#pragma unroll 4
    for (int d = 0; d < DK; ++d) {
      float a[RQ], bb[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) bb[j] = Ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) sc[i][j] = fmaf(a[i], bb[j], sc[i][j]);
    }
#pragma unroll 4
    for (int c = 0; c < DV; ++c) {
      float a[RQ], bb[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = dOs[(ty + 16 * i) * LDO + c];
#pragma unroll
      for (int j = 0; j < RK; ++j) bb[j] = Vs[(tx + 16 * j) * LDO + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) dp[i][j] = fmaf(a[i], bb[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        float x = sc[i][j] * scale;
        const bool masked = causal && kps[tx + 16 * j] > qp[i];
        if (masked) x = kNegInf;
        const float p = expf(x - mr[i]) * inv[i];
        dSs[(ty + 16 * i) * LDS + tx + 16 * j] =
            masked ? 0.f : p * (dp[i][j] - dd[i]);
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[RQ], bb[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = dSs[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < RD; ++j) bb[j] = Ks[c * LDQ + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j)
      dq[(rbase + ty + 16 * i) * DK + tx + 16 * j] = acc[i][j] * scale;
}

template <int BQ, int BK, int DK, int DV, int KR>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ kpos,
               const int* __restrict__ qpos, const float* __restrict__ stats,
               const float* __restrict__ dsum,
               const float* __restrict__ dout, const int* __restrict__ off,
               const int* __restrict__ ent, float* __restrict__ dk,
               float* __restrict__ dv, int hq, int hkv, int s, int s_k,
               int n_sel, int causal, float scale) {
  constexpr int RR = KR / 16;
  constexpr int RQ = BQ / 16;
  constexpr int RD = DK / 16;
  constexpr int RV = DV / 16;
  constexpr int LDQ = DK + 1;
  constexpr int LDO = DV + 1;
  constexpr int LDP = BQ + 1;
  static_assert(BK % KR == 0 && KR % 16 == 0 && BQ % 16 == 0 &&
                    DK % 16 == 0 && DV % 16 == 0,
                "tile shape");

  extern __shared__ float smem[];
  float* Ks = smem;                       // KR x LDQ
  float* Vs = Ks + KR * LDQ;              // KR x LDO
  float* Qs = Vs + KR * LDO;              // BQ x LDQ
  float* dOs = Qs + BQ * LDQ;             // BQ x LDO
  float* Ps = dOs + BQ * LDO;             // KR x LDP
  float* dSs = Ps + KR * LDP;             // KR x LDP
  float* ms = dSs + KR * LDP;             // BQ
  float* invs = ms + BQ;                  // BQ
  float* Ds = invs + BQ;                  // BQ
  int* qps = reinterpret_cast<int*>(Ds + BQ);          // BQ
  int* kps = qps + BQ;                    // KR

  const int key0 = blockIdx.x * KR;       // first key of the block
  const int t = key0 / BK;                // its key tile
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int nqb = s / BQ;
  const int nkb = s_k / BK;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long plane = (long long)gridDim.z * hq * s;
  const long long bh = (long long)b * hkv + kvh;
  const long long kb = bh * s_k + key0;
  const int* o = off + bh * (nkb + 1);
  const int* e = ent + bh * nqb * n_sel;
  const int first = o[t];
  const int visits = (o[t + 1] - first) * g;

  for (int x = tid; x < KR * DK; x += kThreads)
    Ks[(x / DK) * LDQ + x % DK] = k[kb * DK + x];
  for (int x = tid; x < KR * DV; x += kThreads)
    Vs[(x / DV) * LDO + x % DV] = v[kb * DV + x];
  for (int x = tid; x < KR; x += kThreads) kps[x] = kpos[kb + x];

  float gk[RR][RD], gv[RR][RV];
#pragma unroll
  for (int i = 0; i < RR; ++i) {
#pragma unroll
    for (int j = 0; j < RD; ++j) gk[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < RV; ++j) gv[i][j] = 0.f;
  }

  for (int vi = 0; vi < visits; ++vi) {
    const int qt = e[first + vi / g] / n_sel;
    const int h = kvh * g + vi % g;
    const long long rbase = ((long long)b * hq + h) * s + (long long)qt * BQ;
    __syncthreads();                      // previous visit consumed
    for (int x = tid; x < BQ * DK; x += kThreads)
      Qs[(x / DK) * LDQ + x % DK] = q[rbase * DK + x];
    for (int x = tid; x < BQ * DV; x += kThreads)
      dOs[(x / DV) * LDO + x % DV] = dout[rbase * DV + x];
    for (int x = tid; x < BQ; x += kThreads) {
      ms[x] = stats[rbase + x];
      invs[x] = 1.f / fmaxf(stats[plane + rbase + x], 1e-30f);
      Ds[x] = dsum[rbase + x];
      qps[x] = qpos[qt * BQ + x];
    }
    __syncthreads();

    float sc[RR][RQ], dp[RR][RQ];
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; ++d) {
      float a[RR], bb[RQ];
#pragma unroll
      for (int i = 0; i < RR; ++i) a[i] = Ks[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < RQ; ++j) bb[j] = Qs[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) sc[i][j] = fmaf(bb[j], a[i], sc[i][j]);
    }
#pragma unroll 4
    for (int c = 0; c < DV; ++c) {
      float a[RR], bb[RQ];
#pragma unroll
      for (int i = 0; i < RR; ++i) a[i] = Vs[(ty + 16 * i) * LDO + c];
#pragma unroll
      for (int j = 0; j < RQ; ++j) bb[j] = dOs[(tx + 16 * j) * LDO + c];
#pragma unroll
      for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) dp[i][j] = fmaf(bb[j], a[i], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        const int c = tx + 16 * j;
        float x = sc[i][j] * scale;
        const bool masked = causal && kps[ty + 16 * i] > qps[c];
        if (masked) x = kNegInf;
        const float p = expf(x - ms[c]) * invs[c];
        Ps[(ty + 16 * i) * LDP + c] = p;
        dSs[(ty + 16 * i) * LDP + c] = masked ? 0.f : p * (dp[i][j] - Ds[c]);
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float pa[RR], sa[RR], bq_[RD], bo[RV];
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        pa[i] = Ps[(ty + 16 * i) * LDP + c];
        sa[i] = dSs[(ty + 16 * i) * LDP + c];
      }
#pragma unroll
      for (int j = 0; j < RD; ++j) bq_[j] = Qs[c * LDQ + tx + 16 * j];
#pragma unroll
      for (int j = 0; j < RV; ++j) bo[j] = dOs[c * LDO + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RR; ++i) {
#pragma unroll
        for (int j = 0; j < RD; ++j) gk[i][j] = fmaf(sa[i], bq_[j], gk[i][j]);
#pragma unroll
        for (int j = 0; j < RV; ++j) gv[i][j] = fmaf(pa[i], bo[j], gv[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    const long long r = kb + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < RD; ++j) dk[r * DK + tx + 16 * j] = gk[i][j] * scale;
#pragma unroll
    for (int j = 0; j < RV; ++j) dv[r * DV + tx + 16 * j] = gv[i][j];
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int BQ, int BK, int DK, int DV>
struct DqShape {
  static constexpr int kThreads = 2 * BQ;   // one warp per 16 query rows
  static constexpr int kChunk = BK < 32 ? BK : 32;   // keys per step
  static constexpr int LDK = DK + 8;        // bf16 per shared q/k row (+16 B)
  static constexpr int LDV = DV + 8;        // bf16 per shared v/dO row
  static constexpr int kStage = BK * LDK * 2 + BK * LDV * 2 + BK * 4;
  static constexpr size_t kSmem =
      (size_t)BQ * LDK * 2 + (size_t)BQ * LDV * 2 + BQ * 4 +
      2 * (size_t)kStage;
};

template <int BQ, int BK, int DK, int DV>
struct DkvShape {
  static constexpr int kThreads = 2 * BK;   // one warp per 16 keys
  static constexpr int kChunk = BQ < 32 ? BQ : 32;   // query rows per step
  static constexpr int LDK = DK + 8;
  static constexpr int LDV = DV + 8;
  // q and dO rows of one visit, then m, l, D (float) and qpos (int)
  static constexpr int kStage = BQ * LDK * 2 + BQ * LDV * 2 + 4 * BQ * 4;
  static constexpr size_t kSmem =
      (size_t)BK * LDK * 2 + (size_t)BK * LDV * 2 + BK * 4 +
      2 * (size_t)kStage;
};

template <int BQ, int BK, int DK, int DV>
__global__ void __launch_bounds__(DqShape<BQ, BK, DK, DV>::kThreads, 1)
    dq_mma(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const int* __restrict__ kpos,
           const int* __restrict__ qpos, const int* __restrict__ idx,
           const __nv_bfloat16* __restrict__ out,
           const float* __restrict__ stats,
           const __nv_bfloat16* __restrict__ dout,
           __nv_bfloat16* __restrict__ dq, float* __restrict__ dsum, int hq,
           int hkv, int s, int s_k, int n_sel, int causal, float scale_log2,
           float scale) {
  using Shape = DqShape<BQ, BK, DK, DV>;
  constexpr int NT = Shape::kThreads;
  constexpr int LDK = Shape::LDK;
  constexpr int LDV = Shape::LDV;
  constexpr int KC = Shape::kChunk;
  constexpr int NS = KC / 8;               // key n-tiles per chunk
  constexpr int KD = DK / 16;              // k-steps over the q/k dim
  constexpr int KV = DV / 16;              // k-steps over the v dim
  constexpr int NQ = DK / 8;               // dQ n-tiles
  constexpr int CPK = DK / 8;              // 16-byte chunks per q/k row
  constexpr int CPV = DV / 8;              // 16-byte chunks per v row
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && DK % 32 == 0 &&
                    DV % 32 == 0,
                "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * LDK;
  float* Ds = reinterpret_cast<float*>(dOs + BQ * LDV);
  unsigned char* ring = reinterpret_cast<unsigned char*>(Ds + BQ);

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int kvh = h / g;
  const int nqb = s / BQ;
  const int nkb = s_k / BK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;
  const int tg = lane % 4;
  const long long plane = (long long)gridDim.z * hq * s;
  const long long rbase = ((long long)b * hq + h) * s + (long long)qt * BQ;

  const __nv_bfloat16* qb = q + rbase * DK;
  const __nv_bfloat16* db = dout + rbase * DV;
  const long long kvbase = ((long long)b * hkv + kvh) * s_k;
  const __nv_bfloat16* kb = k + kvbase * DK;
  const __nv_bfloat16* vb = v + kvbase * DV;
  const int* pb = kpos + kvbase;
  const int* ib = idx + (((long long)b * hkv + kvh) * nqb + qt) * n_sel;

  auto next_tile = [&](int j) {
    while (j < n_sel && (ib[j] < 0 || ib[j] >= nkb)) ++j;
    return j;
  };
  auto stage_k = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(ring + st * Shape::kStage);
  };
  auto stage_v = [&](int st) { return stage_k(st) + BK * LDK; };
  auto stage_p = [&](int st) {
    return reinterpret_cast<int*>(stage_v(st) + BK * LDV);
  };
  auto load_tile = [&](int st, long long t) {
    const __nv_bfloat16* kt = kb + t * BK * DK;
    const __nv_bfloat16* vt = vb + t * BK * DV;
    __nv_bfloat16* ks = stage_k(st);
    __nv_bfloat16* vs = stage_v(st);
    for (int c = tid; c < BK * CPK; c += NT) {
      const int r = c / CPK;
      const int col = (c % CPK) * 8;
      cp_async16(ks + r * LDK + col, kt + r * DK + col);
    }
    for (int c = tid; c < BK * CPV; c += NT) {
      const int r = c / CPV;
      const int col = (c % CPV) * 8;
      cp_async16(vs + r * LDV + col, vt + r * DV + col);
    }
    int* ps = stage_p(st);
    for (int c = tid; c < BK / 4; c += NT)
      cp_async16(ps + 4 * c, pb + t * BK + 4 * c);
  };

  for (int c = tid; c < BQ * CPK; c += NT) {
    const int r = c / CPK;
    const int col = (c % CPK) * 8;
    cp_async16(Qs + r * LDK + col, qb + r * DK + col);
  }
  for (int c = tid; c < BQ * CPV; c += NT) {
    const int r = c / CPV;
    const int col = (c % CPV) * 8;
    cp_async16(dOs + r * LDV + col, db + r * DV + col);
  }
  int js = next_tile(0);
  if (js < n_sel) load_tile(0, ib[js]);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // D = rowsum(dO o O), one thread a row, in float32
  if (tid < BQ) {
    const __nv_bfloat16* orow = out + (rbase + tid) * DV;
    const __nv_bfloat16* drow = dOs + tid * LDV;
    float acc = 0.f;
    for (int c = 0; c < DV; ++c)
      acc += __bfloat162float(drow[c]) * __bfloat162float(orow[c]);
    Ds[tid] = acc;
    dsum[rbase + tid] = acc;
  }
  uint32_t qf[KD][4], df[KV][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LDK + kk * 16 +
                        (lane / 16) * 8);
#pragma unroll
  for (int kk = 0; kk < KV; ++kk)
    ldsm_x4(df[kk], dOs + (warp * 16 + lane % 16) * LDV + kk * 16 +
                        (lane / 16) * 8);
  __syncthreads();                       // Ds written

  const int r0 = warp * 16 + gr;          // and r0 + 8, in the tile
  const int qp0 = qpos[qt * BQ + r0];
  const int qp1 = qpos[qt * BQ + r0 + 8];
  const float m0 = stats[rbase + r0];
  const float m1 = stats[rbase + r0 + 8];
  const float inv0 = 1.f / fmaxf(stats[plane + rbase + r0], 1e-30f);
  const float inv1 = 1.f / fmaxf(stats[plane + rbase + r0 + 8], 1e-30f);
  const float d0 = Ds[r0];
  const float d1 = Ds[r0 + 8];
  float acc[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[n][x] = 0.f;

  int st = 0;
  while (js < n_sel) {
    cp_async_wait_all();
    __syncthreads();
    const int jn = next_tile(js + 1);
    if (jn < n_sel) load_tile(st ^ 1, ib[jn]);
    cp_async_commit();
    const __nv_bfloat16* Ks = stage_k(st);
    const __nv_bfloat16* Vs = stage_v(st);
    const int* Ps = stage_p(st);

#pragma unroll
    for (int kc = 0; kc < BK / KC; ++kc) {
      float sc[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[j][x] = dp[j][x] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; kk += 2) {
          uint32_t kf[4];
          ldsm_x4(kf, Ks + (kc * KC + j * 8 + lane % 8) * LDK + kk * 16 +
                          (lane / 8) * 8);
          mma_bf16(sc[j], qf[kk], kf[0], kf[1]);
          mma_bf16(sc[j], qf[kk + 1], kf[2], kf[3]);
        }
#pragma unroll
        for (int kk = 0; kk < KV; kk += 2) {
          uint32_t vf[4];
          ldsm_x4(vf, Vs + (kc * KC + j * 8 + lane % 8) * LDV + kk * 16 +
                          (lane / 8) * 8);
          mma_bf16(dp[j], df[kk], vf[0], vf[1]);
          mma_bf16(dp[j], df[kk + 1], vf[2], vf[3]);
        }
      }
      // dS in place of the logits: p from the forward's m and l, zero
      // where the mask replaced the logit
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int2 kp =
            *reinterpret_cast<const int2*>(Ps + kc * KC + j * 8 + tg * 2);
        const bool mk[4] = {causal && kp.x > qp0, causal && kp.y > qp0,
                            causal && kp.x > qp1, causal && kp.y > qp1};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float mx = x < 2 ? m0 : m1;
          const float iv = x < 2 ? inv0 : inv1;
          const float dd = x < 2 ? d0 : d1;
          const float lg = mk[x] ? kNegInf : sc[j][x] * scale_log2;
          const float p = exp2f(lg - mx) * iv;
          sc[j][x] = mk[x] ? 0.f : p * (dp[j][x] - dd);
        }
      }
      // dQ += dS . K with dS = hi + lo: key n-tiles 2t, 2t+1 are the A
      // fragment of key step t
#pragma unroll
      for (int t = 0; t < KC / 16; ++t) {
        uint32_t sh[4], sl[4];
        split_bf16(sc[2 * t][0], sc[2 * t][1], sh[0], sl[0]);
        split_bf16(sc[2 * t][2], sc[2 * t][3], sh[1], sl[1]);
        split_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1], sh[2], sl[2]);
        split_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3], sh[3], sl[3]);
#pragma unroll
        for (int n = 0; n < NQ; n += 2) {
          uint32_t kf[4];
          ldsm_x4_trans(kf, Ks + (kc * KC + t * 16 + lane % 16) * LDK +
                                n * 8 + (lane / 16) * 8);
          mma_bf16(acc[n], sh, kf[0], kf[1]);
          mma_bf16(acc[n], sl, kf[0], kf[1]);
          mma_bf16(acc[n + 1], sh, kf[2], kf[3]);
          mma_bf16(acc[n + 1], sl, kf[2], kf[3]);
        }
      }
    }
    js = jn;
    st ^= 1;
  }

  __nv_bfloat16* o0 = dq + (rbase + r0) * DK + tg * 2;
  __nv_bfloat16* o1 = o0 + 8 * DK;
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(o0 + n * 8) =
        __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(o1 + n * 8) =
        __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int BQ, int BK, int DK, int DV>
__global__ void __launch_bounds__(DkvShape<BQ, BK, DK, DV>::kThreads, 1)
    dkv_mma(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const int* __restrict__ kpos,
            const int* __restrict__ qpos, const float* __restrict__ stats,
            const float* __restrict__ dsum,
            const __nv_bfloat16* __restrict__ dout,
            const int* __restrict__ off, const int* __restrict__ ent,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int hq, int hkv, int s, int s_k, int n_sel, int causal,
            float scale_log2, float scale) {
  using Shape = DkvShape<BQ, BK, DK, DV>;
  constexpr int NT = Shape::kThreads;
  constexpr int LDK = Shape::LDK;
  constexpr int LDV = Shape::LDV;
  constexpr int QC = Shape::kChunk;
  constexpr int NS = QC / 8;               // query n-tiles per chunk
  constexpr int KD = DK / 16;
  constexpr int KV = DV / 16;
  constexpr int NK = DK / 8;               // dK n-tiles
  constexpr int NV = DV / 8;               // dV n-tiles
  constexpr int CPK = DK / 8;
  constexpr int CPV = DV / 8;
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && DK % 32 == 0 &&
                    DV % 32 == 0,
                "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK * LDK;
  int* kps = reinterpret_cast<int*>(Vs + BK * LDV);
  unsigned char* ring = reinterpret_cast<unsigned char*>(kps + BK);

  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int nqb = s / BQ;
  const int nkb = s_k / BK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;
  const int tg = lane % 4;
  const long long plane = (long long)gridDim.z * hq * s;
  const long long bh = (long long)b * hkv + kvh;
  const long long kb = bh * s_k + (long long)t * BK;
  const int* o = off + bh * (nkb + 1);
  const int* e = ent + bh * nqb * n_sel;
  const int first = o[t];
  const int visits = (o[t + 1] - first) * g;

  auto stage_q = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(ring + st * Shape::kStage);
  };
  auto stage_d = [&](int st) { return stage_q(st) + BQ * LDK; };
  auto stage_f = [&](int st) {        // m, l, D: BQ floats each
    return reinterpret_cast<float*>(stage_d(st) + BQ * LDV);
  };
  auto stage_qp = [&](int st) {
    return reinterpret_cast<int*>(stage_f(st) + 3 * BQ);
  };
  auto load_visit = [&](int st, int vi) {
    const int qt = e[first + vi / g] / n_sel;
    const int h = kvh * g + vi % g;
    const long long rb = ((long long)b * hq + h) * s + (long long)qt * BQ;
    __nv_bfloat16* qs = stage_q(st);
    __nv_bfloat16* ds = stage_d(st);
    for (int c = tid; c < BQ * CPK; c += NT) {
      const int r = c / CPK;
      const int col = (c % CPK) * 8;
      cp_async16(qs + r * LDK + col, q + (rb + r) * DK + col);
    }
    for (int c = tid; c < BQ * CPV; c += NT) {
      const int r = c / CPV;
      const int col = (c % CPV) * 8;
      cp_async16(ds + r * LDV + col, dout + (rb + r) * DV + col);
    }
    float* f = stage_f(st);
    int* qp = stage_qp(st);
    for (int c = tid; c < BQ / 4; c += NT) {
      cp_async16(f + 4 * c, stats + rb + 4 * c);
      cp_async16(f + BQ + 4 * c, stats + plane + rb + 4 * c);
      cp_async16(f + 2 * BQ + 4 * c, dsum + rb + 4 * c);
      cp_async16(qp + 4 * c, qpos + (long long)qt * BQ + 4 * c);
    }
  };

  for (int c = tid; c < BK * CPK; c += NT) {
    const int r = c / CPK;
    const int col = (c % CPK) * 8;
    cp_async16(Ks + r * LDK + col, k + (kb + r) * DK + col);
  }
  for (int c = tid; c < BK * CPV; c += NT) {
    const int r = c / CPV;
    const int col = (c % CPV) * 8;
    cp_async16(Vs + r * LDV + col, v + (kb + r) * DV + col);
  }
  for (int c = tid; c < BK / 4; c += NT)
    cp_async16(kps + 4 * c, kpos + kb + 4 * c);
  if (visits > 0) load_visit(0, 0);
  cp_async_commit();

  const int r0 = warp * 16 + gr;           // this lane's keys r0, r0 + 8
  float gk[NK][4], gv[NV][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) gk[n][x] = 0.f;
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) gv[n][x] = 0.f;

  int st = 0;
  for (int vi = 0; vi < visits; ++vi) {
    cp_async_wait_all();
    __syncthreads();
    if (vi + 1 < visits) load_visit(st ^ 1, vi + 1);
    cp_async_commit();
    const __nv_bfloat16* Qs = stage_q(st);
    const __nv_bfloat16* dOs = stage_d(st);
    const float* ms = stage_f(st);
    const float* ls = ms + BQ;
    const float* Dv = ms + 2 * BQ;
    const int* qps = stage_qp(st);
    const int kp0 = kps[r0];
    const int kp1 = kps[r0 + 8];

#pragma unroll
    for (int qc = 0; qc < BQ / QC; ++qc) {
      float sc[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[j][x] = dp[j][x] = 0.f;
      // S^T = K . Q^T and dP^T = V . dO^T, the k / v rows the A operand
#pragma unroll
      for (int kk = 0; kk < KD; kk += 2) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, Ks + (warp * 16 + lane % 16) * LDK + kk * 16 +
                        (lane / 16) * 8);
        ldsm_x4(a1, Ks + (warp * 16 + lane % 16) * LDK + (kk + 1) * 16 +
                        (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          uint32_t bf[4];
          ldsm_x4(bf, Qs + (qc * QC + j * 8 + lane % 8) * LDK + kk * 16 +
                          (lane / 8) * 8);
          mma_bf16(sc[j], a0, bf[0], bf[1]);
          mma_bf16(sc[j], a1, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KV; kk += 2) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, Vs + (warp * 16 + lane % 16) * LDV + kk * 16 +
                        (lane / 16) * 8);
        ldsm_x4(a1, Vs + (warp * 16 + lane % 16) * LDV + (kk + 1) * 16 +
                        (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          uint32_t bf[4];
          ldsm_x4(bf, dOs + (qc * QC + j * 8 + lane % 8) * LDV + kk * 16 +
                          (lane / 8) * 8);
          mma_bf16(dp[j], a0, bf[0], bf[1]);
          mma_bf16(dp[j], a1, bf[2], bf[3]);
        }
      }
      // p^T into sc, dS^T into dp: rows are keys (kp0, kp1), columns
      // query rows c, c + 1
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = qc * QC + j * 8 + tg * 2;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int cc = c + (x & 1);
          const bool mk = causal && (x < 2 ? kp0 : kp1) > qps[cc];
          const float lg = mk ? kNegInf : sc[j][x] * scale_log2;
          const float p = exp2f(lg - ms[cc]) * (1.f / fmaxf(ls[cc], 1e-30f));
          sc[j][x] = p;
          dp[j][x] = mk ? 0.f : p * (dp[j][x] - Dv[cc]);
        }
      }
      // dV += p^T . dO and dK += dS^T . Q, p and dS as hi + lo: query
      // n-tiles 2u, 2u + 1 are the A fragment of query step u
#pragma unroll
      for (int u = 0; u < QC / 16; ++u) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        split_bf16(sc[2 * u][0], sc[2 * u][1], ph[0], pl[0]);
        split_bf16(sc[2 * u][2], sc[2 * u][3], ph[1], pl[1]);
        split_bf16(sc[2 * u + 1][0], sc[2 * u + 1][1], ph[2], pl[2]);
        split_bf16(sc[2 * u + 1][2], sc[2 * u + 1][3], ph[3], pl[3]);
        split_bf16(dp[2 * u][0], dp[2 * u][1], sh[0], sl[0]);
        split_bf16(dp[2 * u][2], dp[2 * u][3], sh[1], sl[1]);
        split_bf16(dp[2 * u + 1][0], dp[2 * u + 1][1], sh[2], sl[2]);
        split_bf16(dp[2 * u + 1][2], dp[2 * u + 1][3], sh[3], sl[3]);
#pragma unroll
        for (int n = 0; n < NV; n += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, dOs + (qc * QC + u * 16 + lane % 16) * LDV +
                                n * 8 + (lane / 16) * 8);
          mma_bf16(gv[n], ph, bf[0], bf[1]);
          mma_bf16(gv[n], pl, bf[0], bf[1]);
          mma_bf16(gv[n + 1], ph, bf[2], bf[3]);
          mma_bf16(gv[n + 1], pl, bf[2], bf[3]);
        }
#pragma unroll
        for (int n = 0; n < NK; n += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, Qs + (qc * QC + u * 16 + lane % 16) * LDK +
                                n * 8 + (lane / 16) * 8);
          mma_bf16(gk[n], sh, bf[0], bf[1]);
          mma_bf16(gk[n], sl, bf[0], bf[1]);
          mma_bf16(gk[n + 1], sh, bf[2], bf[3]);
          mma_bf16(gk[n + 1], sl, bf[2], bf[3]);
        }
      }
    }
    st ^= 1;
  }
  cp_async_wait_all();                     // nothing left in flight

  __nv_bfloat16* k0 = dk + (kb + r0) * DK + tg * 2;
  __nv_bfloat16* k1 = k0 + 8 * DK;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(k0 + n * 8) =
        __floats2bfloat162_rn(gk[n][0] * scale, gk[n][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(k1 + n * 8) =
        __floats2bfloat162_rn(gk[n][2] * scale, gk[n][3] * scale);
  }
  __nv_bfloat16* v0 = dv + (kb + r0) * DV + tg * 2;
  __nv_bfloat16* v1 = v0 + 8 * DV;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(v0 + n * 8) =
        __floats2bfloat162_rn(gv[n][0], gv[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(v1 + n * 8) =
        __floats2bfloat162_rn(gv[n][2], gv[n][3]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

using Args = repro::BwdArgs;

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem, repro::SmemOptin& opt) {
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err == cudaSuccess) err = repro::allow_smem(kern, dev, smem, opt);
  return err;
}

template <int BQ, int BK, int DK, int DV>
int dq_f32(const Args& a) {
  constexpr int QR = dq_rows<BQ, BK, DK, DV>();
  constexpr size_t smem = dq_smem<QR, BK, DK, DV>();
  static_assert(smem <= kMaxSmem, "float32 dQ staging exceeds shared memory");
  static repro::SmemOptin opt;
  auto kern = dq_kernel<BQ, BK, DK, DV, QR>;
  cudaError_t err = prepare(kern, smem, opt);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.s / QR, a.hq, a.b), kThreads, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const int*)a.kpos, (const int*)a.qpos, (const int*)a.idx,
      (const float*)a.out, (const float*)a.stats, (const float*)a.dout,
      (float*)a.dq, (float*)a.dsum_out, a.hq, a.hkv, a.s, a.s_k, a.n_sel,
      a.causal, 1.f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

template <int BQ, int BK, int DK, int DV>
int dkv_f32(const Args& a) {
  constexpr int KR = dkv_rows<BQ, BK, DK, DV>();
  constexpr size_t smem = dkv_smem<KR, BQ, DK, DV>();
  static_assert(smem <= kMaxSmem,
                "float32 dK/dV staging exceeds shared memory");
  static repro::SmemOptin opt;
  auto kern = dkv_kernel<BQ, BK, DK, DV, KR>;
  cudaError_t err = prepare(kern, smem, opt);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.s_k / KR, a.hkv, a.b), kThreads, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const int*)a.kpos, (const int*)a.qpos, (const float*)a.stats,
      (const float*)a.dsum, (const float*)a.dout, (const int*)a.off,
      (const int*)a.ent, (float*)a.dk, (float*)a.dv, a.hq, a.hkv, a.s,
      a.s_k, a.n_sel, a.causal, 1.f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

constexpr float kLog2e = 1.4426950408889634f;

template <int BQ, int BK, int DK, int DV>
int dq_bf16(const Args& a) {
  using Shape = DqShape<BQ, BK, DK, DV>;
  static_assert(Shape::kSmem <= kMaxSmem, "bf16 dQ ring exceeds shared memory");
  static repro::SmemOptin opt;
  auto kern = dq_mma<BQ, BK, DK, DV>;
  cudaError_t err = prepare(kern, Shape::kSmem, opt);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)DK);
  kern<<<dim3(a.s / BQ, a.hq, a.b), Shape::kThreads, Shape::kSmem,
         a.stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
      (const __nv_bfloat16*)a.v, (const int*)a.kpos, (const int*)a.qpos,
      (const int*)a.idx, (const __nv_bfloat16*)a.out, (const float*)a.stats,
      (const __nv_bfloat16*)a.dout, (__nv_bfloat16*)a.dq,
      (float*)a.dsum_out, a.hq, a.hkv, a.s, a.s_k, a.n_sel, a.causal,
      kLog2e / sqrtf((float)DK), scale);
  return (int)cudaGetLastError();
}

template <int BQ, int BK, int DK, int DV>
int dkv_bf16(const Args& a) {
  using Shape = DkvShape<BQ, BK, DK, DV>;
  static_assert(Shape::kSmem <= kMaxSmem,
                "bf16 dK/dV ring exceeds shared memory");
  static repro::SmemOptin opt;
  auto kern = dkv_mma<BQ, BK, DK, DV>;
  cudaError_t err = prepare(kern, Shape::kSmem, opt);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.s_k / BK, a.hkv, a.b), Shape::kThreads, Shape::kSmem,
         a.stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
      (const __nv_bfloat16*)a.v, (const int*)a.kpos, (const int*)a.qpos,
      (const float*)a.stats, (const float*)a.dsum,
      (const __nv_bfloat16*)a.dout, (const int*)a.off, (const int*)a.ent,
      (__nv_bfloat16*)a.dk, (__nv_bfloat16*)a.dv, a.hq, a.hkv, a.s, a.s_k,
      a.n_sel, a.causal, kLog2e / sqrtf((float)DK), 1.f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

// the forward's instances: bq == bk and (bq, dh, dv) in
//   {32, 64, 128} x (64, 64), 128 x (128, 128), 128 x (96, 64)
// in both dtypes, and float32 at 32 x (16, 16); bf16 at bq = 128 (every
// ClusterKV train step) runs the Hopper kernels of
// block_attention_bwd_sm90.cu
#define REPRO_BWD_DISPATCH(F32, BF16, SM90)                               \
  if (bq != bk || (dtype != 0 && dtype != 1))                             \
    return (int)cudaErrorInvalidValue;                                    \
  if (dtype == 1 && bq == 128) return SM90(a, dh, dv);                    \
  if (dtype == 0 && bq == 32 && dh == 16 && dv == 16)                     \
    return F32<32, 32, 16, 16>(a);                                        \
  if (bq == 128 && dh == 64 && dv == 64) return F32<128, 128, 64, 64>(a); \
  if (bq == 64 && dh == 64 && dv == 64)                                   \
    return dtype == 0 ? F32<64, 64, 64, 64>(a) : BF16<64, 64, 64, 64>(a); \
  if (bq == 32 && dh == 64 && dv == 64)                                   \
    return dtype == 0 ? F32<32, 32, 64, 64>(a) : BF16<32, 32, 64, 64>(a); \
  if (bq == 128 && dh == 128 && dv == 128)                                \
    return F32<128, 128, 128, 128>(a);                                    \
  if (bq == 128 && dh == 96 && dv == 64) return F32<128, 128, 96, 64>(a); \
  return (int)cudaErrorInvalidValue;

}  // namespace

// idx (BH, n) i32, n = S/bq * n_sel flat (query tile, slot) positions of
// each (b, kv head); off (BH, nkb + 1) i32 and ent (BH, n) i32: the
// entries of key tile t are ent[off[t] : off[t + 1]], ascending, the rest
// of each row -1.
extern "C" int repro_key_tile_lists(const void* idx, void* off, void* ent,
                                    int bh, int n, int nkb, void* stream) {
  if (bh == 0) return (int)cudaSuccess;
  key_tile_lists_kernel<<<bh, kListThreads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (int*)off, (int*)ent, n, nkb);
  return (int)cudaGetLastError();
}

// order (bh * nkb) i32: the items bh * nkb + t of the lists' offsets off
// (BH, nkb + 1), longest list first, ties in index order; the dK/dV
// kernel numbers its blocks by it
extern "C" int repro_key_tile_order(const void* off, void* order, int bh,
                                    int nkb, void* stream) {
  const int n = bh * nkb;
  if (n == 0) return (int)cudaSuccess;
  key_tile_order_kernel<<<(n + kOrderThreads - 1) / kOrderThreads,
                          kOrderThreads, 0, (cudaStream_t)stream>>>(
      (const int*)off, (int*)order, n, nkb);
  return (int)cudaGetLastError();
}

// dQ (B, Hq, S, dh) in q's dtype, and dsum (2, B, Hq, S) float32: D in the
// first plane, 1 / max(l, 1e-30) in the second (written by the bf16 kernel
// at tiles of 128 only), from the forward's inputs, its output out, its
// stats (2, B, Hq, S) and the cotangent dout (B, Hq, S, dv); dtype 0 =
// float32, 1 = bfloat16.
extern "C" int repro_block_attention_dq(
    const void* q, const void* k, const void* v, const void* kpos,
    const void* qpos, const void* idx, const void* out, const void* stats,
    const void* dout, void* dq, void* dsum, int b, int hq, int hkv, int s,
    int s_k, int dh, int dv, int bq, int bk, int n_sel, int causal,
    int dtype, void* stream) {
  if (b == 0 || s == 0) return (int)cudaSuccess;
  Args a{q, k, v, kpos, qpos, idx, out, stats, dout, nullptr, nullptr,
         nullptr, nullptr, dq, nullptr, nullptr, dsum, b, hq, hkv, s, s_k,
         n_sel, causal, (cudaStream_t)stream};
  REPRO_BWD_DISPATCH(dq_f32, dq_bf16, repro::bwd_dq_sm90)
}

// dK (B, Hkv, S_k, dh) and dV (B, Hkv, S_k, dv) in k's dtype, from the
// key-tile lists (off, ent), their order (the bf16 kernels at tiles of 128
// number their blocks by it) and dsum of the dQ kernel.
extern "C" int repro_block_attention_dkv(
    const void* q, const void* k, const void* v, const void* kpos,
    const void* qpos, const void* stats, const void* dsum, const void* dout,
    const void* off, const void* ent, const void* order, void* dk,
    void* dvo, int b, int hq, int hkv, int s, int s_k, int dh, int dv,
    int bq, int bk, int n_sel, int causal, int dtype, void* stream) {
  if (b == 0 || s_k == 0) return (int)cudaSuccess;
  Args a{q, k, v, kpos, qpos, nullptr, nullptr, stats, dout, dsum, off, ent,
         order, nullptr, dk, dvo, nullptr, b, hq, hkv, s, s_k, n_sel,
         causal, (cudaStream_t)stream};
  REPRO_BWD_DISPATCH(dkv_f32, dkv_bf16, repro::bwd_dkv_sm90)
}
