// Cluster-block-sparse attention (ClusterKV prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/block_attention.py:
//   block_attention (_kernel)  ->  repro_block_attention
// together with the two vmaps of its wrapper (src/repro/kernels/ops.py
// block_attention: over batch x kv head and over the GQA group), which here
// are the launch grid (query tile, query head, batch).
//
// What it computes: for query tile i of query head h of batch member b,
//   an online softmax (m, l, acc) over the n_sel key tiles idx[b, h/g, i, :]
//   of the cluster-sorted k/v of kv head h/g:
//     s = (q_tile . k_tile^T) * 1/sqrt(dh), causally masked elementwise
//         (kpos > qpos -> -1e30, not -inf, as the reference),
//     m' = max(m, rowmax s); alpha = exp(m - m'); p = exp(s - m');
//     l = l alpha + rowsum p; acc = acc alpha + p . v_tile
//   and writes acc / max(l, 1e-30) in q's dtype. A query row whose selected
//   keys are all masked gets uniform weights, exactly as the reference
//   (exp(0) = 1). Tile ids outside [0, S_k/bk) are skipped. No atomics: the
//   result is bit-equal run to run.
//
// Two kernels behind one entry:
//
// * bf16 (dtype 1, every ClusterKV prefill): block_attention_mma, on the
//   tensor cores. What bounds it: operations. Each (query tile, selected
//   key tile) pair is 2 * 2 * bq * bk * dh operations against 2 * bk * dh
//   bf16 values of k and v, about 128 per byte at bq = 128; a Qwen2-0.5B
//   layer at S = 4096 (14 query heads, 16 of 32 key tiles, dh = 64) is
//   30 GFLOP, 0.030 ms at 989 TFLOP/s bf16 (P.V is issued twice, see
//   below, so the kernel executes 1.5x that). Design: one warp per 16
//   query rows (bq / 16 warps); the q fragments are loaded once into
//   registers with ldmatrix. The selected (bk, 64) k and v tiles and their
//   positions stream through a 2-stage cp.async ring (16 bytes a thread,
//   rows padded to 72 bf16 so that ldmatrix is free of bank conflicts):
//   tile j+1 loads while tile j computes, one barrier per tile.
//   Q.K^T is mma.sync.m16n8k16 bf16 -> f32 (K row-major [key][dh] is
//   already the "col" B operand); scale and the causal mask from the
//   tile's positions in shared memory, then the online softmax per row,
//   reduced over the 4 lanes that share a row, over chunks of 32 keys (at
//   128 registers two blocks of 8 warps share an SM), with the logits in
//   log2 units (log2 e folded into the scale, exp2f: p moves by ~1e-6
//   relative). P.V takes P straight from the S accumulators as the A
//   operand and V by ldmatrix.trans. P must stay float32-accurate (the
//   reference keeps p in float32; one bf16 rounding of p is an output
//   error of ~1e-4 rms at S = 2048, outside the kernel-vs-plain bound), so
//   p is split into hi = bf16(p) and lo = bf16(p - hi) and two mmas are
//   issued per step: |p - hi - lo| <= 2^-17 |p|. Q.K^T of bf16 inputs with
//   f32 accumulation is exact up to summation order.
//
// * float32 (dtype 0, the covering-budget check): block_attention_kernel
//   on the CUDA cores: 256 threads in a 16 x 16 grid, each owning an
//   (bq/16) x (bk/16) register tile of the logits and (bq/16) x (dv/16) of
//   the output; q, k, v and p staged as float32 in up to 170 KB of dynamic
//   shared memory (one block per SM), rows padded for conflict-free
//   access; bound 0.45 ms at 67 TFLOP/s for the layer above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int BQ, int BK, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                          (size_t)BK * D + (size_t)BQ * (BK + 16)) +
         sizeof(int) * BK;
}

template <int BQ, int BK, int D>
__global__ void __launch_bounds__(kThreads)
    block_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ kpos,
                           const int* __restrict__ qpos,
                           const int* __restrict__ idx,
                           float* __restrict__ out,
                           int hq, int hkv, int s, int s_k, int n_sel,
                           int causal, float scale) {
  constexpr int RQ = BQ / 16;
  constexpr int RK = BK / 16;
  constexpr int RV = D / 16;
  constexpr int LDQ = D + 1;
  constexpr int LDK = D + 1;
  constexpr int LDP = BK + 16;

  extern __shared__ float smem[];
  float* Qs = smem;                       // BQ x LDQ
  float* Ks = Qs + BQ * LDQ;              // BK x LDK
  float* Vs = Ks + BK * LDK;              // BK x D
  float* Ps = Vs + BK * D;                // BQ x LDP
  int* kps = reinterpret_cast<int*>(Ps + BQ * LDP);   // BK

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int kvh = h / g;
  const int nqb = s / BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const float* qb =
      q + (((long long)b * hq + h) * s + (long long)qt * BQ) * D;
  const long long kvbase = ((long long)b * hkv + kvh) * s_k;
  const float* kb = k + kvbase * D;
  const float* vb = v + kvbase * D;
  const int* pb = kpos + kvbase;
  const int* ib = idx + (((long long)b * hkv + kvh) * nqb + qt) * n_sel;

  for (int e = tid; e < BQ * D; e += kThreads)
    Qs[(e / D) * LDQ + e % D] = qb[e];

  int qp[RQ];
  float m[RQ], l[RQ], o[RQ][RV];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    qp[i] = qpos[qt * BQ + ty + 16 * i];
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RV; ++j) o[i][j] = 0.f;
  }

  const int nkb = s_k / BK;
  for (int js = 0; js < n_sel; ++js) {
    const long long t = ib[js];
    // a tile id outside the cache is skipped (the same for every thread)
    if (t < 0 || t >= nkb) continue;
    __syncthreads();                      // previous tile consumed
    const float* kt = kb + t * BK * D;
    const float* vt = vb + t * BK * D;
    for (int e = tid; e < BK * D; e += kThreads) {
      Ks[(e / D) * LDK + e % D] = kt[e];
      Vs[e] = vt[e];
    }
    for (int e = tid; e < BK; e += kThreads) kps[e] = pb[t * BK + e];
    __syncthreads();

    float sc[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RQ], bb[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) bb[j] = Ks[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) sc[i][j] = fmaf(a[i], bb[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        float x = sc[i][j] * scale;
        if (causal && kps[tx + 16 * j] > qp[i]) x = kNegInf;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 lanes of one row are one half warp
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RV; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[RQ], bb[RV];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < RV; ++j) bb[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RV; ++j) o[i][j] = fmaf(a[i], bb[j], o[i][j]);
    }
  }

  float* ob = out + (((long long)b * hq + h) * s + (long long)qt * BQ) * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < RV; ++j)
      ob[(ty + 16 * i) * D + tx + 16 * j] = o[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, register i receives its fragment
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), each packed low column first
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h),
                                  x1 - __high2float(h)));
}

template <int BQ, int BK, int D>
struct MmaShape {
  static constexpr int kThreads = 2 * BQ;   // one warp per 16 query rows
  static constexpr int kMinBlocks = 2;      // blocks an SM should hold
  static constexpr int kChunk = BK < 32 ? BK : 32;   // keys per softmax step
  static constexpr int LD = D + 8;          // bf16 per shared row (+16 B)
  static constexpr int kStage = 2 * BK * LD * 2 + BK * 4;   // k, v, kpos
  static constexpr size_t kSmem = (size_t)BQ * LD * 2 + 2 * (size_t)kStage;
};

template <int BQ, int BK, int D>
__global__ void __launch_bounds__(MmaShape<BQ, BK, D>::kThreads,
                                  MmaShape<BQ, BK, D>::kMinBlocks)
    block_attention_mma(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ kpos,
                        const int* __restrict__ qpos,
                        const int* __restrict__ idx,
                        __nv_bfloat16* __restrict__ out, int hq, int hkv,
                        int s, int s_k, int n_sel, int causal,
                        float scale_log2) {
  using Shape = MmaShape<BQ, BK, D>;
  constexpr int NT = Shape::kThreads;
  constexpr int LD = Shape::LD;
  constexpr int KC = Shape::kChunk;
  constexpr int NS = KC / 8;               // logit n-tiles per chunk
  constexpr int NO = D / 8;                // output n-tiles
  constexpr int KD = D / 16;               // k-steps over dh
  constexpr int CPR = D / 8;               // 16-byte chunks per row
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && D % 32 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* ring = smem_raw + (size_t)BQ * LD * 2;

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
  const int gr = lane / 4;                 // row of the fragment
  const int tg = lane % 4;                 // column pair of the fragment

  const __nv_bfloat16* qb =
      q + (((long long)b * hq + h) * s + (long long)qt * BQ) * D;
  const long long kvbase = ((long long)b * hkv + kvh) * s_k;
  const __nv_bfloat16* kb = k + kvbase * D;
  const __nv_bfloat16* vb = v + kvbase * D;
  const int* pb = kpos + kvbase;
  const int* ib = idx + (((long long)b * hkv + kvh) * nqb + qt) * n_sel;

  // the next selected tile id inside the cache, from position j on (the
  // same for every thread, so the ring stays block-uniform)
  auto next_tile = [&](int j) {
    while (j < n_sel && (ib[j] < 0 || ib[j] >= nkb)) ++j;
    return j;
  };
  auto stage_k = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(ring + st * Shape::kStage);
  };
  auto stage_v = [&](int st) { return stage_k(st) + BK * LD; };
  auto stage_p = [&](int st) {
    return reinterpret_cast<int*>(stage_k(st) + 2 * BK * LD);
  };
  auto load_tile = [&](int st, long long t) {
    const __nv_bfloat16* kt = kb + t * BK * D;
    const __nv_bfloat16* vt = vb + t * BK * D;
    __nv_bfloat16* ks = stage_k(st);
    __nv_bfloat16* vs = stage_v(st);
    for (int c = tid; c < BK * CPR; c += NT) {
      const int r = c / CPR;
      const int col = (c % CPR) * 8;
      cp_async16(ks + r * LD + col, kt + r * D + col);
      cp_async16(vs + r * LD + col, vt + r * D + col);
    }
    int* ps = stage_p(st);
    for (int c = tid; c < BK / 4; c += NT)
      cp_async16(ps + 4 * c, pb + t * BK + 4 * c);
  };

  for (int c = tid; c < BQ * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    cp_async16(Qs + r * LD + col, qb + r * D + col);
  }
  int js = next_tile(0);
  if (js < n_sel) load_tile(0, ib[js]);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LD + kk * 16 +
                        (lane / 16) * 8);

  const int row0 = qt * BQ + warp * 16 + gr;       // and row0 + 8
  const int qp0 = qpos[row0];
  const int qp1 = qpos[row0 + 8];
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the row sums
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int st = 0;
  while (js < n_sel) {
    cp_async_wait_all();                 // tile js has landed
    __syncthreads();                     // ... for all; stage st^1 is free
    const int jn = next_tile(js + 1);
    if (jn < n_sel) load_tile(st ^ 1, ib[jn]);
    cp_async_commit();
    const __nv_bfloat16* Ks = stage_k(st);
    const __nv_bfloat16* Vs = stage_v(st);
    const int* Ps = stage_p(st);

#pragma unroll
    for (int kc = 0; kc < BK / KC; ++kc) {
      float sc[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; kk += 2) {
          uint32_t kf[4];
          ldsm_x4(kf, Ks + (kc * KC + j * 8 + lane % 8) * LD + kk * 16 +
                          (lane / 8) * 8);
          mma_bf16(sc[j], qf[kk], kf[0], kf[1]);
          mma_bf16(sc[j], qf[kk + 1], kf[2], kf[3]);
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= scale_log2;
        if (causal) {
          const int2 kp =
              *reinterpret_cast<const int2*>(Ps + kc * KC + j * 8 + tg * 2);
          if (kp.x > qp0) sc[j][0] = kNegInf;
          if (kp.y > qp0) sc[j][1] = kNegInf;
          if (kp.x > qp1) sc[j][2] = kNegInf;
          if (kp.y > qp1) sc[j][3] = kNegInf;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
      // the 4 lanes of a row are lanes 4r..4r+3
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0);
      const float a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        sc[j][0] = exp2f(sc[j][0] - mn0);
        sc[j][1] = exp2f(sc[j][1] - mn0);
        sc[j][2] = exp2f(sc[j][2] - mn1);
        sc[j][3] = exp2f(sc[j][3] - mn1);
        rs0 += sc[j][0] + sc[j][1];
        rs1 += sc[j][2] + sc[j][3];
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }
      // acc += P.V with P = hi + lo: logit n-tiles 2t, 2t+1 are the A
      // fragment of key step t
#pragma unroll
      for (int t = 0; t < KC / 16; ++t) {
        uint32_t ph[4], pl[4];
        split_bf16(sc[2 * t][0], sc[2 * t][1], ph[0], pl[0]);
        split_bf16(sc[2 * t][2], sc[2 * t][3], ph[1], pl[1]);
        split_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1], ph[2], pl[2]);
        split_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, Vs + (kc * KC + t * 16 + lane % 16) * LD +
                                n * 8 + (lane / 16) * 8);
          mma_bf16(o[n], ph, vf[0], vf[1]);
          mma_bf16(o[n], pl, vf[0], vf[1]);
          mma_bf16(o[n + 1], ph, vf[2], vf[3]);
          mma_bf16(o[n + 1], pl, vf[2], vf[3]);
        }
      }
    }
    js = jn;
    st ^= 1;
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob =
      out + (((long long)b * hq + h) * s + (long long)qt * BQ) * D;
  __nv_bfloat16* r0 = ob + (warp * 16 + gr) * D + tg * 2;
  __nv_bfloat16* r1 = r0 + 8 * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(r0 + n * 8) =
        __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(r1 + n * 8) =
        __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int BQ, int BK, int D>
int launch_f32(const float* q, const float* k, const float* v,
               const int* kpos, const int* qpos, const int* idx, float* out,
               int b, int hq, int hkv, int s, int s_k, int n_sel, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BQ, BK, D>();
  static repro::SmemOptin opt;
  auto kern = block_attention_kernel<BQ, BK, D>;
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err == cudaSuccess) err = repro::allow_smem(kern, dev, smem, opt);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s / BQ, hq, b);
  const float scale = 1.f / sqrtf((float)D);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, kpos, qpos, idx, out, hq,
                                         hkv, s, s_k, n_sel, causal, scale);
  return (int)cudaGetLastError();
}

template <int BQ, int BK, int D>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, const int* kpos, const int* qpos,
                const int* idx, __nv_bfloat16* out, int b, int hq, int hkv,
                int s, int s_k, int n_sel, int causal, cudaStream_t stream) {
  using Shape = MmaShape<BQ, BK, D>;
  static repro::SmemOptin opt;
  auto kern = block_attention_mma<BQ, BK, D>;
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err == cudaSuccess) err = repro::allow_smem(kern, dev, Shape::kSmem, opt);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s / BQ, hq, b);
  // logits in log2 units: exp(x) = exp2(x log2 e), folded into the scale
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kern<<<grid, Shape::kThreads, Shape::kSmem, stream>>>(
      q, k, v, kpos, qpos, idx, out, hq, hkv, s, s_k, n_sel, causal,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, S, dh); k/v (B, Hkv, S_k, dh) cluster-sorted; kpos (B, Hkv, S_k)
// i32; qpos (S,) i32; idx (B, Hkv, S/bq, n_sel) i32 key tiles; out
// (B, Hq, S, dh). dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores); q, k, v and out alike. bq == bk in {32, 64, 128}, dh = 64; and
// float32 at bq == bk == 32, dh = 16 (the reduced model configuration of
// the tests and the twin example).
extern "C" int repro_block_attention(const void* q, const void* k,
                                     const void* v, const void* kpos,
                                     const void* qpos, const void* idx,
                                     void* out, int b, int hq, int hkv, int s,
                                     int s_k, int dh, int bq, int bk,
                                     int n_sel, int causal, int dtype,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b == 0 || s == 0) return (int)cudaSuccess;
  if (bq == 32 && bk == 32 && dh == 16 && dtype == 0)
    return launch_f32<32, 32, 16>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)kpos,
        (const int*)qpos, (const int*)idx, (float*)out, b, hq, hkv, s, s_k,
        n_sel, causal, st);
  if (bq != bk || dh != 64 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
#define REPRO_BA_CASE(BT)                                                    \
  if (bq == BT) {                                                            \
    if (dtype == 0)                                                          \
      return launch_f32<BT, BT, 64>(                                         \
          (const float*)q, (const float*)k, (const float*)v,                 \
          (const int*)kpos, (const int*)qpos, (const int*)idx, (float*)out,  \
          b, hq, hkv, s, s_k, n_sel, causal, st);                            \
    return launch_bf16<BT, BT, 64>(                                          \
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,                    \
        (const __nv_bfloat16*)v, (const int*)kpos, (const int*)qpos,         \
        (const int*)idx, (__nv_bfloat16*)out, b, hq, hkv, s, s_k, n_sel,     \
        causal, st);                                                         \
  }
  REPRO_BA_CASE(128)
  REPRO_BA_CASE(64)
  REPRO_BA_CASE(32)
#undef REPRO_BA_CASE
  return (int)cudaErrorInvalidValue;
}
