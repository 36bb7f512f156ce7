// Cluster-block-sparse attention (ClusterKV prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/block_attention.py:
//   block_attention (_kernel)  ->  repro_block_attention
// together with the two vmaps of its wrapper (src/repro/kernels/ops.py
// block_attention: over batch x kv head and over the GQA group), which here
// are the launch grid.
//
// What it computes: for query tile i of query head h of batch member b,
//   an online softmax (m, l, acc) over the n_sel key tiles idx[b, h/g, i, :]
//   of the cluster-sorted k/v of kv head h/g:
//     s = (q_tile . k_tile^T) * 1/sqrt(dh), causally masked elementwise
//         (kpos > qpos -> -1e30, not -inf, as the reference),
//     m' = max(m, rowmax s); alpha = exp(m - m'); p = exp(s - m');
//     l = l alpha + rowsum p; acc = acc alpha + p . v_tile
//   and writes acc / max(l, 1e-30) in q's dtype. Products and sums are
//   float32 on the CUDA cores. A query row whose selected keys are all
//   masked gets uniform weights, exactly as the reference (exp(0) = 1).
//
// What bounds it on this card: operations. Each (query tile, selected key
// tile) pair is 2 * 2 * bq * bk * dh float32 operations against 2 * bk * dh
// bf16 values of k and v read, about 128 operations per byte at bq = 128;
// at Qwen2-0.5B's prefill (14 query heads, 16 of up to 48 key tiles per
// 128-row query tile, dh = 64) a layer at S = 4096 is 30 GFLOP, 0.45 ms at
// 67 TFLOP/s (float32, no tensor cores).
//
// What the design does about it: the TPU kernel walks a sequential grid
// axis over the selected tiles and keeps (m, l, acc) in VMEM scratch. A GPU
// has no sequential grid, so one thread block owns one query tile of one
// query head and loops over its selected tiles itself. 256 threads form a
// 16 x 16 grid; each thread owns an (bq/16) x (bk/16) register tile of the
// logits and an (bq/16) x (dv/16) register tile of the output, rows and
// columns strided by 16. The q tile, the current k and v tiles and the
// probabilities are staged in shared memory as float32: at bq = bk = 128,
// dh = 64 that is 33 KB (q) + 33 KB (k) + 32 KB (v) + 72 KB (p) = 170 KB,
// so the kernel uses dynamic shared memory above 48 KB
// (cudaFuncSetAttribute) and runs one block per SM. Row strides are padded
// (dh + 1 for q and k, bk + 16 for p) so that the 16 x 16 thread grid reads
// and writes without bank conflicts. Row maxima and sums are reduced by
// shuffles over the 16 lanes of a row, which share a half warp. No
// atomics: the result is reproducible run to run.
//
// First version: the loads are not double-buffered and the products do
// not use the tensor cores (wgmma on bf16 would raise the bound 15x).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int BQ, int BK, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                          (size_t)BK * D + (size_t)BQ * (BK + 16)) +
         sizeof(int) * BK;
}

template <typename T, int BQ, int BK, int D>
__global__ void __launch_bounds__(kThreads)
    block_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ kpos,
                           const int* __restrict__ qpos,
                           const int* __restrict__ idx, T* __restrict__ out,
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

  const T* qb = q + (((long long)b * hq + h) * s + (long long)qt * BQ) * D;
  const long long kvbase = ((long long)b * hkv + kvh) * s_k;
  const T* kb = k + kvbase * D;
  const T* vb = v + kvbase * D;
  const int* pb = kpos + kvbase;
  const int* ib = idx + (((long long)b * hkv + kvh) * nqb + qt) * n_sel;

  for (int e = tid; e < BQ * D; e += kThreads)
    Qs[(e / D) * LDQ + e % D] = to_f(qb[e]);

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
    const T* kt = kb + t * BK * D;
    const T* vt = vb + t * BK * D;
    for (int e = tid; e < BK * D; e += kThreads) {
      Ks[(e / D) * LDK + e % D] = to_f(kt[e]);
      Vs[e] = to_f(vt[e]);
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

  T* ob = out + (((long long)b * hq + h) * s + (long long)qt * BQ) * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < RV; ++j)
      store(ob + (ty + 16 * i) * D + tx + 16 * j, o[i][j] * inv);
  }
}

template <typename T, int BQ, int BK, int D>
int launch_one(const T* q, const T* k, const T* v, const int* kpos,
               const int* qpos, const int* idx, T* out, int b, int hq,
               int hkv, int s, int s_k, int n_sel, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BQ, BK, D>();
  auto kern = block_attention_kernel<T, BQ, BK, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s / BQ, hq, b);
  const float scale = 1.f / sqrtf((float)D);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, kpos, qpos, idx, out, hq,
                                         hkv, s, s_k, n_sel, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* kpos,
           const int* qpos, const int* idx, T* out, int b, int hq, int hkv,
           int s, int s_k, int dh, int bq, int bk, int n_sel, int causal,
           cudaStream_t stream) {
  if (b == 0 || s == 0) return (int)cudaSuccess;
  if (bq != bk) return (int)cudaErrorInvalidValue;
#define REPRO_BA_CASE(BT, DT)                                              \
  if (bq == BT && dh == DT)                                                \
    return launch_one<T, BT, BT, DT>(q, k, v, kpos, qpos, idx, out, b, hq, \
                                     hkv, s, s_k, n_sel, causal, stream);
  REPRO_BA_CASE(128, 64)
  REPRO_BA_CASE(64, 64)
  REPRO_BA_CASE(32, 64)
#undef REPRO_BA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hq, S, dh); k/v (B, Hkv, S_k, dh) cluster-sorted; kpos (B, Hkv, S_k)
// i32; qpos (S,) i32; idx (B, Hkv, S/bq, n_sel) i32 key tiles; out
// (B, Hq, S, dh). dtype 0 = float32, 1 = bfloat16 (q, k, v and out alike).
// bq == bk in {32, 64, 128}, dh = 64.
extern "C" int repro_block_attention(const void* q, const void* k,
                                     const void* v, const void* kpos,
                                     const void* qpos, const void* idx,
                                     void* out, int b, int hq, int hkv, int s,
                                     int s_k, int dh, int bq, int bk,
                                     int n_sel, int causal, int dtype,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch((const float*)q, (const float*)k, (const float*)v,
                  (const int*)kpos, (const int*)qpos, (const int*)idx,
                  (float*)out, b, hq, hkv, s, s_k, dh, bq, bk, n_sel, causal,
                  st);
  if (dtype == 1)
    return launch((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                  (const __nv_bfloat16*)v, (const int*)kpos,
                  (const int*)qpos, (const int*)idx, (__nv_bfloat16*)out, b,
                  hq, hkv, s, s_k, dh, bq, bk, n_sel, causal, st);
  return (int)cudaErrorInvalidValue;
}
