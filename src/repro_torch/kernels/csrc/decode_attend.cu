// Fused single-token cluster decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/decode_attend.py:
//   decode_attend_fused (_kernel)  ->  repro_decode_attend
//
// What it computes, for one (batch member b, kv head h) per thread block:
//   1. scores[t] = sum_d cent[t, d] * mean_g(q)[d] over the nkb key tiles;
//   2. plan mode only: tiles with no position <= qpos (holes, INT32_MAX,
//      and future entries) score -1e30, and a live tile whose largest live
//      position is >= qpos - window gets +1e4 (the recency boost);
//   3. n_sel rounds of first-argmax with mask-out: descending, ties to the
//      lowest tile index (lax.top_k's order);
//   4. the selected (bk, dh|dv) k/v tiles are read straight from the caches
//      in device memory, plus, in plan mode with has_self, the current
//      token's own k/v as one always-visible extra column at qpos;
//   5. one guarded softmax over all selected columns (masked_softmax:
//      entries with pos > qpos weigh exactly 0, and a selection with no
//      live entry gives exact zeros) and the (g, dv) output.
//
// What bounds it on this card: bytes. Every selected k/v entry is read
// once and used for g (= 7 at Qwen2-0.5B) multiply-adds; with the
// positions of the whole cache (plan mode) and the centroids, one layer's
// tick at 4 slots x 2 kv heads x 16 tiles of 128 x 64 bf16 moves about
// 4.5 MB: 1.3 us at 3.35 TB/s.
//
// What the design does about it: the Pallas kernel DMAs all selected tiles
// into VMEM and takes one softmax over the concatenated n_sel*bk columns.
// At Qwen's shapes those tiles are 16 x 128 x 64 x 2 x 2 bytes = 512 KB in
// bf16, which does not fit the 227 KB of shared memory a block may use, and
// the covering-budget check of the serving path selects 64 tiles (2 MB).
// So the block streams the selected tiles one at a time through shared
// memory (k as float32 with a padded row stride, v as float32, their
// positions) and keeps an online softmax per query row: the running max
// over all columns (masked ones at -1e30, as the reference's flat max), a
// running sum of exp over the live columns and a float32 accumulator per
// output in registers, rescaled by exp(m_old - m_new) per tile. Masked
// columns add exact zeros, so the empty-selection guard holds. The M = 2
// row padding and the single flat softmax of the Pallas kernel exist only
// for bit parity with XLA:CPU and are not kept. Selection runs in one warp
// (lane-strided max with index tie-break, then shuffles). One block per
// (member, kv head) fills only B * Hkv SMs (8 of 132 at 4 slots x 2 kv
// heads); splitting the tiles over blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 4;                 // outputs per thread: g*dv <= 1024
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attend_kernel(const float* __restrict__ q,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const int* __restrict__ pos,
                         const float* __restrict__ cent,
                         const int* __restrict__ qpos,
                         const float* __restrict__ kself,
                         const float* __restrict__ vself,
                         float* __restrict__ out, int* __restrict__ sel_out,
                         int hkv, int g, int s, int dh, int dv, int bk,
                         int n_sel, int plan_mode, int has_self, int window) {
  extern __shared__ float smem[];
  const int ldk = dh + 1;
  const int nkb = s / bk;
  float* qs = smem;                        // g x dh
  float* qm = qs + g * dh;                 // dh
  float* scores = qm + dh;                 // nkb
  float* Ks = scores + nkb;                // bk x ldk
  float* Vs = Ks + bk * ldk;               // bk x dv
  float* L = Vs + bk * dv;                 // g x bk logits, then weights
  float* m_s = L + g * bk;                 // g
  float* l_s = m_s + g;                    // g
  float* a_s = l_s + g;                    // g
  int* sel = reinterpret_cast<int*>(a_s + g);      // n_sel
  int* ps = sel + n_sel;                           // bk

  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = kThreads / 32;
  const int qp = qpos[b];
  const long long cache = (long long)bh * s;

  for (int e = tid; e < g * dh; e += kThreads) qs[e] = q[(long long)bh * g * dh + e];
  __syncthreads();
  for (int d = tid; d < dh; d += kThreads) {
    float sum = 0.f;
    for (int gi = 0; gi < g; ++gi) sum += qs[gi * dh + d];
    qm[d] = sum / (float)g;
  }
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // 1 + 2: centroid scores (one warp per tile), plan-mode masks
  const float* cb = cent + (long long)bh * nkb * dh;
  for (int t = warp; t < nkb; t += nwarps) {
    float sc = 0.f;
    for (int d = lane; d < dh; d += 32) sc = fmaf(cb[t * dh + d], qm[d], sc);
    for (int off = 16; off > 0; off >>= 1)
      sc += __shfl_xor_sync(0xffffffffu, sc, off);
    if (plan_mode) {
      int rec = -1;
      for (int j = lane; j < bk; j += 32) {
        const int p = pos[cache + (long long)t * bk + j];
        if (p <= qp) rec = max(rec, p);
      }
      for (int off = 16; off > 0; off >>= 1)
        rec = max(rec, __shfl_xor_sync(0xffffffffu, rec, off));
      // a live position is >= 0, so rec < 0 means no live entry
      if (rec < 0)
        sc = kNegInf;
      else if (rec >= qp - window)
        sc = sc + 1e4f;
    }
    if (lane == 0) scores[t] = sc;
  }
  __syncthreads();

  // 3: n_sel rounds of first-argmax with mask-out (ties to the lowest index)
  if (warp == 0) {
    for (int r = 0; r < n_sel; ++r) {
      float best = -INFINITY;
      int bi = nkb;
      for (int t = lane; t < nkb; t += 32) {
        const float x = scores[t];
        if (x > best || (x == best && t < bi)) {
          best = x;
          bi = t;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      if (bi >= nkb) bi = nkb - 1;          // only when every score is NaN
      if (lane == 0) {
        sel[r] = bi;
        scores[bi] = -INFINITY;
        if (sel_out) sel_out[(long long)bh * n_sel + r] = bi;
      }
      __syncwarp();
    }
  }

  // 4 + 5: stream the selected tiles (and the self column), online softmax
  const float scale = sqrtf((float)dh);
  float o[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) o[r] = 0.f;
  const int n_out = g * dv;
  const int steps = n_sel + ((plan_mode && has_self) ? 1 : 0);
  for (int js = 0; js < steps; ++js) {
    __syncthreads();                       // selection done / tile consumed
    int ncol;
    if (js < n_sel) {
      ncol = bk;
      const long long row0 = cache + (long long)sel[js] * bk;
      const T* kt = k + row0 * dh;
      const T* vt = v + row0 * dv;
      for (int e = tid; e < bk * dh; e += kThreads)
        Ks[(e / dh) * ldk + e % dh] = to_f(kt[e]);
      for (int e = tid; e < bk * dv; e += kThreads) Vs[e] = to_f(vt[e]);
      for (int e = tid; e < bk; e += kThreads) ps[e] = pos[row0 + e];
    } else {
      ncol = 1;
      for (int e = tid; e < dh; e += kThreads)
        Ks[e] = kself[(long long)bh * dh + e];
      for (int e = tid; e < dv; e += kThreads)
        Vs[e] = vself[(long long)bh * dv + e];
      if (tid == 0) ps[0] = qp;
    }
    __syncthreads();
    for (int e = tid; e < g * ncol; e += kThreads) {
      const int gi = e / ncol;
      const int c = e % ncol;
      const float* qr = qs + gi * dh;
      const float* kr = Ks + c * ldk;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
      L[gi * bk + c] = (ps[c] <= qp) ? dot / scale : kNegInf;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += nwarps) {
      float mx = kNegInf;
      for (int c = lane; c < ncol; c += 32) mx = fmaxf(mx, L[gi * bk + c]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < ncol; c += 32) {
        const float p =
            (ps[c] <= qp) ? expf(L[gi * bk + c] - m_new) : 0.f;
        L[gi * bk + c] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int e = tid + r * kThreads;
      if (e < n_out) {
        const int gi = e / dv;
        const int c2 = e % dv;
        const float* w = L + gi * bk;
        float acc = o[r] * a_s[gi];
        for (int c = 0; c < ncol; ++c) acc = fmaf(w[c], Vs[c * dv + c2], acc);
        o[r] = acc;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int e = tid + r * kThreads;
    if (e < n_out)
      out[(long long)bh * n_out + e] = o[r] / fmaxf(l_s[e / dv], 1e-30f);
  }
}

size_t smem_bytes(int g, int dh, int dv, int bk, int nkb, int n_sel) {
  return sizeof(float) * ((size_t)g * dh + dh + nkb + (size_t)bk * (dh + 1) +
                          (size_t)bk * dv + (size_t)g * bk + 3 * (size_t)g) +
         sizeof(int) * ((size_t)n_sel + bk);
}

template <typename T>
int launch(const float* q, const T* k, const T* v, const int* pos,
           const float* cent, const int* qpos, const float* kself,
           const float* vself, float* out, int* sel_out, int b, int hkv,
           int g, int s, int dh, int dv, int bk, int n_sel, int plan_mode,
           int has_self, int window, cudaStream_t stream) {
  if (b == 0 || hkv == 0) return (int)cudaSuccess;
  if (bk <= 0 || s % bk || s / bk < n_sel || n_sel <= 0 ||
      g * dv > kThreads * kMaxOut)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(g, dh, dv, bk, s / bk, n_sel);
  auto kern = decode_attend_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<b * hkv, kThreads, smem, stream>>>(
      q, k, v, pos, cent, qpos, kself, vself, out, sel_out, hkv, g, s, dh,
      dv, bk, n_sel, plan_mode, has_self, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hkv, g, dh) f32; k/v (B, Hkv, S, dh|dv) in `dtype` (0 = float32,
// 1 = bfloat16); pos (B, Hkv, S) i32; cent (B, Hkv, S/bk, dh) f32; qpos (B,)
// i32; kself/vself (B, Hkv, dh|dv) f32 (read only in plan mode with
// has_self); out (B, Hkv, g, dv) f32; sel_out (B, Hkv, n_sel) i32 or null.
extern "C" int repro_decode_attend(const void* q, const void* k,
                                   const void* v, const void* pos,
                                   const void* cent, const void* qpos,
                                   const void* kself, const void* vself,
                                   void* out, void* sel_out, int b, int hkv,
                                   int g, int s, int dh, int dv, int bk,
                                   int n_sel, int plan_mode, int has_self,
                                   int window, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch((const float*)q, (const float*)k, (const float*)v,
                  (const int*)pos, (const float*)cent, (const int*)qpos,
                  (const float*)kself, (const float*)vself, (float*)out,
                  (int*)sel_out, b, hkv, g, s, dh, dv, bk, n_sel, plan_mode,
                  has_self, window, st);
  if (dtype == 1)
    return launch((const float*)q, (const __nv_bfloat16*)k,
                  (const __nv_bfloat16*)v, (const int*)pos,
                  (const float*)cent, (const int*)qpos, (const float*)kself,
                  (const float*)vself, (float*)out, (int*)sel_out, b, hkv, g,
                  s, dh, dv, bk, n_sel, plan_mode, has_self, window, st);
  return (int)cudaErrorInvalidValue;
}
