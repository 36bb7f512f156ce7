// Single-token cluster decode attention for Hopper (sm_90a), split over
// the card's SMs.
//
// Replaces the TPU kernel of src/repro/kernels/decode_attend.py:
//   decode_attend_fused (_kernel)  ->  repro_decode_attend
//
// What it computes, for each (batch member b, kv head h):
//   1. scores[t] = sum_d cent[t, d] * mean_g(q)[d] over the nkb key tiles;
//   2. plan mode only: tiles with no position <= qpos (holes, INT32_MAX,
//      and future entries) score -1e30, and a live tile whose largest live
//      position is >= qpos - window gets +1e4 (the recency boost);
//   3. the n_sel best tiles in descending order, NaN first, ties to the
//      lowest tile index (lax.top_k's order: n_sel rounds of first-argmax
//      with mask-out);
//   4. the selected (bk, dh|dv) k/v tiles read straight from the caches in
//      device memory, plus, in plan mode with has_self, the current token's
//      own k/v as one always-visible extra column at qpos;
//   5. one guarded softmax over all selected columns (masked_softmax:
//      entries with pos > qpos weigh exactly 0, and a selection with no
//      live entry gives exact zeros) and the (g, dv) output.
//
// What bounds it on this card: bytes. Every selected k/v entry is read
// once and used for g (= 7 at Qwen2-0.5B) multiply-adds; with the
// positions of the whole cache (plan mode) and the centroids, one layer's
// tick at 4 slots x 2 kv heads x 16 tiles of 128 x 64 bf16 moves about
// 4.5 MB: 1.3 us at 3.35 TB/s. At that size the launches' own latency is
// what the kernel can hope to reach.
//
// What the design does about it: the Pallas kernel DMAs all selected tiles
// into VMEM and takes one softmax over the concatenated n_sel*bk columns.
// One block per (member, kv head) would fill only B * Hkv SMs (8 of 132 at
// 4 slots x 2 kv heads), so the work is split flash-decoding style into
// three launches on the caller's stream:
//   (a) decode_select_kernel, one block per (member, kv head): the group
//       mean in float32, the centroid scores (one warp per tile) with the
//       plan-mode masks, then every tile's rank under (score descending,
//       index ascending) at once: rank r < n_sel is written to sel[r],
//       which is exactly what the argmax rounds pick;
//   (b) decode_part_kernel, one block per (member, kv head, selected tile)
//       plus one for the self column: the tile staged in shared memory as
//       float32 (16-byte loads), g x bk logits, and the part's max m_i
//       (masked columns at -1e30, as the reference's flat max), live sum
//       l_i = sum exp(s - m_i) and (g, dv) accumulator acc_i;
//   (c) decode_combine_kernel, one block per (member, kv head): in the
//       fixed order i = 0, 1, ...: M = max m_i, L = sum l_i e^(m_i - M),
//       out = sum acc_i e^(m_i - M) / max(L, 1e-30). Masked columns add
//       exact zeros, so a selection with no live entry gives exact zeros.
// At the serving shape that is 128 blocks of (b) instead of 8 (136 with
// the self column). No atomics: the result is bit-equal run to run. The
// M = 2 row padding and the single flat softmax of the Pallas kernel exist
// only for bit parity with XLA:CPU and are not kept.
//
// At that size the call costs the host more than the card, so the host's
// share is kept small: q and the centroids are read in the caller's dtype
// and the output is written in q's (no casts around the call), the
// partials and the selection share one scratch buffer, and the dynamic
// shared memory opt-in is set once per kernel and device (smem.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// element i of a float32 (bf16 == 0) or bfloat16 (bf16 == 1) array: q and
// the centroids come in the caller's dtype, so the wrapper casts nothing
__device__ __forceinline__ float load_f(const void* p, long long i,
                                        int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Does tile u (score y) rank before tile t (score x)? A total order:
// scores descending with NaN above +inf and two NaNs equal, ties to the
// lowest index: the order of the plain path's stable descending sort
// (core/clusterkv.py topk_stable) and of the reference's lax.top_k, which
// differs only in ordering -0 below +0 and a NaN with its sign bit set
// last. Every rank below n_sel is taken by exactly one tile, and a NaN
// tile is selected first, as in the reference.
__device__ __forceinline__ bool ranks_above(float y, int u, float x, int t) {
  const bool yn = isnan(y), xn = isnan(x);
  if (yn != xn) return yn;
  return (!yn && y > x) || ((yn || y == x) && u < t);
}

// (a) selection: sel (B, Hkv, n_sel) i32
__global__ void __launch_bounds__(kThreads)
    decode_select_kernel(const void* __restrict__ q,
                         const int* __restrict__ pos,
                         const void* __restrict__ cent,
                         const int* __restrict__ qpos, int* __restrict__ sel,
                         int hkv, int g, int s, int dh, int bk, int n_sel,
                         int plan_mode, int window, int q_bf16,
                         int cent_bf16) {
  extern __shared__ float smem[];
  const int nkb = s / bk;
  float* qm = smem;                        // dh
  float* scores = qm + dh;                 // nkb

  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = kThreads / 32;
  const int qp = qpos[b];
  const long long cache = (long long)bh * s;

  const long long qb = (long long)bh * g * dh;
  for (int d = tid; d < dh; d += kThreads) {
    float sum = 0.f;
    for (int gi = 0; gi < g; ++gi)
      sum += load_f(q, qb + gi * dh + d, q_bf16);
    qm[d] = sum / (float)g;
  }
  __syncthreads();

  const long long cb = (long long)bh * nkb * dh;
  for (int t = warp; t < nkb; t += nwarps) {
    float sc = 0.f;
    for (int d = lane; d < dh; d += 32)
      sc = fmaf(load_f(cent, cb + t * dh + d, cent_bf16), qm[d], sc);
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
    // an unmasked NaN score stays NaN (the +1e4 boost keeps it NaN) and
    // is ranked by ranks_above below
    if (lane == 0) scores[t] = sc;
  }
  __syncthreads();

  for (int t = tid; t < nkb; t += kThreads) {
    const float x = scores[t];
    int rank = 0;
    for (int u = 0; u < nkb; ++u) rank += ranks_above(scores[u], u, x, t);
    if (rank < n_sel) sel[(long long)bh * n_sel + rank] = t;
  }
}

// rows x cols values of src (row-major, contiguous) into dst as float32
// with row stride ld: 16-byte loads where the rows allow them
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const T* __restrict__ src,
                                           int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  if (cols % V == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int cpr = cols / V;
    for (int c = threadIdx.x; c < rows * cpr; c += kThreads) {
      const int r = c / cpr;
      const int col = (c % cpr) * V;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (long long)r * cols + col);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) dst[r * ld + col + i] = to_f(e[i]);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads)
      dst[(e / cols) * ld + e % cols] = to_f(src[e]);
  }
}

size_t part_smem_bytes(int g, int dh, int dv, int bk) {
  return sizeof(float) * ((size_t)g * dh + (size_t)bk * (dh + 1) +
                          (size_t)bk * dv + (size_t)g * bk) +
         sizeof(int) * (size_t)bk;
}

// floats per (member, kv head, part, query row) record: m, l, acc[dv]
__device__ __forceinline__ int record(int dv) { return dv + 2; }

// (b) one part: selected tile j of (member, kv head) bh, or the self
// column at j == n_sel
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_part_kernel(const void* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ pos,
                       const int* __restrict__ qpos,
                       const float* __restrict__ kself,
                       const float* __restrict__ vself,
                       const int* __restrict__ sel, float* __restrict__ part,
                       int hkv, int g, int s, int dh, int dv, int bk,
                       int n_sel, int nparts, int q_bf16) {
  extern __shared__ float smem[];
  const int ldk = dh + 1;
  float* qs = smem;                        // g x dh
  float* Ks = qs + g * dh;                 // bk x ldk
  float* Vs = Ks + bk * ldk;               // bk x dv
  float* L = Vs + bk * dv;                 // g x bk logits, then weights
  int* ps = reinterpret_cast<int*>(L + g * bk);   // bk

  const int j = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / hkv;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = kThreads / 32;
  const int qp = qpos[b];

  for (int e = tid; e < g * dh; e += kThreads)
    qs[e] = load_f(q, (long long)bh * g * dh + e, q_bf16);
  int ncol;
  if (j < n_sel) {
    ncol = bk;
    const long long row0 =
        (long long)bh * s + (long long)sel[(long long)bh * n_sel + j] * bk;
    stage_rows(Ks, ldk, k + row0 * dh, bk, dh);
    stage_rows(Vs, dv, v + row0 * dv, bk, dv);
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

  const float scale = sqrtf((float)dh);
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

  float* pb = part + ((long long)bh * nparts + j) * g * record(dv);
  for (int gi = warp; gi < g; gi += nwarps) {
    float mx = kNegInf;
    for (int c = lane; c < ncol; c += 32) mx = fmaxf(mx, L[gi * bk + c]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int c = lane; c < ncol; c += 32) {
      const float p = (ps[c] <= qp) ? expf(L[gi * bk + c] - mx) : 0.f;
      L[gi * bk + c] = p;
      sum += p;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      pb[gi * record(dv)] = mx;
      pb[gi * record(dv) + 1] = sum;
    }
  }
  __syncthreads();

  for (int e = tid; e < g * dv; e += kThreads) {
    const int gi = e / dv;
    const int c2 = e % dv;
    const float* w = L + gi * bk;
    float acc = 0.f;
    for (int c = 0; c < ncol; ++c) acc = fmaf(w[c], Vs[c * dv + c2], acc);
    pb[gi * record(dv) + 2 + c2] = acc;
  }
}

// (c) the fixed-order combine of one (member, kv head)'s parts, written in
// q's dtype (rounded to nearest even in bf16)
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ part,
                          void* __restrict__ out, int g, int dv, int nparts,
                          int out_bf16) {
  extern __shared__ float smem[];
  float* w = smem;                         // nparts x g: e^(m_i - M)
  float* Ls = w + nparts * g;              // g

  const int bh = blockIdx.x;
  const float* pb = part + (long long)bh * nparts * g * record(dv);
  for (int gi = threadIdx.x; gi < g; gi += kThreads) {
    float M = kNegInf;
    for (int i = 0; i < nparts; ++i)
      M = fmaxf(M, pb[((long long)i * g + gi) * record(dv)]);
    float sum = 0.f;
    for (int i = 0; i < nparts; ++i) {
      const float* r = pb + ((long long)i * g + gi) * record(dv);
      const float wi = expf(r[0] - M);
      w[i * g + gi] = wi;
      sum = fmaf(r[1], wi, sum);
    }
    Ls[gi] = sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < g * dv; e += kThreads) {
    const int gi = e / dv;
    const int c2 = e % dv;
    float acc = 0.f;
    for (int i = 0; i < nparts; ++i)
      acc = fmaf(pb[((long long)i * g + gi) * record(dv) + 2 + c2],
                 w[i * g + gi], acc);
    const float o = acc / fmaxf(Ls[gi], 1e-30f);
    const long long i = (long long)bh * g * dv + e;
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(out)[i] = o;
  }
}

size_t part_floats(int bh, int nparts, int g, int dv) {
  return (size_t)bh * nparts * g * (dv + 2);
}

template <typename T>
int launch(const void* q, const T* k, const T* v, const int* pos,
           const void* cent, const int* qpos, const float* kself,
           const float* vself, void* out, int* sel_out, float* scratch,
           int b, int hkv, int g, int s, int dh, int dv, int bk, int n_sel,
           int plan_mode, int has_self, int window, int q_bf16,
           int cent_bf16, cudaStream_t stream) {
  if (b == 0 || hkv == 0) return (int)cudaSuccess;
  if (bk <= 0 || s % bk || s / bk < n_sel || n_sel <= 0 || g <= 0 ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int nparts = n_sel + ((plan_mode && has_self) ? 1 : 0);
  const int bh = b * hkv;
  float* part = scratch;
  int* sel = sel_out != nullptr
                 ? sel_out
                 : reinterpret_cast<int*>(scratch +
                                          part_floats(bh, nparts, g, dv));

  static repro::SmemOptin opt_sel, opt_part, opt_comb;
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem_sel = sizeof(float) * ((size_t)dh + s / bk);
  err = repro::allow_smem(decode_select_kernel, dev, smem_sel, opt_sel);
  if (err != cudaSuccess) return (int)err;
  decode_select_kernel<<<bh, kThreads, smem_sel, stream>>>(
      q, pos, cent, qpos, sel, hkv, g, s, dh, bk, n_sel, plan_mode, window,
      q_bf16, cent_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_part = part_smem_bytes(g, dh, dv, bk);
  err = repro::allow_smem(decode_part_kernel<T>, dev, smem_part, opt_part);
  if (err != cudaSuccess) return (int)err;
  decode_part_kernel<T><<<dim3(nparts, bh), kThreads, smem_part, stream>>>(
      q, k, v, pos, qpos, kself, vself, sel, part, hkv, g, s, dh, dv, bk,
      n_sel, nparts, q_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_comb = sizeof(float) * ((size_t)nparts * g + g);
  err = repro::allow_smem(decode_combine_kernel, dev, smem_comb, opt_comb);
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<bh, kThreads, smem_comb, stream>>>(
      part, out, g, dv, nparts, q_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// One scratch buffer the caller allocates (the kernels allocate nothing):
// B * Hkv * (n_sel + has_self) * g * (dv + 2) f32 partials, then, unless
// sel_out is given, B * Hkv * n_sel i32 for the selection. sel_out
// (B, Hkv, n_sel) i32, or null, receives the selection.
//
// q (B, Hkv, g, dh) in `qdtype`; k/v (B, Hkv, S, dh|dv) in `dtype`; pos
// (B, Hkv, S) i32; cent (B, Hkv, S/bk, dh) in `cdtype`; qpos (B,) i32;
// kself/vself (B, Hkv, dh|dv) f32 (read only in plan mode with has_self);
// out (B, Hkv, g, dv) in `qdtype`. Each dtype is 0 = float32 or
// 1 = bfloat16.
extern "C" int repro_decode_attend(const void* q, const void* k,
                                   const void* v, const void* pos,
                                   const void* cent, const void* qpos,
                                   const void* kself, const void* vself,
                                   void* out, void* sel_out, void* scratch,
                                   int b, int hkv, int g, int s, int dh,
                                   int dv, int bk, int n_sel, int plan_mode,
                                   int has_self, int window, int dtype,
                                   int qdtype, int cdtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((qdtype != 0 && qdtype != 1) || (cdtype != 0 && cdtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch(q, (const float*)k, (const float*)v, (const int*)pos,
                  cent, (const int*)qpos, (const float*)kself,
                  (const float*)vself, out, (int*)sel_out, (float*)scratch,
                  b, hkv, g, s, dh, dv, bk, n_sel, plan_mode, has_self,
                  window, qdtype, cdtype, st);
  if (dtype == 1)
    return launch(q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
                  (const int*)pos, cent, (const int*)qpos,
                  (const float*)kself, (const float*)vself, out,
                  (int*)sel_out, (float*)scratch, b, hkv, g, s, dh, dv, bk,
                  n_sel, plan_mode, has_self, window, qdtype, cdtype, st);
  return (int)cudaErrorInvalidValue;
}
