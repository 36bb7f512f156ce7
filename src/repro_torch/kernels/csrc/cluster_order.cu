// ClusterKV's key ordering for Hopper (sm_90a): each key set's top-d
// principal embedding and its Morton codes in one launch.
//
// Replaces no TPU kernel. The reference orders keys with XLA ops
// (src/repro/core/clusterkv.py cluster_perm: _pca_project, then
// core/hierarchy.morton_codes). The port's plain version is
// core/embedding.pca_project_det followed by core/hierarchy.morton_codes,
// whose batched torch.linalg.qr the card runs as one small factorization
// per matrix, driven from the host: that, not the arithmetic, set the
// ordering's time.
//
// What it computes, for each key set X (S x dh: one (batch, head)):
//   m = the column mean, Xc = X - m in float32 (keys converted exactly);
//   q = I[:, :3]; `iters` times: z = Xc^T (Xc q), q = the Q factor of z's
//   Householder QR, applied as LAPACK's geqr2 and org2r apply it, so Q's
//   column signs are LAPACK's and cuSOLVER's (a mirrored axis would
//   change which keys share a cluster tile); the first d of q's columns
//   are the axes (they do not depend on the columns after them);
//   y = Xc q[:, :d], lo / hi = y's least and largest value per axis, and
//   code = the Morton interleave of
//   trunc(clamp((y - lo) / max(hi - lo, 1e-30) * (2^b - 1), 0, 2^b - 1))
//   in morton_codes_box's float32 operation order; int64 (S,) per set.
// Sums run in another order than the plain version's, never in TF32 or
// with a bf16 product.
//
// What bounds it on this card: the keys are read once (S dh x 2 bytes in
// bf16: 62.9 MB a call at the training shapes, 18.8 us at 3.35 TB/s) and
// the work is (2 iters + 1) x 2 S dh x 3 float32 operations on the CUDA
// cores (1.7 GFLOP, about 25 us at 67 TFLOP/s).
//
// What the design does about it. One thread-block cluster per set; each of
// its c blocks (up to 8) owns a slice of the set's rows. A slice that fits
// is held in shared memory (resident: read from device memory once); a
// larger one is streamed through shared memory in chunks on every pass. A
// pass over a tile of rows is thread-per-row for w = Xc q (a row's 16-byte
// units against q broadcast from shared memory, the rows padded so the
// loads do not conflict), then thread-per-column-pair for Xc^T w over the
// same tile. The c blocks' partial z (and the mean, and the box) are
// summed over distributed shared memory in rank order, so every block
// holds the same z bit for bit, factors it (one warp, dh x 3) and walks
// on with the same q: no atomics, no second launch, and the
// codes are the same from run to run. The layout (c, slice and chunk
// rows) follows the shape and the card (choose(), below):
// repro_cluster_codes takes it, and repro_cluster_layout reports it.

#include <cooperative_groups.h>
#include <algorithm>
#include <atomic>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
// a set is split over more blocks to fill the card only while each block
// keeps at least this many rows
constexpr int kMinRows = 128;
constexpr unsigned kFull = 0xffffffffu;
// the embedding's columns computed for every d <= 3 (one instantiation
// for all d: the columns after d cost a few FMAs)
constexpr int kD = 3;

struct Params {
  const unsigned char* k;
  long long* out;
  float* y;  // (n_sets, s, d) float32 projections, or null
  long long s_outer, s_inner, s_row;  // strides in elements
  int n_inner, s, dh, d, bits, iters, rows_per_cta, chunk_rows, vec;
};

// Keys as stored: float32, or bfloat16 as its 16 raw bits (converted to
// float32 exactly by a shift).
template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int kPerUnit = 4;
  // columns c, c + 1 (c even)
  __device__ static float2 get2(const unsigned char* row, int c) {
    return *reinterpret_cast<const float2*>(row + 4 * c);
  }
  __device__ static void unpack(uint4 u, float* x) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
};

template <>
struct Elt<uint16_t> {
  static constexpr int kPerUnit = 8;
  __device__ static float2 get2(const unsigned char* row, int c) {
    const unsigned w = *reinterpret_cast<const unsigned*>(row + 2 * c);
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
  __device__ static void unpack(uint4 u, float* x) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Shared memory: the tile's w (a float4 a row; between passes the group
// partials), two exchange buffers, q, z, the mean, the box; then the rows,
// with the columns dh..DHP-1 zero. Row r starts `row(r)` bytes in: its
// kUnits 16-byte units and one spare, an odd number of units, so that 8
// neighbouring rows start on 8 different 16-byte bank groups and the
// thread-per-row loads do not conflict.
template <typename T, int DHP>
struct Layout {
  static constexpr int kUnits = DHP * (int)sizeof(T) / 16;
  __host__ __device__ static constexpr int row(int r) {
    return 16 * r * (kUnits | 1);
  }
  // the column pass: a thread sums two columns over every kGroups-th row
  static constexpr int kPairs = DHP / 2;
  static constexpr int kGroups = kThreads / kPairs;
  static constexpr int kRed = DHP * kD;
  static constexpr int kTile = kThreads * 16 > kGroups * kRed * 4
                                   ? kThreads * 16
                                   : kGroups * kRed * 4;
  static constexpr int kFixed =
      kTile + (2 * kRed + 2 * DHP * kD + DHP + 16) * 4;
};

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane adds the same two operands at each step, so
  // every lane ends with the same bits
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Q of the Householder QR of z (DHP x kD, row-major [row * kD + col], rows
// dh..DHP-1 zero) into q, by one warp: LAPACK's geqr2 (dlarfg, dlarf) and
// org2r. Lane l holds rows l + 32 i. Each column is first scaled by a
// power of two (exact, and Q does not change under a positive column
// scale), so no sum of squares overflows or underflows.
template <int DHP>
__device__ void householder_q(const float* z, float* q) {
  constexpr int kRpl = DHP / 32;
  const int lane = threadIdx.x & 31;
  float a[kRpl][kD];
#pragma unroll
  for (int i = 0; i < kRpl; ++i)
#pragma unroll
    for (int j = 0; j < kD; ++j) a[i][j] = z[(lane + 32 * i) * kD + j];
#pragma unroll
  for (int j = 0; j < kD; ++j) {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < kRpl; ++i) m = fmaxf(m, fabsf(a[i][j]));
    m = warp_max(m);
    if (m > 0.f && m <= 3.0e38f) {
      int e;
      frexpf(m, &e);
      const float sc = ldexpf(1.f, -e);
#pragma unroll
      for (int i = 0; i < kRpl; ++i) a[i][j] *= sc;
    }
  }
  float tau[kD];
#pragma unroll
  for (int j = 0; j < kD; ++j) {  // geqr2: H_j from column j below row j
    const float alpha = __shfl_sync(kFull, a[0][j], j);  // row j: lane j
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kRpl; ++i)
      if (lane + 32 * i > j) ss = fmaf(a[i][j], a[i][j], ss);
    const float xnorm = sqrtf(warp_sum(ss));
    float beta = alpha, t = 0.f;
    if (xnorm != 0.f) {  // dlarfg; xnorm == 0 leaves H_j = I
      beta = hypotf(alpha, xnorm);
      if (alpha >= 0.f) beta = -beta;
      t = (beta - alpha) / beta;
      const float sc = 1.f / (alpha - beta);
#pragma unroll
      for (int i = 0; i < kRpl; ++i)
        if (lane + 32 * i > j) a[i][j] *= sc;
    }
    tau[j] = t;
#pragma unroll
    for (int k = j + 1; k < kD; ++k) {  // dlarf on the columns right of j
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kRpl; ++i)
        if (lane + 32 * i > j) s = fmaf(a[i][j], a[i][k], s);
      s = warp_sum(s) + __shfl_sync(kFull, a[0][k], j);  // v_j = 1
      const float f = -t * s;
      if (lane == j) a[0][k] += f;
#pragma unroll
      for (int i = 0; i < kRpl; ++i)
        if (lane + 32 * i > j) a[i][k] = fmaf(f, a[i][j], a[i][k]);
    }
    if (lane == j) a[0][j] = beta;
  }
#pragma unroll
  for (int i0 = kD - 1; i0 >= 0; --i0) {  // org2r: Q = H_0 ... H_{kD-1} I
#pragma unroll
    for (int k = i0 + 1; k < kD; ++k) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kRpl; ++i)
        if (lane + 32 * i > i0) s = fmaf(a[i][i0], a[i][k], s);
      s = warp_sum(s) + __shfl_sync(kFull, a[0][k], i0);  // v_i0 = 1
      const float f = -tau[i0] * s;
      if (lane == i0) a[0][k] += f;
#pragma unroll
      for (int i = 0; i < kRpl; ++i)
        if (lane + 32 * i > i0) a[i][k] = fmaf(f, a[i][i0], a[i][k]);
    }
#pragma unroll
    for (int i = 0; i < kRpl; ++i) {
      const int r = lane + 32 * i;
      if (r > i0) a[i][i0] *= -tau[i0];
      else if (r == i0) a[i][i0] = 1.f - tau[i0];
      else a[i][i0] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < kRpl; ++i)
#pragma unroll
    for (int j = 0; j < kD; ++j) q[(lane + 32 * i) * kD + j] = a[i][j];
}

__device__ __forceinline__ long long part1by1(long long v) {
  v &= 0xFFFF;
  v = (v | (v << 8)) & 0x00FF00FF;
  v = (v | (v << 4)) & 0x0F0F0F0F;
  v = (v | (v << 2)) & 0x33333333;
  v = (v | (v << 1)) & 0x55555555;
  return v;
}

__device__ __forceinline__ long long part1by2(long long v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

__device__ __forceinline__ long long interleave(const long long* c, int d) {
  if (d == 1) return c[0];
  if (d == 2) return part1by1(c[0]) | (part1by1(c[1]) << 1);
  return part1by2(c[0]) | (part1by2(c[1]) << 1) | (part1by2(c[2]) << 2);
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads, 1)
    cluster_codes_kernel(const Params p) {
  using L = Layout<T, DHP>;
  using E = Elt<T>;
  constexpr int kPerUnit = E::kPerUnit;
  constexpr int kUnits = L::kUnits;
  constexpr int kPairs = L::kPairs;
  constexpr int kGroups = L::kGroups;
  constexpr int kRed = L::kRed;
  const float kInf = __int_as_float(0x7f800000);

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int crank = (int)cluster.block_rank();
  const int set = blockIdx.x / csize;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float4* wt = reinterpret_cast<float4*>(smem);
  float* part = reinterpret_cast<float*>(smem);  // wt between passes
  float* red = reinterpret_cast<float*>(smem + L::kTile);
  float* qs = red + 2 * kRed;
  float* zs = qs + DHP * kD;
  float* mean = zs + DHP * kD;
  float* box = mean + DHP;  // lo[kD], then -hi[kD]
  unsigned char* xs = smem + L::kFixed;

  const unsigned char* base =
      p.k + ((long long)(set / p.n_inner) * p.s_outer +
             (long long)(set % p.n_inner) * p.s_inner) *
                (long long)sizeof(T);
  const int r0 = min(p.s, crank * p.rows_per_cta);
  const int nrows = min(p.s, r0 + p.rows_per_cta) - r0;
  const bool resident = nrows <= p.chunk_rows;
  // the column pass: thread (pair, grp) sums columns 2 pair, 2 pair + 1 of
  // rows grp, grp + kGroups, ...
  const int col = 2 * (tid % kPairs), grp = tid / kPairs;
  const bool cthread = grp < kGroups && col < p.dh;

  if (p.dh < DHP) {  // the padding columns stay zero: loads never write them
    const int n16 = L::row(p.chunk_rows) / 16;
    for (int i = tid; i < n16; i += kThreads)
      reinterpret_cast<uint4*>(xs)[i] = make_uint4(0, 0, 0, 0);
  }

  auto load = [&](int row0, int n) {
    const long long rb = p.s_row * (long long)sizeof(T);
    if (p.vec) {
      const int units = p.dh * (int)sizeof(T) / 16;
      for (int i = tid; i < n * units; i += kThreads) {
        const int r = i / units, u = i - r * units;
        const uint4 v = __ldg(
            reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * rb) +
            u);
        *reinterpret_cast<uint4*>(xs + L::row(r) + u * 16) = v;
      }
    } else {
      for (int i = tid; i < n * p.dh; i += kThreads) {
        const int r = i / p.dh, c = i - r * p.dh;
        reinterpret_cast<T*>(xs + L::row(r))[c] = reinterpret_cast<const T*>(
            base + (long long)(row0 + r) * rb)[c];
      }
    }
  };
  // f(n, a) for each chunk of this block's rows (local rows a .. a + n - 1)
  // once it lies in xs; a resident slice is loaded by the first pass only
  bool loaded = false;
  auto over_chunks = [&](auto&& f) {
    for (int a = 0; a < nrows; a += p.chunk_rows) {
      const int n = min(p.chunk_rows, nrows - a);
      if (!(resident && loaded)) {
        __syncthreads();
        load(r0 + a, n);
        __syncthreads();
      }
      f(n, a);
    }
    loaded = true;
  };
  // y = (row - mean) q for one row in xs: a 16-byte unit of the row at a
  // time against the unit's mean and q rows, broadcast as float4s (the loop
  // stays rolled, so q is read where it is used and never held whole)
  auto project = [&](const unsigned char* row, float* y) {
#pragma unroll
    for (int j = 0; j < kD; ++j) y[j] = 0.f;
#pragma unroll 1
    for (int u = 0; u < kUnits; ++u) {
      float x[kPerUnit], m[kPerUnit], q[kPerUnit * kD];
      E::unpack(*reinterpret_cast<const uint4*>(row + u * 16), x);
      const float4* m4 = reinterpret_cast<const float4*>(mean + u * kPerUnit);
#pragma unroll
      for (int i = 0; i < kPerUnit / 4; ++i)
        *reinterpret_cast<float4*>(m + 4 * i) = m4[i];
      const float4* q4 =
          reinterpret_cast<const float4*>(qs + u * kPerUnit * kD);
#pragma unroll
      for (int i = 0; i < kPerUnit * kD / 4; ++i)
        *reinterpret_cast<float4*>(q + 4 * i) = q4[i];
#pragma unroll
      for (int e = 0; e < kPerUnit; ++e) {
        const float xc = x[e] - m[e];
#pragma unroll
        for (int j = 0; j < kD; ++j) y[j] = fmaf(xc, q[e * kD + j], y[j]);
      }
    }
  };
  // dst[i] = sum over the cluster's blocks, in rank order, of each block's
  // sum of part[g * n + i] over g < groups; then / div. Every block ends
  // with the same bits. Two buffers alternate, so one cluster barrier a
  // exchange keeps a block from overwriting what another still reads.
  int ex = 0;
  auto cluster_sum = [&](int groups, int n, float* dst, float div) {
    float* buf = red + (ex++ & 1) * kRed;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      float s = 0.f;
      for (int g = 0; g < groups; ++g) s += part[g * n + i];
      buf[i] = s;
    }
    cluster.sync();
    for (int i = tid; i < n; i += kThreads) {
      float s = 0.f;
      for (int r = 0; r < csize; ++r) s += cluster.map_shared_rank(buf, r)[i];
      dst[i] = s / div;
    }
    __syncthreads();
  };

  // -- the column mean ------------------------------------------------------
  float acc_m[2] = {0.f, 0.f};
  over_chunks([&](int n, int) {
    if (cthread)
      for (int r = grp; r < n; r += kGroups) {
        const float2 x = E::get2(xs + L::row(r), col);
        acc_m[0] += x.x;
        acc_m[1] += x.y;
      }
  });
  __syncthreads();
  if (grp < kGroups) {
    part[grp * DHP + col] = acc_m[0];
    part[grp * DHP + col + 1] = acc_m[1];
  }
  cluster_sum(kGroups, DHP, mean, (float)p.s);

  // -- subspace sweeps: z = Xc^T (Xc q), q = Q of z --------------------------
  for (int i = tid; i < DHP * kD; i += kThreads)
    qs[i] = (i / kD == i % kD) ? 1.f : 0.f;
  __syncthreads();
  for (int it = 0; it < p.iters; ++it) {
    float acc[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    over_chunks([&](int n, int) {
      for (int t0 = 0; t0 < n; t0 += kThreads) {
        const int nt = min(kThreads, n - t0);
        if (tid < nt) {
          float w[3] = {0.f, 0.f, 0.f};
          project(xs + L::row(t0 + tid), w);
          wt[tid] = make_float4(w[0], w[1], w[2], 0.f);
        }
        __syncthreads();
        if (cthread) {
          const float m0 = mean[col], m1 = mean[col + 1];
#pragma unroll 4
          for (int r = grp; r < nt; r += kGroups) {
            const float2 x = E::get2(xs + L::row(t0 + r), col);
            const float xc[2] = {x.x - m0, x.y - m1};
            const float4 w = wt[r];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              acc[e][0] = fmaf(xc[e], w.x, acc[e][0]);
              acc[e][1] = fmaf(xc[e], w.y, acc[e][1]);
              acc[e][2] = fmaf(xc[e], w.z, acc[e][2]);
            }
          }
        }
        __syncthreads();
      }
    });
    if (grp < kGroups) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < kD; ++j)
          part[grp * kRed + (col + e) * kD + j] = acc[e][j];
    }
    cluster_sum(kGroups, kRed, zs, 1.f);
    if (tid < 32) householder_q<DHP>(zs, qs);
    __syncthreads();
  }

  // -- the box: y's least and largest value per axis ------------------------
  float lo[kD], nhi[kD];
#pragma unroll
  for (int j = 0; j < kD; ++j) lo[j] = nhi[j] = kInf;
  over_chunks([&](int n, int) {
    for (int r = tid; r < n; r += kThreads) {
      float y[kD];
      project(xs + L::row(r), y);
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        lo[j] = fminf(lo[j], y[j]);
        nhi[j] = fminf(nhi[j], -y[j]);
      }
    }
  });
#pragma unroll
  for (int j = 0; j < kD; ++j) {
    lo[j] = warp_min(lo[j]);
    nhi[j] = warp_min(nhi[j]);
  }
  __syncthreads();
  if ((tid & 31) == 0) {
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      part[(tid >> 5) * 2 * kD + j] = lo[j];
      part[(tid >> 5) * 2 * kD + kD + j] = nhi[j];
    }
  }
  {
    float* buf = red + (ex++ & 1) * kRed;
    __syncthreads();
    if (tid < 2 * kD) {
      float v = kInf;
      for (int w = 0; w < kWarps; ++w) v = fminf(v, part[w * 2 * kD + tid]);
      buf[tid] = v;
    }
    cluster.sync();
    if (tid < 2 * kD) {
      float v = kInf;
      for (int r = 0; r < csize; ++r)
        v = fminf(v, cluster.map_shared_rank(buf, r)[tid]);
      box[tid] = v;
    }
    __syncthreads();
  }

  // -- the codes, in morton_codes_box's float32 operation order ------------
  const float top = (float)((1LL << p.bits) - 1);
  float lob[kD], span[kD];
#pragma unroll
  for (int j = 0; j < kD; ++j) {
    lob[j] = box[j];
    span[j] = fmaxf(__fsub_rn(-box[kD + j], box[j]), 1e-30f);
  }
  long long* out = p.out + (long long)set * p.s + r0;
  over_chunks([&](int n, int a) {
    for (int r = tid; r < n; r += kThreads) {
      float y[kD];
      project(xs + L::row(r), y);
      long long c[3] = {0, 0, 0};
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        float t = __fmul_rn(__fdiv_rn(__fsub_rn(y[j], lob[j]), span[j]), top);
        t = fminf(fmaxf(t, 0.f), top);
        c[j] = (long long)t;
      }
      out[a + r] = interleave(c, p.d);
      if (p.y) {
#pragma unroll
        for (int j = 0; j < kD; ++j)
          if (j < p.d)
            p.y[((long long)set * p.s + r0 + a + r) * p.d + j] = y[j];
      }
    }
  });
  // no block leaves while another may still read its exchange buffers
  cluster.sync();
}

// The launch's layout for n_sets sets of s rows on a card of `sms` SMs
// with `optin` bytes of opt-in shared memory a block: the fewest blocks a
// set whose shared memory holds the set's rows, raised until the card has
// a block on every SM (at most kMaxCluster, at least kMinRows rows a
// block). A set that kMaxCluster blocks cannot hold is streamed through
// shared memory in chunks on every pass.
struct Choice {
  int cluster, rows, chunk, smem;
};

template <typename T, int DHP>
cudaError_t choose(int n_sets, int s, int sms, int optin, Choice* c) {
  using L = Layout<T, DHP>;
  const int stride = L::row(1);
  const int cap = (optin - L::kFixed) / stride;
  if (cap < 1) return cudaErrorInvalidValue;
  const int fit = (s + cap - 1) / cap;
  const int fill =
      std::min((sms + n_sets - 1) / n_sets, (s + kMinRows - 1) / kMinRows);
  c->cluster = std::max(1, std::min(kMaxCluster, std::max(fit, fill)));
  c->rows = (s + c->cluster - 1) / c->cluster;
  c->chunk = std::min(c->rows, cap);
  c->smem = L::kFixed + c->chunk * stride;
  return cudaSuccess;
}

// The current device's SM count and opt-in shared memory a block, read
// once a device.
cudaError_t card(int* dev, int* sms, int* optin) {
  static std::atomic<int> sm_count[repro::kMaxDevices] = {};
  static std::atomic<int> smem_optin[repro::kMaxDevices] = {};
  cudaError_t err = repro::current_device(dev);
  if (err != cudaSuccess) return err;
  *sms = sm_count[*dev].load(std::memory_order_relaxed);
  *optin = smem_optin[*dev].load(std::memory_order_relaxed);
  if (*sms > 0 && *optin > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               *dev);
  if (err != cudaSuccess) return err;
  sm_count[*dev].store(*sms, std::memory_order_relaxed);
  smem_optin[*dev].store(*optin, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename T, int DHP>
cudaError_t launch(Params p, int n_sets, Choice* out, cudaStream_t st) {
  int dev, sms, optin;
  cudaError_t err = card(&dev, &sms, &optin);
  if (err != cudaSuccess) return err;
  Choice c;
  err = choose<T, DHP>(n_sets, p.s, sms, optin, &c);
  if (err != cudaSuccess) return err;
  if (out) {  // the layout alone: nothing is launched
    *out = c;
    return cudaSuccess;
  }
  p.rows_per_cta = c.rows;
  p.chunk_rows = c.chunk;
  static repro::SmemOptin state;
  auto kern = cluster_codes_kernel<T, DHP>;
  err = repro::allow_smem(kern, dev, (size_t)c.smem, state);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_sets * c.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)c.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Params& p, int n_sets, Choice* out,
                      cudaStream_t st) {
  switch ((p.dh + 31) / 32) {
    case 1: return launch<T, 32>(p, n_sets, out, st);
    case 2: return launch<T, 64>(p, n_sets, out, st);
    case 3: return launch<T, 96>(p, n_sets, out, st);
    case 4: return launch<T, 128>(p, n_sets, out, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Params& p, int dtype, int n_sets, Choice* out,
                     cudaStream_t st) {
  return dtype == 0 ? launch_dh<float>(p, n_sets, out, st)
                    : launch_dh<uint16_t>(p, n_sets, out, st);
}

}  // namespace

// k: n_sets = n_outer x n_inner key sets of s rows x dh, element strides
// s_outer, s_inner, s_row (each row contiguous); dtype 0 float32, 1
// bfloat16. out: int64 (n_sets, s); y: null, or float32 (n_sets, s, d)
// for the projections the codes came from. bits: per-axis bits already
// capped for d. The layout follows the shape and the current device.
extern "C" int repro_cluster_codes(const void* k, void* out, void* y,
                                   int n_sets, int n_inner, long long s_outer,
                                   long long s_inner, long long s_row, int s,
                                   int dh, int d, int bits, int iters,
                                   int dtype, void* stream) {
  if (n_sets <= 0 || n_inner <= 0 || s <= 0 || dh <= 0 || d < 1 || d > 3 ||
      d > dh || bits < 1 || bits > 30 || iters < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int esz = dtype == 0 ? 4 : 2;
  const long long b16 = 16 / esz;  // elements in 16 bytes
  Params p;
  p.k = static_cast<const unsigned char*>(k);
  p.out = static_cast<long long*>(out);
  p.y = static_cast<float*>(y);
  p.s_outer = s_outer;
  p.s_inner = s_inner;
  p.s_row = s_row;
  p.n_inner = n_inner;
  p.s = s;
  p.dh = dh;
  p.d = d;
  p.bits = bits;
  p.iters = iters;
  p.vec = (reinterpret_cast<uintptr_t>(k) % 16 == 0) && dh % b16 == 0 &&
          s_outer % b16 == 0 && s_inner % b16 == 0 && s_row % b16 == 0;
  return (int)dispatch(p, dtype, n_sets, nullptr, (cudaStream_t)stream);
}

// The layout repro_cluster_codes takes on the current device for n_sets
// sets of s rows x dh (dtype as there), launching nothing: out[0..3] =
// blocks a set (one thread-block cluster), rows a block, rows a block
// holds in shared memory at once (the rows: resident, read from device
// memory once; fewer: streamed), dynamic shared memory a block in bytes.
extern "C" int repro_cluster_layout(int n_sets, int s, int dh, int dtype,
                                    int* out) {
  if (n_sets <= 0 || s <= 0 || dh <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.s = s;
  p.dh = dh;
  Choice c;
  const cudaError_t err = dispatch(p, dtype, n_sets, &c, nullptr);
  if (err != cudaSuccess) return (int)err;
  out[0] = c.cluster;
  out[1] = c.rows;
  out[2] = c.chunk;
  out[3] = c.smem;
  return 0;
}
