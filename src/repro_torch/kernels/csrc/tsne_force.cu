// t-SNE attractive force (paper §3.1) over an ELL-BSR affinity for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/tsne_force.py:
//   tsne_force (_kernel)  ->  repro_tsne_force
//
// What it computes:  F[rb*bs + t, :] = sum_s sum_j w * (y_t - y_j),
//   w = P[rb, s, t, j] * q,  q = 1 / (1 + |y_t - y_j|^2),
//   y_t = y[rb*bs + t, :],  y_j = y[col_idx[rb, s]*bs + j, :].
// P tiles are stored target x source. Zero tiles (ELL padding) and zero
// rows (padded targets) contribute exactly 0.
//
// What bounds it on this card: bytes. A tile entry is 4 bytes of P read
// once against about 5d + 3 float32 operations (13 at d = 2), far below
// the ~20 operations per byte an H100 needs before arithmetic matters.
// The least time is (kept tiles * bs^2 * 4 + col_idx + y + F bytes) / HBM
// bandwidth.
//
// What the design does about it: the TPU kernel keeps the whole embedding
// resident in VMEM and accumulates into its output block over a sequential
// grid axis of ELL slots, with col_idx prefetched as scalars. Here one
// thread block owns one row block: it reads its own col_idx row and loops
// the ELL slots inside the block. Per slot the P tile is staged in shared
// memory through coalesced 16-byte streaming loads (__ldcs: read once,
// not kept in cache), with a padded row stride against bank conflicts,
// and the slot's (bs, d) source segment is gathered from global memory /
// L2 (y is n*d*4 bytes, 2 MB at n = 262 144, d = 2: it stays in L2) into
// shared memory, where it is read as a broadcast. `split` threads share
// one target row, each taking every split-th source column; each keeps
// its (d,) accumulator in registers, the lanes of a row are summed by
// shuffles in a fixed order and F is written once. No atomics, so the
// force is bit-for-bit reproducible from run to run.
//
// This first version streams every ELL slot, padding included; the SpMV
// kernel's walk over the kept slots of nbr_mask (bsr_spmv.cu) would skip it.

#include <cuda_runtime.h>

namespace {

constexpr int kTargetThreads = 128;

template <int D>
__global__ void tsne_force_kernel(const float* __restrict__ p_vals,
                                  const int* __restrict__ col_idx,
                                  const float* __restrict__ y,
                                  float* __restrict__ f, int nbr, int bs,
                                  int split, int ld) {
  extern __shared__ float smem[];
  float* P = smem;                               // bs rows, stride ld
  float* S = smem + bs * ld;                     // bs x D source segment

  const long long rb = blockIdx.x;
  const int tid = threadIdx.x;
  const int t = tid / split;                     // target row of the tile
  const int lane = tid % split;                  // source stripe
  const int quads = bs * bs / 4;
  const float4* tiles =
      reinterpret_cast<const float4*>(p_vals + rb * nbr * bs * bs);
  const int* cols = col_idx + rb * nbr;

  float yt[D];
  float acc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    yt[k] = __ldg(y + (rb * bs + t) * D + k);
    acc[k] = 0.f;
  }

  for (int s = 0; s < nbr; ++s) {
    const long long cb = __ldg(cols + s);
    __syncthreads();                             // previous slot consumed
    for (int q = tid; q < quads; q += blockDim.x) {
      const float4 a = __ldcs(tiles + (long long)s * quads + q);
      const int e = q * 4;
      float* dst = P + (e / bs) * ld + (e % bs);
      dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
    }
    for (int q = tid; q < bs * D; q += blockDim.x)
      S[q] = __ldg(y + cb * bs * D + q);
    __syncthreads();
    const float* prow = P + t * ld;
    for (int j = lane; j < bs; j += split) {
      float diff[D];
      float d2 = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        diff[k] = yt[k] - S[j * D + k];
        d2 = fmaf(diff[k], diff[k], d2);
      }
      const float w = prow[j] * (1.f / (1.f + d2));
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] = fmaf(w, diff[k], acc[k]);
    }
  }
  // the split lanes of one row are contiguous and never straddle a warp
  for (int o = split >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < D; ++k)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) f[(rb * bs + t) * D + k] = acc[k];
  }
}

int launch(const float* p_vals, const int* col_idx, const float* y, float* f,
           int n_rb, int nbr, int bs, int d, cudaStream_t stream) {
  if (n_rb == 0) return (int)cudaSuccess;
  if (bs != 8 && bs != 16 && bs != 32 && bs != 64)
    return (int)cudaErrorInvalidValue;
  // threads per target row: a power of two <= bs, so that a block has
  // 64 (bs = 8) or 128 threads, a whole number of warps
  int split = kTargetThreads / bs;
  if (split > bs) split = bs;
  // row stride ld >= bs with ld = split (mod 32): the split lanes of the
  // 32 / split rows a warp covers read 32 distinct banks
  const int ld = bs + ((split - bs) % 32 + 32) % 32;
  const int threads = bs * split;
  const size_t smem = (size_t)(bs * ld + bs * d) * sizeof(float);
  switch (d) {
    case 1:
      tsne_force_kernel<1><<<n_rb, threads, smem, stream>>>(
          p_vals, col_idx, y, f, nbr, bs, split, ld);
      break;
    case 2:
      tsne_force_kernel<2><<<n_rb, threads, smem, stream>>>(
          p_vals, col_idx, y, f, nbr, bs, split, ld);
      break;
    case 3:
      tsne_force_kernel<3><<<n_rb, threads, smem, stream>>>(
          p_vals, col_idx, y, f, nbr, bs, split, ld);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// p_vals (n_rb, nbr, bs, bs) f32; col_idx (n_rb, nbr) i32; y (n_cb*bs, d)
// f32 with n_cb >= n_rb; f (n_rb*bs, d) f32. bs in {8, 16, 32, 64},
// d in {1, 2, 3}.
extern "C" int repro_tsne_force(const void* p_vals, const void* col_idx,
                                const void* y, void* f, int n_rb, int nbr,
                                int bs, int d, void* stream) {
  return launch((const float*)p_vals, (const int*)col_idx, (const float*)y,
                (float*)f, n_rb, nbr, bs, d, (cudaStream_t)stream);
}
