// ELL-BSR block-sparse matrix x dense (multi-)vector for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/bsr_spmv.py:
//   bsr_spmv_batched (_batch_kernel)  ->  repro_bsr_spmv_batched
//   bsr_spmv         (_kernel)        ->  repro_bsr_spmv  (same device code, B = 1)
//
// What it computes:  y[b, rb*bs + i, c] = sum_s sum_j vals[b, rb, s, i, j]
//                                         * xs[b, col_idx[b, rb, s]*bs + j, c]
// Padding slots are zero tiles at column 0, so they need no mask and rows
// without kept tiles come out exactly 0.
//
// What bounds it on this card: bytes. Every tile value is used once
// (f == 1) or f times (f > 1), far below the ~20 flop/byte an H100 needs
// in float32 before arithmetic matters. The least time is
//   (B*n_rb*nbr*bs*bs*4 + col_idx + xs + y bytes) / HBM bandwidth.
//
// What the design does about it: the TPU grid is a sequential accumulator
// over a charge block resident in fast memory; here one thread block owns
// one (member, row block[, feature tile]), reads its own col_idx row,
// loops the ELL slots inside the block, streams each tile once with
// 16-byte coalesced loads that bypass cache retention (__ldcs), gathers
// the slot's charge segment from global/L2 by computed offset, keeps the
// accumulator in registers and writes y once. No output block is
// revisited and there are no atomics, so the result is deterministic.
// Blocks are laid out on gridDim.x only (gridDim.y/z stop at 65535).

#include <cuda_runtime.h>

namespace {

constexpr int kFeatureTile = 8;   // feature columns per block, f > 1 path

// f == 1. blockDim.x = max(32, bs*bs/4) rounded to a warp; thread t owns the
// t-th float4 of the tile: tile row t / (bs/4), columns 4*(t % (bs/4))..+3.
__global__ void bsr_spmv_f1_kernel(const float* __restrict__ vals,
                                   const int* __restrict__ col_idx,
                                   const float* __restrict__ xs,
                                   float* __restrict__ y,
                                   int n_rb, int nbr, int bs,
                                   long long x_rows) {
  const long long blk = blockIdx.x;              // member * n_rb + row block
  const long long member = blk / n_rb;
  const int t = threadIdx.x;
  const int quads = bs * bs / 4;
  const int lpr = bs / 4;                        // lanes per tile row
  const bool active = t < quads;
  const int row = t / lpr;
  const int cq = t % lpr;
  const float4* tiles =
      reinterpret_cast<const float4*>(vals + blk * nbr * bs * bs);
  const int* cols = col_idx + blk * nbr;
  const float* xm = xs + member * x_rows;

  float acc = 0.f;
  if (active) {
#pragma unroll 4
    for (int s = 0; s < nbr; ++s) {
      const int c = __ldg(cols + s);
      const float4 a = __ldcs(tiles + (long long)s * quads + t);
      const float4 b = __ldg(
          reinterpret_cast<const float4*>(xm + (long long)c * bs) + cq);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  }
  // the lpr lanes of one tile row are contiguous and never straddle a warp
  for (int o = lpr >> 1; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (active && cq == 0) y[blk * bs + row] = acc;
}

// f > 1. blockDim.x = bs * kFeatureTile; thread t owns output (row i = t / 8,
// feature c = t % 8) of one feature tile. The tile (padded rows, no bank
// conflicts) and the slot's (bs, 8) charge segment are staged in shared
// memory; the product runs on CUDA cores.
__global__ void bsr_spmm_kernel(const float* __restrict__ vals,
                                const int* __restrict__ col_idx,
                                const float* __restrict__ xs,
                                float* __restrict__ y,
                                int n_rb, int nbr, int bs, int f, int n_ft,
                                long long x_rows) {
  extern __shared__ float smem[];
  const int ld = bs + 1;
  float* T = smem;                               // bs x (bs + 1)
  float* S = smem + bs * ld;                     // bs x kFeatureTile

  const long long g = blockIdx.x;
  const int ft = (int)(g % n_ft);
  const long long blk = g / n_ft;                // member * n_rb + row block
  const long long member = blk / n_rb;
  const int t = threadIdx.x;
  const int i = t / kFeatureTile;
  const int c = t % kFeatureTile;
  const int col_f = ft * kFeatureTile + c;
  const bool cvalid = col_f < f;
  const int quads = bs * bs / 4;
  const float4* tiles =
      reinterpret_cast<const float4*>(vals + blk * nbr * bs * bs);
  const int* cols = col_idx + blk * nbr;
  const float* xm = xs + member * x_rows * f;

  float acc = 0.f;
  for (int s = 0; s < nbr; ++s) {
    const long long cb = __ldg(cols + s);
    __syncthreads();                             // previous slot consumed
    for (int q = t; q < quads; q += blockDim.x) {
      const float4 a = __ldcs(tiles + (long long)s * quads + q);
      const int e = q * 4;
      float* dst = T + (e / bs) * ld + (e % bs);
      dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
    }
    // thread (i, c) stages segment element (j = i, c)
    S[t] = cvalid ? __ldg(xm + (cb * bs + i) * f + col_f) : 0.f;
    __syncthreads();
    const float* trow = T + i * ld;
#pragma unroll 8
    for (int j = 0; j < bs; ++j)
      acc = fmaf(trow[j], S[j * kFeatureTile + c], acc);
  }
  if (cvalid) y[(blk * bs + i) * f + col_f] = acc;
}

int launch(const float* vals, const int* col_idx, const float* xs, float* y,
           int B, int n_rb, int nbr, int bs, int n_cb, int f,
           cudaStream_t stream) {
  const long long blocks = (long long)B * n_rb;
  if (blocks == 0 || f == 0) return (int)cudaSuccess;
  const long long x_rows = (long long)n_cb * bs;
  if (f == 1) {
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    int threads = bs * bs / 4;
    threads = threads < 32 ? 32 : (threads + 31) / 32 * 32;
    bsr_spmv_f1_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        vals, col_idx, xs, y, n_rb, nbr, bs, x_rows);
  } else {
    const int n_ft = (f + kFeatureTile - 1) / kFeatureTile;
    if (blocks * n_ft > 2147483647LL)
      return (int)cudaErrorInvalidConfiguration;
    const size_t smem = (size_t)(bs * (bs + 1) + bs * kFeatureTile) *
                        sizeof(float);
    bsr_spmm_kernel<<<(unsigned)(blocks * n_ft), bs * kFeatureTile, smem,
                      stream>>>(vals, col_idx, xs, y, n_rb, nbr, bs, f, n_ft,
                                x_rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vals (B, n_rb, nbr, bs, bs) f32; col_idx (B, n_rb, nbr) i32;
// xs (B, n_cb*bs, f) f32; y (B, n_rb*bs, f) f32. bs in {4, 8, 16, 32, 64}.
extern "C" int repro_bsr_spmv_batched(const void* vals, const void* col_idx,
                                      const void* xs, void* y, int B,
                                      int n_rb, int nbr, int bs, int n_cb,
                                      int f, void* stream) {
  return launch((const float*)vals, (const int*)col_idx, (const float*)xs,
                (float*)y, B, n_rb, nbr, bs, n_cb, f, (cudaStream_t)stream);
}

// Single-plan entry: vals (n_rb, nbr, bs, bs); col_idx (n_rb, nbr);
// x (n_cb*bs, f); y (n_rb*bs, f).
extern "C" int repro_bsr_spmv(const void* vals, const void* col_idx,
                              const void* x, void* y, int n_rb, int nbr,
                              int bs, int n_cb, int f, void* stream) {
  return launch((const float*)vals, (const int*)col_idx, (const float*)x,
                (float*)y, 1, n_rb, nbr, bs, n_cb, f, (cudaStream_t)stream);
}
