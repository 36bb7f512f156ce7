// Exact gamma-score (paper Eq. 4) raw pairwise sum for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/gamma_score.py:
//   gamma_pairs (_kernel)  ->  repro_gamma_pairs
//
// What it computes:  sum_{p,q} w_p w_q exp(-|c_p - c_q|^2 / sigma^2) over
// n = nb*bn coordinates (row, col) of nonzeros, tiled (bn, bn). Zero-weight
// entries are inert (padding). With symmetric != 0 only tile pairs
// (i, j <= i) are evaluated and off-diagonal tiles count twice.
//
// What bounds it on this card: operations. The inputs are 12 bytes per
// nonzero while the work is n^2 pair terms of about nine float32
// operations each (one of them an exponential), all on CUDA cores.
//
// What the design does about it: the TPU kernel adds every tile into one
// (1, 1) output because its grid runs in order; blocks here run in any
// order. One block owns one tile pair: it stages the q tile's coordinates
// and weights in shared memory, each thread sums its own p row against
// the tile from registers, the block reduces in a fixed order and writes
// ONE partial. A second one-block kernel adds the partials in a fixed
// order in double precision. No atomics anywhere, so gamma is bit-for-bit
// reproducible from run to run (it later arms a drift guard).

#include <cuda_runtime.h>

namespace {

__global__ void gamma_pairs_kernel(const float* __restrict__ coords,
                                   const float* __restrict__ weights,
                                   float* __restrict__ partials, int nb,
                                   float inv_sigma2, int symmetric) {
  extern __shared__ float sm[];
  const int bn = blockDim.x;
  float* qx = sm;
  float* qy = sm + bn;
  float* qw = sm + 2 * bn;
  float* red = sm + 3 * bn;                      // one slot per warp

  const long long t = blockIdx.x;
  long long i, j;
  if (symmetric) {
    // invert t = i*(i+1)/2 + j, j <= i; fix the float estimate exactly
    i = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
    while (i * (i + 1) / 2 > t) --i;
    while ((i + 1) * (i + 2) / 2 <= t) ++i;
    j = t - i * (i + 1) / 2;
  } else {
    i = t / nb;
    j = t % nb;
  }

  const int k = threadIdx.x;
  const long long q = j * bn + k;
  qx[k] = coords[2 * q];
  qy[k] = coords[2 * q + 1];
  qw[k] = weights[q];
  const long long p = i * bn + k;
  const float px = coords[2 * p];
  const float py = coords[2 * p + 1];
  const float pw = weights[p];
  __syncthreads();

  float acc = 0.f;
#pragma unroll 4
  for (int m = 0; m < bn; ++m) {
    const float dx = px - qx[m];
    const float dy = py - qy[m];
    const float d2 = fmaf(dx, dx, dy * dy);
    acc = fmaf(qw[m], expf(-d2 * inv_sigma2), acc);
  }
  acc *= pw;

  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((k & 31) == 0) red[k >> 5] = acc;
  __syncthreads();
  if (k == 0) {
    float tot = 0.f;
    for (int w = 0; w < bn / 32; ++w) tot += red[w];
    partials[t] = (symmetric && j < i) ? 2.f * tot : tot;
  }
}

__global__ void gamma_reduce_kernel(const float* __restrict__ partials,
                                    long long count,
                                    float* __restrict__ out) {
  __shared__ double red[1024];
  const int k = threadIdx.x;
  double a = 0.0;
  for (long long p = k; p < count; p += blockDim.x) a += (double)partials[p];
  red[k] = a;
  __syncthreads();
  for (int o = blockDim.x >> 1; o > 0; o >>= 1) {
    if (k < o) red[k] += red[k + o];
    __syncthreads();
  }
  if (k == 0) out[0] = (float)red[0];
}

}  // namespace

// coords (n, 2) f32, weights (n,) f32 with n = nb*bn; bn a multiple of 32,
// 32 <= bn <= 1024. partials holds nb*(nb+1)/2 (symmetric) or nb*nb floats;
// out is one float.
extern "C" int repro_gamma_pairs(const void* coords, const void* weights,
                                 void* partials, void* out, long long n,
                                 int bn, float sigma, int symmetric,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bn < 32 || bn > 1024 || bn % 32 != 0 || n % bn != 0)
    return (int)cudaErrorInvalidValue;
  const long long nb = n / bn;
  const long long count = symmetric ? nb * (nb + 1) / 2 : nb * nb;
  if (count > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  if (count > 0) {
    const size_t smem = (size_t)(3 * bn + 32) * sizeof(float);
    gamma_pairs_kernel<<<(unsigned)count, bn, smem, st>>>(
        (const float*)coords, (const float*)weights, (float*)partials,
        (int)nb, 1.0f / (sigma * sigma), symmetric);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  gamma_reduce_kernel<<<1, 1024, 0, st>>>((const float*)partials, count,
                                          (float*)out);
  return (int)cudaGetLastError();
}
