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
// What bounds it on this card: the exponentials. The inputs are 12 bytes
// per nonzero while the work is n^2 pair terms, each one exponential on
// the special-function units (16 ex2 per clock per SM on sm_90) and a few
// float32 instructions on the FMA pipe (128 lanes per clock per SM). The
// least time is terms / (16 x SMs x clock).
//
// What the design does about it. The scale is folded into the
// coordinates: with c' = c * sqrt(log2 e) / sigma, a term is
//   w_q * 2^-(dx'^2 + dy'^2),
// taken as ex2.approx.ftz.f32 (one MUFU.EX2; the shared build flags stay
// without fast-math, which would change the arithmetic of every other
// kernel). The negation rides in the operand modifiers of the multiply
// and the fused multiply-add, so a term costs two subtractions, a
// multiply, a fused multiply-add, the ex2 and the weighted accumulate:
// five FMA-pipe instructions for one ex2, and the ex2 rate sets the pace.
// The q tile is staged once per block in shared memory as float4
// (x', y', w, 0), so a term's operands are one 16-byte broadcast load,
// and each thread owns R p rows (4 at bn = 256), so each load feeds R
// terms. The TPU kernel adds every tile into one (1, 1) output because its
// grid runs in order; blocks here run in any order. One block owns one
// tile pair and writes ONE partial (its rows summed in a fixed order); a
// second one-block kernel adds the partials in a fixed order in double
// precision. No atomics anywhere, so gamma is bit-for-bit reproducible
// from run to run (it arms the rebucket drift guard).

#include <cuda_runtime.h>

namespace {

// 2^x on the special-function unit, denormal results flushed to zero
__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// blockDim.x = bn / R; thread k owns p rows k + m * blockDim.x (m < R).
// Shared memory: bn float4 (the q tile), then one float per warp.
template <int R>
__global__ void gamma_pairs_kernel(const float* __restrict__ coords,
                                   const float* __restrict__ weights,
                                   float* __restrict__ partials, int nb,
                                   float scale, int symmetric) {
  extern __shared__ float4 qt[];
  const int nt = blockDim.x;
  const int bn = nt * R;
  float* red = reinterpret_cast<float*>(qt + bn);

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
  const float2* c2 = reinterpret_cast<const float2*>(coords);
  for (int m = k; m < bn; m += nt) {
    const long long q = j * bn + m;
    const float2 c = c2[q];
    qt[m] = make_float4(c.x * scale, c.y * scale, weights[q], 0.f);
  }
  float px[R], py[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 c = c2[i * bn + k + r * nt];
    px[r] = c.x * scale;
    py[r] = c.y * scale;
    acc[r] = 0.f;
  }
  __syncthreads();

#pragma unroll 4
  for (int m = 0; m < bn; ++m) {
    const float4 q = qt[m];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float dx = px[r] - q.x;
      const float dy = py[r] - q.y;
      const float e = ex2_approx(fmaf(-dy, dy, -dx * dx));
      acc[r] = fmaf(q.z, e, acc[r]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
    sum = fmaf(weights[i * bn + k + r * nt], acc[r], sum);

  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, o);
  if ((k & 31) == 0) red[k >> 5] = sum;
  __syncthreads();
  if (k == 0) {
    float tot = 0.f;
    for (int w = 0; w < nt / 32; ++w) tot += red[w];
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

template <int R>
cudaError_t launch_pairs(const float* coords, const float* weights,
                         float* partials, long long count, int nb, int bn,
                         float scale, int symmetric, cudaStream_t st) {
  const int threads = bn / R;
  const size_t smem = (size_t)bn * sizeof(float4) + 32 * sizeof(float);
  gamma_pairs_kernel<R><<<(unsigned)count, threads, smem, st>>>(
      coords, weights, partials, nb, scale, symmetric);
  return cudaGetLastError();
}

}  // namespace

// coords (n, 2) f32 (8-byte aligned), weights (n,) f32 with n = nb*bn; bn
// a multiple of 32, 32 <= bn <= 1024. scale = sqrt(log2 e) / sigma.
// partials holds nb*(nb+1)/2 (symmetric) or nb*nb floats; out is one float.
extern "C" int repro_gamma_pairs(const void* coords, const void* weights,
                                 void* partials, void* out, long long n,
                                 int bn, float scale, int symmetric,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bn < 32 || bn > 1024 || bn % 32 != 0 || n % bn != 0)
    return (int)cudaErrorInvalidValue;
  const long long nb = n / bn;
  const long long count = symmetric ? nb * (nb + 1) / 2 : nb * nb;
  if (count > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  if (count > 0) {
    // R p rows a thread, with bn / R threads a whole number of warps
    const float* c = (const float*)coords;
    const float* w = (const float*)weights;
    float* p = (float*)partials;
    const cudaError_t err =
        bn % 128 == 0 ? launch_pairs<4>(c, w, p, count, (int)nb, bn, scale,
                                        symmetric, st)
        : bn % 64 == 0 ? launch_pairs<2>(c, w, p, count, (int)nb, bn, scale,
                                         symmetric, st)
                       : launch_pairs<1>(c, w, p, count, (int)nb, bn, scale,
                                         symmetric, st);
    if (err != cudaSuccess) return (int)err;
  }
  gamma_reduce_kernel<<<1, 1024, 0, st>>>((const float*)partials, count,
                                          (float*)out);
  return (int)cudaGetLastError();
}
