// ELL-BSR block-sparse matrix x dense (multi-)vector for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/bsr_spmv.py:
//   bsr_spmv_batched (_batch_kernel)  ->  repro_bsr_spmv_batched
//   bsr_spmv         (_kernel)        ->  repro_bsr_spmv  (same device code, B = 1)
//
// What it computes:  y[b, rb*bs + i, c] = sum over KEPT slots s of
//                      sum_j vals[b, rb, s, i, j] * xs[b, col_idx[b, rb, s]*bs + j, c]
// A slot is kept where nbr_mask[b, rb, s] is nonzero (a null mask keeps
// every slot). Masked slots are skipped: no byte of their tile, and not
// their charge segment, is read, so whatever they hold (NaN included) never
// reaches y. A row block with no kept slot writes exact zeros.
//
// What bounds it on this card: bytes. Every kept tile value is used once
// (f == 1) or f times (f > 1): 0.5 flop/byte at f = 1 and 4 flop/byte at
// f = 8, far below the ~20 flop/byte an H100 needs in float32 before
// arithmetic matters. The least time is
//   (kept tiles * bs*bs*4 + col_idx + xs + y bytes) / HBM bandwidth.
// The ELL layout pads every row block to the widest one (47 slots for
// 11.6 kept tiles per row block on the n = 262 144 SIFT plan), so a kernel
// that streams every slot moves 4x the bytes it needs.
//
// What the design does about it. One warp-uniform walk per row block
// (KeptSlots) reads the row's mask and col_idx 32 slots at a time,
// ballots the kept bits and hands out kept slot numbers in slot order
// (__ffs), with the column block broadcast by a shuffle; the next 32-slot
// chunk is already in flight while the current one is taken. Only the
// kept tiles are read. The TPU grid's sequential accumulator over a
// charge block resident in VMEM becomes a loop inside the block with the
// accumulator in registers; no output is revisited and there are no
// atomics, so slots are summed in a fixed order and the result is
// bit-reproducible run to run. Blocks lie on gridDim.x only.
//
// f == 1: one block per (member, row block), thread t owns float4 number
//   t (+ k * threads) of every tile, so all its quads share one charge
//   float4 (a 128-byte segment from L2 at bs = 32). Tiles are streamed
//   with 16-byte coalesced, evict-first loads (__ldcs); each warp takes
//   kUnroll kept slots at a time and issues all their loads before the
//   first multiply, so about 8 float4 per thread are in flight even though
//   a row block has only ~12 kept tiles. Rows are reduced over their
//   bs/4 lanes by shuffles.
// f > 1: one block per (member, row block[, feature group]); every kept
//   tile (contiguous bs*bs*4 bytes) and its charge segment (bs rows of the
//   group's columns) go through a kStages-deep cp.async ring in shared
//   memory, so the next slots load while the current one is multiplied.
//   Each thread keeps a 4-row x 2-feature register tile (rows rg + k*bs/4,
//   which makes the float4 tile reads conflict-free with a bs + 4 row
//   stride) and reads the staged tile with 16-byte shared loads. The
//   feature group is the whole f up to 2048 / (bs/4) columns (256 at
//   bs = 32), so each kept tile is read from device memory once; a wider
//   f is split into groups of at most that width, each a block of its own
//   that reads the tile again.
// Arithmetic is float32 FMA on the CUDA cores. At 4 flop/byte the tensor
// cores would not move the byte bound, and TF32 keeps about 3 decimal
// digits, outside the kernel-vs-plain limit of 2e-5 x max|plain|.

#include <cuda_runtime.h>
#include <climits>

#include "kept_slots.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 3;          // cp.async ring depth, f > 1 path
constexpr int kMaxThreads = 1024;

using repro::KeptSlots;

// ---------------------------------------------------------------- f == 1 --

template <int BS>
struct F1 {
  static constexpr int kQuads = BS * BS / 4;       // float4 per tile
  static constexpr int kLanesPerRow = BS / 4;
  static constexpr int kThreads =
      kQuads < 32 ? 32 : (kQuads > 128 ? 128 : kQuads);
  static constexpr int kPerThread = kQuads > kThreads ? kQuads / kThreads : 1;
  static constexpr int kUnroll = 8 / kPerThread;   // kept slots per round
};

template <int BS>
__global__ void __launch_bounds__(F1<BS>::kThreads)
bsr_spmv_f1_kernel(const float* __restrict__ vals,
                   const int* __restrict__ col_idx,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ xs, float* __restrict__ y,
                   int n_rb, int nbr, long long x_rows) {
  using P = F1<BS>;
  const long long blk = blockIdx.x;              // member * n_rb + row block
  const long long member = blk / n_rb;
  const int t = threadIdx.x;
  const bool active = t < P::kQuads;
  const int cq = t % P::kLanesPerRow;            // charge float4 of the row
  const float4* tiles =
      reinterpret_cast<const float4*>(vals) + blk * nbr * P::kQuads;
  const float4* xm = reinterpret_cast<const float4*>(xs + member * x_rows);
  KeptSlots kept(mask == nullptr ? nullptr : mask + blk * nbr,
                 col_idx + blk * nbr, nbr);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[P::kPerThread];
#pragma unroll
  for (int k = 0; k < P::kPerThread; ++k) acc[k] = 0.f;

  for (;;) {
    int s[P::kUnroll], c[P::kUnroll];
#pragma unroll
    for (int u = 0; u < P::kUnroll; ++u) s[u] = kept.next(&c[u]);
    if (s[0] < 0) break;
    float4 a[P::kUnroll][P::kPerThread], b[P::kUnroll];
#pragma unroll
    for (int u = 0; u < P::kUnroll; ++u) {
      const bool live = active && s[u] >= 0;
#pragma unroll
      for (int k = 0; k < P::kPerThread; ++k)
        a[u][k] = live ? __ldcs(tiles + (long long)s[u] * P::kQuads + t +
                                k * P::kThreads)
                       : zero;
      b[u] = live ? __ldg(xm + (long long)c[u] * P::kLanesPerRow + cq) : zero;
    }
#pragma unroll
    for (int u = 0; u < P::kUnroll; ++u) {
      if (s[u] < 0) continue;
#pragma unroll
      for (int k = 0; k < P::kPerThread; ++k) {
        acc[k] = fmaf(a[u][k].x, b[u].x, acc[k]);
        acc[k] = fmaf(a[u][k].y, b[u].y, acc[k]);
        acc[k] = fmaf(a[u][k].z, b[u].z, acc[k]);
        acc[k] = fmaf(a[u][k].w, b[u].w, acc[k]);
      }
    }
  }
  // the lanes of one tile row are contiguous and never straddle a warp
#pragma unroll
  for (int k = 0; k < P::kPerThread; ++k) {
    float v = acc[k];
#pragma unroll
    for (int o = P::kLanesPerRow >> 1; o > 0; o >>= 1)
      v += __shfl_xor_sync(kFull, v, o);
    if (active && cq == 0)
      y[blk * BS + (t + k * P::kThreads) / P::kLanesPerRow] = v;
  }
}

// ----------------------------------------------------------------- f > 1 --

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int BS>
struct Mm {
  static constexpr int kLdT = BS + 4;            // padded tile row (floats)
  static constexpr int kRowGroups = BS / 4;      // thread rows rg + k*this
  static constexpr int kMaxGroup = 2 * kMaxThreads / kRowGroups;
};

// blockDim.x = kRowGroups * ceil(fg / 2) rounded up to a warp; thread t
// owns rows rg + k * kRowGroups (k < 4) and feature columns 2 fp, 2 fp + 1
// of its group (rg = t % kRowGroups, fp = t / kRowGroups). Shared memory:
// kStages x [tile bs x (bs + 4) | segment bs x lds], lds = fg rounded up
// to 4.
template <int BS>
__global__ void __launch_bounds__(kMaxThreads)
bsr_spmm_kernel(const float* __restrict__ vals,
                const int* __restrict__ col_idx,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ xs, float* __restrict__ y,
                int n_rb, int nbr, int f, int fg, int n_fg,
                long long x_rows) {
  using P = Mm<BS>;
  extern __shared__ __align__(16) float smem[];
  const int lds = (fg + 3) & ~3;
  const int stage_floats = BS * P::kLdT + BS * lds;

  const long long g = blockIdx.x;
  const int grp = (int)(g % n_fg);
  const long long blk = g / n_fg;                // member * n_rb + row block
  const long long member = blk / n_rb;
  const int c0 = grp * fg;                       // first column of the group
  const int fc = min(fg, f - c0);                // columns of the group
  const int t = threadIdx.x, nt = blockDim.x;
  const int rg = t % P::kRowGroups;
  const int fp = t / P::kRowGroups;
  const bool active = 2 * fp < fc;
  const float* tiles = vals + blk * nbr * BS * BS;
  const float* xm = xs + member * x_rows * f + c0;
  KeptSlots kept(mask == nullptr ? nullptr : mask + blk * nbr,
                 col_idx + blk * nbr, nbr);

  // stage the kept slot s (column block c) into ring entry `stage`
  auto issue = [&](int stage, int s, int c) {
    float* T = smem + stage * stage_floats;
    float* S = T + BS * P::kLdT;
    const float* src = tiles + (long long)s * BS * BS;
    for (int q = t; q < BS * BS / 4; q += nt)
      cp_async16(T + (q / (BS / 4)) * P::kLdT + 4 * (q % (BS / 4)),
                 src + 4 * q);
    const float* seg = xm + (long long)c * BS * f;
    if ((f & 3) == 0) {                          // rows 16-byte aligned
      const int per_row = fc / 4;
      for (int q = t; q < BS * per_row; q += nt) {
        const int j = q / per_row, c4 = 4 * (q % per_row);
        cp_async16(S + j * lds + c4, seg + (long long)j * f + c4);
      }
    } else {
      for (int q = t; q < BS * fc; q += nt) {
        const int j = q / fc, cc = q % fc;
        cp_async4(S + j * lds + cc, seg + (long long)j * f + cc);
      }
    }
  };

  float acc[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.f;

  int issued = 0;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    int c;
    const int s = kept.next(&c);
    if (s >= 0) {
      issue(p, s, c);
      ++issued;
    }
    cp_async_commit();
  }
  for (int k = 0; k < issued; ++k) {
    {
      int c;
      const int s = kept.next(&c);
      if (s >= 0) {
        issue((k + kStages - 1) % kStages, s, c);
        ++issued;
      }
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();                // slot k has landed
    __syncthreads();
    const float* T = smem + (k % kStages) * stage_floats;
    const float* S = T + BS * P::kLdT;
    if (active) {
#pragma unroll 4
      for (int j = 0; j < BS; j += 4) {
        float4 a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[r] = *reinterpret_cast<const float4*>(
              T + (rg + r * P::kRowGroups) * P::kLdT + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 b =
              *reinterpret_cast<const float2*>(S + (j + u) * lds + 2 * fp);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float v = lane_of(a[r], u);
            acc[r][0] = fmaf(v, b.x, acc[r][0]);
            acc[r][1] = fmaf(v, b.y, acc[r][1]);
          }
        }
      }
    }
    __syncthreads();                             // ring entry consumed
  }
  if (active) {
    const bool second = 2 * fp + 1 < fc;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* out =
          y + (blk * BS + rg + r * P::kRowGroups) * f + c0 + 2 * fp;
      out[0] = acc[r][0];
      if (second) out[1] = acc[r][1];
    }
  }
}

template <int BS>
int launch_bs(const float* vals, const int* col_idx,
              const unsigned char* mask, const float* xs, float* y,
              long long blocks, int n_rb, int nbr, int f, long long x_rows,
              cudaStream_t stream) {
  if (f == 1) {
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    bsr_spmv_f1_kernel<BS><<<(unsigned)blocks, F1<BS>::kThreads, 0,
                             stream>>>(vals, col_idx, mask, xs, y, n_rb, nbr,
                                       x_rows);
    return (int)cudaGetLastError();
  }
  using P = Mm<BS>;
  const int n_fg = (f + P::kMaxGroup - 1) / P::kMaxGroup;
  // one group is the whole f; more groups are balanced, 4-column aligned
  const int fg = n_fg == 1 ? f : (((f + n_fg - 1) / n_fg) + 3) & ~3;
  if (blocks * n_fg > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const int threads = (P::kRowGroups * ((fg + 1) / 2) + 31) / 32 * 32;
  const int lds = (fg + 3) & ~3;
  const size_t smem =
      (size_t)kStages * (BS * P::kLdT + BS * lds) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_spmm_kernel<BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bsr_spmm_kernel<BS><<<(unsigned)(blocks * n_fg), threads, smem, stream>>>(
      vals, col_idx, mask, xs, y, n_rb, nbr, f, fg, n_fg, x_rows);
  return (int)cudaGetLastError();
}

int launch(const float* vals, const int* col_idx, const unsigned char* mask,
           const float* xs, float* y, int B, int n_rb, int nbr, int bs,
           int n_cb, int f, cudaStream_t stream) {
  const long long blocks = (long long)B * n_rb;
  if (blocks == 0 || f == 0) return (int)cudaSuccess;
  const long long x_rows = (long long)n_cb * bs;
  switch (bs) {
    case 4:
      return launch_bs<4>(vals, col_idx, mask, xs, y, blocks, n_rb, nbr, f,
                          x_rows, stream);
    case 8:
      return launch_bs<8>(vals, col_idx, mask, xs, y, blocks, n_rb, nbr, f,
                          x_rows, stream);
    case 16:
      return launch_bs<16>(vals, col_idx, mask, xs, y, blocks, n_rb, nbr, f,
                           x_rows, stream);
    case 32:
      return launch_bs<32>(vals, col_idx, mask, xs, y, blocks, n_rb, nbr, f,
                           x_rows, stream);
    case 64:
      return launch_bs<64>(vals, col_idx, mask, xs, y, blocks, n_rb, nbr, f,
                           x_rows, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// vals (B, n_rb, nbr, bs, bs) f32; col_idx (B, n_rb, nbr) i32; nbr_mask
// (B, n_rb, nbr) one byte per slot, nonzero = kept, or null (every slot
// kept); xs (B, n_cb*bs, f) f32; y (B, n_rb*bs, f) f32. bs in
// {4, 8, 16, 32, 64}. The kept slots' col_idx must lie in [0, n_cb).
extern "C" int repro_bsr_spmv_batched(const void* vals, const void* col_idx,
                                      const void* nbr_mask, const void* xs,
                                      void* y, int B, int n_rb, int nbr,
                                      int bs, int n_cb, int f, void* stream) {
  return launch((const float*)vals, (const int*)col_idx,
                (const unsigned char*)nbr_mask, (const float*)xs, (float*)y,
                B, n_rb, nbr, bs, n_cb, f, (cudaStream_t)stream);
}

// Single-plan entry: vals (n_rb, nbr, bs, bs); col_idx and nbr_mask
// (n_rb, nbr); x (n_cb*bs, f); y (n_rb*bs, f).
extern "C" int repro_bsr_spmv(const void* vals, const void* col_idx,
                              const void* nbr_mask, const void* x, void* y,
                              int n_rb, int nbr, int bs, int n_cb, int f,
                              void* stream) {
  return launch((const float*)vals, (const int*)col_idx,
                (const unsigned char*)nbr_mask, (const float*)x, (float*)y, 1,
                n_rb, nbr, bs, n_cb, f, (cudaStream_t)stream);
}
