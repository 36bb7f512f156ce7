// t-SNE attractive force (paper §3.1) over an ELL-BSR affinity for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/tsne_force.py:
//   tsne_force (_kernel)  ->  repro_tsne_force
//
// What it computes:  F[rb*bs + t, :] = sum over KEPT slots s of
//   sum_j w * (y_t - y_j),  w = P[rb, s, t, j] * q,  q = 1 / (1 + |y_t - y_j|^2),
//   y_t = y[rb*bs + t, :],  y_j = y[col_idx[rb, s]*bs + j, :].
// P tiles are stored target x source. A slot is kept where nbr_mask[rb, s]
// is nonzero (a null mask keeps every slot); a masked slot's tile and
// column block are never read, so whatever they hold (NaN, a stale index)
// never reaches F. A row block with no kept slot writes exact zeros, and
// zero P rows (padded targets) contribute exactly 0.
//
// What bounds it on this card: bytes. A tile entry is 4 bytes of P read
// once against about 5d + 3 float32 operations (13 at d = 2), far below
// the ~20 operations per byte an H100 needs before arithmetic matters.
// The least time is (kept tiles * bs^2 * 4 + col_idx + y + F bytes) / HBM
// bandwidth. The ELL layout pads every row block to the widest one (49
// slots for 11.8 kept tiles per row block on the perplexity-30 t-SNE plan
// at n = 262 144), so a kernel that streams every slot moves 4x the bytes
// it needs.
//
// What the design does about it. The TPU kernel keeps the whole embedding
// resident in VMEM and accumulates into its output block over a
// sequential grid axis of ELL slots, with col_idx prefetched as scalars.
// Here each warp owns 32/split target rows of one row block and walks the
// row block's kept slots itself (KeptSlots, kept_slots.cuh: the mask and
// col_idx read 32 slots at a time, ballot, __ffs), so no block-wide
// barrier is needed anywhere. Each kept slot goes through a kStages-deep
// cp.async ring private to the warp: the warp's rows of the P tile (each
// lane copies its own fragment, 16-byte copies at bs >= 16, 8-byte at
// bs = 8, lane l taking vectors l, l + split, ... of its row so that each
// copy instruction reads whole 32-byte sectors, L2 only) and the slot's
// source coordinates (bs*d floats, from L2: y is n*d*4 bytes, 2 MB at
// n = 262 144, d = 2). So the next kStages - 1 kept tiles are in flight
// while one is multiplied, and they hold no registers: tiles loaded ahead
// into registers cap the bytes in flight by the register file (at 139
// registers a thread, 12 warps an SM with two to four 1 KB tiles each
// read 1.5 TB/s of kept tiles on an H100 80GB HBM3). A lane reads its P
// fragment back from where it copied it (no conflicts) and the
// coordinates of its columns as broadcasts, after a __syncwarp. `split` lanes share a target
// row and hold bs/split of its columns; each thread
// keeps its (d,) accumulator in registers over the slots in slot order,
// the lanes of a row are summed by shuffles in a fixed order and F is
// written once. No atomics, so the force is bit-for-bit reproducible from
// run to run, and skipping a zero tile adds exact zeros in the same order
// (the force through the plan's mask equals the force over every slot
// when y is finite).

#include <cuda_runtime.h>
#include <climits>

#include "kept_slots.cuh"

namespace {

using repro::KeptSlots;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;          // warps per thread block
constexpr int kStages = 4;         // cp.async ring depth per warp

template <int V>
struct Vec;
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ void put(float* d, const float2& v) {
  d[0] = v.x;
  d[1] = v.y;
}
__device__ __forceinline__ void put(float* d, const float4& v) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// global -> shared without registers; 16 bytes bypass L1 (read once),
// 8 bytes (bs = 8) go through it
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
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

template <int BS>
struct Shape {
  static constexpr int kSplit = BS >= 32 ? BS / 8 : 4;  // lanes per row
  static constexpr int kCols = BS / kSplit;       // columns a thread holds
  static constexpr int kVec = kCols < 4 ? kCols : 4;    // floats per copy
  static constexpr int kChunks = kCols / kVec;    // copies per fragment
  static constexpr int kRows = 32 / kSplit;       // target rows per warp
  static constexpr int kWarpsPerRb = BS / kRows;
};

// One ring entry of one warp: lane l's P fragment in p[k][l], and the
// slot's source segment (bs rows of d floats) as it lies in y.
template <int BS, int D>
struct Stage {
  using VT = typename Vec<Shape<BS>::kVec>::T;
  VT p[Shape<BS>::kChunks][32];
  float4 y[BS * D / 4];
};

template <int BS, int D>
__global__ void __launch_bounds__(kWarps * 32)
    tsne_force_kernel(const float* __restrict__ p_vals,
                      const int* __restrict__ col_idx,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ y, float* __restrict__ f,
                      int n_rb, int nbr) {
  using S = Shape<BS>;
  using VT = typename Vec<S::kVec>::T;
  __shared__ Stage<BS, D> ring[kWarps][kStages];
  const long long gw = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const long long rb = gw / S::kWarpsPerRb;
  if (rb >= n_rb) return;                        // the whole warp
  const int lane = threadIdx.x & 31;
  const int t = (int)(gw % S::kWarpsPerRb) * S::kRows + lane / S::kSplit;
  const int l = lane % S::kSplit;
  Stage<BS, D>* my = ring[threadIdx.x / 32];
  const float* tiles = p_vals + rb * nbr * BS * BS;
  KeptSlots kept(mask == nullptr ? nullptr : mask + rb * nbr,
                 col_idx + rb * nbr, nbr);

  // stage kept slot s (column block c) into ring entry e
  auto issue = [&](int e, int s, int c) {
    const VT* prow =
        reinterpret_cast<const VT*>(tiles + ((long long)s * BS + t) * BS);
#pragma unroll
    for (int k = 0; k < S::kChunks; ++k)
      cp_async(&my[e].p[k][lane], prow + l + k * S::kSplit);
    const float4* seg =
        reinterpret_cast<const float4*>(y + (long long)c * BS * D);
    for (int i = lane; i < BS * D / 4; i += 32)
      cp_async(&my[e].y[i], seg + i);
  };

  float yt[D], acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    yt[e] = __ldg(y + (rb * BS + t) * D + e);
    acc[e] = 0.f;
  }

  int issued = 0;
#pragma unroll
  for (int e = 0; e < kStages - 1; ++e) {
    int c;
    const int s = kept.next(&c);
    if (s >= 0) {
      issue(e, s, c);
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
    __syncwarp();                                // and every lane's copies
    const Stage<BS, D>& st = my[k % kStages];
    const VT* ys = reinterpret_cast<const VT*>(st.y);
    float p[S::kCols], yj[S::kCols * D];
#pragma unroll
    for (int k2 = 0; k2 < S::kChunks; ++k2) {
      const int v = l + k2 * S::kSplit;          // vector of the row
      put(&p[k2 * S::kVec], st.p[k2][lane]);
#pragma unroll
      for (int e = 0; e < D; ++e)                // kVec columns x D floats
        put(&yj[k2 * S::kVec * D + e * S::kVec], ys[v * D + e]);
    }
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) {
      float diff[D];
      float d2 = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) {
        diff[e] = yt[e] - yj[j * D + e];
        d2 = fmaf(diff[e], diff[e], d2);
      }
      const float w = p[j] * __frcp_rn(1.f + d2);
#pragma unroll
      for (int e = 0; e < D; ++e) acc[e] = fmaf(w, diff[e], acc[e]);
    }
    __syncwarp();                                // entry consumed
  }

  // the split lanes of one row are contiguous and never straddle a warp
#pragma unroll
  for (int o = S::kSplit >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int e = 0; e < D; ++e)
      acc[e] += __shfl_xor_sync(kFull, acc[e], o);
  }
  if (l == 0) {
#pragma unroll
    for (int e = 0; e < D; ++e) f[(rb * BS + t) * D + e] = acc[e];
  }
}

template <int BS, int D>
int launch_bsd(const float* p_vals, const int* col_idx,
               const unsigned char* mask, const float* y, float* f, int n_rb,
               int nbr, cudaStream_t stream) {
  const long long warps = (long long)n_rb * Shape<BS>::kWarpsPerRb;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  tsne_force_kernel<BS, D><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      p_vals, col_idx, mask, y, f, n_rb, nbr);
  return (int)cudaGetLastError();
}

template <int BS>
int launch_bs(const float* p_vals, const int* col_idx,
              const unsigned char* mask, const float* y, float* f, int n_rb,
              int nbr, int d, cudaStream_t stream) {
  switch (d) {
    case 1:
      return launch_bsd<BS, 1>(p_vals, col_idx, mask, y, f, n_rb, nbr,
                               stream);
    case 2:
      return launch_bsd<BS, 2>(p_vals, col_idx, mask, y, f, n_rb, nbr,
                               stream);
    case 3:
      return launch_bsd<BS, 3>(p_vals, col_idx, mask, y, f, n_rb, nbr,
                               stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch(const float* p_vals, const int* col_idx, const unsigned char* mask,
           const float* y, float* f, int n_rb, int nbr, int bs, int d,
           cudaStream_t stream) {
  if (n_rb == 0) return (int)cudaSuccess;
  switch (bs) {
    case 8:
      return launch_bs<8>(p_vals, col_idx, mask, y, f, n_rb, nbr, d, stream);
    case 16:
      return launch_bs<16>(p_vals, col_idx, mask, y, f, n_rb, nbr, d,
                           stream);
    case 32:
      return launch_bs<32>(p_vals, col_idx, mask, y, f, n_rb, nbr, d,
                           stream);
    case 64:
      return launch_bs<64>(p_vals, col_idx, mask, y, f, n_rb, nbr, d,
                           stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// p_vals (n_rb, nbr, bs, bs) f32; col_idx (n_rb, nbr) i32; nbr_mask
// (n_rb, nbr) one byte per slot, nonzero = kept, or null (every slot
// kept); y (n_cb*bs, d) f32 with n_cb >= n_rb; f (n_rb*bs, d) f32.
// bs in {8, 16, 32, 64}, d in {1, 2, 3}; p_vals and y 16-byte aligned.
// The kept slots' col_idx must lie in [0, n_cb).
extern "C" int repro_tsne_force(const void* p_vals, const void* col_idx,
                                const void* nbr_mask, const void* y, void* f,
                                int n_rb, int nbr, int bs, int d,
                                void* stream) {
  return launch((const float*)p_vals, (const int*)col_idx,
                (const unsigned char*)nbr_mask, (const float*)y, (float*)f,
                n_rb, nbr, bs, d, (cudaStream_t)stream);
}
