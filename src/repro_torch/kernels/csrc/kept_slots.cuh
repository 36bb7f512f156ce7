// The warp-uniform walk over the kept ELL slots of one row block, shared
// by the kernels that read an ELL-BSR tile tensor through its nbr_mask
// (bsr_spmv.cu: B1/B2; tsne_force.cu: B4).
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr unsigned kFull = 0xffffffffu;

// Warp-uniform walk over the kept slots of one row block, in slot order.
// Every lane of the warp must call next() together. Lane l holds the mask
// bit and column block of slot base + l of the current 32-slot chunk, and
// those of the next chunk, loaded one chunk ahead.
struct KeptSlots {
  const unsigned char* mask;   // nullptr: every slot is kept
  const int* cols;
  int nbr, base;
  unsigned bits;               // kept slots of this chunk not handed out yet
  int col, next_col;
  bool next_kept;

  __device__ void fetch(int first, bool& kept, int& c) const {
    const int s = first + (int)(threadIdx.x & 31);
    kept = s < nbr && (mask == nullptr || __ldg(mask + s) != 0);
    c = kept ? __ldg(cols + s) : 0;
  }

  __device__ KeptSlots(const unsigned char* m, const int* c, int n)
      : mask(m), cols(c), nbr(n), base(0) {
    bool kept;
    fetch(0, kept, col);
    fetch(32, next_kept, next_col);
    bits = __ballot_sync(kFull, kept);
  }

  // The next kept slot (its column block in *c), or -1 after the last.
  __device__ int next(int* c) {
    while (bits == 0) {
      base += 32;
      if (base >= nbr) return -1;
      col = next_col;
      bits = __ballot_sync(kFull, next_kept);
      fetch(base + 32, next_kept, next_col);
    }
    const int b = __ffs(bits) - 1;
    bits &= bits - 1;
    *c = __shfl_sync(kFull, col, b);
    return base + b;
  }
};

}  // namespace repro
