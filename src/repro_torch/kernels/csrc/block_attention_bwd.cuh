// What block_attention_bwd.cu's entries hand its kernels, and the Hopper
// kernels of block_attention_bwd_sm90.cu that take the bf16 instances at
// tiles of 128.
#pragma once

#include <cuda_runtime.h>

namespace repro {

struct BwdArgs {
  const void *q, *k, *v, *kpos, *qpos, *idx, *out, *stats, *dout, *dsum,
      *off, *ent, *order;
  void *dq, *dk, *dv, *dsum_out;
  int b, hq, hkv, s, s_k, n_sel, causal;
  cudaStream_t stream;
};

// bf16, bq = bk = 128, (dh, dv) in {(64, 64), (128, 128), (96, 64)}: the
// dQ kernel (which writes D) and the dK/dV kernel; cudaErrorInvalidValue
// for another (dh, dv)
int bwd_dq_sm90(const BwdArgs& a, int dh, int dv);
int bwd_dkv_sm90(const BwdArgs& a, int dh, int dv);

}  // namespace repro
