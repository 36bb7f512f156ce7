"""B6's backward in the traced steps: 2 bq bk (3 dh + 2 dv) FLOPs a
selected tile pair (what the gradient needs), per backward (one dQ launch
each), at 989 TFLOP/s, over the device seconds of its key-tile lists and
order, dQ and dK/dV kernels."""
from perfbench.harness import counts, trace
from perfbench.harness.b6 import BWD_KERNELS, DQ_KERNELS, launch_pairs


def read(rec):
    tr = rec.get("trace")
    if not tr or rec.get("train_tokens_per_s") is None:
        return None
    sec, _ = trace.kernel_seconds(tr, BWD_KERNELS)
    _, backwards = trace.kernel_seconds(tr, DQ_KERNELS)
    if not backwards:
        return None
    pairs, bq, bk, dh, dv = launch_pairs(rec)
    flops = counts.b6_bwd_flops(pairs, bq, bk, dh, dv) * backwards
    return 100.0 * flops / counts.PEAK_BF16_FLOPS / sec
