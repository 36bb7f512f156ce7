"""B6's forward in the traced steps: 2 bq bk (dh + dv) FLOPs a selected
tile pair, n_sel pairs a query tile (masked pairs counted), per launch,
at 989 TFLOP/s, over the forward kernels' device seconds."""
from perfbench.harness import counts, trace
from perfbench.harness.b6 import launch_pairs


def read(rec):
    tr = rec.get("trace")
    if not tr or rec.get("train_tokens_per_s") is None:
        return None
    sec, launches = trace.kernel_seconds(tr, ("block_attention",))
    if not launches:
        return None
    pairs, bq, bk, dh, dv = launch_pairs(rec)
    flops = counts.b6_fwd_flops(pairs, bq, bk, dh, dv) * launches
    return 100.0 * flops / counts.PEAK_BF16_FLOPS / sec
