"""Model FLOPs of the window's steps (6 x every parameter but the
embedding table x tokens, plus attention over the selected tile pairs,
forward and backward; remat's recompute not counted) over the window at
989 TFLOP/s (bf16)."""
from perfbench.harness import counts


def read(rec):
    if rec.get("train_tokens_per_s") is None:
        return None
    sh = rec["shape"]
    flops = counts.model_flops_per_step(rec["model"], sh["batch"],
                                        sh["seq"]) * rec["units"]
    return 100.0 * flops / rec["window_s"] / counts.PEAK_BF16_FLOPS
