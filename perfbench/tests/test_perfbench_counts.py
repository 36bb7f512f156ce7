"""The frozen arithmetic reproduces PERF.md section 6's own figures and
the program's analytic model-FLOP forms."""
import math

import pytest

from perfbench.harness import counts, registry


def test_b1_bound_at_the_sift_plan():
    # 95 291 kept tiles of 32 x 32, 8 192 row blocks of ELL width 47,
    # n = 262 144 charges of 8 columns: 0.12197888 ms at 3.35 TB/s
    s = counts.b1_bound_s(95291, 32, 8192, 47, 262144, 8)
    assert s * 1e3 == pytest.approx(0.12197888, rel=1e-12)
    s1 = counts.b1_bound_s(95291, 32, 8192, 47, 262144, 1)
    assert s1 * 1e3 == pytest.approx(0.11759677134328358, rel=1e-9)


def test_b6_backward_at_qwen_and_minicpm3():
    # Qwen2-0.5B: batch 8, 14 heads, 32 query tiles, 16 kept, dh 64
    pairs = 8 * 14 * 32 * 16
    assert counts.b6_bwd_flops(pairs, 128, 128, 64, 64) \
        == pytest.approx(601.3e9, rel=1e-4)
    assert counts.b6_bwd_flops(pairs, 128, 128, 64, 64) / 989e12 * 1e3 \
        == pytest.approx(0.6079832370475228, rel=1e-12)
    # minicpm3: batch 1, 40 heads, q/k 96, v 64
    assert counts.b6_bwd_flops(40 * 32 * 16, 128, 128, 96, 64) / 989e12 \
        * 1e3 == pytest.approx(0.28227793148634983, rel=1e-12)
    assert counts.b6_fwd_flops(1, 128, 128, 96, 64) == 2 * 128 * 128 * 160


@pytest.mark.parametrize("seq", [2048, 8192])
def test_model_flops_follow_the_analytic_forms(seq):
    from repro_torch.launch import analytic
    from repro_torch.models import model_api
    from repro_torch.models.param import count_params
    from perfbench.drivers.train import program_config

    m = registry.config("minicpm3-4b")
    cfg = program_config(m)
    assert counts.attention_pairs_flops(m, seq) == pytest.approx(
        analytic._attn_flops_per_layer(cfg, seq, "clusterkv"), rel=1e-12)
    c = registry.arch(m["architecture"]).param_counts(m)
    total = count_params(model_api.param_shapes(cfg))
    assert (m["num_hidden_layers"] * c["layer"] + c["embedding"]
            + c["head"] + c["final_norm"]) == total
    dense = total - c["embedding"]
    want = 6.0 * dense * 2 * seq + 3.0 * 2 * m["num_hidden_layers"] \
        * analytic._attn_flops_per_layer(cfg, seq, "clusterkv")
    assert counts.model_flops_per_step(m, 2, seq) == pytest.approx(want)
    assert math.isfinite(want)
