"""llama4-maverick-400b-a17b [moe]: MoE 128 experts top-1 + 1 shared expert,
early fusion (text path only here). [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
A copy of the reference's config (its optimizer and parameter dtype are the
reference's choices for its trainer)."""
from repro_torch.configs.base import ClusterKVConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared_experts=1),
    clusterkv=ClusterKVConfig(enabled=True),
    long_context="clusterkv",
    optimizer="adafactor",
    param_dtype="bfloat16",
    loss_chunk=4096,
)

REDUCED = ModelConfig(
    name="llama4-maverick-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128, n_shared_experts=1),
    remat=False,
)
