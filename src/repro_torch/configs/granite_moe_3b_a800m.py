"""granite-moe-3b-a800m [moe]: 40 experts top-8, tiny expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ClusterKVConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
    clusterkv=ClusterKVConfig(enabled=True),
    long_context="clusterkv",
    loss_chunk=8192,
)

REDUCED = ModelConfig(
    name="granite-moe-3b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab=256,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
    remat=False,
)
