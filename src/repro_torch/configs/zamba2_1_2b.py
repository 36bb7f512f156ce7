"""zamba2-1.2b [hybrid]: 38 mamba2 layers + a SHARED attention block applied
every 6 layers on concat(h, x_emb). [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ClusterKVConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(version=2, d_state=64, head_dim=64, expand=2, chunk=256),
    shared_attn_every=6,
    clusterkv=ClusterKVConfig(enabled=True),
    long_context="ssm",
    loss_chunk=8192,
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-reduced",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    ssm=SSMConfig(version=2, d_state=16, head_dim=16, expand=2, chunk=32),
    shared_attn_every=2,
    remat=False,
)
