"""falcon-mamba-7b [ssm]: attention-free mamba1. [arXiv:2410.05355; unverified]
d_inner = 2*d_model = 8192, dt_rank = d_model/16 = 256."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    ssm=SSMConfig(version=1, d_state=16, d_conv=4, expand=2, dt_rank=256),
    long_context="ssm",
    loss_chunk=8192,
)

REDUCED = ModelConfig(
    name="falcon-mamba-7b-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=256,
    ssm=SSMConfig(version=1, d_state=8, d_conv=4, expand=2, dt_rank=8),
    remat=False,
)
