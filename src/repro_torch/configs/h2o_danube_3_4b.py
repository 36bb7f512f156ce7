"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    swa_window=4096,
    long_context="swa",           # natively sub-quadratic
    loss_chunk=8192,
)

REDUCED = ModelConfig(
    name="h2o-danube-3-4b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    swa_window=32,
    remat=False,
)
