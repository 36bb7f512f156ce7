"""qwen2-0.5b [dense]: GQA with QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ClusterKVConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    clusterkv=ClusterKVConfig(enabled=True),
    long_context="clusterkv",
    loss_chunk=8192,
)

REDUCED = ModelConfig(
    name="qwen2-0.5b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    tie_embeddings=True,
    remat=False,
)
