"""llava-next-34b [vlm]: transformer backbone only (anyres patch frontend is a
stub; input_specs supplies precomputed patch+text embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ClusterKVConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    embedding_inputs=True,
    clusterkv=ClusterKVConfig(enabled=True),
    long_context="clusterkv",
    loss_chunk=8192,
)

REDUCED = ModelConfig(
    name="llava-next-34b-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    embedding_inputs=True,
    remat=False,
)
