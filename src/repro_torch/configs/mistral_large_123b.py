"""mistral-large-123b [dense]: 123B dense GQA.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
A copy of the reference's config (its optimizer and parameter dtype are the
reference's choices for its trainer)."""
from repro_torch.configs.base import ClusterKVConfig, ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    clusterkv=ClusterKVConfig(enabled=True),
    long_context="clusterkv",
    optimizer="adafactor",
    param_dtype="bfloat16",
    loss_chunk=8192,
)

REDUCED = ModelConfig(
    name="mistral-large-123b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    remat=False,
)
