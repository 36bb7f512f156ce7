"""minicpm3-4b [dense]: Multi-head Latent Attention (MLA).
[hf:openbmb/MiniCPM3-4B; hf]  MLA dims from the public HF config."""
from repro_torch.configs.base import ClusterKVConfig, MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    d_head=64,
    clusterkv=ClusterKVConfig(enabled=True),
    long_context="clusterkv",
    loss_chunk=8192,
)

REDUCED = ModelConfig(
    name="minicpm3-4b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    mla=MLAConfig(
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_head_dim=8,
        qk_rope_head_dim=4,
        v_head_dim=8,
    ),
    d_head=8,
    remat=False,
)
