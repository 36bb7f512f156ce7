"""whisper-medium [audio]: enc-dec, conv frontend stubbed (input_specs gives
frame embeddings). 24 enc + 24 dec layers. [arXiv:2212.04356; unverified]
long_500k SKIPPED: 500k-frame audio exceeds the architecture's positional
design (see DESIGN.md §6)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    embedding_inputs=True,       # encoder takes precomputed frame embeddings
    long_context="skip",
    loss_chunk=8192,
)

REDUCED = ModelConfig(
    name="whisper-medium-reduced",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    embedding_inputs=True,
    long_context="skip",
    remat=False,
)
