"""Model configs of the port: the dataclasses, input shapes and the registry.

A copy of the reference's ``configs/base.py`` (the port imports nothing of
the reference) with two fields renamed for the port:

* ``ClusterKVConfig.use_pallas`` is ``use_kernel``. The device picks the
  path: a CUDA tensor launches the hand-written CUDA kernel, a CPU tensor
  takes its plain version (the kernel has no CPU mode). ``"auto"`` and
  ``True`` mean just that; ``False`` asks for the plain version and raises
  on a CUDA tensor.
* ``ClusterKVConfig.decode_backend`` names ``"cuda"`` (the counterpart of
  the reference's ``"pallas"``; its plain version on a CPU tensor),
  ``"plain"`` (of ``"xla"``; CPU tensors only, it raises on a CUDA
  tensor) or ``"auto"`` (``"cuda"`` on a CUDA tensor and ``"plain"`` on
  the CPU).

``convert.config_from_reference`` carries both across as ``"auto"``. Only
the architectures whose family is ported are known to :func:`get_config`;
any other id raises with its ROADMAP item.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple, Union

# name -> (seq_len, global_batch, kind), as in the reference
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    router_jitter: float = 0.0
    expert_parallel: bool = False
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    version: int = 1
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    head_dim: int = 64
    chunk: int = 256


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class ClusterKVConfig:
    """The paper's technique as an attention backend (see core/clusterkv.py)."""
    enabled: bool = False
    embed_dim: int = 3                 # PCA embedding dim (paper: d = 1..3)
    block_q: int = 128                 # query tile
    block_k: int = 128                 # key tile
    blocks_per_query: int = 16         # top-B key blocks kept per query block
    local_window_blocks: int = 1       # always-kept local diagonal blocks
    decode_clusters: int = 16          # top-c clusters gathered at decode
    use_kernel: Union[bool, str] = "auto"   # kernels/block_attention for
                                       # the tiles: "auto" | True | False
    decode_backend: str = "auto"       # plan-decode attend: "plain" | "cuda"
                                       # | "auto"

    def __post_init__(self):
        if self.use_kernel not in (True, False, "auto"):
            raise ValueError(f"use_kernel must be True, False or 'auto', got "
                             f"{self.use_kernel!r}")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                    # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    swa_window: int = 0                # sliding-window attention; 0 = full
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    shared_attn_every: int = 0
    n_enc_layers: int = 0
    embedding_inputs: bool = False
    clusterkv: ClusterKVConfig = field(default_factory=ClusterKVConfig)
    optimizer: str = "adamw"
    remat: bool = True
    remat_policy: str = "full"
    loss_chunk: int = 0
    dtype: str = "bfloat16"            # compute dtype
    param_dtype: str = "float32"       # master param dtype
    long_context: str = "clusterkv"

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    def with_(self, **kw: Any) -> "ModelConfig":
        return replace(self, **kw)


# ported architectures -> config module (the reference's order); every
# other id of the reference waits for its ROADMAP item
ARCH_IDS = [
    "llava-next-34b",
    "qwen2-0.5b",
    "minicpm3-4b",
    "h2o-danube-3-4b",
    "mistral-large-123b",
    "llama4-maverick-400b-a17b",
    "granite-moe-3b-a800m",
]
_MOD_FOR: Dict[str, str] = {a: a.replace("-", "_").replace(".", "_")
                            for a in ARCH_IDS}
_NOT_PORTED: Dict[str, str] = {
    "falcon-mamba-7b": "A13b", "whisper-medium": "A13b",
    "zamba2-1.2b": "A13b",
}


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"config {arch_id!r} is not ported to repro_torch yet (port "
            f"queue item {_NOT_PORTED[arch_id]} in ROADMAP.md)")
    if arch_id not in _MOD_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MOD_FOR[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def reduced_config(arch_id: str) -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _module(arch_id).REDUCED


def cells(arch_id: str):
    """Yield the (shape_name, seq, batch, kind) cells assigned to this arch."""
    cfg = get_config(arch_id)
    for name, (seq, batch, kind) in SHAPES.items():
        if name == "long_500k" and cfg.long_context == "skip":
            continue
        yield name, seq, batch, kind


def all_cells():
    for a in ARCH_IDS:
        for c in cells(a):
            yield (a,) + c
