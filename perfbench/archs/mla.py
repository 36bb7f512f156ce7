"""Architecture ``mla``: a decoder with multi-head latent attention
(MiniCPM3, DeepSeek-V2's attention with a dense MLP), in the keys of its
Hugging Face configuration.

A language-model configuration names its architecture (``architecture``)
and its plain reference (``reference``); the training driver and the
metric readers find this module by that name and hold no architecture of
their own. An architecture module supplies:

    program_config(m, common)  the program's ``ModelConfig``; ``common``
                               holds the keywords every architecture shares
                               (ClusterKV, optimizer, remat, precision)
    leaves(m)                  (path, shape, kind) of every parameter, named
                               as the program's parameter tree names them;
                               kind is ``"ones"``, ``"linear"`` or
                               ``"embedding"`` (``harness/weights.leaf``)
    param_counts(m)            parameters of a layer, of the embedding
                               table, of the head and of the final norm
    attention_dims(m)          (heads, q/k head size, v head size) of the
                               attention that B6 runs
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str]


def program_config(m: Dict[str, Any], common: Dict[str, Any]):
    from repro_torch.configs.base import MLAConfig, ModelConfig
    return ModelConfig(
        name=m["name"], family="dense", n_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
        vocab=m["vocab_size"], d_head=m["v_head_dim"],
        rope_theta=m["rope_theta"], norm_eps=m["rms_norm_eps"],
        tie_embeddings=m["tie_word_embeddings"],
        mla=MLAConfig(q_lora_rank=m["q_lora_rank"],
                      kv_lora_rank=m["kv_lora_rank"],
                      qk_nope_head_dim=m["qk_nope_head_dim"],
                      qk_rope_head_dim=m["qk_rope_head_dim"],
                      v_head_dim=m["v_head_dim"]),
        **common)


def leaves(m: Dict[str, Any]) -> List[Leaf]:
    L, d = m["num_hidden_layers"], m["hidden_size"]
    h = m["num_attention_heads"]
    qr, kr = m["q_lora_rank"], m["kv_lora_rank"]
    dn, dr, dv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                  m["v_head_dim"])
    f, v = m["intermediate_size"], m["vocab_size"]
    lay = ("layers",)
    return [
        (("embed", "table"), (v, d), "embedding"),
        (lay + ("ln1", "scale"), (L, d), "ones"),
        (lay + ("ln2", "scale"), (L, d), "ones"),
        (lay + ("attn", "q_a", "w"), (L, d, qr), "linear"),
        (lay + ("attn", "q_ln", "scale"), (L, qr), "ones"),
        (lay + ("attn", "q_b", "w"), (L, qr, h * (dn + dr)), "linear"),
        (lay + ("attn", "kv_a", "w"), (L, d, kr + dr), "linear"),
        (lay + ("attn", "kv_ln", "scale"), (L, kr), "ones"),
        (lay + ("attn", "kv_b", "w"), (L, kr, h * (dn + dv)), "linear"),
        (lay + ("attn", "wo", "w"), (L, h * dv, d), "linear"),
        (lay + ("ffn", "wg", "w"), (L, d, f), "linear"),
        (lay + ("ffn", "wu", "w"), (L, d, f), "linear"),
        (lay + ("ffn", "wd", "w"), (L, f, d), "linear"),
        (("ln_f", "scale"), (d,), "ones"),
        (("head", "w"), (d, v), "linear"),
    ]


def param_counts(m: Dict[str, Any]) -> Dict[str, int]:
    d, h = m["hidden_size"], m["num_attention_heads"]
    qr, kr = m["q_lora_rank"], m["kv_lora_rank"]
    dn, dr, dv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                  m["v_head_dim"])
    attn = (d * qr + qr + qr * h * (dn + dr) + d * (kr + dr) + kr
            + kr * h * (dn + dv) + h * dv * d)
    mlp = 3 * d * m["intermediate_size"]
    layer = attn + mlp + 2 * d
    v = m["vocab_size"]
    return {"layer": layer, "embedding": v * d, "head": d * v,
            "final_norm": d}


def attention_dims(m: Dict[str, Any]) -> Tuple[int, int, int]:
    return (m["num_attention_heads"],
            m["qk_nope_head_dim"] + m["qk_rope_head_dim"], m["v_head_dim"])
