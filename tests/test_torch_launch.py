"""``repro_torch.launch.serve``, the twin of the reference's
``launch/serve.py``: ``generate`` gives the tokens of the reference's
one-shot flow (``prefill``, ``model_api.grow_cache`` to ``prompt + gen``,
greedy ``decode_step``s), on the reduced configs in float32 with the
reference's parameters crossed over; ``main`` runs both of its branches on
the CPU."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.configs.base import ClusterKVConfig as RCKV
from repro.models import model_api as r_api
from repro.models.sharding import NO_SHARD
from repro_torch import convert as t_convert
from repro_torch.launch import serve as t_serve

PROMPT, GEN = 32, 6


def _reference_flow(cfg, params, batch, gen, backend):
    """The reference launcher's loop (``src/repro/launch/serve.py``), with
    its module called directly."""
    mod = r_api.module_for(cfg)
    cache, logits = mod.prefill(params, cfg, batch, NO_SHARD, backend)
    cache = r_api.grow_cache(cfg, cache, PROMPT + gen)
    toks = jnp.argmax(logits, -1)[:, None]
    outs = [toks]
    for _ in range(gen - 1):
        logits, cache = mod.decode_step(params, cfg, cache, toks, NO_SHARD,
                                        backend)
        toks = jnp.argmax(logits, -1)[:, None]
        outs.append(toks)
    return np.asarray(jnp.concatenate(outs, 1))


@pytest.mark.parametrize("arch,backend", [
    ("falcon-mamba-7b", "flash"), ("zamba2-1.2b", "flash"),
    ("zamba2-1.2b", "clusterkv"), ("whisper-medium", "flash"),
    ("qwen2-0.5b", "clusterkv")])
def test_generate_gives_the_reference_flow_tokens(arch, backend):
    rcfg = r_base.reduced_config(arch).with_(
        dtype="float32", clusterkv=RCKV(enabled=True, block_q=16,
                                        block_k=16, blocks_per_query=2,
                                        decode_clusters=2))
    rp, _ = r_api.init(rcfg, jax.random.PRNGKey(11))
    tcfg = t_convert.config_from_reference(rcfg)
    tp = t_convert.params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                         device="cpu")
    rng = np.random.default_rng(12)
    batch = {"tokens": rng.integers(0, rcfg.vocab, (2, PROMPT)).astype(
        np.int32)}
    if rcfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (2, PROMPT, rcfg.d_model)).astype(np.float32)
    want = _reference_flow(rcfg, rp, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                           GEN, backend)
    timings = {}
    got = t_serve.generate(tcfg, tp, {k: torch.from_numpy(v)
                                      for k, v in batch.items()},
                           GEN, backend, timings=timings)
    assert got.tolist() == want.tolist()
    assert timings["prefill_s"] > 0 and len(timings["step_s"]) == GEN - 1


def test_main_runs_the_one_shot_loop_and_the_service(capsys, tmp_path):
    out = t_serve.main(["--arch", "zamba2-1.2b", "--reduced",
                        "--prompt-len", "32", "--gen", "4", "--batch", "2",
                        "--backend", "clusterkv", "--device", "cpu"])
    assert tuple(out.shape) == (2, 4)
    text = capsys.readouterr().out
    assert "arch=zamba2-1.2b-reduced backend=clusterkv device=cpu" in text
    vlm = t_serve.main(["--arch", "llava-next-34b", "--reduced",
                        "--prompt-len", "16", "--gen", "3", "--batch", "1",
                        "--device", "cpu"])
    assert tuple(vlm.shape) == (1, 3)
    report_path = tmp_path / "report.json"
    report = t_serve.main(["--arch", "qwen2-0.5b", "--reduced",
                           "--service", "--slots", "2", "--batch", "3",
                           "--gen", "3", "--prompt-len", "40",
                           "--max-seq", "128", "--prefill-bucket", "32",
                           "--device", "cpu", "--report",
                           str(report_path)])
    assert json.loads(report_path.read_text()) == json.loads(
        json.dumps(report))
    # the ticks decode every token but each request's first (its prefill's)
    assert report["tokens_out"] == 3 * (3 - 1)
