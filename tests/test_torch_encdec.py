"""The Whisper-style encoder-decoder (ROADMAP A13b) against the reference,
and its standing caveat C38: after ``grow_cache`` the decoder's cross
attention attends the zero-padded encoder positions, in both packages.

The reference's float32 parameters of the reduced whisper-medium cross
over by ``convert.params_from_reference``; frames and tokens are made from
a seed with numpy. Tolerances: the encoder output and hidden states
``rtol 1e-5`` with ``atol 1e-4``; logits within ``1e-4 x max|logits|``
and caches within ``1e-4``, as the A13a zoo; teacher forcing ``2e-3``, as
the reference's ``tests/test_models.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, tn

from repro.configs import base as r_base
from repro.models import encdec as r_ed
from repro.models import model_api as r_api
from repro.models.sharding import NO_SHARD
from repro_torch import convert as t_convert
from repro_torch.configs import base as t_base
from repro_torch.models import encdec as t_ed
from repro_torch.models import model_api as t_api
from repro_torch.models import param as t_pm

ARCH = "whisper-medium"
SEQ, FRAMES, STEPS = 24, 40, 3
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def whisper():
    rcfg = r_base.reduced_config(ARCH).with_(dtype="float32")
    rp, _ = r_api.init(rcfg, jax.random.PRNGKey(4))
    tcfg = t_convert.config_from_reference(rcfg)
    tp = t_convert.params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                         device="cpu")
    return rcfg, rp, tcfg, tp


def _batch(cfg, seed, b=2, s=SEQ, frames=FRAMES):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((b, frames, cfg.d_model)).astype(
                np.float32),
            "tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close_logits(port, ref):
    ref = tn(ref)
    np.testing.assert_allclose(tn(port), ref, rtol=0,
                               atol=LOGIT_TOL * float(np.abs(ref).max()))


def test_config_cells_and_params_match_the_reference(whisper):
    rcfg, rp, tcfg, tp = whisper
    for ref, ours in ((r_base.get_config(ARCH), t_base.get_config(ARCH)),
                      (r_base.reduced_config(ARCH),
                       t_base.reduced_config(ARCH))):
        assert t_convert.config_from_reference(ref) == ours
    assert list(t_base.cells(ARCH)) == list(r_base.cells(ARCH))
    assert all(c[0] != "long_500k" for c in t_base.cells(ARCH))
    assert t_api.module_for(tcfg) is t_ed
    own = t_api.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert t_pm.tree_map(lambda t: tuple(t.shape), own) == \
        t_pm.tree_map(lambda t: tuple(t.shape), tp)


def test_mlp_gelu_is_the_tanh_approximation(whisper):
    """``jax.nn.gelu`` defaults to the tanh form; PyTorch's to erf."""
    rcfg, rp, tcfg, tp = whisper
    x = np.random.default_rng(5).standard_normal(
        (2, 7, rcfg.d_model)).astype(np.float32) * 3
    lr = jax.tree.map(lambda a: a[0], rp["dec"]["mlp"])
    lt = t_pm.layer(tp["dec"], 0)["mlp"]
    assert_close(t_ed._mlp_apply(lt, torch.from_numpy(x)),
                 r_ed._mlp_apply(lr, jnp.asarray(x)))


@pytest.mark.parametrize("backend", ["flash", "dense"])
def test_encode_and_forward_match_the_reference(whisper, backend):
    rcfg, rp, tcfg, tp = whisper
    rb, tb = _both(_batch(rcfg, 6))
    assert_close(t_ed.encode(tp, tcfg, tb["frames"], backend),
                 r_ed.encode(rp, rcfg, rb["frames"], NO_SHARD, backend),
                 atol=1e-4)
    rh, _ = r_ed.forward(rp, rcfg, rb, NO_SHARD, backend)
    th, aux = t_ed.forward(tp, tcfg, tb, backend)
    assert_close(th, rh, atol=1e-4)
    assert float(aux) == 0.0


@pytest.mark.parametrize("backend", ["flash", "dense", "clusterkv"])
def test_prefill_then_decode_matches_the_reference(whisper, backend):
    """``prefill`` of 24 tokens over 40 frames (the four caches leaf for
    leaf, the logits), then 3 ``decode_step``s in caches grown to 64: the
    cross caches grow too, and both packages attend their zero rows
    (C38). Whisper's attention has no ClusterKV path: ``clusterkv`` runs
    flash, in both packages."""
    rcfg, rp, tcfg, tp = whisper
    rb, tb = _both(_batch(rcfg, 7))
    rc, rl = r_ed.prefill(rp, rcfg, rb, NO_SHARD, backend)
    tc, tl = t_ed.prefill(tp, tcfg, tb, backend)
    _close_logits(tl, rl)
    assert sorted(tc) == sorted(rc) == ["k", "pos", "v", "xk", "xv"]
    for key in ("k", "v", "xk", "xv"):
        assert_close(tc[key], rc[key], atol=1e-4)
    rc, tc = r_api.grow_cache(rcfg, rc, 64), t_api.grow_cache(tcfg, tc, 64)
    assert tuple(tc["xk"].shape)[3] == rc["xk"].shape[3] == 64
    nxt = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    for _ in range(STEPS):
        rl, rc = r_ed.decode_step(rp, rcfg, rc, jnp.asarray(nxt), NO_SHARD,
                                  backend)
        tl, tc = t_ed.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                  backend)
        _close_logits(tl, rl)
        nxt = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    for key in ("k", "v", "xk", "xv"):
        assert_close(tc[key], rc[key], atol=1e-4)
    assert int(tc["pos"]) == int(rc["pos"]) == SEQ + STEPS


def test_decode_matches_prefill_in_float32(whisper):
    """Teacher forcing, the reference's ``tests/test_models.py`` case in
    the port: the encoder input stays whole, the decoder drops its last
    token and decodes it; the cross caches are as long as the frames, so
    ``grow_cache`` pads the self caches only."""
    rcfg, rp, tcfg, tp = whisper
    s = 32
    _, tb = _both(_batch(rcfg, 8, s=s, frames=s))
    _, full = t_ed.prefill(tp, tcfg, tb, "dense")
    short = dict(tb, tokens=tb["tokens"][:, :s - 1])
    cache, _ = t_ed.prefill(tp, tcfg, short, "dense")
    grown = t_api.grow_cache(tcfg, cache, s)
    assert grown["xk"] is cache["xk"] and grown["k"].shape[3] == s
    lg, _ = t_ed.decode_step(tp, tcfg, grown, tb["tokens"][:, s - 1:],
                             "dense")
    np.testing.assert_allclose(tn(lg), tn(full), rtol=2e-3, atol=2e-3)


def test_cache_seq_axes_match_the_reference():
    """All four caches scale with the cache length, the cross caches
    included (why ``grow_cache`` pads them, C38)."""
    tcfg = t_base.reduced_config(ARCH)
    assert t_api.cache_seq_axes(tcfg) == \
        r_api.cache_seq_axes(r_base.reduced_config(ARCH)) == \
        {"k": 3, "v": 3, "xk": 3, "xv": 3}


def test_decode_attends_the_padded_cross_positions_as_the_reference(
        whisper):
    """ROADMAP C38. After ``grow_cache`` to ``prompt + gen`` the cross
    caches hold ``gen`` zero rows past the frames, and ``decode_step``
    attends every cross position: its logits equal the reference's on the
    same padded caches, and differ from the same step over the unpadded
    cross caches (what a decoder that masked the padding would give)."""
    rcfg, rp, tcfg, tp = whisper
    rb, tb = _both(_batch(rcfg, 9))
    rc, rl = r_ed.prefill(rp, rcfg, rb, NO_SHARD, "flash")
    tc, _ = t_ed.prefill(tp, tcfg, tb, "flash")
    total = FRAMES + 16
    rg, tg = r_api.grow_cache(rcfg, rc, total), t_api.grow_cache(tcfg, tc,
                                                                 total)
    assert not tg["xk"][:, :, :, FRAMES:].any()
    nxt = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    want, _ = r_ed.decode_step(rp, rcfg, rg, jnp.asarray(nxt), NO_SHARD,
                               "flash")
    unpadded = dict(tg, k=tg["k"].clone(), v=tg["v"].clone(),
                    xk=tc["xk"], xv=tc["xv"])
    got, _ = t_ed.decode_step(tp, tcfg, tg, torch.from_numpy(nxt), "flash")
    _close_logits(got, want)
    masked, _ = t_ed.decode_step(tp, tcfg, unpadded, torch.from_numpy(nxt),
                                 "flash")
    gap = float((masked - got).abs().max())
    assert gap > 100 * LOGIT_TOL * float(got.abs().max())
