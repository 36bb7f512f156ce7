"""A whole run, with the look for a card skipped and the timed path broken
underneath, must come out not correct: once for each fault the cell can
have (an answer altered where it is produced; half of the batch left out;
a training step that returns its state unchanged, or moves it double)."""
import pytest
import torch

from perfbench.tests import tiny


def _broken_matvec(monkeypatch, how):
    from repro_torch import api
    orig = api.InteractionPlan.matvec

    def matvec(self, x, *a, **kw):
        y = orig(self, x, *a, **kw)
        if how == "altered":
            return y * 1.25
        y = y.clone()
        y[:, y.shape[1] // 2:] = 0.0
        return y
    monkeypatch.setattr(api.InteractionPlan, "matvec", matvec)


@pytest.mark.parametrize("how", ["altered", "half_batch"])
def test_matvec_fault_is_caught(monkeypatch, how):
    _broken_matvec(monkeypatch, how)
    res, _ = tiny.run("sift-262k.matvec8", tiny.SIFT)
    assert not res["correct"] and res["failed"] > 0


def test_build_fault_is_caught(monkeypatch):
    # the plan's pattern altered where it is produced: every row's k-th
    # neighbor replaced by its (k+1)-th
    from repro_torch.core import knn
    orig = knn.knn_coo

    def knn_coo(t, s, k, *a, **kw):
        r, c, d = orig(t, s, k + 1, *a, **kw)
        keep = torch.ones(r.numel(), dtype=torch.bool)
        keep[k - 1::k + 1] = False
        return r[keep], c[keep], d[keep]
    monkeypatch.setattr(knn, "knn_coo", knn_coo)
    res, _ = tiny.run("sift-262k.build", tiny.SIFT)
    assert not res["correct"] and res["failed"] > 0


def _broken_step(monkeypatch, how):
    from repro_torch.train import trainer
    orig = trainer.make_train_step

    def make(cfg, mesh=None, backend="flash", microbatch=1, **kw):
        step, opt = orig(cfg, mesh, backend, microbatch, **kw)
        if how == "half_batch":
            half, _ = orig(cfg, mesh, backend, max(microbatch // 2, 1), **kw)

            def run(params, state, batch):
                rows = batch["tokens"].shape[0] // 2
                return half(params, state,
                            {k: v[:rows] for k, v in batch.items()})
            return run, opt
        if how == "unchanged":
            def run(params, state, batch):
                saved = [p.clone() for p in _leaves(params)]
                params, state, met = step(params, state, batch)
                for p, s in zip(_leaves(params), saved):
                    p.copy_(s)
                return params, state, met
            return run, opt

        def run(params, state, batch):          # "double": moved twice
            saved = [p.clone() for p in _leaves(params)]
            params, state, met = step(params, state, batch)
            for p, s in zip(_leaves(params), saved):
                p.add_(p - s)
            return params, state, met
        return run, opt
    monkeypatch.setattr(trainer, "make_train_step", make)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("how", ["half_batch", "unchanged", "double"])
def test_train_fault_is_caught(monkeypatch, how):
    _broken_step(monkeypatch, how)
    res, checks = tiny.run("minicpm3-4b.train8k", tiny.MLA)
    assert not res["correct"], checks
