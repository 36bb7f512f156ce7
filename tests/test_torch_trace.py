"""``repro_torch.trace``: spans and counters inside the port, on the CPU.

The module's own rules (nesting, self time, one shared object when off,
the profiler's clock), then the spans and counters that the plan and
ClusterKV training record. The device side (kernels launched inside
their spans on a card) is in ``tests/test_torch_cuda.py``.
"""
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import api as t_api
from repro_torch import trace
from repro_torch.configs import base as t_base
from repro_torch.core import clusterkv as t_ckv
from repro_torch.models import attention as t_attn
from repro_torch.models import model_api as t_api_models
from repro_torch.train import trainer as t_tr


class _Ops(TorchDispatchMode):
    """Counts the tensor ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _names(rec):
    return [s.name for s in rec.spans]


def test_spans_nest_with_parent_root_and_self_time():
    with trace.recording() as rec:
        with trace.span("a"):
            with trace.span("b"):
                time.sleep(0.002)
            with trace.span("c"):
                with trace.span("d"):
                    time.sleep(0.001)
        with trace.span("e"):
            pass
    assert _names(rec) == ["a", "b", "c", "d", "e"]
    parents = [s.parent for s in rec.spans]
    roots = [s.root for s in rec.spans]
    assert parents == [None, 0, 0, 2, None]
    assert roots == [0, 0, 0, 0, 4]
    for s in rec.spans:
        assert rec.start_ns <= s.start_ns <= s.end_ns <= rec.end_ns
        assert s.thread == threading.get_ident()
    own = rec.self_ns()
    a, b, c, d, _ = rec.spans
    assert own[0] == (a.end_ns - a.start_ns) - (b.end_ns - b.start_ns) \
        - (c.end_ns - c.start_ns)
    assert own[2] == (c.end_ns - c.start_ns) - (d.end_ns - d.start_ns)
    assert own[1] == b.end_ns - b.start_ns >= 2_000_000
    assert own[3] == d.end_ns - d.start_ns >= 1_000_000


def test_a_thread_with_no_open_span_nests_under_the_open_one():
    """As autograd's device thread runs a backward while the caller waits
    inside its span: the thread's first span takes the latest-opened span
    still open on any thread as parent, and its root."""
    with trace.recording() as rec:
        with trace.span("step"):
            with trace.span("micro"):
                def work():
                    with trace.span("recompute"):
                        with trace.span("inner"):
                            pass
                t = threading.Thread(target=work)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
    step, micro, recompute, inner = rec.spans
    assert recompute.parent == 1 and recompute.root == 0
    assert inner.parent == 2 and inner.root == 0
    assert recompute.thread != step.thread == micro.thread
    assert rec.self_ns()[1] == (micro.end_ns - micro.start_ns) \
        - (recompute.end_ns - recompute.start_ns)


def test_off_span_is_one_shared_object_that_records_and_launches_nothing():
    assert trace.span("a") is trace.span("b")
    with trace.span("a") as s:
        assert s is trace.span("c")
    trace.count("n", 3)
    called = []

    def fn(t):
        called.append(1)
        return (t > 0).sum()

    x = torch.arange(8)
    with _Ops() as ops:
        trace.count_device("live", fn, x)
    assert ops.n == 0 and not called
    with trace.recording() as rec:
        with _Ops() as ops:
            trace.count_device("live", fn, x)
            trace.count_device("live", fn, x)
        trace.count("n", 3)
    assert ops.n > 0 and rec.counters == {"n": 3, "live": 14}
    with trace.recording() as rec2:
        pass
    assert rec2.spans == [] and rec2.counters == {}


def _ckv_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    b, hq, hkv, s, dh = 1, 4, 2, 64, 8
    q = torch.randn((b, hq, s, dh), generator=g)
    k = torch.randn((b, hkv, s, dh), generator=g)
    v = torch.randn((b, hkv, s, dh), generator=g)
    pos = torch.arange(s, dtype=torch.int32)
    cfg = t_base.ClusterKVConfig(enabled=True, block_q=16, block_k=16,
                                 blocks_per_query=2)
    return q, k, v, pos, cfg


def test_off_clusterkv_spans_run_no_tensor_op(monkeypatch):
    """A ClusterKV call dispatches the same ops whether its spans and
    counters are the module's (off) or stubs that do nothing; recording
    adds the live-pair count's ops and nothing else changes the output."""
    q, k, v, pos, cfg = _ckv_inputs()

    def ops_of():
        with _Ops() as ops:
            out = t_attn.clusterkv_attention(q, k, v, pos, pos, cfg)
        return ops.n, out

    off, out_off = ops_of()
    with trace.recording() as rec:
        on, out_on = ops_of()
    assert on > off and torch.equal(out_on, out_off)
    assert {"ckv.attention", "ckv.cluster_perm", "ckv.pca",
            "ckv.morton_sort", "ckv.permute_kv",
            "ckv.select"} == set(_names(rec))

    class Nothing:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    for mod in (t_attn, t_ckv):
        monkeypatch.setattr(mod.trace, "span", lambda name: Nothing())
    monkeypatch.setattr(t_attn.trace, "count", lambda *a: None)
    monkeypatch.setattr(t_attn.trace, "count_device", lambda *a: None)
    stub, out_stub = ops_of()
    assert stub == off and torch.equal(out_stub, out_off)


def _host_events(prof, names):
    """The profile's host events of the given names: ``name -> (start_ns,
    end_ns)``, on the profiler's clock."""
    return {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() in names}


def test_a_span_stands_in_the_profiler_trace_on_its_clock():
    """Under ``torch.profiler`` each span is a host event of its name
    whose start and end lie within 50 us of the in-memory span's. (A
    shared CPU can stall a thread between the two clock reads: the best
    of three profiles is held to the bound; the card test holds one.)"""
    acts = [torch.profiler.ProfilerActivity.CPU]
    worst = []
    for _ in range(4):        # the first record_function warms up
        with torch.profiler.profile(activities=acts) as prof:
            with trace.recording() as rec:
                with trace.span("outer"):
                    with trace.span("inner"):
                        torch.ones(256).add_(1)
                    time.sleep(0.001)
        evs = _host_events(prof, {"outer", "inner"})
        assert [s.name for s in rec.spans] == ["outer", "inner"]
        worst.append(max(max(abs(evs[s.name][0] - s.start_ns),
                             abs(evs[s.name][1] - s.end_ns))
                         for s in rec.spans))
    assert min(worst[1:]) < 50_000, worst


def test_self_time_counts_overlapping_children_once():
    """Two threads' children of one span overlap in time: the parent's
    self time is its duration less their union, never below zero."""
    opened = threading.Event()

    def other():
        with trace.span("other"):
            opened.set()
            time.sleep(0.004)

    with trace.recording() as rec:
        with trace.span("parent"):
            t = threading.Thread(target=other)
            t.start()
            assert opened.wait(timeout=30)
            with trace.span("mine"):
                time.sleep(0.004)
            t.join(timeout=30)
            assert not t.is_alive()
            time.sleep(0.002)
    parent = rec.spans[0]
    kids = rec.spans[1:]
    assert [s.name for s in kids] == ["other", "mine"]
    assert all(s.parent == 0 and s.root == 0 for s in kids)
    lo = min(s.start_ns for s in kids)
    hi = max(s.end_ns for s in kids)
    assert max(s.start_ns for s in kids) < min(s.end_ns for s in kids)
    own = rec.self_ns()
    assert own[0] == (parent.end_ns - parent.start_ns) - (hi - lo)
    assert own[0] >= 2_000_000
    assert own[1:] == [s.end_ns - s.start_ns for s in kids]


def test_only_one_recording_at_a_time():
    with trace.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with trace.recording():
                pass
    with trace.recording() as rec:
        with trace.span("x"):
            pass
    assert _names(rec) == ["x"]


def test_build_plan_and_matvec_record_their_spans():
    x = np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32)
    with trace.recording() as rec:
        plan = t_api.build_plan(x, k=6, bs=16, sb=2, backend="bsr",
                                device="cpu", symmetrize=True,
                                values=lambda r, c, d2: np.exp(-d2))
        y = plan.matvec(np.ones(300, np.float32))
    assert set(plan.host.timings) == {"knn", "embedding", "tree",
                                      "build_bsr"}
    assert y.shape == (300,)
    names = _names(rec)
    assert names == ["plan.build", "build.knn", "build.values",
                     "build.embedding", "build.tree",
                     "build.apply_ordering", "build.bsr", "bsr.layout",
                     "bsr.fill", "plan.matvec", "plan.permute",
                     "plan.unpermute"]
    by = {s.name: i for i, s in enumerate(rec.spans)}
    for child, parent in (("build.knn", "plan.build"),
                          ("build.bsr", "plan.build"),
                          ("bsr.layout", "build.bsr"),
                          ("bsr.fill", "build.bsr"),
                          ("plan.permute", "plan.matvec"),
                          ("plan.unpermute", "plan.matvec")):
        assert rec.spans[by[child]].parent == by[parent]
    assert rec.spans[by["plan.unpermute"]].root == by["plan.matvec"]
    # each stage's span holds its timing, and little more
    dur = {s.name: (s.end_ns - s.start_ns) * 1e-9 for s in rec.spans}
    for key, name in (("knn", "build.knn"), ("build_bsr", "build.bsr")):
        t = plan.host.timings[key]
        assert t <= dur[name] + 1e-6 < t + 0.1, name
    assert dur["bsr.layout"] + dur["bsr.fill"] <= dur["build.bsr"]


def _train_setup(microbatch):
    ckv = t_base.ClusterKVConfig(enabled=True, block_q=16, block_k=16,
                                 blocks_per_query=2, decode_clusters=2)
    cfg = t_base.reduced_config("qwen2-0.5b").with_(
        dtype="float32", clusterkv=ckv, remat=True)
    g = torch.Generator().manual_seed(0)
    params = t_api_models.init(cfg, g, device="cpu")
    batch = t_api_models.make_small_batch(cfg, g, batch=2, seq=64,
                                          device="cpu")
    step, opt = t_tr.make_train_step(cfg, None, "clusterkv",
                                     microbatch=microbatch)
    return cfg, params, batch, step, opt


def test_clusterkv_train_step_records_forward_recompute_and_live_pairs(
        monkeypatch):
    """A reduced ClusterKV train step under remat records ``ckv.*`` in the
    forward and again in the recompute, under one ``train.step``; the live
    pair count equals a numpy count from the step's own selections."""
    cfg, params, batch, step, opt = _train_setup(microbatch=2)
    state = opt.init(params)
    seen = []
    select = t_ckv.select_blocks

    def spy(q_cent, k_cent, kpos_min, kpos_max, qpos_min, qpos_max, *a,
            **kw):
        idx = select(q_cent, k_cent, kpos_min, kpos_max, qpos_min, qpos_max,
                     *a, **kw)
        seen.append((idx.numpy().copy(), kpos_min.numpy().copy(),
                     qpos_max.numpy().copy()))
        return idx

    monkeypatch.setattr(t_ckv, "select_blocks", spy)
    with trace.recording() as rec:
        step(params, state, batch)
    n = cfg.n_layers
    names = _names(rec)
    assert names[0] == "train.step"
    assert names.count("train.step") == 1
    assert names.count("train.microbatch") == 2
    assert names.count("train.accumulate") == 3
    assert names.count("train.optimizer") == 1
    for name in ("ckv.attention", "ckv.cluster_perm", "ckv.pca",
                 "ckv.morton_sort", "ckv.permute_kv", "ckv.select"):
        assert names.count(name) == 2 * 2 * n, name   # 2 microbatches x
        # (forward + recompute)
    assert all(s.root == 0 for s in rec.spans)
    micro = {i for i, s in enumerate(rec.spans)
             if s.name == "train.microbatch"}
    att = [s for s in rec.spans if s.name == "ckv.attention"]
    assert all(s.parent in micro for s in att)
    assert len(seen) == 2 * 2 * n
    g = cfg.n_heads // cfg.n_kv_heads
    live = sel = 0
    for idx, kpmin, qpmax in seen:
        kmin = np.take_along_axis(kpmin, idx.reshape(*idx.shape[:2], -1),
                                  axis=-1).reshape(idx.shape)
        live += int((kmin <= qpmax[:, None]).sum()) * g
        sel += idx.size * g
    assert rec.counters == {"b6.pairs_selected": sel, "b6.pairs_live": live}
    assert 0 < live <= sel


def test_live_pairs_counts_key_tiles_at_or_before_the_query_tile():
    """Key tiles in time order (positions 16 t .. 16 t + 15) under causal
    query tiles of 16: a pair is live when its key tile starts at or
    before the query tile's last position; out-of-range ids never are."""
    kpmin = torch.tensor([[[0, 16, 32, 48]]])               # (1, 1, 4)
    qpmax = torch.tensor([15, 31, 47, 63])
    idx = torch.tensor([[[[0, 3], [1, 2], [2, 3], [3, 4]]]],
                       dtype=torch.int32)                   # (1,1,4,2)
    # live: (0,0) (1,1) (2,2) (3,3); dead: (0,3) (1,2) (2,3); (3,4) out
    assert int(t_ckv.live_pairs(idx, kpmin, qpmax, 3)) == 4 * 3
    assert int(t_ckv.live_pairs(idx, kpmin, None, 3)) == 7 * 3


def test_non_causal_clusterkv_counts_every_pair_live():
    q, k, v, pos, cfg = _ckv_inputs(1)
    with trace.recording() as rec:
        t_attn.clusterkv_attention(q, k, v, pos, pos, cfg, causal=False)
    assert rec.counters["b6.pairs_live"] == rec.counters["b6.pairs_selected"]
    assert rec.counters["b6.pairs_selected"] == 4 * 4 * 2
    assert _names(rec).count("ckv.cluster_perm") == 2     # keys, queries
