"""The port's cost model and autotune (``repro_torch.core.costmodel`` and
``core.autotune``) against the reference's (``repro.core.costmodel``,
``repro.core.autotune``).

Every formula the two share is equal at rtol 1e-12 given the same knob
values (the reference's ``peak_flops`` is the port's ``fp32_flops``,
``link_bw`` its ``nvlink_bw``). Where the port prices differently it is
said in the test: ``cuda`` reads only the kept tiles and the charges once
(the reference's ``pallas`` prices a segment per slot), and decode costs
count the launches the port issues. The autotune runs on CPU plans here;
its CUDA cases are in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import stream_plan_from_reference, tt

from repro import api as ref_api
from repro.configs.base import ClusterKVConfig as RefCKV
from repro.core import autotune as ref_tune
from repro.core import clusterkv as ref_ckv
from repro.core import costmodel as ref_cm
from repro.data.pipeline import feature_mixture
from repro_torch import api as t_api
from repro_torch.configs.base import ClusterKVConfig as TCKV
from repro_torch.core import autotune as t_tune
from repro_torch.core import blocksparse as t_bs
from repro_torch.core import clusterkv as t_ckv
from repro_torch.core import costmodel as t_cm
from repro_torch.core.registry import register_backend
from repro_torch.models import attention as t_attn

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _reset_model_state():
    yield
    for cm, tune in ((t_cm, t_tune), (ref_cm, ref_tune)):
        cm.set_hardware(None)
        tune.clear_tune_memo()
        tune.clear_calibration()


def _knobs(**kw):
    """One set of knob values in both packages' names."""
    v = dict(flops=50e12, hbm=2e12, link=300e9, launch=3e-6, gather=3.0,
             edge=1e-10)
    v.update(kw)
    ref = ref_cm.HardwareConfig(
        peak_flops=v["flops"], hbm_bw=v["hbm"], link_bw=v["link"],
        launch_overhead=v["launch"], gather_penalty=v["gather"],
        edge_cost=v["edge"])
    port = t_cm.HardwareConfig(
        fp32_flops=v["flops"], hbm_bw=v["hbm"], nvlink_bw=v["link"],
        launch_overhead=v["launch"], gather_penalty=v["gather"],
        edge_cost=v["edge"])
    return ref, port


def _port_plan(n=256, bs=16, sb=4, backend="auto"):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    return t_api.build_plan(x, k=8, bs=bs, sb=sb, backend=backend,
                            device="cpu")


# -- hardware config --------------------------------------------------------


def test_hardware_config_json_roundtrip(tmp_path):
    hw = t_cm.HardwareConfig(name="test-card", fp32_flops=1e12, hbm_bw=1e11,
                             smem_per_sm=1 << 16)
    p = tmp_path / "hw.json"
    hw.to_json(str(p))
    assert t_cm.HardwareConfig.from_json(str(p)) == hw
    p.write_text(json.dumps({"fp32_flops": 1.0, "warp_size": 32}))
    with pytest.raises(ValueError, match="warp_size"):
        t_cm.HardwareConfig.from_json(str(p))


def test_reference_knob_file_is_refused_naming_the_counterparts(tmp_path):
    p = tmp_path / "tpu.json"
    ref_cm.HardwareConfig().to_json(str(p))
    with pytest.raises(ValueError) as err:
        t_cm.HardwareConfig.from_json(str(p))
    msg = str(err.value)
    for tpu, port in (("peak_flops", "fp32_flops"), ("link_bw", "nvlink_bw"),
                      ("vmem_bytes", "smem_per_sm"), ("mxu_tile", "mma"),
                      ("interpret_penalty", "plain versions")):
        assert tpu in msg and port in msg, (tpu, msg)


def test_knob_file_environment_variable_is_the_ports_own(tmp_path,
                                                         monkeypatch):
    """A TPU knob file set for the reference (``REPRO_HW_CONFIG``) never
    reaches the port; ``REPRO_TORCH_HW_CONFIG`` does."""
    tpu = tmp_path / "tpu.json"
    ref_cm.HardwareConfig().to_json(str(tpu))
    card = tmp_path / "card.json"
    t_cm.HardwareConfig(name="probed", hbm_bw=3.0e12).to_json(str(card))
    monkeypatch.setenv("REPRO_HW_CONFIG", str(tpu))
    monkeypatch.delenv("REPRO_TORCH_HW_CONFIG", raising=False)
    assert t_cm.set_hardware(None) == t_cm.HardwareConfig()
    monkeypatch.setenv("REPRO_TORCH_HW_CONFIG", str(card))
    hw = t_cm.set_hardware(None)
    assert hw.name == "probed" and hw.hbm_bw == 3.0e12
    monkeypatch.setenv("REPRO_TORCH_HW_CONFIG", str(tpu))
    with pytest.raises(ValueError, match="TPU knobs"):
        t_cm.set_hardware(None)


def test_set_hardware_accepts_dict_and_resets():
    hw = t_cm.set_hardware({"name": "knobs", "gather_penalty": 2.0})
    assert t_cm.get_hardware() is hw
    assert t_cm.get_hardware().gather_penalty == 2.0
    assert t_cm.set_hardware(None).name == "nvidia-h100-sxm"


def test_report_envelope():
    rep = t_cm.make_report("backend_rank", {"winner": "bsr"})
    assert rep["schema"] == t_cm.SCHEMA == ref_cm.SCHEMA == "repro.cost/v1"
    assert rep["kind"] == "backend_rank"
    assert rep["hardware"]["fp32_flops"] == t_cm.get_hardware().fp32_flops
    assert rep["winner"] == "bsr"
    json.dumps(rep)


# -- the SpMV formulas --------------------------------------------------------

KEYS = [(512, 16, 4, 32, 32, 6), (1024, 16, 8, 64, 64, 38),
        (4096, 32, 8, 128, 128, 47)]


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("backend", ["csr", "bsr", "bsr_ml", "user"])
@pytest.mark.parametrize("f,batch,nnz", [(1, 1, None), (4, 3, 8192)])
def test_backend_cost_equals_the_reference(key, backend, f, batch, nnz):
    ref_hw, hw = _knobs()
    want = ref_cm.backend_cost(ref_cm.plan_features(key, f, batch, nnz),
                               backend, ref_hw)
    got = t_cm.backend_cost(t_cm.plan_features(key, f, batch, nnz),
                            backend, hw)
    for field in ("flops", "hbm_bytes", "launches", "seconds"):
        np.testing.assert_allclose(got[field], want[field], rtol=RTOL,
                                   err_msg=field)


@pytest.mark.parametrize("f,batch", [(1, 1), (8, 1), (1, 8)])
def test_cuda_is_priced_by_kept_tiles_and_charges_read_once(f, batch):
    """With every slot kept, ``cuda`` moves the tiles, indices and result
    that the reference's ``pallas`` prices, and reads the charges once
    where ``pallas`` prices one segment per slot: the byte counts differ
    by exactly that. Fewer kept tiles cost fewer bytes and flops."""
    key = (4096, 32, 8, 128, 128, 47)
    ref_hw, hw = _knobs()
    pal = ref_cm.backend_cost(ref_cm.plan_features(key, f, batch), "pallas",
                              ref_hw)
    cuda = t_cm.backend_cost(t_cm.plan_features(key, f, batch), "cuda", hw)
    _, bs, _, n_rb, n_cb, nbr = key
    slots = batch * n_rb * nbr
    seg = slots * bs * f * 4.0
    charges = batch * n_cb * bs * f * 4.0
    np.testing.assert_allclose(cuda["hbm_bytes"],
                               pal["hbm_bytes"] - seg + charges, rtol=RTOL)
    np.testing.assert_allclose(cuda["flops"], pal["flops"], rtol=RTOL)
    assert cuda["launches"] == pal["launches"] == 1
    half = t_cm.backend_cost(
        t_cm.plan_features(key, f, batch, kept_tiles=slots // 2), "cuda", hw)
    np.testing.assert_allclose(
        cuda["hbm_bytes"] - half["hbm_bytes"],
        (slots - slots // 2) * bs * bs * 4.0, rtol=RTOL)
    np.testing.assert_allclose(half["flops"] * slots,
                               cuda["flops"] * (slots // 2), rtol=RTOL)


@pytest.mark.parametrize("kept,f", [(95291, 8), (95291, 1),
                                     (8192 * 47, 1)])
def test_cuda_bytes_are_chip_smokes_spmv_bound_bytes(kept, f):
    """``chip_smoke.spmv_bound`` counts B1/B2's bytes on its own; the
    model's ``cuda`` bytes equal that count on the SIFT plan's shape (its
    kept tiles, and every slot kept)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_mod", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    key = (262144, 32, 8, 8192, 8192, 47)
    feat = t_cm.plan_features(key, f=f, kept_tiles=kept)
    byts = t_cm.backend_cost(feat, "cuda")["hbm_bytes"]
    col, x, y = 8192 * 47, 8192 * 32 * f, 8192 * 32 * f
    assert byts == t_cm.spmv_kernel_bytes(kept, 32, col, x, y)
    ms, by = smoke.spmv_bound(kept, 32, col, x, y, f)
    assert by == "bytes"
    assert ms * 1e-3 * smoke.HBM_BYTES_PER_S == pytest.approx(byts,
                                                             rel=RTOL)


def test_csr_priced_on_true_nnz():
    key = (1024, 16, 8, 64, 64, 38)          # kNN hubs: max_nbr >> k
    sparse = t_cm.plan_features(key, nnz=8192)
    dense = t_cm.plan_features(key)
    hw = t_cm.HardwareConfig(gather_penalty=4.0, edge_cost=2e-10)
    assert t_cm.backend_cost(sparse, "csr", hw)["seconds"] \
        < t_cm.backend_cost(dense, "csr", hw)["seconds"]
    assert t_cm.backend_cost(dense, "bsr", hw)["seconds"] \
        < t_cm.backend_cost(dense, "csr", hw)["seconds"]


def test_rank_backends_excludes_inf_calibration_and_cuda_on_the_cpu():
    feat = t_cm.plan_features((512, 16, 4, 32, 32, 6))
    rep = t_cm.rank_backends(feat, ("csr", "bsr", "bsr_ml", "cuda"),
                             calibration={"bsr_ml": float("inf"),
                                          "csr": 1.0})
    assert "bsr_ml" not in rep["predicted_s"]
    assert rep["winner"] == rep["ranking"][0] == "cuda"
    assert rep["winner"] == min(rep["predicted_s"], key=rep["predicted_s"].get)
    cpu = t_cm.rank_backends(feat, ("csr", "bsr", "bsr_ml", "cuda"),
                             on_cpu=True)
    assert "cuda" not in cpu["predicted_s"] and cpu["winner"] is not None


def test_rank_backends_equals_the_reference_on_shared_backends():
    ref_hw, hw = _knobs()
    key = (1024, 16, 8, 64, 64, 38)
    cal = {"csr": 2.0, "bsr": 0.5, "bsr_ml": 1.5}
    want = ref_cm.rank_backends(ref_cm.plan_features(key, nnz=9000), cal,
                                hw=ref_hw, calibration=cal)
    got = t_cm.rank_backends(t_cm.plan_features(key, nnz=9000), cal, hw=hw,
                             calibration=cal)
    assert got["ranking"] == want["ranking"]
    for name in cal:
        np.testing.assert_allclose(got["predicted_s"][name],
                                   want["predicted_s"][name], rtol=RTOL)


@pytest.mark.parametrize("precond", ["block_jacobi", "jacobi", "identity"])
def test_solver_cost_equals_the_reference(precond):
    ref_hw, hw = _knobs()
    key = (4096, 32, 8, 128, 128, 45)
    for backend in ("bsr", "bsr_ml"):
        want = ref_cm.solver_cost(ref_cm.plan_features(key, 2, 3), backend,
                                  iters=7, precond=precond, hw=ref_hw)
        got = t_cm.solver_cost(t_cm.plan_features(key, 2, 3), backend,
                               iters=7, precond=precond, hw=hw)
        for field in ("setup_flops", "setup_bytes", "iter_flops",
                      "iter_bytes", "setup_seconds", "iter_seconds",
                      "seconds"):
            np.testing.assert_allclose(got[field], want[field], rtol=RTOL,
                                       err_msg=f"{backend} {field}")
    cal = {"bsr": 1.3, "bsr_ml": 0.7}
    want = ref_cm.rank_solver_backends(ref_cm.plan_features(key), cal,
                                       iters=5, precond=precond, hw=ref_hw,
                                       calibration=cal)
    got = t_cm.rank_solver_backends(t_cm.plan_features(key), cal, iters=5,
                                    precond=precond, hw=hw, calibration=cal)
    assert got["ranking"] == want["ranking"] and got["kind"] == "solver_rank"
    for name in cal:
        np.testing.assert_allclose(got["predicted_s"][name],
                                   want["predicted_s"][name], rtol=RTOL)


def test_exchange_cost_equals_the_reference():
    ref_hw, hw = _knobs()
    assert t_cm.exchange_cost(None, 16) is None
    for blocks in (3, 7, 1000):
        np.testing.assert_allclose(t_cm.exchange_cost(blocks, 32, hw),
                                   ref_cm.exchange_cost(blocks, 32, ref_hw),
                                   rtol=RTOL)
    slow = dataclasses.replace(hw, nvlink_bw=hw.nvlink_bw / 2)
    assert t_cm.exchange_cost(3, 16, slow) == pytest.approx(
        2 * t_cm.exchange_cost(3, 16, hw))


# -- decode -------------------------------------------------------------------


def _decode_feat(cm, **kw):
    base = dict(batch=4, hq=14, hkv=2, s=8192, dh=64, dv=64, bk=128,
                n_sel=16)
    base.update(kw)
    return cm.DecodeFeatures(**base)


@pytest.mark.parametrize("port,ref", [("plain", "xla"), ("cuda", "pallas")])
@pytest.mark.parametrize("shape", [{}, dict(batch=1, s=4096, n_sel=4)])
def test_decode_cost_equals_the_reference_but_for_launches(port, ref, shape):
    """Flops and bytes are the reference's; the seconds differ only by
    the launches each package issues (B5: 3; the plain path: its ops)."""
    ref_hw, hw = _knobs()
    want = ref_cm.decode_cost(_decode_feat(ref_cm, **shape), ref, ref_hw)
    got = t_cm.decode_cost(_decode_feat(t_cm, **shape), port, hw)
    for field in ("flops", "hbm_bytes"):
        np.testing.assert_allclose(got[field], want[field], rtol=RTOL)
    launches = (t_cm.CUDA_DECODE_LAUNCHES if port == "cuda"
                else t_cm.PLAIN_DECODE_LAUNCHES)
    assert got["launches"] == launches
    np.testing.assert_allclose(
        got["seconds"],
        want["seconds"] + (launches - want["launches"]) * hw.launch_overhead,
        rtol=RTOL)


def test_plain_decode_launch_count_is_what_the_plain_path_issues():
    """``PLAIN_DECODE_LAUNCHES`` counts the ops of ``plan_decode_plain``
    (self column, float32 caches) that compute on the device: every aten
    op but the metadata-only ones (views, expands) and those on 0-d
    host scalars."""
    meta = {"view", "expand", "unsqueeze", "slice", "transpose",
            "_unsafe_view", "detach", "lift_fresh", "scalar_tensor",
            "alias", "reshape", "squeeze", "select", "permute", "t"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0]
            if name not in meta and not (isinstance(out, torch.Tensor)
                                         and out.ndim == 0):
                Count.n += 1
            return out

    g = torch.Generator().manual_seed(0)
    b, hq, hkv, s, dh, bk = 2, 4, 2, 64, 8, 8
    ks = torch.randn(b, hkv, s, dh, generator=g)
    vs = torch.randn(b, hkv, s, dh, generator=g)
    ps = torch.arange(s, dtype=torch.int32).expand(b, hkv, s).contiguous()
    with Count():
        t_ckv.plan_decode_plain(
            torch.randn(b, hq, dh, generator=g), ks, vs, ps,
            t_ckv.block_centroids(ks, bk), torch.tensor([40, 50]), n_sel=3,
            bk=bk, window=16, k_self=torch.randn(b, hkv, dh, generator=g),
            v_self=torch.randn(b, hkv, dh, generator=g))
    assert Count.n == t_cm.PLAIN_DECODE_LAUNCHES, Count.n


def test_decode_choice_picks_cuda_on_the_card_and_plain_on_the_cpu():
    feat = _decode_feat(t_cm)
    plain = t_cm.decode_cost(feat, "plain")
    cuda = t_cm.decode_cost(feat, "cuda")
    assert cuda["hbm_bytes"] < plain["hbm_bytes"]
    assert cuda["launches"] < plain["launches"]
    assert t_cm.choose_decode_backend(feat) == "cuda"
    assert t_cm.choose_decode_backend(feat, on_cpu=True) == "plain"
    rep = t_cm.rank_decode_backends(feat)
    assert rep["schema"] == "repro.cost/v1" and rep["kind"] == "decode_rank"
    assert rep["winner"] == rep["ranking"][0] == "cuda"
    assert set(rep["costs"]) == {"plain", "cuda"}
    json.dumps(rep)


def test_decode_choice_memoized():
    feat = _decode_feat(t_cm, batch=3)
    t_cm._DECODE_CHOICE.clear()
    a = t_cm.choose_decode_backend(feat)
    b = t_cm.choose_decode_backend(feat)
    assert a == b and len(t_cm._DECODE_CHOICE) == 1
    t_cm.choose_decode_backend(feat, on_cpu=True)
    assert len(t_cm._DECODE_CHOICE) == 2


def test_resolve_decode_backend_asks_the_model():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 4, 8, generator=g)
    ks = torch.randn(2, 2, 64, 8, generator=g)
    cfg = TCKV(block_k=8, decode_clusters=3)
    t_cm._DECODE_CHOICE.clear()
    assert t_attn.resolve_decode_backend(cfg, q, ks, ks) == "plain"
    assert len(t_cm._DECODE_CHOICE) == 1       # through the model
    assert t_attn.resolve_decode_backend(cfg, q) == "plain"
    assert t_attn.resolve_decode_backend(
        dataclasses.replace(cfg, decode_backend="cuda"), q, ks, ks) == "cuda"


# -- the autotune on CPU plans --------------------------------------------------


def test_tune_backend_reports_ranking_in_memo():
    plan = _port_plan()
    name, times = t_tune.tune_backend(plan)
    assert times and name == min(times, key=times.get)
    assert "cuda" not in times                 # not ranked on the CPU
    (report,) = t_tune._TUNE_MEMO.values()
    assert report["schema"] == t_cm.SCHEMA and report["kind"] == "backend_rank"
    assert report["winner"] == report["ranking"][0] == name
    assert report["features"]["kept_tiles"] == int(plan.bsr.nbr_mask.sum())
    assert t_tune.tune_backend(plan) == (name, times)
    assert set(t_tune._CALIB) == {"cpu:bsr", "cpu:bsr_ml", "cpu:csr"}


def test_cpu_auto_is_the_uncalibrated_models_winner():
    """A CPU plan's ``"auto"`` ranks with the model alone: no probe runs,
    and the winner is what the default knobs give at this shape (``csr``:
    one launch and few true edges against ``bsr``'s penalized segment
    gather), whatever calibration earlier probes left behind."""
    plan = _port_plan()
    t_tune._CALIB.update({"cpu:csr": 1e9, "cpu:bsr": 1e-9})
    want = t_cm.rank_backends(
        t_cm.plan_features(plan.spec.shape_key, nnz=len(plan.host.coo[0]),
                           kept_tiles=int(plan.bsr.nbr_mask.sum())),
        ("csr", "bsr", "bsr_ml"), on_cpu=True)
    assert want["winner"] == "csr"
    assert plan.resolve_backend() == plan.resolve_backend("auto") == "csr"
    assert t_tune.tune_backend(plan, calibrate=False) == (
        "csr", want["predicted_s"])
    assert set(t_tune._CALIB) == {"cpu:csr", "cpu:bsr"}   # nothing probed


def test_tune_memo_is_bounded(monkeypatch):
    """A streamed plan's edge count changes every step, and with it the
    memo key: the memo drops its oldest decision once it is full."""
    monkeypatch.setattr(t_tune, "_MEMO_MAX", 2)
    plan = _port_plan()
    sets = (("bsr",), ("bsr", "csr"), ("bsr", "bsr_ml"))
    for names in sets:
        t_tune.tune_backend(plan, backends=names, calibrate=False)
    assert [k[3] for k in t_tune._TUNE_MEMO] == list(sets[1:])


def test_hw_config_flip_changes_decision_without_reprobing(monkeypatch):
    plan = _port_plan(n=256, bs=16, sb=4)     # n_rb=16, sb=4: 4 stripes
    t_tune._CALIB.update({"cpu:bsr": 1.0, "cpu:bsr_ml": 1.0,
                          "cpu:csr": float("inf")})

    def boom(*a, **k):
        raise AssertionError("probe ran despite existing calibration")

    monkeypatch.setattr(t_tune, "_probe", boom)
    t_cm.set_hardware(t_cm.HardwareConfig(gather_penalty=100.0,
                                          launch_overhead=0.0))
    assert t_tune.tune_backend(plan)[0] == "bsr_ml"
    t_tune.clear_tune_memo()
    t_cm.set_hardware(t_cm.HardwareConfig(gather_penalty=1.0,
                                          launch_overhead=1.0))
    assert t_tune.tune_backend(plan)[0] == "bsr"


def test_calibration_is_keyed_by_device_type(monkeypatch):
    """A ratio measured on the card does not calibrate a CPU plan."""
    plan = _port_plan()
    t_tune._CALIB.update({"cuda:bsr": 1e-9, "cuda:bsr_ml": 1e9,
                          "cuda:csr": 1e9, "cuda:cuda": 1e9})
    probed = []
    real = t_tune._probe

    def spy(run, names, *a):
        probed.extend(names)
        return real(run, names, *a)

    monkeypatch.setattr(t_tune, "_probe", spy)
    t_tune.tune_backend(plan)
    assert sorted(probed) == ["bsr", "bsr_ml", "csr"]
    assert t_tune._CALIB["cuda:bsr"] == 1e-9


def test_probe_skips_cuda_on_the_cpu_and_times_the_plain_paths():
    plan = _port_plan(n=128)
    x = tt(np.random.default_rng(1).standard_normal(plan.n).astype(
        np.float32))
    times = t_tune.probe_backends(plan, x, backends=("bsr", "cuda"),
                                  iters=1, warmup=0)
    assert set(times) == {"bsr"} and times["bsr"] > 0


def test_probe_agreement_is_relative_to_the_output():
    """A user backend within 1e-4 x max|bsr| is timed even where its
    max-abs difference passes the reference's absolute 1e-3; one beyond
    it is skipped, and its calibration is inf (excluded from 'auto')."""
    from repro_torch.core.registry import get_backend

    bsr = get_backend("bsr")

    @register_backend("scaled_close", overwrite=True)
    def close(plan, x, **kw):
        return bsr(plan, x) * (1 + 5e-5)

    @register_backend("scaled_far", overwrite=True)
    def far(plan, x, **kw):
        return bsr(plan, x) * (1 + 5e-4)

    plan = _port_plan(n=128)
    x = tt(1e6 * np.random.default_rng(2).standard_normal(plan.n).astype(
        np.float32))
    ref = bsr(plan, x)
    assert float((close(plan, x) - ref).abs().max()) > 1e-3
    try:
        times = t_tune.probe_backends(plan, x,
                                      backends=("scaled_close", "scaled_far"),
                                      iters=1, warmup=0)
        assert set(times) == {"scaled_close"}
        name, pred = t_tune.tune_backend(
            plan, x, backends=("bsr", "scaled_close", "scaled_far"))
        assert "scaled_far" not in pred
        assert t_tune._CALIB["cpu:scaled_far"] == float("inf")
    finally:
        from repro_torch.core import registry
        registry._BACKENDS.pop("scaled_close", None)
        registry._BACKENDS.pop("scaled_far", None)


def test_on_the_card_the_winner_is_the_kernel_whatever_the_ranking():
    """On a CUDA plan the ranking is a report: the winner is ``cuda`` even
    where calibration ranks a plain path first (device-free: the ranking
    touches no tensor)."""
    feat = t_cm.plan_features((256, 16, 4, 16, 16, 6))
    t_tune._CALIB.update({"cuda:cuda": 1e9, "cuda:bsr": 1.0})
    names = ("bsr", "cuda")
    cuda = torch.device("cuda")
    name, pred = t_tune._rank(("k",), feat, names, cuda, True, False)
    assert name == "cuda" and min(pred, key=pred.get) == "bsr"
    assert t_tune._TUNE_MEMO[("k",)]["ranking"] == ["bsr", "cuda"]
    cpu = torch.device("cpu")
    assert t_tune._rank(("c",), feat, names, cpu, True, False)[0] == "bsr"


def test_multi_device_tune_picks_dist_as_the_reference():
    """ROADMAP A11, ported: on 2 or more devices ``dist`` wins where the
    analyzed halo beats replication — the reference's decision on the same
    plan — with its probe on the default mesh (the one CPU here), named in
    the report; single-device decisions stay as they were, memoized."""
    x = feature_mixture(512, 32, n_clusters=8, seed=0)
    rp = ref_api.build_plan(jnp.asarray(x), k=8, bs=16, sb=4,
                            backend="bsr", ell_slack=8)
    tp = stream_plan_from_reference(rp)
    for ndev in (4, 8):
        want, wtimes = ref_tune.tune_backend(rp, device_count=ndev)
        got, times = t_tune.tune_backend(tp, device_count=ndev)
        assert want == got == "dist"
        assert set(times) == set(wtimes) - {"pallas"}
        report = t_tune._TUNE_MEMO[next(k for k in t_tune._TUNE_MEMO
                                        if k[-1] == ndev)]
        assert report["winner"] == "dist"
        assert report["dist"]["n_dev"] == ndev
        assert report["dist"]["probe_mesh"] == ["cpu"]
    assert "cpu:dist" in t_tune._CALIB
    memo = len(t_tune._TUNE_MEMO)
    one, times1 = t_tune.tune_backend(tp, device_count=1)
    assert one != "dist" and "dist" not in times1
    assert len(t_tune._TUNE_MEMO) == memo + 1
    assert t_tune.tune_backend(tp, device_count=1) == (one, times1)
    scattered = t_api.InteractionPlan.from_bsr(t_bs.random_bsr(
        3, 2048, 32, 8, device="cpu"))
    name, times = t_tune.tune_backend(scattered, device_count=8)
    assert name != "dist" and "dist" not in times   # all-gather: no halo


def test_tune_batch_backend_on_the_cpu():
    rng = np.random.default_rng(3)
    pb = t_api.build_plan_batch(rng.standard_normal((3, 96, 8)), k=5, bs=16,
                                sb=2, device="cpu")
    name, pred = t_tune.tune_batch_backend(pb)
    assert name in ("bsr", "bsr_ml") and "cuda" not in pred
    assert set(k for k in t_tune._CALIB if ":batch:" in k) == {
        "cpu:batch:bsr", "cpu:batch:bsr_ml"}
    report = t_tune._TUNE_MEMO[("batch", pb.spec.shape_key, 3, 1,
                                ("bsr", "bsr_ml"), True, "cpu")]
    assert report["features"]["batch"] == 3
    assert report["features"]["kept_tiles"] == int(pb.data.nbr_mask.sum())
    # "auto" ranks uncalibrated: one launch beats bsr_ml's two stripes
    assert pb.resolve_backend() == "bsr"
    xs = rng.standard_normal((3, 96)).astype(np.float32)
    np.testing.assert_allclose(pb.matvec(xs).numpy(),
                               pb.matvec(xs, backend="bsr").numpy(),
                               rtol=1e-5, atol=1e-5)


# -- the attention budget -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_coverage_curve_and_blocks_per_query_match_the_reference(seed):
    """On the CPU the cluster ordering equals the reference's (C9), so the
    chosen budget is exact and the curve agrees to float32 rounding — for
    float32 inputs; bf16 inputs: the test after this one (C30)."""
    rng = np.random.default_rng(seed)
    b, hq, hkv, s, dh = 1, 4, 2, 256, 16
    q = rng.standard_normal((b, hq, s, dh)).astype(np.float32)
    centers = rng.standard_normal((8, dh)).astype(np.float32) * 3
    k = (centers[rng.integers(0, 8, (b, hkv, s))]
         + 0.3 * rng.standard_normal((b, hkv, s, dh))).astype(np.float32)
    kw = dict(block_q=32, block_k=32, blocks_per_query=8,
              local_window_blocks=1)
    want = ref_tune.coverage_curve(jnp.asarray(q), jnp.asarray(k),
                                   RefCKV(**kw))
    got = t_tune.coverage_curve(tt(q), tt(k), TCKV(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    for target in (0.5, 0.9, 0.95, 0.999):
        rc, rcov = ref_tune.tune_blocks_per_query(
            jnp.asarray(q), jnp.asarray(k), RefCKV(**kw), target)
        tc, tcov = t_tune.tune_blocks_per_query(tt(q), tt(k), TCKV(**kw),
                                                target)
        assert tc.blocks_per_query == rc.blocks_per_query, target
        assert tcov == pytest.approx(rcov, rel=1e-6)


def _c30_draws():
    """ROADMAP C30's draws: Qwen's head shape at S = 512, in this order."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 14, 512, 64)).astype(np.float32)
    centers = rng.standard_normal((8, 64)).astype(np.float32) * 3
    k = (centers[rng.integers(0, 8, (1, 2, 512))]
         + 0.3 * rng.standard_normal((1, 2, 512, 64))).astype(np.float32)
    return q, k


def test_coverage_curve_in_bf16_differs_by_one_rounded_tie():
    """ROADMAP C30: in bf16 the float32 case's exactness does not hold.

    The cluster ordering and the centroids are equal, and of the 2 048
    bf16 q-tile means one differs, element (0, 0, 2, 19): its exact mean
    -0.087158203125 lies halfway between two bf16 values, and the port
    (the exact float32 mean rounded once, to even) gives -0.0869140625
    where XLA gives -0.08740234375, one bf16 spacing (2^-11) away. That
    moves the curve by a bound stated below. A budget whose target falls
    between the two curves is a near-tie (the reference may keep one tile
    more, as at 0.6479068); every other budget is equal."""
    q, k = _c30_draws()
    kw = dict(block_q=32, block_k=32, blocks_per_query=8,
              local_window_blocks=1)
    qj, kj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k))
    qt, kt = (tt(a).to(torch.bfloat16) for a in (q, k))
    b, hq, s, dh = q.shape
    hkv, bq, bk = 2, 32, 32
    nqb = s // bq
    qc_ref = np.asarray(qj.reshape(b, hkv, hq // hkv, nqb, bq, dh).mean(
        axis=(2, 4)).astype(jnp.float32))
    qc = qt.reshape(b, hkv, hq // hkv, nqb, bq, dh).mean(
        dim=(2, 4)).float().numpy()
    assert [tuple(i) for i in np.argwhere(qc != qc_ref)] == [(0, 0, 2, 19)]
    exact = qt.double().reshape(b, hkv, hq // hkv, nqb, bq, dh).mean(
        dim=(2, 4))[0, 0, 2, 19].item()
    assert exact == -0.087158203125
    assert (qc[0, 0, 2, 19], qc_ref[0, 0, 2, 19]) == (-0.0869140625,
                                                      -0.08740234375)
    assert torch.tensor(exact).to(torch.bfloat16).item() == qc[0, 0, 2, 19]
    want = np.asarray(ref_tune.coverage_curve(qj, kj, RefCKV(**kw)))
    got = t_tune.coverage_curve(qt, kt, TCKV(**kw)).numpy()
    # one logit row of query tile (0, 0, 2) moves by delta * cent[:, 19] *
    # bk / sqrt(dh); a softmax partial sum moves by at most a quarter of
    # the range of that change (first order; a half here), and the curve
    # is the mean over the b * hkv * nqb query tiles
    perm = t_ckv.cluster_perm(kt, d=3)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(ref_ckv.cluster_perm(kj, d=3)))
    k_s = torch.gather(kt, -2, perm[..., None].expand(kt.shape))
    cent = t_ckv.block_centroids(k_s, bk)[0, 0, :, 19].float().numpy()
    delta = 2.0 ** -11
    bound = delta * float(cent.max() - cent.min()) * bk / dh ** 0.5 / 2 \
        / (b * hkv * nqb)
    err = float(np.abs(got - want).max())
    assert 0 < err <= bound, (err, bound)
    for target in (0.5, 0.6479068, 0.9, 0.95, 0.999):
        rc, _ = ref_tune.tune_blocks_per_query(qj, kj, RefCKV(**kw), target)
        tc, _ = t_tune.tune_blocks_per_query(qt, kt, TCKV(**kw), target)
        in_gap = bool(np.any((np.minimum(got, want) < target)
                             & (target <= np.maximum(got, want))))
        assert in_gap == (target == 0.6479068), target
        if in_gap:
            assert abs(tc.blocks_per_query - rc.blocks_per_query) == 1
        else:
            assert tc.blocks_per_query == rc.blocks_per_query, target


def test_reference_plan_ranks_alike_given_the_same_calibration():
    """The same plan, the same ratios and knobs: the port's ranking of
    the plain backends is the reference's."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((256, 8)).astype(np.float32)
    rp = ref_api.build_plan(jnp.asarray(x), k=8, bs=16, sb=4, backend="bsr")
    ref_hw, hw = _knobs(gather=6.0)
    cal = {"csr": 3.0, "bsr": 1.0, "bsr_ml": 2.0}
    nnz = int(len(rp.host.coo[0]))
    want = ref_cm.rank_backends(
        ref_cm.plan_features(rp.spec.shape_key, nnz=nnz), cal, hw=ref_hw,
        calibration=cal)
    got = t_cm.rank_backends(
        t_cm.plan_features(rp.spec.shape_key, nnz=nnz), cal, hw=hw,
        calibration=cal)
    assert got["ranking"] == want["ranking"]
