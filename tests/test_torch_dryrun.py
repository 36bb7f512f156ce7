"""The dry run and roofline (ROADMAP A15): ``launch/dryrun.py`` and
``launch/roofline.py`` against the reference's, and the opaque ops they
trace.

- B5 and B6 under ``FakeTensorMode`` on fake CUDA tensors: outputs of the
  right shape, dtype and device, with every warning an error (reading a
  fake tensor's ``data_ptr()`` warns), no launch counted, and the ops'
  FLOP formulas counted by ``FlopCounterMode`` and by the dry run's
  counters;
- ``parse_collectives`` on the reference test's HLO text equals the
  reference's dict;
- ``roofline.analyse`` of the same records as the reference's: FLOPs, HBM
  bytes, collective bytes and ``scan_trips`` equal, the terms priced at the
  port's H100 rates; ``roofline.main`` writes the table of a directory of
  port records;
- a reduced Qwen2-0.5B train cell traced on a fake 2x2 world gives the
  per-rank FLOPs and collective counts and bytes of the same step run for
  real on four ``gloo`` ranks under the same counters;
- Qwen2-0.5B's ``train_4k`` cell at full width on the production 16x16
  world traces (``status: ok``).

Every job that forms a process group (fake or gloo) runs in its own
processes (``_torch_mesh_harness.spawn``).
"""
import json
import warnings

import pytest
import torch

import _torch_mesh_harness as H

from repro.launch import dryrun as r_dry
from repro.launch import roofline as r_roof
from repro_torch.launch import analytic as t_ana
from repro_torch.launch import dryrun as t_dry
from repro_torch.launch import roofline as t_roof

HLO = """
HloModule jit_step

%region_1.2 {
  %x = f32[128,256]{1,0} parameter(0)
  %all-reduce.1 = f32[128,256]{1,0} all-reduce(%x), replica_groups={}
  ROOT %r = f32[128,256]{1,0} add(%all-reduce.1, %x)
}

ENTRY %main {
  %p0 = bf16[64]{0} parameter(0)
  %ag = bf16[1024]{0} all-gather(%p0), dimensions={0}
  %a2a = f32[16,8]{1,0} all-to-all(%p0), dimensions={0}
  %rs = bf16[32,4]{1,0} reduce-scatter(%p0), dimensions={0}
  %cp = s32[7]{0} collective-permute-start(%p0), source_target_pairs={}
  ROOT %out = f32[16,8]{1,0} copy(%a2a)
}
"""


def test_parse_collectives_equals_the_reference():
    assert t_dry.parse_collectives(HLO) == r_dry.parse_collectives(HLO)
    got = t_dry.parse_collectives(HLO)
    assert got["body"]["weighted_bytes"] == 128 * 256 * 4 * 2.0
    assert got["entry"]["counts"]["collective-permute"] == 1


def test_collective_kinds_of_the_c10d_ops():
    kinds = {"allreduce_": "all-reduce", "all_reduce": "all-reduce",
             "_allgather_base_": "all-gather",
             "all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "_reduce_scatter_base_": "reduce-scatter",
             "alltoall_base_": "all-to-all",
             "all_to_all_single": "all-to-all", "send": "collective-permute",
             "recv_": "collective-permute",
             "broadcast_": "collective-permute", "wait_tensor": None,
             "barrier": None}
    for name, kind in kinds.items():
        assert t_dry.collective_kind(name) == kind, name


def _record(arch, shape, mesh, flops, entry, body, backend=None, **kw):
    sec = {"bytes_by_op": {}, "counts": {}, "weighted_bytes": 0.0}
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
           "backend": backend, "layout": "2d", "ep": False,
           "param_dtype": None, "remat": None, "cost": {"flops": flops},
           "collectives": {"entry": dict(sec, weighted_bytes=entry),
                           "body": dict(sec, weighted_bytes=body)},
           "memory": {"peak_bytes": 123}}
    rec.update(kw)
    return rec


RECORDS = [("qwen2-0.5b", "train_4k", "pod16x16", 3.1e13, 1.0e9, 2.0e7),
           ("qwen2-0.5b", "decode_32k", "pod2x16x16", 0.0, 0.0, 0.0),
           ("zamba2-1.2b", "prefill_32k", "pod16x16", 1.0e12, 5e8, 1e6),
           ("whisper-medium", "train_4k", "pod16x16", 4.0e11, 2e8, 3e6),
           ("granite-moe-3b-a800m", "long_500k", "pod16x16", 2.0e9, 1e7,
            1e5),
           ("llama4-maverick-400b-a17b", "prefill_32k", "pod2x16x16", 9e13,
            4e9, 1e8)]


@pytest.mark.parametrize("row", RECORDS, ids=[f"{r[0]}-{r[1]}-{r[2]}"
                                               for r in RECORDS])
def test_roofline_counts_equal_the_reference_at_h100_rates(row):
    """On the same (reference-style) record: the corrected FLOPs, the HBM
    bytes, both collective byte counts and the scan trips equal the
    reference's; each term is the count over the port's H100 rate."""
    arch, shape, mesh, flops, entry, body = row
    rec = _record(arch, shape, mesh, flops, entry, body)
    want = r_roof.analyse(rec)
    got = t_roof.analyse(rec)
    assert t_roof.scan_trips(arch, shape) == r_roof.scan_trips(arch, shape)
    for k in ("flops_dev_corrected", "coll_bytes_hlo_scaled",
              "coll_bytes_analytic", "model_flops_dev", "chips"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    hbm_ref = want["memory_s"] * r_roof.HBM_BW
    assert got["hbm_bytes_dev"] == pytest.approx(hbm_ref, rel=1e-12)
    assert got["compute_s"] == pytest.approx(
        got["flops_dev_corrected"] / t_ana.PEAK_FLOPS, rel=1e-12)
    assert got["memory_s"] == pytest.approx(hbm_ref / t_ana.HBM_BW,
                                            rel=1e-12)
    assert got["collective_s"] == pytest.approx(
        got["coll_bytes_analytic"] / t_ana.LINK_BW, rel=1e-12)
    assert (t_ana.PEAK_FLOPS, t_ana.LINK_BW) == (989e12, 450e9)


def test_roofline_takes_the_ports_traced_flops_unscaled(tmp_path,
                                                        monkeypatch):
    """A port record (``"world"``) traced every layer: its FLOPs are not
    multiplied by the scan trips (the reference's HLO counts a scan body
    once); ``main`` writes ``roofline_torch.json`` from the records of
    ``results/dryrun_torch``."""
    ana = t_ana.cell_model("qwen2-0.5b", "train_4k", chips=256).flops / 256
    base = _record("qwen2-0.5b", "train_4k", "pod16x16", 2 * ana, 1e9, 0.0)
    port = dict(base, world="fake", chips=256)
    assert t_roof.analyse(port)["flops_dev_corrected"] == 2 * ana
    assert t_roof.analyse(base)["flops_dev_corrected"] == 4 * ana
    d = tmp_path / "dryrun_torch"
    d.mkdir()
    (d / "qwen2-0.5b__train_4k__pod16x16.json").write_text(json.dumps(port))
    (d / "qwen2-0.5b__decode_32k__pod16x16.json").write_text(json.dumps(
        dict(port, shape="decode_32k", status="error")))
    monkeypatch.setattr(t_roof, "RESULTS", tmp_path)
    rows = t_roof.main([])
    assert [r["shape"] for r in rows] == ["train_4k"]
    table = json.loads((tmp_path / "roofline_torch.json").read_text())
    assert table["kind"] == "roofline" and len(table["rows"]) == 1


def test_b5_b6_trace_as_opaque_ops_under_fake_tensors():
    """Fake CUDA tensors (no card needed): each wrapper returns a fake
    output of the right shape, dtype and device; no warning (touching a
    fake tensor's ``data_ptr()`` warns), no launch counted; the FLOPs are
    the kernels' own counts."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import block_attention as _ba
    from repro_torch.kernels import decode_attend as _da
    from repro_torch.kernels import ops

    b, hq, hkv, s, dh, dv, bq, n_sel = 2, 14, 2, 512, 64, 64, 128, 2
    launches = (_ba.block_attention.launches, _da.decode_attend_fused.launches)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with FakeTensorMode():
            def t(*shape, dtype=torch.bfloat16):
                return torch.empty(shape, dtype=dtype, device="cuda")
            q, k = t(b, hq, s, dh), t(b, hkv, s, dh)
            pos, qpos = t(b, hkv, s, dtype=torch.int32), t(s, dtype=torch.int32)
            idx = t(b, hkv, s // bq, n_sel, dtype=torch.int64)
            with FlopCounterMode(display=False) as fc:
                o = ops.block_attention(q, k, k, pos, qpos, idx, bq=bq, bk=bq)
            assert isinstance(o, FakeTensor)
            assert (tuple(o.shape), o.dtype, o.device.type) == \
                ((b, hq, s, dv), torch.bfloat16, "cuda")
            pairs = b * hq * (s // bq) * n_sel
            assert fc.get_total_flops() == 2 * bq * bq * (dh + dv) * pairs
            cent = t(b, hkv, s // bq, dh, dtype=torch.float32)
            for qp in (100, t(dtype=torch.int32), t(b, dtype=torch.int32)):
                with t_dry.StepCounters() as c:
                    o = ops.decode_attend_fused(t(b, hq, dh), k, k, pos, cent,
                                                qp, n_sel=n_sel, bk=bq)
                assert (tuple(o.shape), o.dtype, o.device.type) == \
                    ((b, hq, dv), torch.bfloat16, "cuda")
                assert c.flops == 2 * dh * b * hkv * (s // bq) + \
                    2 * (dh + dv) * b * hq * n_sel * bq
            ks = t(b, hkv, dh, dtype=torch.float32)
            with FlopCounterMode(display=False) as fc:
                o = ops._cuda_plan_decode(
                    t(b, hq, dh), k, k, pos, cent, t(b, dtype=torch.int32),
                    _cfg(), k_self=ks, v_self=ks)
            assert tuple(o.shape) == (b, hq, dv)
            assert fc.get_total_flops() == 2 * dh * b * hkv * (s // bq) + \
                2 * (dh + dv) * b * hq * (2 * bq + 1)
    assert (_ba.block_attention.launches,
            _da.decode_attend_fused.launches) == launches


def _cfg():
    from repro_torch.configs.base import ClusterKVConfig
    return ClusterKVConfig(enabled=True, block_k=128, decode_clusters=2)


def test_a_fake_2x2_trace_counts_what_the_gloo_step_runs(tmp_path):
    """The reduced Qwen2-0.5B train cell (2 microbatches of 2 x 32
    tokens): traced on a fake 2x2 world, and run for real on four gloo
    ranks under the same counters. Every rank's FLOPs and collective
    counts and bytes equal the trace's."""
    cell = dict(arch="qwen2-0.5b", shape="train_4k", reduced=True,
                sizes=(32, 8), microbatch=2)
    fake = H.spawn("dryrun_cell", 1, tmp_path / "fake", timeout=120,
                   group=False, mesh=(2, 2), **cell)[0]
    real = H.spawn("dryrun_real", 4, tmp_path / "real", timeout=120, **cell)
    assert fake["flops"] > 0 and fake["counts/all-gather"] > 0
    assert fake["counts/all-reduce"] > 0 and fake["counts/reduce-scatter"] > 0
    for r, got in enumerate(real):
        for k, v in fake.items():
            if k == "peak_bytes":
                continue
            assert got[k] == v, f"rank {r} {k}: {got[k]} against {v}"


def test_dtensor_sharding_propagation_is_not_counted(tmp_path):
    """ROADMAP C51: DTensor learns an op's output metadata by running it
    once on fake tensors of the GLOBAL shapes, in the fake mode it finds
    active; the dry run's counters skip those ops, so a rank's peak counts
    its shards only (before, the gradient clip of llama4-maverick's
    stacked experts counted 21.5 GB a layer)."""
    got = H.spawn("dryrun_propagation", 1, tmp_path, timeout=120,
                  group=False)[0]
    assert 2 * got["local_bytes"] <= got["peak_bytes"] < got["whole_bytes"]


def test_full_width_qwen_train_cell_traces_on_the_production_world(
        tmp_path):
    """Qwen2-0.5B ``train_4k`` at full width on the fake 16x16 world:
    status ok, every layer's gathers and sums counted, a rank's FLOPs
    within 1.3x of its 1/256 share of the analytic model's (its heads,
    MLP columns and vocab split over ``tp``), a peak of GB per rank
    (nothing allocated)."""
    got = H.spawn("dryrun_cell", 1, tmp_path, timeout=240, group=False,
                  arch="qwen2-0.5b", shape="train_4k", mesh=(16, 16),
                  reduced=False, sizes=None)[0]
    share = t_ana.cell_model("qwen2-0.5b", "train_4k", chips=256).flops / 256
    assert share < got["flops"] < 1.3 * share
    assert got["counts/all-gather"] >= 24 and got["counts/reduce-scatter"] > 0
    assert 1e9 < got["peak_bytes"] < 80e9
