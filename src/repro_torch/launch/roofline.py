"""Roofline analysis: three terms per (arch x shape x mesh), as the
reference's ``launch/roofline.py``, priced at the H100 rates of
``launch/analytic.py`` (the reference prices a TPU's):

  compute    = FLOPs / (chips x PEAK_FLOPS)     989e12, bf16 tensor cores
  memory     = HBM bytes / (chips x HBM_BW)     the probed HBM rate
  collective = weighted collective bytes / LINK_BW   NVLink one way

Sources: the dry-run records (``results/dryrun_torch/*.json``, the port's
``launch/dryrun.py``), cross-checked against the closed-form analytic model
(``launch/analytic.py``). FLOPs and HBM bytes are taken as the reference
takes them: ``max(analytic, min(traced, 4 x analytic))``, the analytic
model exact for matmul work and the trace catching what it misses. The
reference's records count a scan body once, so their FLOPs and 'body'
collectives are scaled by the layer-scan trip count (``scan_trips``); the
port traces every layer (its records say ``"world"``), so its FLOPs are
taken as traced and its 'body' is zero: the rule stays, and reads either
package's records.

These are H100 rates applied to counts, not measurements.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod16x16]
Writes results/roofline_torch.json and prints the table.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.costmodel import make_report
from repro_torch.launch.analytic import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                         analytic_collectives, cell_model)

RESULTS = Path(__file__).resolve().parents[3] / "results"


def scan_trips(arch: str, shape: str) -> int:
    """Trip count of the dominant (layer) scan for body-collective scaling."""
    cfg = get_config(arch)
    if cfg.family == "hybrid":
        return cfg.shared_attn_every          # python loop over groups
    kind = SHAPES[shape][2]
    trips = cfg.n_layers
    if cfg.family == "encdec" and kind != "decode":
        trips = cfg.n_layers + cfg.n_enc_layers
    return trips


def analyse(rec: dict) -> dict:
    arch, shape, mesh = rec["arch"], rec["shape"], rec["mesh"]
    chips = rec.get("chips") or (512 if mesh == "pod2x16x16" else 256)
    model = cell_model(arch, shape, rec.get("backend"),
                       layout=rec.get("layout", "2d"), chips=chips,
                       param_dtype=rec.get("param_dtype"),
                       remat=rec.get("remat"), ep=rec.get("ep", False))

    traced_flops_dev = (rec.get("cost") or {}).get("flops") or 0.0
    trips = scan_trips(arch, shape)
    # the reference's HLO counts a scan body once; the port's trace all
    traced_scaled = traced_flops_dev * (1 if "world" in rec else trips)
    ana_flops_dev = model.flops / chips
    flops_dev = max(ana_flops_dev, min(traced_scaled, ana_flops_dev * 4)) \
        if traced_flops_dev else ana_flops_dev

    hbm_dev = model.hbm_bytes / chips
    coll = rec.get("collectives") or {}
    entry_b = (coll.get("entry") or {}).get("weighted_bytes", 0.0)
    body_b = (coll.get("body") or {}).get("weighted_bytes", 0.0)
    coll_traced = entry_b + body_b * trips       # evidence, body x layer-scan
    coll_ana = analytic_collectives(arch, shape, mesh == "pod2x16x16",
                                    rec.get("backend"),
                                    layout=rec.get("layout", "2d"),
                                    ep=rec.get("ep", False))["total"]
    coll_dev = coll_ana

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = hbm_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_coll)
    mf = model.model_flops / chips
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
        "backend": rec.get("backend"),
        "compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll,
        "dominant": dominant.replace("_s", ""),
        "model_flops_dev": mf,
        "hlo_flops_dev_raw": traced_flops_dev,
        "flops_dev_corrected": flops_dev,
        "hbm_bytes_dev": hbm_dev,
        "coll_bytes_hlo_scaled": coll_traced,
        "coll_bytes_analytic": coll_ana,
        "useful_ratio": mf / flops_dev if flops_dev else None,
        "roofline_fraction": (mf / PEAK_FLOPS) / bound if bound else None,
        "peak_bytes_dev": (rec.get("memory") or {}).get("peak_bytes"),
        "status": rec["status"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None,
                    help="pod16x16 (default: every mesh)")
    ap.add_argument("--tag", default="", help="analyse tagged variant runs")
    args = ap.parse_args(argv)

    rows = []
    for f in sorted((RESULTS / "dryrun_torch").glob("*.json")):
        parts = f.stem.split("__")
        tag = parts[3] if len(parts) > 3 else ""
        if tag != args.tag:
            continue
        rec = json.loads(f.read_text())
        if rec["status"] != "ok":
            continue
        if args.mesh and rec["mesh"] != args.mesh:
            continue
        rows.append(analyse(rec))

    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    RESULTS.mkdir(parents=True, exist_ok=True)
    out = RESULTS / (f"roofline_torch{('_' + args.tag) if args.tag else ''}"
                     ".json")
    # the same repro.cost/v1 envelope as the autotune cost model reports
    out.write_text(json.dumps(make_report("roofline", {"rows": rows}),
                              indent=2))

    hdr = (f"{'arch':28s} {'shape':12s} {'mesh':10s} {'backend':9s} "
           f"{'compute':>9s} {'memory':>9s} {'collect':>9s} {'dom':>7s} "
           f"{'useful':>6s} {'roof%':>6s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['arch']:28s} {r['shape']:12s} {r['mesh']:10s} "
              f"{(r['backend'] or ''):9s} "
              f"{r['compute_s']*1e3:8.2f}m {r['memory_s']*1e3:8.2f}m "
              f"{r['collective_s']*1e3:8.2f}m {r['dominant']:>7s} "
              f"{(r['useful_ratio'] or 0)*100:5.1f}% "
              f"{(r['roofline_fraction'] or 0)*100:5.1f}%")
    print(f"\nwrote {out}")
    return rows


if __name__ == "__main__":
    main()
