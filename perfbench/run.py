"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout. Loads the cell named in ``BENCHMARK.json``
(``perfbench/cells/<cell>.json``: its configuration, traffic mix and
correctness limits), makes its inputs and weights from ``--seed``, warms
up, measures for ``--seconds``, checks what the timed path produced
against the plain reference in ``perfbench/reference/``, and prints as the
last line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit. The same numbers are the last lines of standard error.

Exits 1 without printing a result when no CUDA card is present, when the
cell asks for more cards than there are, when the program (``src/``) is
missing, or when a module of JAX or of the JAX package has been loaded.
Caches of built kernels stay inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".perfbench_cache"


def _environment() -> None:
    """Fixed cache directories inside the checkout (the program's own nvcc
    output already lands in ``src/repro_torch/kernels/_build``)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from perfbench.harness import registry, runner
    t_imported = time.perf_counter()

    bench = registry.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"run.py: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"run.py: the cell needs {entry['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("run.py: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.empty(1, device=dev)
    phases = {"imports": t_imported - T_START,
              "cuda_context": time.perf_counter() - t_imported}
    result, checks = runner.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), T_START, dev, bench=bench,
                                phases=phases)
    found = runner.forbidden_modules()
    if found:
        print("run.py: modules of JAX or of the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 1
    sys.stdout.flush()
    for name, value, limit in checks:
        print(f"check {name}: {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
