"""Device milliseconds per ``plan.matvec`` outside B1 (the permutation
gathers, padding, casts) in the traced calls."""
from perfbench.harness import trace


def read(rec):
    tr = rec.get("trace")
    if not tr or "counts" not in rec:
        return None
    total = sum(v[0] for v in tr["kernels"].values())
    b1, _ = trace.kernel_seconds(tr, ("bsr_sp",))
    return (total - b1) / tr["units"] * 1e3
