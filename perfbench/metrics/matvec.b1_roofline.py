"""B1's share of its byte bound in the traced calls: the bytes of one call
(kept tiles x bs^2 x 4 + the column table + charges + result, once each)
at 3.35 TB/s over B1's device seconds per call."""
from perfbench.harness import counts, trace


def read(rec):
    tr = rec.get("trace")
    if not tr or "counts" not in rec:
        return None
    sec, launches = trace.kernel_seconds(tr, ("bsr_sp",))
    if not launches:
        return None
    per_call = sec / tr["units"]
    return 100.0 * counts.b1_bound_s(**rec["counts"]) / per_call
