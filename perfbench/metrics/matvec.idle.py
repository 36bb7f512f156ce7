"""Share of the traced calls' window in which no device operation ran."""


def read(rec):
    tr = rec.get("trace")
    if not tr or rec.get("matvec_ms") is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
