"""Milliseconds per ``plan.matvec``: the window over the calls completed."""


def read(rec):
    return rec.get("matvec_ms")
