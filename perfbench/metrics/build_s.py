"""Seconds per ``api.build_plan``: the window over the builds completed."""


def read(rec):
    return rec.get("build_s")
