"""Set-up seconds: from the process's start to the first timed unit
(loading, inputs and weights from the seed, building, warm-up)."""


def read(rec):
    return rec["setup_s"]
