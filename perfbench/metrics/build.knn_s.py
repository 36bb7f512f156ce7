"""Mean seconds of the ``knn`` stage over the window's builds (the
program's own stage timing, drained at the stage's end)."""


def read(rec):
    st = rec.get("stages")
    if not st:
        return None
    return sum(s.get("knn", 0.0) for s in st) / len(st)
