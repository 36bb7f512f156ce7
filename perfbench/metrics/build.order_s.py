"""Mean seconds of the ordering stages (``embedding`` + ``tree`` +
``ordering``) over the window's builds (the program's stage timings)."""


def read(rec):
    st = rec.get("stages")
    if not st:
        return None
    return sum(s.get("embedding", 0.0) + s.get("tree", 0.0)
               + s.get("ordering", 0.0) for s in st) / len(st)
