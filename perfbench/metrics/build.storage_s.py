"""Mean seconds of the ``build_bsr`` stage (host layout, tiles filled on
the card) over the window's builds (the program's stage timing)."""


def read(rec):
    st = rec.get("stages")
    if not st:
        return None
    return sum(s.get("build_bsr", 0.0) for s in st) / len(st)
