"""GiB at the allocator's peak over the training window
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start)."""


def read(rec):
    peak = rec.get("train_peak_bytes")
    return None if not peak else peak / 2 ** 30
