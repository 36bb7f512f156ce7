"""Training tokens per second: every token of the steps completed in the
window over the window."""


def read(rec):
    return rec.get("train_tokens_per_s")
