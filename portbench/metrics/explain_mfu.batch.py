"""explain_mfu: the model operations of the window's prefill and decode
tokens (at each token's real context) over the window at the bf16 peak."""
from readings import mfu_pct


def read(rec):
    return mfu_pct(rec)
