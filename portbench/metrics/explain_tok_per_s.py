"""explain_tok_per_s: explanation tokens emitted in the window over its
seconds (all the work over all the time)."""
from readings import per_second


def read(rec):
    return per_second(rec, "tokens")
