"""setup_s: from process start to the window's first timed operation."""


def read(rec):
    return rec.get("setup_s")
