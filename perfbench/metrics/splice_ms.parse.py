"""Host ms to admit one page into the continuous decoder (its prefill, the
vision tower and the 64-layer prompt pass, and the splice into a row) over
the window's call, from ``continuous_generate(stats=)``."""


def read(run):
    c = run.counters
    if not c.get("pages"):
        return None
    return 1e3 * c["splice_s"] / c["pages"]
