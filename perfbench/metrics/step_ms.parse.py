"""Host ms a decode step of the continuous decoder over the window's call:
(its wall seconds less the seconds spent admitting pages) over its decode
steps, from ``continuous_generate(stats=)``."""


def read(run):
    c = run.counters
    if not c.get("decode_steps"):
        return None
    return 1e3 * (c["wall_s"] - c["splice_s"]) / c["decode_steps"]
