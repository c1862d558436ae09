"""Share of the traced span of the page stream in which no operation ran
on the device (the union of the device operations' intervals), in %."""


def read(run):
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
