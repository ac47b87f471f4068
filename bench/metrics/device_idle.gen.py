"""Share of the traced stretch of decode steps in which no operation ran
on the device (the busy union from the raw trace)."""


def read(out):
    t = out.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
