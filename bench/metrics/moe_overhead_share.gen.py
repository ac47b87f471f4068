"""The share of the sparse-expert layer's device time in decode that is
not the expert products: the device time of the program's ``moe.route``,
``moe.dispatch`` and ``moe.combine`` spans plus the ``moe`` spans' self
time (what their child spans leave uncovered), over the ``moe`` spans'
device intervals, summed over the traced stretch.  A span's device
interval also holds any time the card waited there for the host.  Read
from the program's spans (``repro_torch.spans.summary()``); nothing off
the card, or from a program that records none."""

OVERHEAD = ("moe.route", "moe.dispatch", "moe.combine")


def share(summary):
    """Percent, from a ``summary()``; None without a ``moe`` span."""
    moe = summary.get("moe")
    if not moe or moe["device_ms"] <= 0:
        return None
    over = moe["device_self_ms"] + sum(summary.get(n, {}).get("device_ms", 0.0) for n in OVERHEAD)
    return 100.0 * over / moe["device_ms"]


def read(out):
    t = out.trace
    if t is None or t.device.type != "cuda":
        return None
    try:
        from repro_torch import spans
    except ImportError:  # a program without spans of its own
        return None
    return share(spans.summary())
