"""The attention's read of its KV cache in decode against its roofline:
for each ``attn.cache_read`` span of the program (the validity mask, then
scores, softmax and values over the cache), the larger of the valid slots'
K and V bytes over HBM (2 rows slots_valid KV hd itemsize) and the
attention's FLOPs over the bf16 peak (4 rows slots_valid H hd), summed over
the traced stretch, over the summed device intervals of those spans.  Only
the slots that hold a position at or below the step's are needed, so only
they count.  A span's device interval runs from the event recorded on the
stream at its entry to the one at its exit, so it also holds any time the
card waited there for the host.  Read from the program's spans
(``repro_torch.spans.records()``); nothing off the card, or from a program
that records none."""

from metlbench import peaks

SPAN = "attn.cache_read"


def bound_s(rows: int, slots_valid: int, KV: int, hd: int, H: int, itemsize: int) -> float:
    bytes_ = 2 * rows * slots_valid * KV * hd * itemsize
    flop = 4 * rows * slots_valid * H * hd
    return max(bytes_ / peaks.HBM_BYTES_PER_S, flop / peaks.BF16_FLOP_PER_S)


def share(spans, cfg):
    """Percent of the spans' device time that their bound needs; None
    without a finished span."""
    need, took_ms = 0.0, 0.0
    for s in spans:
        if s.name == SPAN and s.device_end_ms is not None:
            c = s.counts
            need += bound_s(c["rows"], c["slots_valid"], cfg.n_kv_heads, cfg.hd, cfg.n_heads,
                            cfg.cdtype.itemsize)
            took_ms += s.device_end_ms - s.device_start_ms
    return 100.0 * need / (took_ms * 1e-3) if took_ms > 0 else None


def read(out):
    t = out.trace
    if t is None or t.device.type != "cuda":
        return None
    try:
        from repro_torch import spans
    except ImportError:  # a program without spans of its own
        return None
    return share(spans.records(), out.window["cfg"])
