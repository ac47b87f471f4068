"""``attention_decode``'s share of its roofline: per call, the least time
the card needs for what the step's inputs need (the valid p + 1 slots of
the K and V cache read once, the new K and V written, the four projection
weights, the input and output rows; the projections' and the attention's
FLOPs), the larger of bytes over HBM and FLOPs over the bf16 peak, summed
over the traced steps' calls, over the device time of the kernels launched
inside a range around it.  The cache beyond the position is not needed, so
not counted."""

from metlbench import peaks

RANGES = {"bench.attention_decode": "repro_torch.models.model:attention_decode"}


def bound_s(B: int, T: int, KV: int, hd: int, H: int, D: int, pos: int, itemsize: int) -> float:
    valid = min(pos + 1, T)
    weights = D * H * hd + 2 * D * KV * hd + H * hd * D
    bytes_ = itemsize * (2 * B * valid * KV * hd + 2 * B * KV * hd + weights + 2 * B * D)
    flop = 2 * B * weights + 4 * B * valid * H * hd
    return max(bytes_ / peaks.HBM_BYTES_PER_S, flop / peaks.BF16_FLOP_PER_S)


def _probe(state):
    calls = state.setdefault("attention_decode", [])

    def hook(p, x, cache_k, cache_v, pos, cfg, **kwargs):
        B, T, KV, hd = cache_k.shape
        calls.append((B, T, KV, hd, cfg.n_heads, x.shape[-1], int(pos), cache_k.element_size()))
    return hook


PROBES = {"repro_torch.models.model:attention_decode": _probe}


def read(out):
    t = out.trace
    calls = out.window.get("probes", {}).get("attention_decode")
    if t is None or not calls or t.range_s.get("bench.attention_decode", 0.0) <= 0:
        return None
    return 100.0 * sum(bound_s(*c) for c in calls) / t.range_s["bench.attention_decode"]
