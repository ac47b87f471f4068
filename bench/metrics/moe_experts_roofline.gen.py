"""The sparse-expert layer's expert products in decode against their
roofline: for each ``moe.experts`` span of the program (the three batched
products and the SiLU), the larger of the bytes of the experts that receive
a token over HBM (hit 3 D F itemsize) and the FLOPs of each token's k
experts over the bf16 peak (2 tokens k 3 D F), summed over the traced
stretch, over the summed device intervals of those spans.  Which experts
receive a token is worked out after the stretch from the inputs that
``moe_roofline.gen``'s probe records (its probe, so both read one list),
call by call in the order of the spans.  A span's device interval also
holds any time the card waited there for the host.  Read from the
program's spans (``repro_torch.spans.records()``); nothing off the card,
or from a program that records none."""

import torch

from metlbench import harness, peaks

SPAN = "moe.experts"
PROBES = harness.load_reader("moe_roofline.gen").PROBES


def bound_s(tokens: int, D: int, F: int, k: int, hit: int, itemsize: int) -> float:
    bytes_ = hit * 3 * D * F * itemsize
    flop = 2 * tokens * k * 3 * D * F
    return max(bytes_ / peaks.HBM_BYTES_PER_S, flop / peaks.BF16_FLOP_PER_S)


def hit(router, x, k: int) -> int:
    """Experts that receive a token: top-k of the float32 router's softmax."""
    with torch.no_grad():
        xt = x.reshape(-1, router.shape[0]).float()
        probs = torch.softmax(xt @ router.float(), -1)
        return int(torch.unique(torch.topk(probs, k, -1).indices).numel())


def share(spans, calls):
    """Percent of the spans' device time that their bound needs, the
    ``moe_ffn`` calls (router, x, k, (E, D, F), itemsize) matched to the
    spans in order; None without a finished span or where the two counts
    differ."""
    experts = [s for s in spans if s.name == SPAN and s.device_end_ms is not None]
    if not experts or len(experts) != len(calls):
        return None
    need, took_ms = 0.0, 0.0
    for s, (router, x, k, (E, D, F), itemsize) in zip(experts, calls):
        tokens = spans[s.parent].counts["tokens"]
        need += bound_s(tokens, D, F, k, hit(router, x, k), itemsize)
        took_ms += s.device_end_ms - s.device_start_ms
    return 100.0 * need / (took_ms * 1e-3) if took_ms > 0 else None


def read(out):
    t = out.trace
    calls = out.window.get("probes", {}).get("moe_ffn")
    if t is None or t.device.type != "cuda" or not calls:
        return None
    try:
        from repro_torch import spans
    except ImportError:  # a program without spans of its own
        return None
    return share(spans.records(), calls)
