"""The sparse-expert layer's share of its roofline in decode (``moe_ffn``,
the name ``models.model`` calls it by): per call, the larger of its bytes
over HBM (each expert that receives a token read once, the router, the
input and output rows) and its FLOPs over the bf16 peak (each token's k
experts and the router), summed over the traced steps' calls, over the
device time of the kernels launched inside a range around it.  Which
experts receive a token is worked out after the stretch from the recorded
inputs (a float32 router, top-k of the softmax)."""

import torch

from metlbench import peaks

RANGES = {"bench.moe_ffn": "repro_torch.models.model:moe_ffn"}


def bound_s(tokens: int, D: int, F: int, E: int, k: int, hit: int, itemsize: int) -> float:
    bytes_ = hit * 3 * D * F * itemsize + D * E * 4 + 2 * tokens * D * itemsize
    flop = 2 * tokens * (k * 3 * D * F + D * E)
    return max(bytes_ / peaks.HBM_BYTES_PER_S, flop / peaks.BF16_FLOP_PER_S)


def _probe(state):
    calls = state.setdefault("moe_ffn", [])

    def hook(p, x, cfg):
        calls.append((p["router"], x, cfg.top_k, p["w_in"].shape, p["w_in"].element_size()))
    return hook


PROBES = {"repro_torch.models.model:moe_ffn": _probe}


def read(out):
    t = out.trace
    calls = out.window.get("probes", {}).get("moe_ffn")
    if t is None or not calls or t.range_s.get("bench.moe_ffn", 0.0) <= 0:
        return None
    total = 0.0
    with torch.no_grad():
        for router, x, k, (E, D, F), itemsize in calls:
            xt = x.reshape(-1, D).float()
            probs = torch.softmax(xt @ router.float(), -1)
            hit = int(torch.unique(torch.topk(probs, k, -1).indices).numel())
            total += bound_s(xt.shape[0], D, F, E, k, hit, itemsize)
    return 100.0 * total / t.range_s["bench.moe_ffn"]
