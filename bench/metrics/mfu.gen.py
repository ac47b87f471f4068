"""The decode steps' model FLOPs over the window against the bf16 dense
peak: a step of R rows at position p does 2 R (active parameters that
multiply: attention, MLP or the k experts a token takes and the router,
the head) plus attention over the p + 1 valid positions, 4 R (p + 1) H hd
a layer; summed over the steps that ended inside the window, over the
window's seconds."""

from metlbench import peaks


def step_flop(cfg, rows: int, pos: int) -> float:
    D, F, L, hd, H = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.hd, cfg.n_heads
    att = D * H * hd + 2 * D * cfg.n_kv_heads * hd + H * hd * D
    ffn = (D * cfg.n_experts + cfg.top_k * 3 * D * F) if cfg.n_experts else 3 * D * F
    head = -(-cfg.vocab // 256) * 256 * D
    return 2.0 * rows * (L * (att + ffn) + head) + 4.0 * rows * (pos + 1) * H * hd * L


def read(out):
    w = out.window
    pos = w.get("step_pos")
    if not pos:
        return None
    rows = w["traffic"]["rows"]
    flop = sum(step_flop(w["cfg"], rows, p) for p in pos)
    return 100.0 * flop / w["seconds"] / peaks.BF16_FLOP_PER_S
