"""The port's side of tests/test_torch_decode_mesh.py: the functions that run
on every rank of a gloo mesh (``run_on_mesh`` spawns them, so they live in
a module that imports neither JAX nor the reference), and the inputs both
sides share.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax
from repro_torch.models import model as TM
from repro_torch.serve.decode import Server, ServeConfig, greedy_decode, make_serve_step
from repro_torch.sharding import comm
from repro_torch.sharding.specs import make_policy, param_spec_tree
from repro_torch.train.loop import place_tree

import _torch_mesh_ranks as R
import _torch_tp_ranks as TP

BATCH, PROMPT, MAX_NEW = 4, 6, 14  # 20 positions: hymba's window of 16 wraps
# (name, arch, config overrides, cache_len, mesh shapes): heads and KV heads
# split (olmo, whisper and its memory); KV 2 on M 4 with the heads split
# (llama: the cache split in time); 6 heads with a cache of 18 (phi3_h6:
# attention repeated) and of 16 (phi3_h6_time: time split, the output
# whole); hymba's rolling window split in time beside Mamba over Di; rwkv6
# with 4 heads (one a rank) and its channel mix over F; qwen3-moe under
# ep; whisper with 2 heads (its encoder memory split in time)
CASES = [("olmo", "olmo_1b", {}, 16, ((1, 4), (2, 2))),
         ("llama", "llama3_405b", {}, 16, ((1, 4), (2, 2))),
         ("phi3_h6", "phi3_medium_14b", dict(d_model=48, n_heads=6, n_kv_heads=2), 18,
          ((1, 4), (2, 2))),
         ("phi3_h6_time", "phi3_medium_14b", dict(d_model=48, n_heads=6, n_kv_heads=2), 16,
          ((1, 4),)),
         ("hymba", "hymba_1_5b", {}, 16, ((1, 4), (2, 2))),
         ("rwkv", "rwkv6_3b", dict(ssm_heads=4), 16, ((1, 4), (2, 2))),
         ("qwen3_ep", "qwen3_moe_30b_a3b", dict(moe_impl="ep", capacity_factor=8.0), 16,
          ((2, 2),)),
         ("whisper", "whisper_tiny", {}, 16, ((1, 4), (2, 2))),
         ("whisper_h2", "whisper_tiny", dict(n_heads=2, n_kv_heads=2), 16, ((1, 4),))]
SERVE = dict(batch=4, cache_len=32, max_new=5, eos=-1)  # the Server case, olmo on (2, 2)
SERVE_PROMPTS = [3, 1, 5, 2, 4, 6]  # six requests of mixed lengths
SSM_TRAIN = [("hymba_train", "hymba_1_5b", {}), ("rwkv_train", "rwkv6_3b", dict(ssm_heads=4))]
DRY_CASES = ["olmo", "llama", "hymba", "rwkv"]  # the dry run's decode cells on (2, 2)


def case(name):
    return next(c for c in CASES if c[0] == name)


def case_cfg(name):
    _, arch, kw, _, _ = case(name)
    return TC.get_smoke(arch).replace(**R.F32, **kw)


def prompt(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)


def frames(cfg):
    rng = np.random.default_rng(1)
    return rng.normal(size=(BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def serve_prompts(vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(1, vocab, n).tolist() for n in SERVE_PROMPTS]


def flat_state(state, prefix=""):
    """{'/'-joined path: tensor} of a decode state (``pos`` left out)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(flat_state(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


def _rank0():
    return torch.distributed.get_rank() == 0


def _placed(cfg, params_np, mesh):
    params = params_from_jax(params_np, device="cpu")
    return place_tree(params, param_spec_tree(params, make_policy(mesh)), mesh)


def _extras(cfg):
    return {"frames": torch.as_tensor(frames(cfg))} if cfg.enc_dec else None


def step_logits(params, cfg, sh, cache_len):
    """Greedy decoding through ``make_serve_step(cfg, sh)``, as
    ``greedy_decode`` steps: (every step's logits (S0 - 1 + MAX_NEW, B,
    V_pad), the generated tokens (B, MAX_NEW)), whole on every rank."""
    sharded = sh is not None
    rows = sh.data_rows(BATCH) if sharded else slice(0, BATCH)
    toks = torch.as_tensor(prompt(cfg))
    state = TM.init_decode_state(cfg, BATCH, cache_len, device="cpu", sh=sh)
    if cfg.enc_dec:
        TM.prefill_memory(params, cfg, _extras(cfg)["frames"][rows], state, sh)
    step = make_serve_step(cfg, sh)
    ts = sh.tensor_split(cfg) if sharded else None
    logits, outs = [], []
    tok = toks[:, 0]
    for t in range(1, PROMPT + MAX_NEW):
        nxt, lg, state = step(params, state, tok[rows])
        if ts is not None and ts.vocab:
            lg = comm.all_gather_cols(lg, sh.model_group())
        if sharded and sh.data_size() > 1:
            lg = comm.all_gather_rows(lg, sh.data_group())
            nxt = comm.all_gather_rows(nxt, sh.data_group())
        logits.append(lg.numpy())
        if t < PROMPT:
            tok = toks[:, t]
        else:
            tok = nxt
            outs.append(nxt.numpy())
    return np.stack(logits), np.stack(outs, axis=1)


def _decode(mesh, name, params_np):
    """One case on this mesh: ``greedy_decode(sh)``'s tokens, the step
    logits and their tokens, and (rank 0) the mesh-free port's."""
    _, _, _, cache_len, _ = case(name)
    cfg = case_cfg(name)
    sh = make_policy(mesh)
    placed = _placed(cfg, params_np, mesh)
    toks = torch.as_tensor(prompt(cfg))
    out = {"greedy": greedy_decode(placed, cfg, toks, max_new=MAX_NEW, cache_len=cache_len,
                                   sh=sh, device="cpu", extras=_extras(cfg)).numpy()}
    out["logits"], out["steps"] = step_logits(placed, cfg, sh, cache_len)
    if _rank0():
        whole = params_from_jax(params_np, device="cpu")
        out["free_greedy"] = greedy_decode(whole, cfg, toks, max_new=MAX_NEW,
                                           cache_len=cache_len, device="cpu",
                                           extras=_extras(cfg)).numpy()
        out["free_logits"], _ = step_logits(whole, cfg, None, cache_len)
    return out


def _state_shapes(mesh):
    """Each case's decode state leaves on this rank: {case: {path: shape}}."""
    out = {}
    for name, _, _, cache_len, _ in CASES:
        cfg = case_cfg(name)
        st = TM.init_decode_state(cfg, BATCH, cache_len, device="cpu", sh=make_policy(mesh))
        out[name] = {k: tuple(v.shape) for k, v in flat_state(st).items()}
    return out


def _serve(mesh, params_np, sh=True):
    cfg = case_cfg("olmo")
    server = (Server(_placed(cfg, params_np, mesh), cfg, ServeConfig(**SERVE), make_policy(mesh),
                     device="cpu") if sh else
              Server(params_from_jax(params_np, device="cpu"), cfg, ServeConfig(**SERVE),
                     device="cpu"))
    for p in serve_prompts(cfg.vocab):
        server.submit(p)
    server.run(n_steps=200)
    return server.done


def _ssm_leaves(mesh, params):
    """One rank's gathered SSM leaves of layer 0 against the whole ones:
    {case: ({leaf: (shape, whole shape)}, in_proj x/z columns' max abs
    difference)}."""
    sh = make_policy(mesh)
    ts_rank = sh.model_index()
    out = {}
    for name, arch, kw in SSM_TRAIN:
        cfg = TP.case_cfg(arch, kw)
        whole = params_from_jax(params[name], device="cpu")["layers"][0]
        placed = _placed(cfg, params[name], mesh)["layers"][0]
        with torch.no_grad():
            got = sh.gather_layer(placed, cfg)
        block = "mamba" if cfg.family == "hybrid" else "cm"
        shapes = {f"{b}/{k}": (tuple(got[b][k].shape), tuple(whole[b][k].shape))
                  for b in (block, "tm") if b in got for k in got[b]}
        err = None
        if block == "mamba":
            di, n = cfg.d_model, cfg.d_model // mesh.size(1)
            w = whole["mamba"]["in_proj"]
            want = torch.cat([w[:, ts_rank * n:(ts_rank + 1) * n],
                              w[:, di + ts_rank * n:di + (ts_rank + 1) * n]], dim=1)
            err = float((got["mamba"]["in_proj"] - want).abs().max())
        out[name] = (shapes, err)
    return out


def _dry_step(mesh, params):
    """One real ``make_serve_step(cfg, sh)`` step from a fresh state, per
    dry-run case: the collective bytes by kind (``comm.STATS``) and the
    flops (``FlopCounterMode``) of this rank."""
    out = {}
    for name in DRY_CASES:
        _, _, _, cache_len, _ = case(name)
        cfg = case_cfg(name)
        sh = make_policy(mesh)
        placed = _placed(cfg, params[name], mesh)
        state = TM.init_decode_state(cfg, BATCH, cache_len, device="cpu", sh=sh)
        tok = torch.as_tensor(prompt(cfg))[sh.data_rows(BATCH), 0]
        step = make_serve_step(cfg, sh)
        comm.reset_stats()
        with FlopCounterMode(display=False) as fc:
            step(placed, state, tok)
        out[name] = (dict(comm.STATS["bytes"]), fc.get_total_flops())
    return out


ARGMAX_COLS = 8  # a rank's vocabulary columns in the argmax case: 32 in all, 30 valid


def argmax_logits():
    """(3, 32) logits with ties: row 0 tied across ranks 1 and 3, row 1
    within rank 2, row 2 whose largest values sit in the pad columns."""
    x = np.random.default_rng(5).normal(size=(3, 4 * ARGMAX_COLS)).astype(np.float32)
    x[0, [9, 27]] = 7.0
    x[1, [19, 21]] = 9.0
    x[2, [30, 31]] = 99.0
    return x


def _argmax(mesh):
    """``comm.vocab_argmax`` of this rank's columns of :func:`argmax_logits`."""
    r = mesh.get_coordinate()[1]
    x = torch.as_tensor(argmax_logits())[:, r * ARGMAX_COLS:(r + 1) * ARGMAX_COLS]
    return comm.vocab_argmax(x, r * ARGMAX_COLS, 4 * ARGMAX_COLS - 2,
                             mesh.get_group("model")).tolist()


def combine_inputs():
    """Scores (2, 3, 16) and values (2, 16, 5) over 16 keys, 4 a rank;
    ranks 1 and 3 hold no key of row 0 (-inf) and rank 2 none of row 1
    (-1e9, the decode mask)."""
    rng = np.random.default_rng(6)
    s = rng.normal(size=(2, 3, 16)).astype(np.float32)
    s[0, :, 4:8] = -np.inf
    s[0, :, 12:16] = -np.inf
    s[1, :, 8:12] = -1e9
    return s, rng.normal(size=(2, 16, 5)).astype(np.float32)


def _combine(mesh):
    """``comm.softmax_combine`` of this rank's keys of :func:`combine_inputs`."""
    r = mesh.get_coordinate()[1]
    s, v = (torch.as_tensor(a) for a in combine_inputs())
    s, v = s[..., r * 4:(r + 1) * 4], v[:, r * 4:(r + 1) * 4]
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(torch.isnan(p), 0.0, p)  # a row of -inf alone: exp(-inf - -inf)
    return comm.softmax_combine(m, p.sum(-1), torch.matmul(p, v), mesh.get_group("model")).numpy()


def mesh_14(mesh, params):
    """Every case of the (1, 4) mesh, in one spawn: rank 0 returns them."""
    out = {name: _decode(mesh, name, params[name]) for name, _, _, _, shapes in CASES
           if (1, 4) in shapes}
    out["argmax"] = _gathered(_argmax(mesh))
    out["combine"] = _gathered(_combine(mesh))
    out["state_shapes"] = _gathered(_state_shapes(mesh))
    out["ssm_leaves"] = _gathered(_ssm_leaves(mesh, params))
    for name, arch, kw in SSM_TRAIN:
        out[name] = TP._train(mesh, arch, kw, params[name])
    out["phase8f"] = _gathered(_phase8f(mesh))
    return out if _rank0() else None


def mesh_22(mesh, params):
    """Every case of the (2, 2) mesh, in one spawn: rank 0 returns them."""
    out = {name: _decode(mesh, name, params[name]) for name, _, _, _, shapes in CASES
           if (2, 2) in shapes}
    out["state_shapes"] = _gathered(_state_shapes(mesh))
    out["serve"] = _gathered(_serve(mesh, params["olmo"]))
    if _rank0():
        out["serve_free"] = _serve(None, params["olmo"], sh=False)
    out["dry"] = _dry_step(mesh, params)
    return out if _rank0() else None


def _gathered(obj):
    got = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(got, obj)
    return got


def _phase8f(mesh):
    """chip_smoke.py phase 8 (f)'s rank function at the smoke sizes."""
    repo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    return chip_smoke.mesh_decode_rank(mesh, True)


TIMED = dict(batch=8, cache_len=1024, fill=512, warm=5, steps=20)  # the four-card decode


def decode_time_rank(mesh):
    """One rank's split decode step of olmo-1b at full width and depth on
    the card, batch 8 at position 512 of a 1,024-slot cache, after warm-up
    steps: each timed step's seconds, the host seconds inside ``comm``
    calls and their bytes by kind, and every row's last greedy token."""
    import time

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = TC.get("olmo_1b")
    sh = make_policy(mesh)
    params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    placed = place_tree(params, param_spec_tree(params, sh), mesh)
    del params
    step = make_serve_step(cfg, sh)
    state = TM.init_decode_state(cfg, TIMED["batch"], TIMED["cache_len"], device=dev, sh=sh)
    state["pos"] = TIMED["fill"]
    rows = sh.data_rows(TIMED["batch"])
    tok = torch.full((rows.stop - rows.start,), 7, dtype=torch.int32, device=dev)
    out = {"rank": torch.distributed.get_rank(), "coordinate": list(mesh.get_coordinate()),
           "step_s": [], "comm_s": [], "bytes": None}
    for i in range(TIMED["warm"] + TIMED["steps"]):
        comm.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, _, state = step(placed, state, tok)
        torch.cuda.synchronize()
        if i >= TIMED["warm"]:
            out["step_s"].append(time.perf_counter() - t0)
            out["comm_s"].append(comm.STATS["seconds"])
            out["bytes"] = dict(comm.STATS["bytes"])
    every = comm.all_gather_rows(tok, sh.data_group()) if sh.data_size() > 1 else tok
    out["tokens"] = every.tolist()
    return out
