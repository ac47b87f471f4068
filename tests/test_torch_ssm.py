"""The port's SSM and hybrid families against the JAX reference, on the CPU.

rwkv6-3b (RWKV-6 time and channel mix) and hymba-1.5b (windowed attention
beside Mamba heads) at their smoke sizes, and rwkv6 at d_model 128, whose
two RWKV heads catch a wrong head reshape (the stock smoke config has one).
Both packages get the same weights: the reference's ``init_params`` pytree
with the token-shift mixes, the group-norm scale and Mamba's ``D`` redrawn
from a numpy seed (at init they are 0 and 1, which would hide the token
shift and the scales), carried across by ``params_from_jax``.  Inputs come
from numpy seeds.

Every reference result is computed by :func:`reference_results`: in this
process for float32, and for bfloat16 in a subprocess with XLA's
``--xla_allow_excess_precision=false``, so the reference rounds at every
operation, as the port does (tests/test_torch_model.py).  Tolerances:
float32 1e-4, bfloat16 5e-2 (tests/test_models.py's).
"""

import ast
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import repro.configs as RC
from repro.etl.batcher import make_token_batch
from repro.models import model as RM
from repro.models import ssm as RS
from repro.serve.decode import ServeConfig as RServeConfig
from repro.serve.decode import Server as RServer
from repro.serve.decode import greedy_decode as r_greedy_decode

import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.serve.decode import ServeConfig, Server, greedy_decode

REPO = os.path.join(os.path.dirname(__file__), "..")
# case: (arch, overrides of its smoke config)
CASES = {
    "rwkv6": ("rwkv6_3b", {}),
    "rwkv6-2heads": ("rwkv6_3b", {"d_model": 128}),
    "hymba": ("hymba_1_5b", {}),
}
RWKV = ["rwkv6", "rwkv6-2heads"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
KEY = jax.random.PRNGKey(0)
FWD_SHAPE = (2, 32)
DECODE_SHAPE, DECODE_CACHE = (3, 10), 8  # batch 3, 10 steps on 8 cache slots
UNIT_SHAPE = (2, 21)  # (B, S) of the block-level inputs: unaligned to the chunk


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=atol)


def _configs(case, dtype, **kw):
    """(reference config, port config) of a case."""
    arch, over = CASES[case]
    kw = dict(F32 if dtype == "float32" else {}, **over, **kw)
    return RC.get_smoke(arch).replace(**kw), TC.get_smoke(arch).replace(**kw)


def _redraw(tree, rng):
    """The mixes (uniform in [0, 1)), the group-norm scale and Mamba's D
    (1 + N(0, 0.2)) redrawn, the rest kept; numpy leaves of the same dtypes."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng)
            continue
        v = np.asarray(v)
        if k == "mu":
            v = rng.uniform(0.0, 1.0, v.shape).astype(v.dtype)
        elif k in ("gn_scale", "D"):
            v = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)
        out[k] = v
    return out


def _ref_params(rcfg):
    """The reference's parameters of ``rcfg`` (numpy leaves), redrawn."""
    jp = jax.tree_util.tree_map(np.asarray, RM.init_params(rcfg, KEY))
    return _redraw(jp, np.random.default_rng(3))


def _tokens(cfg, shape, seed):
    return make_token_batch(cfg, shape[0], shape[1], seed=seed)["tokens"]


def _x(cfg, shape, seed):
    """A block's input (B, S, D), float32 from a numpy seed (cast by the caller)."""
    return (0.5 * np.random.default_rng(seed).normal(size=(*shape, cfg.d_model))).astype(np.float32)


def _rwkv_state(cfg, b, seed):
    H = cfg.n_rwkv_heads
    hd = cfg.d_model // H
    rng = np.random.default_rng(seed)
    return {"x_tm": rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32),
            "wkv": (0.1 * rng.normal(size=(b, H, hd, hd))).astype(np.float32)}


def _mamba_state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return {"h": (0.1 * rng.normal(size=(b, cfg.d_model, cfg.ssm_state))).astype(np.float32),
            "conv": rng.normal(size=(b, TS.CONV_W - 1, cfg.d_model)).astype(np.float32)}


def _layer0(params, name):
    """Layer 0's ``name`` block of a reference parameter tree."""
    return jax.tree_util.tree_map(lambda a: a[0], params["layers"][name])


def _state_leaves(state, family):
    sub = state["rwkv"] if family == "ssm" else {**state["mamba"], "k": state["k"],
                                                 "v": state["v"]}
    return {k: np.asarray(v, np.float32) for k, v in sub.items()}


def reference_results(dtype: str) -> dict:
    """Every reference result the tests compare with, in ``dtype``."""
    out = {}
    for case in CASES:
        rcfg, _ = _configs(case, dtype)
        cd = rcfg.cdtype
        jp = _ref_params(rcfg)
        tokens = jnp.asarray(_tokens(rcfg, FWD_SHAPE, seed=0))
        impls = ("chunked", "scan") if rcfg.family == "ssm" else (rcfg.rwkv_impl,)
        for impl in impls:
            logits, _ = RM.forward(jp, rcfg.replace(rwkv_impl=impl), {"tokens": tokens})
            out[f"forward/{case}/{impl}"] = np.asarray(logits, np.float32)
        step = jax.jit(RM.decode_step, static_argnums=1)
        tokens = _tokens(rcfg, DECODE_SHAPE, seed=4)
        state = RM.init_decode_state(rcfg, DECODE_SHAPE[0], DECODE_CACHE)
        for t in range(DECODE_SHAPE[1]):
            logits, state = step(jp, rcfg, state, jnp.asarray(tokens[:, t]))
            out[f"decode/{case}/{t}"] = np.asarray(logits, np.float32)
            for k, v in _state_leaves(state, rcfg.family).items():
                out[f"state/{case}/{t}/{k}"] = v
        # the blocks, from a carried state
        x = jnp.asarray(_x(rcfg, UNIT_SHAPE, seed=1)).astype(cd)
        if rcfg.family == "ssm":
            st = _rwkv_state(rcfg, UNIT_SHAPE[0], seed=2)
            st = {"x_tm": jnp.asarray(st["x_tm"]).astype(cd), "wkv": jnp.asarray(st["wkv"])}
            for impl in ("scan", "chunked"):
                o, ns = RS.rwkv_train(_layer0(jp, "tm"), x, rcfg, state=st, impl=impl)
                out[f"rwkv_train/{case}/{impl}"] = np.asarray(o, np.float32)
                out[f"rwkv_train/{case}/{impl}/wkv"] = np.asarray(ns["wkv"])
            o, _ = RS.rwkv_channel_mix(_layer0(jp, "cm"), x, st["x_tm"], rcfg)
            out[f"channel_mix/{case}"] = np.asarray(o, np.float32)
        else:
            st = {k: jnp.asarray(v) for k, v in _mamba_state(rcfg, UNIT_SHAPE[0], seed=2).items()}
            o, ns = RS.mamba_train(_layer0(jp, "mamba"), x, rcfg, state=st)
            out[f"mamba_train/{case}"] = np.asarray(o, np.float32)
            for k in ("h", "conv"):
                out[f"mamba_train/{case}/{k}"] = np.asarray(ns[k])
    return out


_BF16_REFERENCE = """
import sys
import numpy as np
sys.path.insert(0, %(tests)r)
import test_torch_ssm as T
np.savez(%(path)r, **T.reference_results("bfloat16"))
"""


@pytest.fixture(scope="module")
def reference_float32():
    return reference_results("float32")


@pytest.fixture(scope="module")
def reference_bfloat16(tmp_path_factory):
    """:func:`reference_results` in bfloat16, in a subprocess with XLA's
    excess precision off (see the module docstring)."""
    path = str(tmp_path_factory.mktemp("bf16") / "reference.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    code = textwrap.dedent(_BF16_REFERENCE % {"tests": os.path.dirname(os.path.abspath(__file__)),
                                              "path": path})
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def _reference(request, dtype):
    return request.getfixturevalue(f"reference_{dtype}")


def _port_params(rcfg):
    return params_from_jax(_ref_params(rcfg), device="cpu")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["rwkv6", "hymba"])
def test_params_from_jax_carries_the_ssm_layouts_bit_for_bit(case):
    rcfg, _ = _configs(case, "bfloat16")
    jp = RM.init_params(rcfg, KEY)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    want_keys = ({"ln1", "tm", "ln2", "cm"} if rcfg.family == "ssm"
                 else {"norm1", "attn", "norm2", "mamba", "mlp"})
    assert len(tp["layers"]) == rcfg.n_layers
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp["layers"]):
        keys = [p.key for p in path]
        for layer in range(rcfg.n_layers):
            assert set(tp["layers"][layer]) == want_keys
            got = tp["layers"][layer]
            for k in keys:
                got = got[k]
            want = np.asarray(leaf)[layer]
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("case", list(CASES))
def test_init_params_follows_the_reference_layout(case):
    rcfg, tcfg = _configs(case, "bfloat16")
    jp = RM.init_params(rcfg, KEY)
    tp = TM.init_params(tcfg, 0, device="cpu")
    leaves = jax.tree_util.tree_leaves_with_path(jp["layers"])
    for path, leaf in leaves:
        got = tp["layers"][0]
        for p in path:
            got = got[p.key]
        assert tuple(got.shape) == leaf.shape[1:] and got.dtype == torch.bfloat16
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    # the deterministic leaves equal the reference's
    for block, names in (("tm", ("w0", "gn_scale", "mu")), ("cm", ("mu",)),
                         ("mamba", ("dt_bias", "A_log", "D"))):
        if block not in tp["layers"][0]:
            continue
        for name in names:
            want = np.asarray(jp["layers"][block][name])[0]
            _close(_np(tp["layers"][0][block][name]), want.astype(np.float32), 0)


# ---------------------------------------------------------------------------
# RWKV-6 blocks (float32, the reference in this process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", RWKV)
def test_rwkv_inputs_match_reference(case):
    rcfg, tcfg = _configs(case, "float32")
    p = _layer0(_ref_params(rcfg), "tm")
    x = _x(rcfg, UNIT_SHAPE, seed=1)
    x_prev = _rwkv_state(rcfg, UNIT_SHAPE[0], seed=2)["x_tm"]
    want = RS._rwkv_inputs(p, jnp.asarray(x), jnp.asarray(x_prev), rcfg)
    got = TS._rwkv_inputs({k: _t(v) for k, v in p.items()}, _t(x), _t(x_prev), tcfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(_np(g), w, 1e-5)
    assert float(got[5].min()) >= -4.0  # the decay clamp


def _wkv_operands(B, S, H, hd, seed):
    """r, k, v (B, S, H, hd), a decay w in (e^-4, 1), u (H, hd), a state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3))
    w = np.exp(np.maximum(-np.exp(rng.normal(size=(B, S, H, hd)) - 1.0), -4.0)).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(B, H, hd, hd))).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("S", [1, 17, 32])
def test_wkv_scan_matches_reference(S):
    ops = _wkv_operands(2, S, 3, 8, seed=S)
    want_o, want_s = RS._wkv_scan(*(jnp.asarray(a) for a in ops))
    got_o, got_s = TS._wkv_scan(*(_t(a) for a in ops))
    assert got_o.shape == (2, S, 3, 8)
    _close(_np(got_o), want_o, 1e-4)
    _close(_np(got_s), want_s, 1e-4)


@pytest.mark.parametrize("S", [16, 37, 48], ids=["aligned", "unaligned", "three-chunks"])
def test_wkv_chunked_matches_reference(S):
    ops = _wkv_operands(2, S, 3, 8, seed=100 + S)
    want_o, want_s = RS._wkv_chunked(*(jnp.asarray(a) for a in ops))
    got_o, got_s = TS._wkv_chunked(*(_t(a) for a in ops))
    assert got_o.shape == (2, S, 3, 8)
    _close(_np(got_o), want_o, 1e-4)
    _close(_np(got_s), want_s, 1e-4)
    # and the scan, for the port alone
    scan_o, scan_s = TS._wkv_scan(*(_t(a) for a in ops))
    _close(_np(got_o), _np(scan_o), 1e-4)
    _close(_np(got_s), _np(scan_s), 1e-4)


@pytest.mark.parametrize("H", [1, 2, 4])
def test_group_norm_matches_reference(H):
    rng = np.random.default_rng(H)
    o = (3.0 * rng.normal(size=(2, 5, H, 16)) + 1.0).astype(np.float32)
    o[0, 0, 0] = 7.0  # a constant head: the population variance is 0, eps keeps it finite
    scale = rng.normal(size=H * 16).astype(np.float32)
    want = RS._group_norm(jnp.asarray(o), jnp.asarray(scale), H)
    got = TS._group_norm(_t(o), _t(scale), H)
    _close(_np(got), want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["scan", "chunked"])
@pytest.mark.parametrize("case", RWKV)
def test_rwkv_train_with_carried_state_matches_reference(case, impl, dtype, request):
    rcfg, tcfg = _configs(case, dtype)
    cd = tcfg.cdtype
    p = {k: _t(v) for k, v in _layer0(_ref_params(rcfg), "tm").items()}
    st = _rwkv_state(rcfg, UNIT_SHAPE[0], seed=2)
    state = {"x_tm": _t(st["x_tm"]).to(cd), "wkv": _t(st["wkv"])}
    o, ns = TS.rwkv_train(p, _t(_x(rcfg, UNIT_SHAPE, seed=1)).to(cd), tcfg, state=state,
                          impl=impl)
    ref = _reference(request, dtype)
    assert o.dtype == cd and ns["wkv"].dtype == torch.float32
    _close(_np(o), ref[f"rwkv_train/{case}/{impl}"], TOL[dtype])
    _close(_np(ns["wkv"]), ref[f"rwkv_train/{case}/{impl}/wkv"], TOL[dtype])
    assert torch.equal(state["wkv"], _t(st["wkv"]))  # the state is read, never written


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RWKV)
def test_rwkv_channel_mix_matches_reference(case, dtype, request):
    rcfg, tcfg = _configs(case, dtype)
    cd = tcfg.cdtype
    p = {k: _t(v) for k, v in _layer0(_ref_params(rcfg), "cm").items()}
    x = _t(_x(rcfg, UNIT_SHAPE, seed=1)).to(cd)
    x_prev = _t(_rwkv_state(rcfg, UNIT_SHAPE[0], seed=2)["x_tm"]).to(cd)
    o, last = TS.rwkv_channel_mix(p, x, x_prev, tcfg)
    assert o.dtype == cd and torch.equal(last, x[:, -1:])
    _close(_np(o), _reference(request, dtype)[f"channel_mix/{case}"], TOL[dtype])


# ---------------------------------------------------------------------------
# Mamba blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 3, 24])
def test_mamba_core_matches_reference(S):
    """From a carried conv tail and h: S 1 is a decode step (the tail is the
    last two carried rows and the new one), S 3 exactly the conv width."""
    rcfg, tcfg = _configs("hymba", "float32")
    p = _layer0(_ref_params(rcfg), "mamba")
    rng = np.random.default_rng(S)
    xz = (0.5 * rng.normal(size=(2, S, 2 * rcfg.d_model))).astype(np.float32)
    st = _mamba_state(rcfg, 2, seed=S + 1)
    want = RS._mamba_core(p, jnp.asarray(xz), jnp.asarray(st["conv"]), jnp.asarray(st["h"]), rcfg)
    got = TS._mamba_core({k: _t(v) for k, v in p.items()}, _t(xz), _t(st["conv"]), _t(st["h"]),
                         tcfg)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(_np(g), w, 1e-4)
    if S == 1:
        np.testing.assert_array_equal(_np(got[2])[:, :2], st["conv"][:, 1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_train_with_carried_state_matches_reference(dtype, request):
    rcfg, tcfg = _configs("hymba", dtype)
    p = {k: _t(v) for k, v in _layer0(_ref_params(rcfg), "mamba").items()}
    st = {k: _t(v) for k, v in _mamba_state(rcfg, UNIT_SHAPE[0], seed=2).items()}
    o, ns = TS.mamba_train(p, _t(_x(rcfg, UNIT_SHAPE, seed=1)).to(tcfg.cdtype), tcfg, state=st)
    ref = _reference(request, dtype)
    assert o.dtype == tcfg.cdtype
    _close(_np(o), ref["mamba_train/hymba"], TOL[dtype])
    for k in ("h", "conv"):
        assert ns[k].dtype == torch.float32
        _close(_np(ns[k]), ref[f"mamba_train/hymba/{k}"], TOL[dtype])


def test_conv_tail_is_rounded_to_the_input_dtype():
    """The carried conv rows are cast to the input's dtype before the
    concatenation (bfloat16 at full size), as the reference casts them."""
    _, tcfg = _configs("hymba", "bfloat16")
    conv_prev = torch.full((1, TS.CONV_W - 1, 4), 1.0 + 2.0 ** -12)  # not a bfloat16 value
    x = torch.zeros((1, 1, 4), dtype=torch.bfloat16)
    _, tail = TS._causal_conv(x, conv_prev, torch.ones((TS.CONV_W, 4)))
    assert tail.dtype == torch.float32
    assert torch.equal(tail[0, :2], torch.ones((2, 4)))


def test_ssm_module_keeps_its_own_recurrences():
    """No ``F.conv1d`` (cuDNN sums in another order) and no library scan:
    the recurrences are the module's own loops."""
    src = open(TS.__file__).read()
    calls = {node.func.attr for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)}
    assert not calls & {"conv1d", "associative_scan", "scan", "cumprod"}
    assert "conv1d(" not in src


# ---------------------------------------------------------------------------
# forward (the prefill), decode, serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_reference(case, dtype, request):
    rcfg, tcfg = _configs(case, dtype)
    tp = _port_params(rcfg)
    tokens = _t(_tokens(rcfg, FWD_SHAPE, seed=0))
    ref = _reference(request, dtype)
    impls = ("chunked", "scan") if tcfg.family == "ssm" else (tcfg.rwkv_impl,)
    for impl in impls:
        got, aux = TM.forward(tp, tcfg.replace(rwkv_impl=impl), {"tokens": tokens})
        assert got.dtype == tcfg.cdtype and got.shape == (*FWD_SHAPE, tcfg.vocab_padded)
        assert aux.dtype == torch.float32 and float(aux) == 0.0
        _close(_np(got), ref[f"forward/{case}/{impl}"], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps_and_states_match_reference(case, dtype, request):
    """Step-by-step logits and the whole decode state after every step;
    hymba's rolling cache holds min(8, 16) = 8 slots, so steps 8 and 9
    wrap its write slot."""
    rcfg, tcfg = _configs(case, dtype)
    tp = _port_params(rcfg)
    tokens = _tokens(rcfg, DECODE_SHAPE, seed=4)
    ref = _reference(request, dtype)
    state = TM.init_decode_state(tcfg, DECODE_SHAPE[0], DECODE_CACHE, device="cpu")
    for t in range(DECODE_SHAPE[1]):
        got, state = TM.decode_step(tp, tcfg, state, _t(tokens[:, t]))
        assert state["pos"] == t + 1
        _close(_np(got), ref[f"decode/{case}/{t}"], TOL[dtype])
        leaves = state["rwkv"] if tcfg.family == "ssm" else {**state["mamba"], "k": state["k"],
                                                             "v": state["v"]}
        for k, v in leaves.items():
            _close(_np(v), ref[f"state/{case}/{t}/{k}"], TOL[dtype])


@pytest.mark.parametrize("case", ["rwkv6", "hymba"])
def test_decode_state_is_written_in_place(case):
    _, tcfg = _configs(case, "float32")
    tp = TM.init_params(tcfg, 0, device="cpu")
    state = TM.init_decode_state(tcfg, 2, 8, device="cpu")
    sub = "rwkv" if tcfg.family == "ssm" else "mamba"
    held = dict(state[sub])
    assert all(v.device.type == "cpu" for v in held.values())
    for _ in range(3):
        _, state = TM.decode_step(tp, tcfg, state, torch.tensor([5, 9]))
    assert all(state[sub][k] is v for k, v in held.items())
    assert all(bool(v.abs().sum() > 0) for v in held.values())
    assert state["pos"] == 3


def test_init_decode_state_layouts():
    _, rwkv = _configs("rwkv6-2heads", "bfloat16")
    st = TM.init_decode_state(rwkv, 3, 64, device="cpu")
    assert set(st) == {"pos", "rwkv"}
    assert st["rwkv"]["wkv"].shape == (2, 3, 2, 64, 64) and st["rwkv"]["wkv"].dtype == torch.float32
    for k in ("x_tm", "x_cm"):
        assert st["rwkv"][k].shape == (2, 3, 1, 128) and st["rwkv"][k].dtype == torch.bfloat16
    _, hymba = _configs("hymba", "bfloat16")
    st = TM.init_decode_state(hymba, 3, 64, device="cpu")
    assert st["k"].shape == (2, 3, 16, 2, 16)  # min(cache_len, window) slots
    assert st["mamba"]["h"].shape == (2, 3, 64, 4) and st["mamba"]["h"].dtype == torch.float32
    assert st["mamba"]["conv"].shape == (2, 3, 3, 64)
    assert st["mamba"]["conv"].dtype == torch.float32


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_decode_matches_reference(case):
    rcfg, tcfg = _configs(case, "float32")
    jp = _ref_params(rcfg)
    tp = params_from_jax(jp, device="cpu")
    prompt = np.random.default_rng(0).integers(2, rcfg.vocab, (2, 4)).astype(np.int32)
    want = np.asarray(r_greedy_decode(jp, rcfg, jnp.asarray(prompt), max_new=6, cache_len=32))
    got = greedy_decode(tp, tcfg, torch.from_numpy(prompt), max_new=6, cache_len=32,
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(CASES))
def test_server_matches_reference(case):
    """Five requests through a 2-slot server, token for token."""
    rcfg, tcfg = _configs(case, "float32")
    jp = _ref_params(rcfg)
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, rcfg.vocab, int(n)).tolist() for n in (3, 2, 5, 3, 4)]
    sc_kw = dict(batch=2, cache_len=64, max_new=5, eos=-1)
    rs = RServer(jp, rcfg, RServeConfig(**sc_kw))
    ts = Server(tp, tcfg, ServeConfig(**sc_kw), device="cpu")
    for p in prompts:
        rs.submit(p)
        ts.submit(p)
    rs.run(n_steps=200)
    ts.run(n_steps=200)
    assert len(ts.done) == len(prompts)
    assert ts.done == rs.done


def _launch(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


@pytest.mark.parametrize("etl", [False, True], ids=["random", "etl"])
@pytest.mark.parametrize("arch", ["rwkv6_3b", "hymba_1_5b"])
def test_serve_launcher_runs_on_cpu(arch, etl):
    proc = _launch("--arch", arch, "--smoke", "--device", "cpu", *(["--etl"] if etl else []))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert any(line.startswith("etl: ") for line in lines) == etl
    requests = [line for line in lines if line.startswith("request ")]
    assert len(requests) == 8  # --requests 8
    for i, line in enumerate(requests):  # 16 tokens, or fewer ending at EOS 0
        m = re.match(rf"request {i}: (\d+) tokens -> \[", line)
        assert m and 1 <= int(m.group(1)) <= 16, line


# ---------------------------------------------------------------------------
# the invariants of tests/test_ssm_moe.py and tests/test_models.py, for the port
# ---------------------------------------------------------------------------


def _rwkv_block(S, seed=1):
    _, tcfg = _configs("rwkv6-2heads", "float32")
    p = TS.rwkv_params(torch.Generator().manual_seed(seed), tcfg)
    p["mu"] = torch.rand((5, tcfg.d_model), generator=torch.Generator().manual_seed(seed))
    return tcfg, p, _t(_x(tcfg, (2, S), seed=seed))


@pytest.mark.parametrize("S", [48, 37])
def test_chunked_equals_scan(S):
    tcfg, p, x = _rwkv_block(S)
    o1, s1 = TS.rwkv_train(p, x, tcfg, impl="scan")
    o2, s2 = TS.rwkv_train(p, x, tcfg, impl="chunked")
    _close(_np(o2), _np(o1), 1e-4)
    _close(_np(s2["wkv"]), _np(s1["wkv"]), 1e-4)


@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_rwkv_streaming_state_equals_batch(impl):
    """[0:S] at once == [0:20] then [20:S] with the carried state."""
    tcfg, p, x = _rwkv_block(32)
    o_full, s_full = TS.rwkv_train(p, x, tcfg, impl=impl)
    o_a, s_a = TS.rwkv_train(p, x[:, :20], tcfg, impl=impl)
    o_b, s_b = TS.rwkv_train(p, x[:, 20:], tcfg, state=s_a, impl=impl)
    _close(_np(o_b), _np(o_full[:, 20:]), 1e-4)
    _close(_np(s_b["wkv"]), _np(s_full["wkv"]), 1e-4)


def test_mamba_streaming_state_equals_batch():
    _, tcfg = _configs("hymba", "float32")
    p = TS.mamba_params(torch.Generator().manual_seed(7), tcfg)
    x = _t(_x(tcfg, (2, 24), seed=2))
    o_full, s_full = TS.mamba_train(p, x, tcfg)
    _, s_a = TS.mamba_train(p, x[:, :11], tcfg)
    o_b, s_b = TS.mamba_train(p, x[:, 11:], tcfg, state=s_a)
    _close(_np(o_b), _np(o_full[:, 11:]), 1e-4)
    _close(_np(s_b["h"]), _np(s_full["h"]), 1e-4)
    _close(_np(s_b["conv"]), _np(s_full["conv"]), 0)


@pytest.mark.parametrize("w0", [0.5, 2.0])
def test_decay_clamp_keeps_chunked_finite(w0):
    """The decay LoRA pushed hard (w0 0.5, the reference test's; at 2.0
    every step's -exp(w0 + lora) is below -4, and only the clamp keeps the
    chunk's exp(-cum) factors, e^(16 * 7.4) unclamped, inside float32)."""
    tcfg, p, x = _rwkv_block(64)
    p["w0"] = torch.full_like(p["w0"], w0)
    o, st = TS.rwkv_train(p, x, tcfg, impl="chunked")
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(st["wkv"]).all())
    _, _, _, _, _, logw = TS._rwkv_inputs(p, x, torch.zeros_like(x[:, :1]), tcfg)
    assert (float(logw.max()) == -4.0) == (w0 == 2.0)


@pytest.mark.parametrize("case,S", [("rwkv6", 12), ("rwkv6-2heads", 12), ("hymba", 24)])
def test_decode_matches_teacher_forcing(case, S):
    """Streaming decode logits == the prefill's (float32, port alone);
    hymba's S 24 crosses its 16-token window, so the rolling cache wraps."""
    _, tcfg = _configs(case, "float32")
    tp = TM.init_params(tcfg, 0, device="cpu")
    tokens = _t(_tokens(tcfg, (2, S), seed=2))
    full, _ = TM.forward(tp, tcfg, {"tokens": tokens})
    state = TM.init_decode_state(tcfg, 2, S, device="cpu")
    got = []
    for t in range(S):
        logits, state = TM.decode_step(tp, tcfg, state, tokens[:, t])
        got.append(logits)
    _close(_np(torch.stack(got, 1)), _np(full), 1e-4)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 5c, rehearsed on the CPU at the smoke sizes
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("arch", ["rwkv6_3b", "hymba_1_5b"])
def test_chip_smoke_ssm_phase_rehearsal(arch):
    """Phase 5c's prefill checks (bf16) and its float32 checks at 2 layers
    on the CPU (the "card" side is the CPU too); hymba's teacher forcing
    crosses its 16-token window, as the card's crosses 1,024."""
    smoke = _chip_smoke()
    cpu = torch.device("cpu")
    cfg = TC.get_smoke(arch)
    params = TM.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab, (2, 40)))
    out = smoke.ssm_prefill_checks(cfg.name, params, cfg, {"tokens": tokens})
    assert out["shape_ok"] and out["repeat_bit_identical"] and out["port_kernel_launches"] == 0
    teacher = 24 if cfg.window else 12
    cut = smoke.ssm_cut_f32(cpu, cfg.replace(n_layers=smoke.CUT_LAYERS, **F32), teacher=teacher,
                            prompts=(32, 30))
    assert cut["server_tokens_equal"] and cut["teacher_forcing_f32"]["tokens"] == teacher
    assert cut["card_vs_cpu_f32_30"]["max_abs_err"] == 0
    assert ("chunked_vs_scan_f32" in cut) == (cfg.family == "ssm")


def test_chip_smoke_ssm_ranges_wrap_and_restore():
    """The profiler's ranges leave the forward unchanged and the model's
    functions as they were."""
    smoke = _chip_smoke()
    for arch in ("rwkv6_3b", "hymba_1_5b"):
        cfg = TC.get_smoke(arch).replace(**F32)
        params = TM.init_params(cfg, 0, device="cpu")
        tokens = _t(_tokens(cfg, (1, 20), seed=3))
        want, _ = TM.forward(params, cfg, {"tokens": tokens})
        before = (TM.rwkv_train, TM.mamba_train, TM.lm_logits, TS._wkv_chunked, TS._selective_scan)
        with smoke.ssm_ranges(cfg):
            assert TM.lm_logits is not before[2]
            got, _ = TM.forward(params, cfg, {"tokens": tokens})
        assert (TM.rwkv_train, TM.mamba_train, TM.lm_logits, TS._wkv_chunked,
                TS._selective_scan) == before
        assert torch.equal(got, want)


def test_chip_smoke_ssm_split_and_decode_bytes():
    smoke = _chip_smoke()
    rwkv, hymba = TC.get_smoke("rwkv6_3b"), TC.get_smoke("hymba_1_5b")
    profile = {"device_us": 100.0, "range_device_us": {
        "ssm.time_mix": 50.0, "ssm.inputs": 20.0, "ssm.wkv": 25.0, "ssm.channel_mix": 30.0,
        "ssm.head": 10.0}}
    split = smoke.ssm_split(profile, rwkv)
    assert {k: v["us"] for k, v in split.items()} == {
        "time-mix projections and LoRA": 20.0, "wkv recurrence": 25.0,
        "group norm, gate and output": 5.0, "channel mix": 30.0, "head": 10.0, "rest": 10.0}
    profile = {"device_us": 100.0, "range_device_us": {
        "ssm.attention": 20.0, "ssm.mamba": 40.0, "ssm.mamba_core": 30.0, "ssm.conv": 5.0,
        "ssm.x_proj_dt": 6.0, "ssm.scan": 15.0, "ssm.mlp": 25.0, "ssm.head": 5.0}}
    split = smoke.ssm_split(profile, hymba)
    assert {k: v["us"] for k, v in split.items()} == {
        "attention": 20.0, "mamba in_proj and out_proj": 10.0, "mamba conv": 5.0,
        "mamba x_proj and dt": 6.0, "mamba scan": 15.0, "mamba gate": 4.0, "mlp": 25.0,
        "head": 5.0, "rest": 10.0}
    assert smoke.ssm_split({**profile, "range_device_us": {}}, hymba) is None
    # the step's bytes: the weights but the embedding table, the recurrent
    # state read and written, the rolling window's filled slots, the logits
    for cfg, fill in ((rwkv, 3), (hymba, 3), (hymba, 40)):
        params = TM.init_params(cfg, 0, device="cpu")
        state = TM.init_decode_state(cfg, 8, 64, device="cpu")
        emb = params["embed"]["tok"]
        want = sum(t.numel() * t.element_size() for t in smoke._tensors(params))
        want += 8 * cfg.d_model * 2 - emb.numel() * 2 + 8 * cfg.vocab_padded * 2
        rec = state["rwkv"] if cfg.family == "ssm" else state["mamba"]
        want += 2 * sum(t.numel() * t.element_size() for t in rec.values())
        if cfg.family == "hybrid":
            slots = min(fill + 1, cfg.window)
            want += 2 * cfg.n_layers * 8 * slots * cfg.n_kv_heads * cfg.hd * 2
        assert smoke.decode_bytes(params, cfg, batch=8, fill=fill) == want


class _Event:
    """One event of a raw profiler trace, as ``_KinetoEvent`` answers."""

    def __init__(self, name, device, start, dur, corr=0, linked=0):
        self._v = (name, device, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[1] == "cuda"
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_chip_smoke_trace_sums_attribute_kernels_to_ranges():
    """A kernel counts in every range (nested ones too) whose interval
    holds the start of the operator that launched it; a range's own
    device-side event is its span, kept out of the kernels."""
    smoke = _chip_smoke()
    events = [
        _Event("ssm.mamba", "cpu", 100, 100), _Event("ssm.scan", "cpu", 150, 30),
        _Event("ssm.mamba", "cpu", 400, 50),
        _Event("aten::mul", "cpu", 110, 5, corr=1), _Event("aten::add_", "cpu", 160, 5, corr=2),
        _Event("aten::mm", "cpu", 300, 5, corr=3), _Event("aten::mul", "cpu", 420, 5, corr=4),
        _Event("cudaLaunchKernel", "cpu", 161, 2, corr=99, linked=2),
        _Event("mul_kernel", "cuda", 1000, 2000, linked=1),
        _Event("add_kernel", "cuda", 3000, 3000, linked=2),
        _Event("gemm", "cuda", 7000, 7000, linked=3),
        _Event("mul_kernel", "cuda", 9000, 4000, linked=4),
        _Event("ssm.scan", "cuda", 3000, 3500),
    ]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    device, ranges, spans = smoke._trace_sums(Prof)
    assert device == {"mul_kernel": (6.0, 2), "add_kernel": (3.0, 1), "gemm": (7.0, 1)}
    assert ranges == {"ssm.mamba": 9.0, "ssm.scan": 3.0}
    assert spans == {"ssm.scan": 3.5}


def test_chip_smoke_ssm_launcher_rehearsal(monkeypatch):
    """The launcher's runs of phase 5c with the smoke configs on the CPU:
    every request answered, and a request left unanswered fails."""
    smoke = _chip_smoke()
    launches = {name: ([*argv, "--smoke", "--device", "cpu", "--requests", "3",
                        "--max-new", "4"], 3)
                for name, (argv, _) in smoke.SSM_LAUNCHES.items()}
    assert any("--etl" in argv for argv, _ in launches.values())
    assert {argv[1] for argv, _ in launches.values()} == {"rwkv6_3b", "hymba_1_5b"}
    out = smoke.run_launcher(launches, "5c")
    assert all(v["requests"] == v["answered"] == 3 for v in out.values())
    name, (argv, _) = next(iter(launches.items()))
    with pytest.raises(AssertionError, match="not every request answered"):
        smoke.run_launcher({name: (argv, 4)}, "5c")


# ---------------------------------------------------------------------------
# on the card (marker gpu; skipped without a Hopper card)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    """The Hopper card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0) with CUDA")
    return torch.device("cuda")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_forward_on_the_card_matches_the_cpu(case, card):
    """float32 on the card against the CPU (TF32 off, PyTorch's default for
    matmul), both RWKV forms; bfloat16 repeat calls on the card bit-identical."""
    rcfg, tcfg = _configs(case, "float32")
    tp = _port_params(rcfg)
    tokens = _t(_tokens(rcfg, FWD_SHAPE, seed=0))
    impls = ("chunked", "scan") if tcfg.family == "ssm" else (tcfg.rwkv_impl,)
    for impl in impls:
        cfg = tcfg.replace(rwkv_impl=impl)
        want, _ = TM.forward(tp, cfg, {"tokens": tokens})
        got, _ = TM.forward(_to(tp, card), cfg, {"tokens": tokens.to(card)})
        _close(_np(got.cpu()), _np(want), 1e-4)
    bcfg = tcfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    bp = TM.init_params(bcfg, 0, device=card)
    a, _ = TM.forward(bp, bcfg, {"tokens": tokens.to(card)})
    b, _ = TM.forward(bp, bcfg, {"tokens": tokens.to(card)})
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_decode_on_the_card_matches_the_cpu(case, card):
    rcfg, tcfg = _configs(case, "float32")
    tp = _port_params(rcfg)
    tokens = _t(_tokens(rcfg, (2, 20), seed=4))
    on_cpu = TM.init_decode_state(tcfg, 2, 8, device="cpu")
    on_card = TM.init_decode_state(tcfg, 2, 8, device=card)
    dp = _to(tp, card)
    for t in range(20):
        want, on_cpu = TM.decode_step(tp, tcfg, on_cpu, tokens[:, t])
        got, on_card = TM.decode_step(dp, tcfg, on_card, tokens[:, t].to(card))
        _close(_np(got.cpu()), _np(want), 1e-4)
    sub = "rwkv" if tcfg.family == "ssm" else "mamba"
    for k, v in on_cpu[sub].items():
        _close(_np(on_card[sub][k].cpu()), _np(v), 1e-4)
