"""The port's training path against the JAX reference, on the CPU.

``models.layers.cross_entropy``, ``models.model.loss_fn`` and its
gradients, remat, ``train.optimizer`` (AdamW, int8 quantization),
``train.loop.make_train_step`` and ``core.convert.params_to_jax``.  Both
packages get the same weights: the reference's ``init_params`` pytree with
the token-shift mixes, the norms' scales and biases, the group-norm scale
and Mamba's ``D`` redrawn from a numpy seed (at init they are 0 or 1,
which would hide terms), carried across by ``params_from_jax``; inputs come
from numpy seeds, with a 0/1 ``loss_weight``.  The reference's gradients
are ``jax.jit(jax.value_and_grad(loss_fn))``, computed once per case and
shared by the tests (:func:`reference_grads`).

Tolerances: float32 1e-4 (atol and rtol), as tests/test_torch_model.py;
bfloat16 5e-2, against the reference run in a subprocess with XLA's excess
precision off (tests/test_torch_model.py says why).  AdamW after 3 steps
(lr 1e-2), moments at ``ADAMW_TOL``; the largest differences found: with
float32 moments and parameters 6.0e-8 in a parameter, 1.2e-10 in m and
4.5e-13 in v; with bfloat16 moments 2.4e-7 in m (one bfloat16 ulp of a
small moment) and 5.2e-5 in a float32 parameter (that ulp moves a step by
up to 2^-7 of lr); bfloat16 parameters one bfloat16 ulp (1.2e-4 and
2.4e-4).  ``pow`` and the division round differently in XLA and PyTorch.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import ml_dtypes
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as RC
from repro.etl.batcher import make_token_batch
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import ssm as RS
from repro.train import loop as RLOOP
from repro.train import optimizer as ROPT

import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax, params_to_jax
from repro_torch.kernels import flash_attention as TFLASH
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.train import loop as TLOOP
from repro_torch.train import optimizer as TOPT
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten

REPO = os.path.join(os.path.dirname(__file__), "..")
KEY = jax.random.PRNGKey(0)
F32 = dict(param_dtype="float32", compute_dtype="float32")
SHAPE = (2, 16)  # (B, S) of the gradient cases
# case: (arch, overrides of its float32 smoke config)
CASES = {
    "olmo": ("olmo_1b", {}),
    "olmo-chunked": ("olmo_1b", {"attn_impl": "chunked"}),
    "olmo-pallas": ("olmo_1b", {"attn_impl": "pallas"}),
    "qwen3-moe": ("qwen3_moe_30b_a3b", {}),
    "qwen3-moe-dmm": ("qwen3_moe_30b_a3b", {"moe_impl": "dmm"}),
    "rwkv6": ("rwkv6_3b", {}),
    "rwkv6-chunked": ("rwkv6_3b", {"rwkv_impl": "chunked"}),
    "hymba": ("hymba_1_5b", {}),
    "whisper": ("whisper_tiny", {}),
    "internvl2": ("internvl2_1b", {}),
}
REMAT_CASES = ["olmo", "qwen3-moe", "rwkv6-chunked", "hymba", "whisper", "internvl2"]
ADAMW_TOL = {"float32": (1e-6, 1e-5), "bfloat16": (1e-6, 2 ** -7)}  # (atol, rtol) of m, v


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(a) -> np.ndarray:
    """A leaf as float32 numpy: a port tensor, a reference array, or a
    ``uint16`` view of bfloat16 bits (what ``params_to_jax`` writes)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    a = np.asarray(a)
    if a.dtype == np.uint16:
        a = a.view(ml_dtypes.bfloat16)
    return a.astype(np.float32)


def _close(got, want, atol, rtol=None, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol,
                               rtol=atol if rtol is None else rtol, err_msg=what)


def _flat(tree, prefix=""):
    """{'/'-joined path: leaf} of a nested dict (the reference's layout)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_trees_close(got, want, atol, rtol=None):
    """Every leaf of two reference-layout trees (port side through
    ``params_to_jax``) within tolerance, the same leaves on both sides."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for name in w:
        _close(g[name], w[name], atol, rtol, what=name)


def _assert_adam_close(got, want, lr, steps):
    """Parameters after ``steps`` AdamW steps at ``lr``: within 1e-5 but
    for at most one element in 10^4, and every element within the most the
    steps can move it.  Where a gradient is at float32 noise (a few 1e-9),
    Adam's normalised step is +-lr either way, so a few elements part by up
    to lr a step."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for name in w:
        d = np.abs(_f32(g[name]) - _f32(w[name]))
        assert d.max(initial=0) <= 2 * lr * steps, name
        assert np.count_nonzero(d > 1e-5 + 1e-5 * np.abs(_f32(w[name]))) <= d.size * 1e-4, name


def _configs(case, dtype="float32"):
    arch, over = CASES[case]
    kw = dict(F32 if dtype == "float32" else {}, **over)
    return RC.get_smoke(arch).replace(**kw), TC.get_smoke(arch).replace(**kw)


def _redraw(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng)
            continue
        v = np.asarray(v)
        if k == "mu":
            v = rng.uniform(0.0, 1.0, v.shape).astype(v.dtype)
        elif k in ("scale", "gn_scale", "D"):
            v = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)
        elif k == "bias":
            v = (0.1 * rng.normal(size=v.shape)).astype(v.dtype)
        out[k] = v
    return out


def _ref_params(rcfg):
    jp = jax.tree_util.tree_map(np.asarray, RM.init_params(rcfg, KEY))
    return _redraw(jp, np.random.default_rng(3))


def _batch(cfg, shape=SHAPE, seed=1, step=0):
    b = make_token_batch(cfg, shape[0], shape[1], step=step, seed=seed)
    b["loss_weight"] = np.random.default_rng(seed).integers(0, 2, shape).astype(np.float32)
    return b


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: _t(v) for k, v in b.items()}


_REF = {}


def reference_grads(case):
    """(params, loss, grads) of the reference for a case, numpy leaves;
    computed once a process."""
    if case not in _REF:
        rcfg, _ = _configs(case)
        params = _ref_params(rcfg)
        vg = jax.jit(jax.value_and_grad(RM.loss_fn), static_argnums=1)
        loss, grads = vg(jax.tree_util.tree_map(jnp.asarray, params), rcfg,
                         _jax_batch(_batch(rcfg)))
        _REF[case] = (params, float(loss), jax.tree_util.tree_map(np.asarray, grads))
    return _REF[case]


def _port_grads(case, remat=None):
    _, tcfg = _configs(case)
    if remat is not None:
        tcfg = tcfg.replace(remat=remat)
    params, _, _ = reference_grads(case)
    tp = params_from_jax(params, device="cpu")
    return TLOOP.value_and_grad(tp, tcfg, _torch_batch(_batch(tcfg)))


# ---------------------------------------------------------------------------
# cross_entropy and loss_fn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight", [None, "ones", "binary", "zeros", "real"])
def test_cross_entropy_matches_the_reference(weight):
    """A padded vocab (500 -> 512), logits wide enough that the pad columns
    would change the loss unmasked; with and without a loss weight (all
    zeros: the max(sum w, 1) floor)."""
    rcfg, tcfg = RC.get_smoke("olmo_1b").replace(vocab=500), TC.get_smoke("olmo_1b").replace(
        vocab=500)
    assert rcfg.vocab_padded == 512
    rng = np.random.default_rng(0)
    logits = (4.0 * rng.normal(size=(3, 7, 512))).astype(np.float32)
    labels = rng.integers(0, 500, (3, 7)).astype(np.int32)
    w = {None: None, "ones": np.ones((3, 7)), "binary": rng.integers(0, 2, (3, 7)),
         "zeros": np.zeros((3, 7)), "real": rng.uniform(0, 2, (3, 7))}[weight]
    w = None if w is None else w.astype(np.float32)
    want = RL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), rcfg,
                            None if w is None else jnp.asarray(w))
    got = TL.cross_entropy(_t(logits), _t(labels), tcfg, None if w is None else _t(w))
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, np.asarray(want), 1e-6)
    # bfloat16 logits: the loss in float32 all the same
    lb = _t(logits).to(torch.bfloat16)
    got = TL.cross_entropy(lb, _t(labels), tcfg)
    want = RL.cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels), rcfg)
    assert got.dtype == torch.float32
    _close(got, np.asarray(want), 1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_match_the_reference(case):
    """float32 smoke configs of the six families and the attention, MoE and
    RWKV variants: the loss and every gradient leaf at 1e-4, remat
    ``"full"`` (the configs' default) on both sides."""
    _, loss, grads = reference_grads(case)
    got_loss, got = _port_grads(case)
    assert got_loss.dtype == torch.float32
    _close(got_loss, loss, 1e-4)
    _assert_trees_close(params_to_jax(got), grads, 1e-4)


def test_vlm_loss_drops_the_patch_prefix():
    _, tcfg = _configs("internvl2")
    params, _, _ = reference_grads("internvl2")
    tp = params_from_jax(params, device="cpu")
    b = _torch_batch(_batch(tcfg))
    logits, aux = TM.forward(tp, tcfg, b)
    assert logits.shape[1] == tcfg.frontend_tokens + SHAPE[1]
    want = TL.cross_entropy(logits[:, tcfg.frontend_tokens:], b["labels"], tcfg,
                            b["loss_weight"]) + TM.AUX_WEIGHT * aux
    assert torch.equal(TM.loss_fn(tp, tcfg, b), want)
    assert TM.AUX_WEIGHT == RM.AUX_WEIGHT == 0.01


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("case", REMAT_CASES)
def test_remat_gives_the_same_bits(case, remat):
    """remat "full" and "dots" against "none": loss and gradients bit for
    bit (recomputation repeats the same operations)."""
    l0, g0 = _port_grads(case, "none")
    l1, g1 = _port_grads(case, remat)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


class _CountProducts(TorchDispatchMode):
    """Counts the 2-D (``aten.mm`` / ``addmm``) and batched (``aten.bmm``)
    products run under it."""

    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        elif func == torch.ops.aten.bmm.default:
            self.bmm += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_should():
    """Products run by the backward pass: "full" recomputes the layers'
    2-D products, "dots" keeps them (as many as "none") and recomputes the
    batched ones; a forward whose parameters need no grad (serving) runs no
    checkpoint; an unknown remat raises."""
    _, tcfg = _configs("olmo")
    tp = TM.init_params(tcfg, 0, device="cpu")
    b = _torch_batch(_batch(tcfg))
    counts = {}
    for remat in ("none", "dots", "full"):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
        loss = TM.loss_fn(tree_unflatten(tp, leaves), tcfg.replace(remat=remat), b)
        with _CountProducts() as c:
            torch.autograd.grad(loss, leaves)
        counts[remat] = (c.mm, c.bmm)
    assert counts["dots"][0] == counts["none"][0] < counts["full"][0], counts
    assert counts["none"][1] < counts["dots"][1] == counts["full"][1], counts
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    with pytest.raises(ValueError, match="remat"):
        TM.loss_fn(tree_unflatten(tp, leaves), tcfg.replace(remat="some"), b)
    calls = []
    orig = TM.checkpoint
    TM.checkpoint = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        TM.forward(tp, tcfg, b)
    finally:
        TM.checkpoint = orig
    assert calls == []


# ---------------------------------------------------------------------------
# the serving loops' two branches
# ---------------------------------------------------------------------------


def _wkv_inputs(seed, B=2, S=37, H=2, hd=8):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, hd)).astype(np.float32))
               for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.3, 0.99, (B, S, H, hd)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(H, hd)).astype(np.float32))
    s0 = torch.from_numpy(rng.normal(size=(B, H, hd, hd)).astype(np.float32))
    return r, k, v, w, u, s0


@pytest.mark.parametrize("fn", ["_wkv_scan", "_wkv_chunked"])
def test_wkv_loops_and_their_gradients_match_the_reference(fn):
    """The RWKV loops at the function level: outputs, final state and the
    gradient of every input (under random cotangents) against
    ``jax.value_and_grad`` of the reference's loop at float32 1e-4; the
    values with grad on are the bits of a run under ``torch.no_grad``, as
    serving runs them, and no input is overwritten."""
    ins = _wkv_inputs(0)
    rng = np.random.default_rng(9)
    B, S, H, hd = ins[0].shape
    co = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    cs = rng.normal(size=(B, H, hd, hd)).astype(np.float32)

    def ref_loss(*args):
        o, st = getattr(RS, fn)(*args)
        return jnp.sum(o * co) + jnp.sum(st * cs)

    want_l, want_g = jax.jit(jax.value_and_grad(ref_loss, argnums=tuple(range(6))))(
        *(jnp.asarray(a.numpy()) for a in ins))
    with torch.no_grad():
        o0, s0 = getattr(TS, fn)(*(t.clone() for t in ins))
    leaves = [t.clone().requires_grad_(True) for t in ins]
    o1, s1 = getattr(TS, fn)(*leaves)
    assert torch.equal(o0, o1.detach()) and torch.equal(s0, s1.detach())
    loss = (o1 * torch.from_numpy(co)).sum() + (s1 * torch.from_numpy(cs)).sum()
    loss.backward()
    _close(loss.detach(), np.asarray(want_l), 1e-4)
    for name, t, w, x in zip("rkvwus", leaves, want_g, ins):
        assert torch.equal(t.detach(), x)
        _close(t.grad, np.asarray(w), 1e-4, what=f"d{name}")


def test_selective_scan_and_its_gradient():
    """Mamba's scan: h_t = dA_t h_{t-1} + dBx_t and y_t = h_t C_t step by
    step in float64 against the loop, the loop's gradient against finite
    differences (``gradcheck``, float64), the values with grad on equal to
    those under ``torch.no_grad`` bit for bit, and no input overwritten."""
    rng = np.random.default_rng(1)
    S, B, Di, N = 9, 2, 6, 4
    dA = torch.from_numpy(rng.uniform(0.5, 1.0, (S, B, Di, N)).astype(np.float32))
    dBx = torch.from_numpy(rng.normal(size=(S, B, Di, N)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(S, B, N, 1)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(B, Di, N)).astype(np.float32))
    ins = (dA, dBx, C, h0)
    with torch.no_grad():
        y0, hS = TS._selective_scan(*(t.clone() for t in ins))
    h, ys = h0.double(), []
    for t in range(S):
        h = dA[t].double() * h + dBx[t].double()
        ys.append((h @ C[t].double())[..., 0])
    np.testing.assert_allclose(y0.numpy(), torch.stack(ys, 1).numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hS.numpy(), h.numpy(), atol=1e-5, rtol=1e-5)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    y1, h1 = TS._selective_scan(*leaves)
    assert torch.equal(y0, y1.detach()) and torch.equal(hS, h1.detach())
    (y1.sum() + h1.sum()).backward()
    assert all(torch.equal(t.detach(), x) and t.grad is not None for t, x in zip(leaves, ins))
    small = [t.double().clone().requires_grad_(True)
             for t in (dA[:4, :1, :3], dBx[:4, :1, :3], C[:4, :1], h0[:1, :3])]
    assert torch.autograd.gradcheck(lambda *a: TS._selective_scan(*a), small)


def test_flash_attention_on_the_cpu_stays_differentiable():
    """``attn_impl="pallas"`` on CPU tensors is the plain version, which
    autograd differentiates (the refusal is for the card's kernel)."""
    _, tcfg = _configs("olmo-pallas")
    p = TA.attn_params(torch.Generator().manual_seed(0), tcfg)
    for t in p.values():
        t.requires_grad_(True)
    x = torch.randn(2, 8, tcfg.d_model)
    before = TFLASH.launches
    TA.attention_train(p, x, torch.arange(8)[None], tcfg).sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in p.values())
    assert TFLASH.launches == before


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_optimizer_configs_equal_the_reference():
    assert dataclasses.asdict(TOPT.AdamWConfig()) == dataclasses.asdict(ROPT.AdamWConfig())
    rtc, ttc = RLOOP.TrainConfig(), TLOOP.TrainConfig()
    assert dataclasses.asdict(rtc) == dataclasses.asdict(ttc)


def test_adamw_init_matches_the_reference():
    rcfg, _ = _configs("olmo")
    jp = jax.tree_util.tree_map(np.asarray, RM.init_params(rcfg, KEY))
    cfg = dict(moment_dtype="bfloat16", compress_grads=True)
    want = ROPT.adamw_init(jp, ROPT.AdamWConfig(**cfg))
    got = TOPT.adamw_init(params_from_jax(jp, device="cpu"), TOPT.AdamWConfig(**cfg))
    assert sorted(got) == sorted(want) == ["ef", "m", "step", "v"]
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0
    for k in ("m", "v", "ef"):
        g, w = _flat(params_to_jax(got[k])), _flat(jax.tree_util.tree_map(np.asarray, want[k]))
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name].shape == w[name].shape and not _f32(g[name]).any()
            assert (g[name].dtype == np.uint16) == (w[name].dtype.name == "bfloat16")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(moment_dtype, param_dtype):
    """Three steps on identical gradients with the clip active (global norm
    far above ``grad_clip``) and a 2-step warm-up: parameters, moments, the
    step counter, grad_norm and lr at each step."""
    rcfg, _ = _configs("olmo")
    rcfg = rcfg.replace(param_dtype=param_dtype)
    jp = jax.tree_util.tree_map(np.asarray, RM.init_params(rcfg, KEY))
    oc = dict(moment_dtype=moment_dtype, grad_clip=0.5, warmup_steps=2, lr=1e-2)
    rstate, tstate = ROPT.adamw_init(jp, ROPT.AdamWConfig(**oc)), None
    tp = params_from_jax(jp, device="cpu")
    tstate = TOPT.adamw_init(tp, TOPT.AdamWConfig(**oc))
    rp = jax.tree_util.tree_map(jnp.asarray, jp)
    rng = np.random.default_rng(5)
    atol, rtol = ADAMW_TOL[moment_dtype]
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(a.dtype), jp)
        rp, rstate, rm = jax.jit(ROPT.adamw_update, static_argnums=3)(
            jax.tree_util.tree_map(jnp.asarray, g), rstate, rp, ROPT.AdamWConfig(**oc))
        tp, tstate, tm = TOPT.adamw_update(params_from_jax(g, device="cpu"), tstate, tp,
                                           TOPT.AdamWConfig(**oc))
        assert float(rm["grad_norm"]) > 0.5
        _close(tm["grad_norm"], np.asarray(rm["grad_norm"]), 1e-5)
        assert float(tm["lr"]) == float(rm["lr"])
        assert int(tstate["step"]) == int(rstate["step"]) == step + 1
        assert tstate["step"].dtype == torch.int32
        # a bfloat16 parameter within one ulp; with bfloat16 moments one ulp
        # of m or v (2^-8 to 2^-7) moves a step by up to 2^-7 of lr
        tol = 2 ** -7 if param_dtype == "bfloat16" else (
            1e-6 if moment_dtype == "float32" else (step + 1) * oc["lr"] * 2 ** -7)
        _assert_trees_close(params_to_jax(tp), jax.tree_util.tree_map(np.asarray, rp), tol)
        for k in ("m", "v"):
            _assert_trees_close(params_to_jax(tstate[k]),
                                jax.tree_util.tree_map(np.asarray, rstate[k]), atol, rtol)
            assert all(t.dtype == getattr(torch, moment_dtype) for t in tree_leaves(tstate[k]))
        assert all(t.dtype == getattr(torch, param_dtype) for t in tree_leaves(tp))


def test_adamw_update_leaves_its_inputs_as_they_were():
    tp = TM.init_params(TC.get_smoke("olmo_1b").replace(**F32), 0, device="cpu")
    state = TOPT.adamw_init(tp, TOPT.AdamWConfig())
    grads = tree_map(torch.ones_like, tp)
    before = [t.clone() for t in tree_leaves([tp, state["m"]])]
    p2, s2, _ = TOPT.adamw_update(grads, state, tp, TOPT.AdamWConfig(warmup_steps=1))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves([tp, state["m"]])))
    assert int(state["step"]) == 0 and int(s2["step"]) == 1
    assert not any(torch.equal(a, b) for a, b in zip(tree_leaves(tp), tree_leaves(p2))
                   if a.numel() > 1)


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "bfloat16"])
def test_quantize_int8_matches_the_reference(kind):
    """q and scale bit for bit, the dequantized values too; ties (x / scale
    at k + 0.5) round half to even on both sides."""
    rng = np.random.default_rng(2)
    if kind == "ties":
        x = np.concatenate([[127.0], np.arange(-126.5, 127.0, 1.0)]).astype(np.float32)
    elif kind == "zeros":
        x = np.zeros((4, 5), np.float32)
    else:
        x = (3.0 * rng.normal(size=(33, 17))).astype(np.float32)
    jx = jnp.asarray(x) if kind != "bfloat16" else jnp.asarray(x).astype(jnp.bfloat16)
    tx = _t(x) if kind != "bfloat16" else _t(x).to(torch.bfloat16)
    rq, rs = ROPT.quantize_int8(jx)
    tq, ts = TOPT.quantize_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert ts.numpy().tobytes() == np.asarray(rs).tobytes()
    want = np.asarray(ROPT.dequantize_int8(rq, rs))
    assert TOPT.dequantize_int8(tq, ts).numpy().tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_micro", [1, 2])
def test_make_train_step_matches_the_reference(n_micro):
    """Two steps of the olmo smoke config in float32 (batch 4): loss,
    grad_norm and lr each step, then every parameter and moment."""
    rcfg, tcfg = _configs("olmo")
    jp = _ref_params(rcfg)
    oc = dict(warmup_steps=1, lr=1e-3)
    rtc = RLOOP.TrainConfig(batch=4, seq=16, n_micro=n_micro, opt=ROPT.AdamWConfig(**oc))
    ttc = TLOOP.TrainConfig(batch=4, seq=16, n_micro=n_micro, opt=TOPT.AdamWConfig(**oc))
    rstep = jax.jit(RLOOP.make_train_step(rcfg, rtc))
    tstep = TLOOP.make_train_step(tcfg, ttc)
    rp = jax.tree_util.tree_map(jnp.asarray, jp)
    ro = ROPT.adamw_init(rp, rtc.opt)
    tp = params_from_jax(jp, device="cpu")
    to = TOPT.adamw_init(tp, ttc.opt)
    for step in range(2):
        b = _batch(tcfg, (4, 16), seed=7, step=step)
        rp, ro, rm = rstep(rp, ro, _jax_batch(b))
        tp, to, tm = tstep(tp, to, _torch_batch(b))
        for k in ("loss", "grad_norm", "lr"):
            _close(tm[k], np.asarray(rm[k]), 1e-4, what=k)
    _assert_trees_close(params_to_jax(tp), jax.tree_util.tree_map(np.asarray, rp), 1e-5)
    for k in ("m", "v"):
        _assert_trees_close(params_to_jax(to[k]), jax.tree_util.tree_map(np.asarray, ro[k]),
                            1e-5, 1e-3)


def test_training_refuses_a_mesh():
    """A mesh that is not a ``torch.distributed`` DeviceMesh is refused (the
    mesh itself is trained on in tests/test_torch_mesh.py), and so is a
    DeviceMesh outside a process group."""
    from repro_torch.launch.mesh import make_local_mesh

    _, tcfg = _configs("olmo")
    with pytest.raises(TypeError, match="DeviceMesh"):
        TLOOP.init_all(tcfg, TLOOP.TrainConfig(), mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        TLOOP.train(tcfg, TLOOP.TrainConfig(steps=1), mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh(1, 1, device="cpu")


def test_train_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, tcfg = _configs("olmo")
    with pytest.raises(RuntimeError, match="cuda"):
        TLOOP.init_all(tcfg, TLOOP.TrainConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        TLOOP.train(tcfg, TLOOP.TrainConfig(steps=1))


def test_train_loop_matches_the_reference_loop():
    """``train`` from the same weights over the same synthetic batches:
    the history's losses at 1e-4 and the final parameters at 1e-5."""
    rcfg, tcfg = _configs("olmo")
    jp = _ref_params(rcfg)
    kw = dict(steps=3, batch=2, seq=16, log_every=1)
    rtc = RLOOP.TrainConfig(**kw, opt=ROPT.AdamWConfig(warmup_steps=1))
    ttc = TLOOP.TrainConfig(**kw, opt=TOPT.AdamWConfig(warmup_steps=1))
    orig = RLOOP.init_all
    RLOOP.init_all = lambda cfg, tc, mesh=None: (
        jax.tree_util.tree_map(jnp.asarray, jp),
        ROPT.adamw_init(jax.tree_util.tree_map(jnp.asarray, jp), tc.opt), None)
    try:
        want = RLOOP.train(rcfg, rtc)
    finally:
        RLOOP.init_all = orig
    got = TLOOP.train(tcfg, ttc, device="cpu", params=params_from_jax(jp, device="cpu"))
    assert [m["step"] for m in got["history"]] == [m["step"] for m in want["history"]]
    for g, w in zip(got["history"], want["history"]):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(g[k] - w[k]) <= 1e-4 * (1 + abs(w[k])), (k, g, w)
    _assert_adam_close(params_to_jax(got["params"]),
                       jax.tree_util.tree_map(np.asarray, want["params"]), 3e-4, 3)


# ---------------------------------------------------------------------------
# params_to_jax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmo_1b", "whisper_tiny", "hymba_1_5b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_to_jax_round_trips_bit_for_bit(arch, dtype):
    rcfg = RC.get_smoke(arch).replace(param_dtype=dtype, compute_dtype=dtype)
    jp = jax.tree_util.tree_map(np.asarray, RM.init_params(rcfg, KEY))
    tp = params_from_jax(jp, device="cpu")
    back = params_to_jax(tp)
    g, w = _flat(back), _flat(jp)
    assert sorted(g) == sorted(w)
    for name in w:
        bits = w[name].view(np.uint16) if w[name].dtype.name == "bfloat16" else w[name]
        assert g[name].dtype == bits.dtype and g[name].shape == bits.shape, name
        assert g[name].tobytes() == bits.tobytes(), name
    again = params_from_jax(back, device="cpu")
    for a, b in zip(tree_leaves(again), tree_leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------

_BF16_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
import repro.configs as RC
from repro.etl.batcher import make_token_batch
from repro.models import model as RM
from repro.models import ssm as RS
cfg = RC.get_smoke("olmo_1b")
params = RM.init_params(cfg, jax.random.PRNGKey(0))
b = make_token_batch(cfg, 2, 16, seed=1)
b["loss_weight"] = np.random.default_rng(1).integers(0, 2, (2, 16)).astype(np.float32)
loss, grads = jax.jit(jax.value_and_grad(RM.loss_fn), static_argnums=1)(
    params, cfg, {k: jnp.asarray(v) for k, v in b.items()})
out = {"loss": np.asarray(loss, np.float32)}
for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
    out["grad/" + "/".join(k.key for k in path)] = np.asarray(g, np.float32)
for path, p in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["param/" + "/".join(k.key for k in path)] = np.asarray(p).view(np.uint16)
np.savez(%(path)r, **out)
"""


def test_bfloat16_loss_and_gradients_match_the_reference(tmp_path):
    """The olmo smoke config in bfloat16: loss and every gradient leaf
    within 5e-2 of the reference run with excess precision off."""
    path = str(tmp_path / "reference.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_BF16_REFERENCE % {
        "path": path})], capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        ref = dict(z)
    jp = jax.tree_util.tree_map(np.asarray, RM.init_params(RC.get_smoke("olmo_1b"), KEY))
    for name, v in _flat(jp).items():  # the subprocess drew the same weights
        assert v.view(np.uint16).tobytes() == ref["param/" + name].tobytes()
    tp = params_from_jax(jp, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    tcfg = TC.get_smoke("olmo_1b")
    loss, grads = TLOOP.value_and_grad(tp, tcfg, _torch_batch(_batch(tcfg)))
    _close(loss, ref["loss"], 5e-2)
    got = _flat(params_to_jax(grads))
    want = {k[len("grad/"):]: v for k, v in ref.items() if k.startswith("grad/")}
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.uint16  # bfloat16 gradients, as the parameters
        _close(got[name], want[name], 5e-2, what=name)


# ---------------------------------------------------------------------------
# on the card (marker gpu; skipped without a Hopper card)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    """The Hopper card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0) with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
def test_flash_attention_refuses_a_backward_on_the_card(card):
    """q requiring grad with grad mode on: NotImplementedError before any
    launch; under no_grad, or with no input requiring grad, it launches."""
    q = torch.randn(4, 64, 64, device=card, requires_grad=True)
    k = torch.randn(4, 64, 64, device=card)
    before = TFLASH.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        TFLASH.flash_attention(q, k, k)
    assert TFLASH.launches == before
    with torch.no_grad():
        TFLASH.flash_attention(q, k, k)
    TFLASH.flash_attention(q.detach(), k, k)
    assert TFLASH.launches == before + 2
    _, tcfg = _configs("olmo-pallas")
    tp = TM.init_params(tcfg, 0, device=card)
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    b = {k: v.to(card) for k, v in _torch_batch(_batch(tcfg)).items()}
    with pytest.raises(NotImplementedError, match="attn_impl 'dense' or 'chunked'"):
        TM.loss_fn(tp, tcfg, b).backward()
    assert TFLASH.launches == before + 2


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(card):
    """One olmo smoke ``make_train_step`` in float32 (TF32 off): loss and
    every parameter and moment from the card against the CPU at 1e-4."""
    _, tcfg = _configs("olmo")
    jp = _ref_params(_configs("olmo")[0])
    ttc = TLOOP.TrainConfig(batch=4, seq=16, opt=TOPT.AdamWConfig(warmup_steps=1, lr=1e-3))
    step = TLOOP.make_train_step(tcfg, ttc)
    b = _torch_batch(_batch(tcfg, (4, 16)))
    cp = params_from_jax(jp, device="cpu")
    want = step(cp, TOPT.adamw_init(cp, ttc.opt), b)
    dp = params_from_jax(jp, device=card)
    got = step(dp, TOPT.adamw_init(dp, ttc.opt), {k: v.to(card) for k, v in b.items()})
    for k in ("loss", "grad_norm", "lr"):
        _close(got[2][k].cpu(), want[2][k], 1e-4, what=k)
    for g, w in zip(tree_leaves(list(got[:2])), tree_leaves(list(want[:2]))):
        assert g.device.type == "cuda"
        _close(g.cpu(), w, 1e-4)
