"""The port's MoE family against the JAX reference, on the CPU.

qwen3-moe-30b-a3b and dbrx-132b at their smoke sizes (qwen3-moe: rmsnorm,
8 experts, top-2; dbrx: layernorm, 4 experts, top-2).  Both packages get
the same weights (the reference's ``init_params`` / ``moe_params`` pytree
through ``repro_torch.core.convert.params_from_jax``) and the same inputs
from numpy seeds.  As in tests/test_torch_model.py, the float32 reference
runs in this process and the bfloat16 one in a subprocess with XLA's
``--xla_allow_excess_precision=false`` (so it rounds at every operation,
as the port does).  Tolerances are that file's: float32 1e-4, bfloat16
5e-2 (tests/test_models.py's).

Routing is held exactly: the chosen experts, their capacity slots and the
keep mask equal the reference's, in a group that drops tokens too; the
top-k keeps ``jax.lax.top_k``'s tie order.
"""

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
from repro.models import moe as RMOE
from repro.serve.decode import ServeConfig as RServeConfig
from repro.serve.decode import Server as RServer
from repro.serve.decode import greedy_decode as r_greedy_decode

import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.serve.decode import ServeConfig, Server, greedy_decode

REPO = os.path.join(os.path.dirname(__file__), "..")
MOE = ["qwen3_moe_30b_a3b", "dbrx_132b"]
IMPLS = ["dense", "dmm", "ep"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
KEY = jax.random.PRNGKey(0)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
X_SHAPE = (3, 32)  # (B, S) of moe_apply's input: both archs drop at the default capacity


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


def _configs(arch, dtype, **kw):
    """(reference config, port config) for a smoke arch."""
    kw = dict(F32 if dtype == "float32" else {}, **kw)
    return RC.get_smoke(arch).replace(**kw), TC.get_smoke(arch).replace(**kw)


def _weights(rcfg):
    jp = RM.init_params(rcfg, KEY)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _moe_weights(rcfg):
    jp = RMOE.moe_params(KEY, rcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _x(cfg, seed=0, shape=X_SHAPE):
    """moe_apply's input, float32 from a numpy seed (cast by the caller)."""
    return np.random.default_rng(seed).normal(size=(*shape, cfg.d_model)).astype(np.float32)


def _tokens(cfg, b=2, s=16, seed=0):
    return make_token_batch(cfg, b, s, seed=seed)["tokens"]


_BF16_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
import repro.configs as RC
from repro.etl.batcher import make_token_batch
from repro.models import model as RM, moe as RMOE
out = {}
for arch in %(archs)r:
    for impl in ("dense", "dmm", "ep"):
        cfg = RC.get_smoke(arch).replace(moe_impl=impl)
        p = RMOE.moe_params(jax.random.PRNGKey(0), cfg)
        x = np.random.default_rng(0).normal(size=%(x_shape)r + (cfg.d_model,))
        o, aux = RMOE.moe_apply(p, jnp.asarray(x.astype(np.float32)).astype(cfg.cdtype), cfg)
        out[f"moe/{arch}/{impl}"] = np.asarray(o, np.float32)
        out[f"moe_aux/{arch}/{impl}"] = np.asarray(aux, np.float32)
    for impl in ("dense", "pallas"):
        cfg = RC.get_smoke(arch).replace(attn_impl=impl)
        params = RM.init_params(cfg, jax.random.PRNGKey(0))
        tokens = make_token_batch(cfg, 2, 32, seed=0)["tokens"]
        logits, aux = RM.forward(params, cfg, {"tokens": jnp.asarray(tokens)})
        out[f"forward/{arch}/{impl}"] = np.asarray(logits, np.float32)
        out[f"forward_aux/{arch}/{impl}"] = np.asarray(aux, np.float32)
    tokens = make_token_batch(cfg, 3, 7, seed=4)["tokens"]
    state = RM.init_decode_state(cfg, 3, 4)
    for t in range(7):
        logits, state = RM.decode_step(params, cfg, state, jnp.asarray(tokens[:, t]))
        out[f"decode/{arch}/{t}"] = np.asarray(logits, np.float32)
np.savez(%(path)r, **out)
"""


@pytest.fixture(scope="module")
def bf16_reference(tmp_path_factory):
    """The reference's bfloat16 moe_apply, forward and decode results,
    computed in a subprocess with XLA's excess precision off."""
    path = str(tmp_path_factory.mktemp("bf16") / "reference.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    code = textwrap.dedent(_BF16_REFERENCE % {"archs": MOE, "path": path,
                                              "x_shape": X_SHAPE})
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_params_from_jax_is_bit_exact_on_the_moe_subtree(arch):
    rcfg, _ = _configs(arch, "bfloat16")
    jp, tp = _weights(rcfg)
    for layer in range(rcfg.n_layers):
        got = tp["layers"][layer]
        assert set(got) == {"norm1", "attn", "norm2", "moe"}
        for name, leaf in jp["layers"]["moe"].items():
            want = np.asarray(leaf)[layer]
            t = got["moe"][name]
            if name == "router":  # kept in float32, as the reference keeps it
                assert t.dtype == torch.float32 and want.dtype == np.float32
                np.testing.assert_array_equal(t.view(torch.int32).numpy(), want.view(np.int32))
            else:
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(t.view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("arch", MOE)
def test_init_params_follows_the_reference_layout(arch):
    rcfg, tcfg = _configs(arch, "bfloat16")
    jp = RM.init_params(rcfg, KEY)
    tp = TM.init_params(tcfg, 0, device="cpu")
    assert set(tp["layers"][0]) == set(jp["layers"])
    for name, v in tp["layers"][0]["moe"].items():
        want = jp["layers"]["moe"][name]
        assert tuple(v.shape) == want.shape[1:]
        assert v.dtype == (torch.float32 if name == "router" else torch.bfloat16)
    n = sum(v.numel() for lp in tp["layers"] for sub in lp.values() for v in sub.values())
    n += sum(v.numel() for v in tp["embed"].values()) + sum(
        v.numel() for v in tp["final_norm"].values())
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    # trunc_normal takes fan_in from shape[0]: E for the expert tensors
    w = tp["layers"][0]["moe"]["w_in"].float()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(tcfg.n_experts) * 1.01


# ---------------------------------------------------------------------------
# routing: capacity, drops, tie order, aux loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("tokens", [1, 7, 24, 100, 2048])
@pytest.mark.parametrize("factor", [0.25, 1.25, 2.0])
def test_capacity_matches_reference(arch, tokens, factor):
    rcfg, tcfg = _configs(arch, "float32", capacity_factor=factor)
    assert TMOE._capacity(tokens, tcfg) == RMOE._capacity(tokens, rcfg)
    assert TMOE._capacity(tokens, tcfg) % 4 == 0 and TMOE._capacity(tokens, tcfg) >= 4


def test_capacity_at_full_size():
    """qwen3-moe's prefill group and decode step: C 160 at 2,048 tokens,
    4 at one token; capacity factor E / k holds a whole group."""
    cfg = TC.get("qwen3_moe_30b_a3b")
    assert TMOE._capacity(2048, cfg) == 160 and TMOE._capacity(1, cfg) == 4
    assert TMOE._capacity(2048, cfg.replace(capacity_factor=16.0)) == 2048


@pytest.mark.parametrize("arch", MOE)
def test_dispatch_drops_tokens_as_the_reference(arch):
    """A group that overflows its experts (capacity factor 0.5): the
    chosen experts, slot positions and keep mask equal the reference's, and
    the reference does drop."""
    rcfg, tcfg = _configs(arch, "float32", capacity_factor=0.5)
    jp, tp = _moe_weights(rcfg)
    x = _x(rcfg, seed=3, shape=(48,))
    C = RMOE._capacity(48, rcfg)
    jg, je, jprobs = RMOE._route(jp, jnp.asarray(x), rcfg)
    jslot, jkeep = RMOE._dispatch_indices(je, rcfg.n_experts, C)
    tg, te, tprobs = TMOE._route(tp, _t(x), tcfg)
    tslot, tkeep = TMOE._dispatch_indices(te, tcfg.n_experts, C)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert not np.asarray(jkeep).all(), "the reference drops no token here"
    _close(tg.numpy(), jg, 1e-6)
    _close(tprobs.numpy(), jprobs, 1e-6)
    # the two algorithms' outputs in that group, against the reference's
    for impl in IMPLS:
        want, waux = RMOE.moe_apply(jp, jnp.asarray(x[None]), rcfg.replace(moe_impl=impl))
        got, gaux = TMOE.moe_apply(tp, _t(x[None]), tcfg.replace(moe_impl=impl))
        _close(_np(got), want, 1e-4)
        _close(float(gaux), float(waux), 1e-5)


def test_batched_groups_dispatch_as_the_reference_vmap():
    """Several batch rows: each row is its own group with its own slots."""
    rcfg, tcfg = _configs("qwen3_moe_30b_a3b", "float32", capacity_factor=0.5)
    jp, tp = _moe_weights(rcfg)
    x = _x(rcfg, seed=6, shape=(4, 20))
    C = RMOE._capacity(20, rcfg)
    _, je, _ = RMOE._route(jp, jnp.asarray(x), rcfg)
    jslot, jkeep = jax.vmap(lambda e: RMOE._dispatch_indices(e, rcfg.n_experts, C))(je)
    _, te, _ = TMOE._route(tp, _t(x), tcfg)
    tslot, tkeep = TMOE._dispatch_indices(te, tcfg.n_experts, C)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_top_k_keeps_the_reference_tie_order(k):
    """Planted equal probabilities: the lower expert id comes first, as
    ``jax.lax.top_k`` orders them."""
    rng = np.random.default_rng(k)
    probs = rng.integers(0, 4, size=(64, 16)).astype(np.float32) / 4  # many ties
    probs[0] = 0.5  # all equal
    probs[1, ::2] = 0.75
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
    got_v, got_i = TMOE._top_k(_t(probs), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("arch", MOE)
def test_route_ties_follow_the_reference(arch):
    """A router whose columns repeat gives exactly equal probabilities; the
    experts chosen equal the reference's."""
    rcfg, tcfg = _configs(arch, "float32")
    D, E = rcfg.d_model, rcfg.n_experts
    col = np.random.default_rng(2).normal(size=(D, 1)).astype(np.float32) / 8
    router = np.repeat(col, E, axis=1)
    router[:, E - 1] *= 0.5  # one column differs, the rest tie
    x = _x(rcfg, seed=4, shape=(10,))
    _, je, _ = RMOE._route({"router": jnp.asarray(router)}, jnp.asarray(x), rcfg)
    _, te, _ = TMOE._route({"router": _t(router)}, _t(x), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_router_aux_loss_matches_reference():
    rcfg, tcfg = _configs("qwen3_moe_30b_a3b", "float32")
    E, k = rcfg.n_experts, rcfg.top_k
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(2, 30, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    experts = np.argsort(-probs, axis=-1)[..., :k].astype(np.int32)
    want = RMOE.router_aux_loss(jnp.asarray(probs), jnp.asarray(experts), rcfg)
    got = TMOE.router_aux_loss(_t(probs), _t(experts), tcfg)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(float(got), float(want), 1e-6)
    # a balanced router gives exactly E * (1/E) summed = 1 (tests/test_ssm_moe.py)
    T = 64
    balanced = torch.full((T, E), 1.0 / E)
    experts = torch.stack([torch.arange(T) % E] * k, dim=-1) % E
    assert abs(float(TMOE.router_aux_loss(balanced, experts, tcfg)) - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_reference(arch, impl, dtype, request):
    """dense, dmm and ep (no mesh: the dense path) at the default capacity
    factor, where (B, S) = (3, 32) drops tokens: outputs and aux loss."""
    rcfg, tcfg = _configs(arch, dtype, moe_impl=impl)
    jp, tp = _moe_weights(rcfg)
    x = _x(rcfg)
    got, aux = TMOE.moe_apply(tp, _t(x).to(tcfg.cdtype), tcfg)
    assert got.dtype == tcfg.cdtype and got.shape == x.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    if dtype == "float32":
        want, waux = RMOE.moe_apply(jp, jnp.asarray(x), rcfg)
        want, waux = np.asarray(want), float(waux)
    else:
        ref = request.getfixturevalue("bf16_reference")
        want, waux = ref[f"moe/{arch}/{impl}"], float(ref[f"moe_aux/{arch}/{impl}"])
    _close(_np(got), want, TOL[dtype])
    _close(float(aux), waux, 1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_default_capacity_drops_at_the_tested_shape(arch):
    """The moe_apply cases above do exercise drops: some (token, choice) of
    some group is past its expert's capacity."""
    rcfg, _ = _configs(arch, "float32")
    jp = RMOE.moe_params(KEY, rcfg)
    C = RMOE._capacity(X_SHAPE[1], rcfg)
    _, je, _ = RMOE._route(jp, jnp.asarray(_x(rcfg)), rcfg)
    _, keep = jax.vmap(lambda e: RMOE._dispatch_indices(e, rcfg.n_experts, C))(je)
    assert not np.asarray(keep).all()


def test_ep_without_a_mesh_is_the_dense_path():
    _, tcfg = _configs("qwen3_moe_30b_a3b", "bfloat16")
    _, tp = _moe_weights(_configs("qwen3_moe_30b_a3b", "bfloat16")[0])
    x = _t(_x(tcfg)).to(tcfg.cdtype)
    dense, daux = TMOE.moe_apply(tp, x, tcfg)
    ep, eaux = TMOE.moe_apply(tp, x, tcfg.replace(moe_impl="ep"))
    assert torch.equal(dense, ep) and torch.equal(daux, eaux)
    assert torch.equal(TMOE.moe_ffn(tp, x, tcfg), dense)


@pytest.mark.parametrize("impl", IMPLS)
def test_two_cpu_runs_are_bit_identical(impl):
    """The fixed combine order: repeat calls give the same bits (bfloat16,
    where another summation order would show)."""
    rcfg, tcfg = _configs("qwen3_moe_30b_a3b", "bfloat16", moe_impl=impl)
    _, tp = _weights(rcfg)
    tokens = _t(_tokens(rcfg, s=32, seed=5))
    a, aux_a = TM.forward(tp, tcfg, {"tokens": tokens})
    b, aux_b = TM.forward(tp, tcfg, {"tokens": tokens})
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(aux_a, aux_b)


def test_dmm_equals_dense_in_one_group():
    """At batch 1 both algorithms see one group with one capacity, so they
    drop the same choices; only the combine's order differs (top-k order
    against expert order)."""
    _, tcfg = _configs("qwen3_moe_30b_a3b", "float32")
    tp = TM.init_params(tcfg, 0, device="cpu")
    tokens = _t(_tokens(tcfg, b=1, s=40, seed=8))
    dense, daux = TM.forward(tp, tcfg, {"tokens": tokens})
    dmm, maux = TM.forward(tp, tcfg.replace(moe_impl="dmm"), {"tokens": tokens})
    _close(_np(dmm), _np(dense), 1e-5)
    _close(float(maux), float(daux), 1e-6)


# ---------------------------------------------------------------------------
# forward (the prefill), decode, serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "pallas"])
@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_reference(arch, impl, dtype, request):
    rcfg, tcfg = _configs(arch, dtype, attn_impl=impl)
    jp, tp = _weights(rcfg)
    tokens = _tokens(rcfg, b=2, s=32)
    got, aux = TM.forward(tp, tcfg, {"tokens": _t(tokens)})
    assert got.dtype == tcfg.cdtype and got.shape == (2, 32, tcfg.vocab_padded)
    assert aux.dtype == torch.float32 and float(aux) > 0
    if dtype == "float32":
        want, waux = RM.forward(jp, rcfg, {"tokens": jnp.asarray(tokens)})
        want, waux = np.asarray(want), float(waux)
    else:
        ref = request.getfixturevalue("bf16_reference")
        want, waux = ref[f"forward/{arch}/{impl}"], float(ref[f"forward_aux/{arch}/{impl}"])
    _close(_np(got), want, TOL[dtype])
    _close(float(aux), waux, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_decode_steps_match_reference(arch, dtype, request):
    """Step-by-step decode logits on a 4-slot cache driven for 7 steps
    (steps 4-6 write the clamped last slot)."""
    rcfg, tcfg = _configs(arch, dtype)
    jp, tp = _weights(rcfg)
    tokens = _tokens(rcfg, b=3, s=7, seed=4)
    jstate = RM.init_decode_state(rcfg, 3, 4)
    tstate = TM.init_decode_state(tcfg, 3, 4, device="cpu")
    for t in range(7):
        got, tstate = TM.decode_step(tp, tcfg, tstate, _t(tokens[:, t]))
        if dtype == "float32":
            want, jstate = RM.decode_step(jp, rcfg, jstate, jnp.asarray(tokens[:, t]))
        else:
            want = request.getfixturevalue("bf16_reference")[f"decode/{arch}/{t}"]
        assert tstate["pos"] == t + 1
        _close(_np(got), want, TOL[dtype])


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_teacher_forcing(arch):
    """The port alone, float32: with capacity factor E / k every group
    holds every token (C >= T), so the prefill drops nothing and the cache
    machinery reproduces it step by step."""
    _, tcfg = _configs(arch, "float32")
    tcfg = tcfg.replace(capacity_factor=tcfg.n_experts / tcfg.top_k)
    assert TMOE._capacity(12, tcfg) >= 12
    tp = TM.init_params(tcfg, 0, device="cpu")
    tokens = _t(_tokens(tcfg, s=12, seed=2))
    full, _ = TM.forward(tp, tcfg.replace(attn_impl="pallas"), {"tokens": tokens})
    state = TM.init_decode_state(tcfg, 2, 12, device="cpu")
    got = []
    for t in range(12):
        logits, state = TM.decode_step(tp, tcfg, state, tokens[:, t])
        got.append(logits)
    _close(_np(torch.stack(got, 1)), _np(full), 1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_greedy_decode_matches_reference(arch):
    rcfg, tcfg = _configs(arch, "float32")
    jp, tp = _weights(rcfg)
    prompt = np.random.default_rng(0).integers(2, rcfg.vocab, (2, 4)).astype(np.int32)
    want = np.asarray(r_greedy_decode(jp, rcfg, jnp.asarray(prompt), max_new=6, cache_len=32))
    got = greedy_decode(tp, tcfg, torch.from_numpy(prompt), max_new=6, cache_len=32,
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", MOE)
def test_server_matches_reference(arch):
    """Five requests through a 2-slot server, token for token."""
    rcfg, tcfg = _configs(arch, "float32")
    jp, tp = _weights(rcfg)
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
@pytest.mark.parametrize("arch", MOE)
def test_serve_launcher_runs_moe_on_cpu(arch, etl):
    proc = _launch("--arch", arch, "--smoke", "--device", "cpu",
                   *(["--etl"] if etl else []))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert any(line.startswith("etl: ") for line in lines) == etl
    requests = [line for line in lines if line.startswith("request ")]
    assert len(requests) == 8  # --requests 8
    for i, line in enumerate(requests):  # each completed: 16 tokens, or fewer ending at EOS 0
        m = re.match(rf"request {i}: (\d+) tokens -> \[", line)
        assert m and 1 <= int(m.group(1)) <= 16, line


# ---------------------------------------------------------------------------
# chip_smoke.py phase 5b, rehearsed on the CPU at the smoke sizes
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_routing_agreement_counts_prefixes():
    """A routing that differs at token 2 of row 0 in one layer spoils rows
    (0, 2..) and nothing else; the share counts (token, layer) pairs."""
    smoke = _chip_smoke()
    experts = torch.zeros((2, 5, 2), dtype=torch.long)
    keep = torch.ones((2, 5, 2), dtype=torch.bool)
    a = {"route": [(None, experts, None)] * 2, "keep": [keep] * 2}
    other = experts.clone()
    other[0, 2, 1] = 3
    b = {"route": [(None, experts, None), (None, other, None)], "keep": [keep, keep]}
    share, rows = smoke.routing_agreement(a, b)
    assert share == pytest.approx(1 / 20)
    assert rows.tolist() == [[True, True, False, False, False], [True] * 5]
    dropped = keep.clone()
    dropped[1, 4, 0] = False
    b["keep"] = [keep, dropped]
    _, rows = smoke.routing_agreement(a, b)
    assert rows[1].tolist() == [True, True, True, True, False]


def test_chip_smoke_moe_phase_rehearsal():
    """Phase 5b's checks (b), (c) and (e)-(g) at the smoke sizes, on the
    CPU (the plain versions; the "card" side is the CPU too, so card and
    CPU agree exactly)."""
    smoke = _chip_smoke()
    cpu = torch.device("cpu")
    qwen3 = TC.get_smoke("qwen3_moe_30b_a3b")
    params = TM.init_params(qwen3, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, qwen3.vocab, (2, 256)))
    b = smoke.moe_prefill_checks("qwen3-moe smoke", params, qwen3, {"tokens": tokens})
    assert b["repeat_bit_identical"] and b["prefill_flash_attention_launches"] == 0
    assert b["vs_dense"]["argmax_agree"] >= smoke.BF16_ARGMAX_AGREE
    cut = smoke.qwen3_moe_cut_f32(cpu, qwen3.replace(**F32))
    e = cut["card_vs_cpu_f32"]
    assert e["routing_differs_share"] == 0 and e["rows_routed_alike"] == 1
    assert e["server_tokens_equal"] and e["max_abs_err"] == 0
    assert cut["dmm_vs_dense_f32"]["dropped_choices"] > 0  # (f) compares drops too
    assert cut["teacher_forcing_f32"]["capacity_factor"] == qwen3.n_experts / qwen3.top_k
    g = smoke.dbrx_cut(cpu, TC.get_smoke("dbrx_132b"))
    assert g["prefill"]["shape_ok"] and len(g["decode_tokens"]) == 2


def test_chip_smoke_moe_launcher_rehearsal(monkeypatch, capsys):
    """Phase 5b (h) with the smoke config on the CPU: the launcher answers
    every request, and a request left unanswered fails the phase."""
    smoke = _chip_smoke()
    argv = ["--arch", "qwen3_moe_30b_a3b", "--smoke", "--device", "cpu", "--etl",
            "--requests", "4", "--max-new", "4"]
    monkeypatch.setattr(smoke, "MOE_LAUNCHES", {"qwen3-moe smoke --etl": (argv, 4)})
    out = smoke.moe_launcher()["qwen3-moe smoke --etl"]
    assert out["requests"] == out["answered"] == 4
    monkeypatch.setattr(smoke, "MOE_LAUNCHES", {"too many": (argv, 5)})
    with pytest.raises(AssertionError, match="not every request answered"):
        smoke.moe_launcher()


def test_chip_smoke_moe_split_and_decode_bytes():
    smoke = _chip_smoke()
    profile = {"device_us": 100.0, "flash_attention_us": 5.0,
               "range_device_us": {"moe._moe": 70.0, "moe._route": 4.0,
                                   "moe.router_aux_loss": 1.0, "moe._expert_ffn": 50.0}}
    split = smoke.moe_split(profile)
    assert {k: v["us"] for k, v in split.items()} == {
        "expert products": 50.0, "router": 5.0, "dispatch and combine": 16.0,
        "flash_attention": 5.0, "rest": 24.0}
    assert smoke.moe_split({**profile, "range_device_us": {}}) is None
    cfg = TC.get_smoke("qwen3_moe_30b_a3b")
    params = TM.init_params(cfg, 0, device="cpu")
    n = smoke.decode_bytes(params, cfg, batch=8, fill=3)
    emb = params["embed"]["tok"]
    every = sum(t.numel() * t.element_size() for t in smoke._tensors(params))
    kv = 2 * cfg.n_layers * 8 * 4 * cfg.n_kv_heads * cfg.hd * 2
    assert n == every - emb.numel() * 2 + 8 * cfg.d_model * 2 + kv + 8 * cfg.vocab_padded * 2


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
def test_router_product_is_ieee_float32_with_tf32_on(card):
    """With TF32 switched on globally the router's logits stay IEEE float32
    (a TF32 product misses a float64 one by ~1e-3 here), and the setting
    is restored."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(512, 2048)).astype(np.float32)).to(card)
    router = torch.from_numpy(rng.normal(size=(2048, 128)).astype(np.float32) / 45).to(card)
    want = (x.double() @ router.double()).float()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = TMOE._ieee_matmul(x, router)
        assert torch.backends.cuda.matmul.allow_tf32
        tf32 = x @ router
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert float((got - want).abs().max()) < 1e-4
    assert float((tf32 - want).abs().max()) > 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("impl", IMPLS)
def test_moe_apply_on_the_card_matches_the_cpu(impl, card):
    """float32 on the card against the CPU (plain versions) at the smoke
    size, and bfloat16 repeat calls on the card bit-identical."""
    rcfg, tcfg = _configs("qwen3_moe_30b_a3b", "float32", moe_impl=impl)
    _, tp = _moe_weights(rcfg)
    x = _t(_x(tcfg))
    want, waux = TMOE.moe_apply(tp, x, tcfg)
    got, aux = TMOE.moe_apply({k: v.to(card) for k, v in tp.items()}, x.to(card), tcfg)
    _close(_np(got.cpu()), _np(want), 1e-5)
    _close(float(aux), float(waux), 1e-6)
    bcfg = tcfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    tb = {k: (v if k == "router" else v.to(torch.bfloat16)).to(card) for k, v in tp.items()}
    xb = x.to(card, torch.bfloat16)
    a, _ = TMOE.moe_apply(tb, xb, bcfg)
    b, _ = TMOE.moe_apply(tb, xb, bcfg)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
