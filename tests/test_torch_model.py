"""The port's dense model stack against the JAX reference, on the CPU.

Both models get the same weights: the reference's ``init_params`` pytree,
carried across by ``repro_torch.core.convert.params_from_jax``.  Inputs
come from numpy seeds.  The reference's ``attn_impl="pallas"`` runs its
oracle ``attention_ref`` on the CPU (as its own tests run it); the port's
runs the plain version of its flash kernel.

Tolerances: float32 at atol/rtol 1e-4 (the two frameworks sum in other
orders; logits are O(10), so a few float32 ulps of each of ~10^2 terms);
bfloat16 at 5e-2, the tolerance of tests/test_models.py.  The bfloat16
reference runs in a subprocess with XLA's ``--xla_allow_excess_precision=
false``: by default XLA's CPU backend skips bf16 roundings between fused
operations, which moves ~0.07 % of the olmo smoke logits by up to 0.09 from
the program as written; with the flag the reference rounds at every
operation, as the port does, and the two agree to ~1e-7.
"""

import os
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
from repro.models import layers as RL
from repro.models import model as RM

import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

DENSE = ["olmo_1b", "llama3_405b", "phi3_medium_14b", "stablelm_1_6b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
KEY = jax.random.PRNGKey(0)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _close(got, want, atol, rtol=None):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=atol if rtol is None else rtol)


def _configs(arch, dtype, impl="dense"):
    """(reference config, port config) for a smoke arch."""
    kw = dict(F32 if dtype == "float32" else {}, attn_impl=impl)
    return RC.get_smoke(arch).replace(**kw), TC.get_smoke(arch).replace(**kw)


def _weights(rcfg):
    jp = RM.init_params(rcfg, KEY)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


_BF16_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
import repro.configs as RC
from repro.etl.batcher import make_token_batch
from repro.models import model as RM
out = {}
for arch in %(archs)r:
    for impl in ("dense", "chunked", "pallas"):
        cfg = RC.get_smoke(arch).replace(attn_impl=impl)
        params = RM.init_params(cfg, jax.random.PRNGKey(0))
        tokens = make_token_batch(cfg, 2, 32, seed=0)["tokens"]
        logits, _ = RM.forward(params, cfg, {"tokens": jnp.asarray(tokens)})
        out[f"forward/{arch}/{impl}"] = np.asarray(logits, np.float32)
    tokens = make_token_batch(cfg, 3, 7, seed=4)["tokens"]
    state = RM.init_decode_state(cfg, 3, 4)
    for t in range(7):
        logits, state = RM.decode_step(params, cfg, state, jnp.asarray(tokens[:, t]))
        out[f"decode/{arch}/{t}"] = np.asarray(logits, np.float32)
    for c in ("k", "v"):
        out[f"decode/{arch}/{c}"] = np.asarray(state[c], np.float32)
np.savez(%(path)r, **out)
"""


@pytest.fixture(scope="module")
def bf16_reference(tmp_path_factory):
    """The reference's bfloat16 forward and decode logits, computed in a
    subprocess with XLA's excess precision off (see the module docstring)."""
    path = str(tmp_path_factory.mktemp("bf16") / "reference.npz")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=src,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    code = textwrap.dedent(_BF16_REFERENCE % {"archs": DENSE, "path": path})
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    import dataclasses

    for get in ("get", "get_smoke"):
        r, t = getattr(RC, get)(arch), getattr(TC, get)(arch)
        assert dataclasses.asdict(r) == dataclasses.asdict(t)
        assert t.param_count() == r.param_count()
        assert t.active_param_count() == r.active_param_count()
        assert t.vocab_padded == r.vocab_padded and t.hd == r.hd
    assert TC.get(arch).pdtype == torch.bfloat16
    assert TC.get(arch).replace(**F32).cdtype == torch.float32


def test_config_grid_equals_the_reference():
    assert TC.ARCHS == RC.ARCHS
    assert TC.cells() == RC.cells()
    assert {k: tuple(v.__dict__.values()) for k, v in TC.SHAPES.items()} == {
        k: tuple(v.__dict__.values()) for k, v in RC.SHAPES.items()}
    for arch in TC.ARCHS:
        for name in TC.SHAPES:
            assert TC.runnable(TC.get(arch), TC.SHAPES[name]) == RC.runnable(
                RC.get(arch), RC.SHAPES[name])


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_jax_is_bit_exact(arch):
    rcfg, _ = _configs(arch, "bfloat16")
    jp, tp = _weights(rcfg)
    flat = jax.tree_util.tree_leaves_with_path(jp)
    assert len(tp["layers"]) == rcfg.n_layers
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for layer in range(rcfg.n_layers):
                got = tp["layers"][layer]
                for k in keys[1:]:
                    got = got[k]
                want = np.asarray(leaf)[layer]
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                              want.view(np.int16))
        else:
            got = tp
            for k in keys:
                got = got[k]
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          np.asarray(leaf).view(np.int16))


def test_init_params_shapes_follow_the_reference_layout():
    rcfg, tcfg = _configs("llama3_405b", "bfloat16")
    jp = RM.init_params(rcfg, KEY)
    tp = TM.init_params(tcfg, 0, device="cpu")
    assert tp["embed"]["tok"].shape == jp["embed"]["tok"].shape
    for k, v in tp["layers"][0]["attn"].items():
        assert tuple(v.shape) == jp["layers"]["attn"][k].shape[1:] and v.dtype == torch.bfloat16
    for k, v in tp["layers"][0]["mlp"].items():
        assert tuple(v.shape) == jp["layers"]["mlp"][k].shape[1:]
    n = sum(v.numel() for v in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: x, tp, is_leaf=lambda x: isinstance(x, torch.Tensor))))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    # one seed on one device gives the same parameters; another seed does not
    again = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"][1]["mlp"]["w_in"], tp["layers"][1]["mlp"]["w_in"])
    other = TM.init_params(tcfg, 1, device="cpu")
    assert not torch.equal(other["embed"]["tok"], tp["embed"]["tok"])


def test_trunc_normal_cuts_at_two_standard_deviations():
    g = torch.Generator().manual_seed(0)
    x = TL.trunc_normal(g, (4096, 64), 1.0, torch.float32)  # std 1/64
    assert float(x.abs().max()) <= 2.0 / 64
    assert float(x.abs().max()) > 1.9 / 64
    assert abs(float(x.std()) * 64 - 0.8796) < 0.01  # a normal cut at +-2 sigma


def _leaf_shapes(tree, stacked=(), prefix=(), drop=False):
    """{path: (shape, dtype name)} of a parameter or state tree; the
    reference's stacked entries (``stacked``) without their leading layer
    axis, the port's per-layer lists by their first layer."""
    out = {}
    for key, v in tree.items():
        path = (*prefix, key)
        if isinstance(v, list):
            out.update(_leaf_shapes(v[0], prefix=path))
        elif isinstance(v, dict):
            out.update(_leaf_shapes(v, prefix=path, drop=drop or key in stacked))
        else:
            shape = tuple(v.shape)[1 if drop else 0:]
            out[path] = (shape, str(v.dtype).removeprefix("torch."))
    return out


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_every_arch_builds_params_and_decode_state_as_the_reference(arch):
    """No family raises: every smoke config's parameters and decode state
    on the CPU have the reference's keys, shapes and dtypes."""
    rcfg, tcfg = RC.get_smoke(arch), TC.get_smoke(arch)
    tp = TM.init_params(tcfg, 0, device="cpu")
    assert len(tp["layers"]) == tcfg.n_layers
    assert _leaf_shapes(tp) == _leaf_shapes(RM.init_params(rcfg, KEY),
                                            stacked=("layers", "enc_layers"))
    rstate = RM.init_decode_state(rcfg, 2, 8)
    tstate = TM.init_decode_state(tcfg, 2, 8, device="cpu")
    assert set(tstate) == set(rstate) and tstate["pos"] == 0
    assert _leaf_shapes({k: v for k, v in tstate.items() if k != "pos"}) == _leaf_shapes(
        {k: v for k, v in rstate.items() if k != "pos"})


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    cfg = TC.get_smoke("olmo_1b")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TM.init_decode_state(cfg, 2, 8)
    rcfg, _ = _configs("olmo_1b", "float32")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        params_from_jax(jax.tree_util.tree_map(np.asarray, RM.init_params(rcfg, KEY)))


# ---------------------------------------------------------------------------
# layers (float32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_apply_norm_matches_reference(norm):
    rcfg = RC.get_smoke("olmo_1b").replace(norm=norm, **F32)
    tcfg = TC.get_smoke("olmo_1b").replace(norm=norm, **F32)
    rng = np.random.default_rng(0)
    x = (3.0 * rng.normal(size=(2, 9, 64)) + 1.0).astype(np.float32)
    p = {}
    if norm != "nonparametric_ln":
        p["scale"] = rng.normal(size=64).astype(np.float32)
        if norm == "layernorm":
            p["bias"] = rng.normal(size=64).astype(np.float32)
    want = RL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), rcfg)
    got = TL.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    _close(_np(got), want, 1e-5)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 4, 16)).astype(np.float32)
    pos = np.arange(11)[None] + np.array([[0], [1000]])  # two offsets
    want = RL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.rope(_t(x), _t(pos), theta)
    # angles up to ~1e3 rad: cos/sin of large float32 arguments differ by a
    # few ulps of the angle between libraries
    _close(_np(got), want, 1e-4)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_apply_mlp_matches_reference(activation):
    rcfg = RC.get_smoke("olmo_1b").replace(activation=activation, **F32)
    tcfg = TC.get_smoke("olmo_1b").replace(activation=activation, **F32)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    p = {"w_in": rng.normal(size=(64, 256)) / 8, "w_out": rng.normal(size=(256, 64)) / 16}
    if activation == "swiglu":
        p["w_gate"] = rng.normal(size=(64, 256)) / 8
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = RL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), rcfg)
    got = TL.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    _close(_np(got), want, 1e-5)


# ---------------------------------------------------------------------------
# forward (the prefill) and decode
# ---------------------------------------------------------------------------


def _tokens(cfg, b=2, s=16, seed=0):
    return make_token_batch(cfg, b, s, seed=seed)["tokens"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "chunked", "pallas"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch, impl, dtype, request):
    rcfg, tcfg = _configs(arch, dtype, impl)
    jp, tp = _weights(rcfg)
    tokens = _tokens(rcfg, b=2, s=32)
    got, aux = TM.forward(tp, tcfg, {"tokens": _t(tokens)})
    assert got.dtype == tcfg.cdtype and got.shape == (2, 32, tcfg.vocab_padded)
    assert float(aux) == 0.0
    if dtype == "float32":
        want, _ = RM.forward(jp, rcfg, {"tokens": jnp.asarray(tokens)})
        _close(_np(got), want, 1e-4)
    else:
        want = request.getfixturevalue("bf16_reference")[f"forward/{arch}/{impl}"]
        _close(_np(got), want, 5e-2)


@pytest.mark.parametrize("arch", DENSE)
def test_port_attention_impls_agree(arch):
    """dense, chunked and pallas are re-schedules of one function
    (tests/test_models.py::test_alt_attention_matches_dense), in float32."""
    _, tcfg = _configs(arch, "float32")
    tp = TM.init_params(tcfg, 0, device="cpu")
    tokens = _t(_tokens(tcfg, s=32, seed=1))
    base, _ = TM.forward(tp, tcfg, {"tokens": tokens})
    for impl in ("chunked", "pallas"):
        got, _ = TM.forward(tp, tcfg.replace(attn_impl=impl), {"tokens": tokens})
        _close(_np(got), _np(base), 1e-4)


def test_pallas_path_interleaves_query_heads_for_gqa():
    """llama3 smoke: 8 query heads on 2 KV heads.  The flash op sees the
    heads sharing a KV head side by side (``h // n_rep``), so its output
    equals dense attention over the un-interleaved heads."""
    _, tcfg = _configs("llama3_405b", "float32", "pallas")
    rng = np.random.default_rng(5)
    p = {k: _t(rng.normal(size=s).astype(np.float32) / 8) for k, s in
         [("wq", (64, 64)), ("wk", (64, 16)), ("wv", (64, 16)), ("wo", (64, 64))]}
    x = _t(rng.normal(size=(2, 12, 64)).astype(np.float32))
    pos = torch.arange(12)[None]
    got = TA.attention_train(p, x, pos, tcfg)
    want = TA.attention_train(p, x, pos, tcfg.replace(attn_impl="dense"))
    _close(_np(got), _np(want), 1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_reference(arch):
    """Step-by-step decode logits and caches against the reference's
    ``decode_step`` in float32, on a cache of 4 slots driven for 7 steps:
    steps 4-6 write at ``pos >= cache_len``, where the reference's
    ``dynamic_update_slice`` clamps the write to the last slot."""
    rcfg, tcfg = _configs(arch, "float32")
    jp, tp = _weights(rcfg)
    tokens = _tokens(rcfg, b=3, s=7, seed=4)
    jstate = RM.init_decode_state(rcfg, 3, 4)
    tstate = TM.init_decode_state(tcfg, 3, 4, device="cpu")
    for t in range(7):
        want, jstate = RM.decode_step(jp, rcfg, jstate, jnp.asarray(tokens[:, t]))
        got, tstate = TM.decode_step(tp, tcfg, tstate, _t(tokens[:, t]))
        assert tstate["pos"] == int(jstate["pos"]) == t + 1
        _close(_np(got), want, 1e-4)
        for c in ("k", "v"):
            _close(_np(tstate[c]), jstate[c], 1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_reference_bf16(arch, bf16_reference):
    rcfg, tcfg = _configs(arch, "bfloat16")
    _, tp = _weights(rcfg)
    tokens = _tokens(rcfg, b=3, s=7, seed=4)
    state = TM.init_decode_state(tcfg, 3, 4, device="cpu")
    for t in range(7):
        got, state = TM.decode_step(tp, tcfg, state, _t(tokens[:, t]))
        _close(_np(got), bf16_reference[f"decode/{arch}/{t}"], 5e-2)
    for c in ("k", "v"):
        _close(_np(state[c]), bf16_reference[f"decode/{arch}/{c}"], 5e-2)


def test_decode_write_is_clamped_in_place():
    _, tcfg = _configs("olmo_1b", "float32")
    tp = TM.init_params(tcfg, 0, device="cpu")
    state = TM.init_decode_state(tcfg, 2, 4, device="cpu")
    cache = state["k"]
    tok = torch.tensor([5, 9])
    seen = []
    for _ in range(7):
        _, state = TM.decode_step(tp, tcfg, state, tok)
        assert state["k"] is cache  # written in place, never copied
        seen.append(cache[0, :, :].clone())
    # steps 4, 5, 6 (pos >= 4) all wrote slot 3; slots 0-2 kept steps 0-2
    for step in (4, 5, 6):
        assert torch.equal(seen[step][:, :3], seen[2][:, :3])
    assert state["pos"] == 7


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_teacher_forcing(arch):
    """tests/test_models.py::test_decode_matches_teacher_forcing for the
    port alone, in float32: the cache machinery reproduces the prefill."""
    _, tcfg = _configs(arch, "float32")
    tp = TM.init_params(tcfg, 0, device="cpu")
    tokens = _t(_tokens(tcfg, s=12, seed=2))
    full, _ = TM.forward(tp, tcfg.replace(attn_impl="pallas"), {"tokens": tokens})
    state = TM.init_decode_state(tcfg, 2, 12, device="cpu")
    got = []
    for t in range(12):
        logits, state = TM.decode_step(tp, tcfg, state, tokens[:, t])
        got.append(logits)
    _close(_np(torch.stack(got, 1)), _np(full), 1e-4)


def _windowed(dtype="float32"):
    """hymba's smoke shape as a dense arch with a 4-token window (as
    tests/test_models.py::test_sliding_window_restricts_attention)."""
    kw = dict(window=4, family="dense", ssm_state=0, **(F32 if dtype == "float32" else {}))
    return RC.get_smoke("hymba_1_5b").replace(**kw), TC.get_smoke("hymba_1_5b").replace(**kw)


@pytest.mark.parametrize("impl", ["dense", "chunked", "pallas"])
def test_windowed_forward_matches_reference(impl):
    rcfg, tcfg = _windowed()
    rcfg, tcfg = rcfg.replace(attn_impl=impl), tcfg.replace(attn_impl=impl)
    jp, tp = _weights(rcfg)
    tokens = _tokens(rcfg, b=1, s=12)
    want, _ = RM.forward(jp, rcfg, {"tokens": jnp.asarray(tokens)})
    got, _ = TM.forward(tp, tcfg, {"tokens": _t(tokens)})
    _close(_np(got), want, 1e-4)
    # the last position attends only to [8..11]: token 0 must not matter
    changed = tokens.copy()
    changed[0, 0] = (changed[0, 0] + 7) % tcfg.vocab
    got2, _ = TM.forward(tp, tcfg, {"tokens": _t(changed)})
    _close(_np(got2)[0, -1], _np(got)[0, -1], 1e-5)
    assert not np.allclose(_np(got2)[0, 1], _np(got)[0, 1])


def test_windowed_rolling_decode_matches_reference():
    """The rolling window cache (4 slots, written at pos % 4) over 10 steps."""
    rcfg, tcfg = _windowed()
    jp, tp = _weights(rcfg)
    tokens = _tokens(rcfg, b=2, s=10, seed=6)
    jstate = RM.init_decode_state(rcfg, 2, 64)
    tstate = TM.init_decode_state(tcfg, 2, 64, device="cpu")
    assert tstate["k"].shape[2] == 4  # min(cache_len, window)
    for t in range(10):
        want, jstate = RM.decode_step(jp, rcfg, jstate, jnp.asarray(tokens[:, t]))
        got, tstate = TM.decode_step(tp, tcfg, tstate, _t(tokens[:, t]))
        _close(_np(got), want, 1e-4)
    _close(_np(tstate["v"]), jstate["v"], 1e-4)
