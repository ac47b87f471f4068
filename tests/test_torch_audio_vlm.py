"""The port's audio and VLM families against the JAX reference, on the CPU.

whisper-tiny (an encoder over stubbed conv-frontend frames, decoder layers
that cross-attend it) and internvl2-1b (stubbed ViT patches before the
text) at their smoke sizes, and whisper with ``enc_seq`` 37, a length that
is ragged for every tile.  Both packages get the same weights: the
reference's ``init_params`` pytree with the norms' scales and biases
redrawn from a numpy seed (at init they are 1 and 0, which would hide a
norm applied at the wrong place), carried across by ``params_from_jax``.
Inputs come from numpy seeds (``make_token_batch`` makes the frames and
patches, as the reference's batcher does).

Every reference result is computed by :func:`reference_results`: in this
process for float32, and for bfloat16 in one subprocess with XLA's
``--xla_allow_excess_precision=false``, so the reference rounds at every
operation, as the port does (tests/test_torch_model.py).  Tolerances:
float32 1e-4, bfloat16 5e-2 (tests/test_models.py's).  The reference's
``attn_impl="pallas"`` runs its oracle ``attention_ref`` on the CPU, the
port's the plain version of its flash kernel.
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
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro.models import attention as RA
from repro.models import model as RM
from repro.serve.decode import ServeConfig as RServeConfig
from repro.serve.decode import Server as RServer
from repro.serve.decode import greedy_decode as r_greedy_decode

import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.serve.decode import ServeConfig, Server, greedy_decode

REPO = os.path.join(os.path.dirname(__file__), "..")
# case: (arch, overrides of its smoke config)
CASES = {
    "whisper": ("whisper_tiny", {}),
    "whisper-ragged": ("whisper_tiny", {"enc_seq": 37}),
    "internvl2": ("internvl2_1b", {}),
}
WHISPER = ["whisper", "whisper-ragged"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
KEY = jax.random.PRNGKey(0)
FWD_SHAPE = (2, 16)
DECODE_SHAPE, DECODE_CACHE = (3, 10), 8  # batch 3, 10 steps on 8 cache slots: 8, 9 clamp
XATTN_S = 5  # decoder positions of the cross-attention block's input


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
    """The norms' scales (1 + N(0, 0.2)) and biases (N(0, 0.1)) redrawn, the
    rest kept; numpy leaves of the same dtypes."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng)
            continue
        v = np.asarray(v)
        if k == "scale":
            v = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)
        elif k == "bias":
            v = (0.1 * rng.normal(size=v.shape)).astype(v.dtype)
        out[k] = v
    return out


def _ref_params(rcfg):
    """The reference's parameters of ``rcfg`` (numpy leaves), norms redrawn."""
    jp = jax.tree_util.tree_map(np.asarray, RM.init_params(rcfg, KEY))
    return _redraw(jp, np.random.default_rng(3))


def _port_params(rcfg):
    return params_from_jax(_ref_params(rcfg), device="cpu")


def _batch(cfg, shape, seed):
    """tokens, and the family's frames or patches, as numpy arrays."""
    b = make_token_batch(cfg, shape[0], shape[1], seed=seed)
    return {k: v for k, v in b.items() if k in ("tokens", "frames", "patches")}


def _x(cfg, shape, seed):
    """A block's input (B, S, D), float32 from a numpy seed (cast by the caller)."""
    return (0.5 * np.random.default_rng(seed).normal(size=(*shape, cfg.d_model))).astype(np.float32)


def _xattn0(params):
    """Layer 0's cross-attention weights of a reference parameter tree."""
    return {k: v[0] for k, v in params["layers"]["xattn"].items()}


def _state_leaves(state):
    return {k: np.asarray(state[k], np.float32) for k in ("k", "v", "xk", "xv") if k in state}


def reference_results(dtype: str) -> dict:
    """Every reference result the tests compare with, in ``dtype``."""
    out = {}
    for case in CASES:
        rcfg, _ = _configs(case, dtype)
        cd = rcfg.cdtype
        jp = _ref_params(rcfg)
        jb = {k: jnp.asarray(v) for k, v in _batch(rcfg, FWD_SHAPE, seed=0).items()}
        for impl in ("dense", "pallas"):
            cfg = rcfg.replace(attn_impl=impl)
            logits, _ = RM.forward(jp, cfg, jb)
            out[f"forward/{case}/{impl}"] = np.asarray(logits, np.float32)
            if rcfg.enc_dec:
                enc = RM._encode(jp, jb["frames"], cfg, None)
                out[f"encode/{case}/{impl}"] = np.asarray(enc, np.float32)
        if rcfg.enc_dec:
            p = _xattn0(jp)
            mem = jnp.asarray(_x(rcfg, (2, rcfg.enc_seq), seed=2)).astype(cd)
            k, v = RA.project_memory(p, mem, rcfg)
            out[f"project_memory/{case}/k"] = np.asarray(k, np.float32)
            out[f"project_memory/{case}/v"] = np.asarray(v, np.float32)
            x = jnp.asarray(_x(rcfg, (2, XATTN_S), seed=1)).astype(cd)
            out[f"cross_attention/{case}"] = np.asarray(RA.cross_attention(p, x, k, v, rcfg),
                                                        np.float32)
        step = jax.jit(RM.decode_step, static_argnums=1)
        db = _batch(rcfg, DECODE_SHAPE, seed=4)
        state = RM.init_decode_state(rcfg, DECODE_SHAPE[0], DECODE_CACHE)
        if rcfg.enc_dec:
            state = RM.prefill_memory(jp, rcfg, jnp.asarray(db["frames"]), state)
        for t in range(DECODE_SHAPE[1]):
            logits, state = step(jp, rcfg, state, jnp.asarray(db["tokens"][:, t]))
            out[f"decode/{case}/{t}"] = np.asarray(logits, np.float32)
            for k, v in _state_leaves(state).items():
                out[f"state/{case}/{t}/{k}"] = v
    return out


_BF16_REFERENCE = """
import sys
import numpy as np
sys.path.insert(0, %(tests)r)
import test_torch_audio_vlm as T
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


def _tb(b):
    """A numpy batch as port tensors (frames / patches stay float32, as
    the batcher makes them: the model casts them)."""
    return {k: _t(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# parameters and layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["whisper", "internvl2"])
def test_params_from_jax_carries_every_leaf_bit_for_bit(case):
    rcfg, _ = _configs(case, "bfloat16")
    jp = RM.init_params(rcfg, KEY)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [p.key for p in path]
        want = np.asarray(leaf)
        stacked = keys[0] in ("layers", "enc_layers")
        for i in range(want.shape[0] if stacked else 1):
            got = tp[keys[0]][i] if stacked else tp[keys[0]]
            for k in keys[1:]:
                got = got[k]
            w = want[i] if stacked else want
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == w.shape
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), w.view(np.int16))
            n += 1
    if rcfg.enc_dec:
        assert len(tp["enc_layers"]) == rcfg.enc_layers
        assert set(tp["layers"][0]) == {"norm1", "attn", "norm2", "mlp", "norm_x", "xattn"}
        assert set(tp["enc_layers"][0]) == {"norm1", "attn", "norm2", "mlp"}
        assert tuple(tp["enc_pos"].shape) == (rcfg.enc_seq, rcfg.d_model)
    assert n == sum(t.numel() > 0 for t in _leaves(tp))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("case", list(CASES))
def test_init_params_follows_the_reference_layout(case):
    rcfg, tcfg = _configs(case, "bfloat16")
    jp = RM.init_params(rcfg, KEY)
    tp = TM.init_params(tcfg, 0, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [p.key for p in path]
        stacked = keys[0] in ("layers", "enc_layers")
        got = tp[keys[0]][0] if stacked else tp[keys[0]]
        for k in keys[1:]:
            got = got[k]
        assert tuple(got.shape) == (leaf.shape[1:] if stacked else leaf.shape)
        assert got.dtype == torch.bfloat16
    assert sum(t.numel() for t in _leaves(tp)) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))


@pytest.mark.parametrize("case", list(CASES))
def test_init_decode_state_follows_the_reference_layout(case):
    rcfg, tcfg = _configs(case, "bfloat16")
    want = RM.init_decode_state(rcfg, 3, 8)
    got = TM.init_decode_state(tcfg, 3, 8, device="cpu")
    assert set(got) == set(want) and got["pos"] == 0
    for k in set(want) - {"pos"}:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.bfloat16
        assert not bool(got[k].any())
    assert ("xk" in got) == rcfg.enc_dec


# ---------------------------------------------------------------------------
# blocks: cross-attention, the memory projection, the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WHISPER)
def test_project_memory_matches_reference(case, dtype, request):
    rcfg, tcfg = _configs(case, dtype)
    p = {k: _t(v) for k, v in _xattn0(_ref_params(rcfg)).items()}
    mem = _t(_x(rcfg, (2, rcfg.enc_seq), seed=2)).to(tcfg.cdtype)
    k, v = TA.project_memory(p, mem, tcfg)
    ref = _reference(request, dtype)
    shape = (2, rcfg.enc_seq, rcfg.n_kv_heads, rcfg.hd)
    for name, got in (("k", k), ("v", v)):
        assert tuple(got.shape) == shape and got.dtype == tcfg.cdtype
        _close(_np(got), ref[f"project_memory/{case}/{name}"], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WHISPER)
def test_cross_attention_matches_reference(case, dtype, request):
    """On the reference's own projected K / V: every query sees every frame."""
    rcfg, tcfg = _configs(case, dtype)
    p = {k: _t(v) for k, v in _xattn0(_ref_params(rcfg)).items()}
    ref = _reference(request, dtype)
    k, v = (_t(ref[f"project_memory/{case}/{n}"]).to(tcfg.cdtype) for n in ("k", "v"))
    x = _t(_x(rcfg, (2, XATTN_S), seed=1)).to(tcfg.cdtype)
    got = TA.cross_attention(p, x, k, v, tcfg.replace(attn_impl="pallas"))
    assert got.dtype == tcfg.cdtype and tuple(got.shape) == (2, XATTN_S, rcfg.d_model)
    _close(_np(got), ref[f"cross_attention/{case}"], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "pallas"])
@pytest.mark.parametrize("case", WHISPER)
def test_encode_matches_reference(case, impl, dtype, request):
    rcfg, tcfg = _configs(case, dtype, attn_impl=impl)
    tp = _port_params(rcfg)
    frames = _t(_batch(rcfg, FWD_SHAPE, seed=0)["frames"])
    got = TM._encode(tp, frames, tcfg)
    assert got.dtype == tcfg.cdtype and tuple(got.shape) == (2, rcfg.enc_seq, rcfg.d_model)
    _close(_np(got), _reference(request, dtype)[f"encode/{case}/{impl}"], TOL[dtype])


def test_reference_flash_kernel_refuses_the_whisper_encoder():
    """Recorded in ROADMAP queue 3: the reference's Pallas kernel refuses
    non-causal attention whose T is no multiple of its key block (512), so
    it cannot run whisper's 1,500-frame encoder; its ``ops.attention`` takes
    the oracle on the CPU.  The port's plain version agrees with that
    oracle at the encoder's length."""
    q = jnp.zeros((2, 1500, 64), jnp.float32)
    with pytest.raises(ValueError, match="non-causal flash requires T % block_k == 0"):
        pallas_flash_attention(q, q, q, causal=False, interpret=True)
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 1500, 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=False))
    got = tref.attention_ref(_t(q), _t(k), _t(v), causal=False)
    _close(_np(got), want, 3e-5)


# ---------------------------------------------------------------------------
# forward (the prefill), decode, serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_reference(case, impl, dtype, request):
    rcfg, tcfg = _configs(case, dtype, attn_impl=impl)
    tp = _port_params(rcfg)
    batch = _tb(_batch(rcfg, FWD_SHAPE, seed=0))
    got, aux = TM.forward(tp, tcfg, batch)
    positions = FWD_SHAPE[1] + (rcfg.frontend_tokens if rcfg.family == "vlm" else 0)
    assert got.dtype == tcfg.cdtype and got.shape == (FWD_SHAPE[0], positions, tcfg.vocab_padded)
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    _close(_np(got), _reference(request, dtype)[f"forward/{case}/{impl}"], TOL[dtype])


def test_learned_positions_are_added_once():
    """whisper's decoder input is the token row plus the position row, once,
    in that order (the reference adds the encoder-decoder's in ``forward``,
    the port in ``_embed_tokens``)."""
    rcfg, tcfg = _configs("whisper", "float32")
    tp = _port_params(rcfg)
    tokens = _t(_batch(rcfg, FWD_SHAPE, seed=0)["tokens"])
    x = TM._embed_tokens(tp, tokens, tcfg)
    want = tp["embed"]["tok"][tokens.long()] + tp["embed"]["pos"][: FWD_SHAPE[1]][None]
    assert torch.equal(x, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps_and_states_match_reference(case, dtype, request):
    """``prefill_memory`` (whisper) then every decode step's logits and the
    whole state (k, v and the cross memory xk, xv); steps 8 and 9 write the
    clamped last slot of the 8-slot cache."""
    rcfg, tcfg = _configs(case, dtype)
    tp = _port_params(rcfg)
    db = _batch(rcfg, DECODE_SHAPE, seed=4)
    ref = _reference(request, dtype)
    state = TM.init_decode_state(tcfg, DECODE_SHAPE[0], DECODE_CACHE, device="cpu")
    if tcfg.enc_dec:
        held = (state["xk"], state["xv"])
        assert TM.prefill_memory(tp, tcfg, _t(db["frames"]), state) is state
        assert (state["xk"], state["xv"]) == held  # written in place
    for t in range(DECODE_SHAPE[1]):
        got, state = TM.decode_step(tp, tcfg, state, _t(db["tokens"][:, t]))
        assert state["pos"] == t + 1
        _close(_np(got), ref[f"decode/{case}/{t}"], TOL[dtype])
        leaves = {k: state[k] for k in ("k", "v", "xk", "xv") if k in state}
        assert set(leaves) == ({"k", "v", "xk", "xv"} if tcfg.enc_dec else {"k", "v"})
        for k, v in leaves.items():
            _close(_np(v), ref[f"state/{case}/{t}/{k}"], TOL[dtype])


def test_prefill_memory_refuses_frames_of_another_batch():
    _, tcfg = _configs("whisper", "float32")
    tp = TM.init_params(tcfg, 0, device="cpu")
    state = TM.init_decode_state(tcfg, 3, 8, device="cpu")
    with pytest.raises(ValueError, match="do not fit the cache"):
        TM.prefill_memory(tp, tcfg, torch.zeros(1, tcfg.enc_seq, tcfg.d_model), state)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_teacher_forcing(case):
    """Streaming decode logits == the prefill's (float32, port alone):
    whisper's over the same frames (after ``prefill_memory``), internvl2's
    over an empty patch prefix (decode takes no patches)."""
    _, tcfg = _configs(case, "float32")
    tp = TM.init_params(tcfg, 0, device="cpu")
    S = 12
    batch = _tb(_batch(tcfg, (2, S), seed=2))
    if tcfg.family == "vlm":
        batch["patches"] = batch["patches"][:, :0]
    full, _ = TM.forward(tp, tcfg, batch)
    state = TM.init_decode_state(tcfg, 2, S, device="cpu")
    if tcfg.enc_dec:
        TM.prefill_memory(tp, tcfg, batch["frames"], state)
    got = []
    for t in range(S):
        logits, state = TM.decode_step(tp, tcfg, state, batch["tokens"][:, t])
        got.append(logits)
    _close(_np(torch.stack(got, 1)), _np(full), 1e-4)


def test_whisper_memory_moves_the_decode():
    """The cross memory is read: decoding against prefilled frames differs
    from decoding against the zero memory a ``Server`` keeps, which adds
    nothing (a uniform softmax over zero values)."""
    _, tcfg = _configs("whisper", "float32")
    tp = TM.init_params(tcfg, 0, device="cpu")
    b = _tb(_batch(tcfg, (2, 1), seed=5))
    zero = TM.init_decode_state(tcfg, 2, 4, device="cpu")
    filled = TM.prefill_memory(tp, tcfg, b["frames"],
                               TM.init_decode_state(tcfg, 2, 4, device="cpu"))
    a, _ = TM.decode_step(tp, tcfg, zero, b["tokens"][:, 0])
    c, _ = TM.decode_step(tp, tcfg, filled, b["tokens"][:, 0])
    assert float((a - c).abs().max()) > 1e-2
    # the zero memory's cross-attention output is exactly zero
    x = torch.randn(2, 1, tcfg.d_model)
    out = TA.cross_attention(tp["layers"][0]["xattn"], x, zero["xk"][0], zero["xv"][0], tcfg)
    assert not bool(out.any())


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_decode_matches_reference(case):
    rcfg, tcfg = _configs(case, "float32")
    jp = _ref_params(rcfg)
    tp = params_from_jax(jp, device="cpu")
    prompt = np.random.default_rng(0).integers(2, rcfg.vocab, (2, 4)).astype(np.int32)
    frames = _batch(rcfg, (2, 1), seed=6).get("frames")
    r_extras = {"frames": jnp.asarray(frames)} if rcfg.enc_dec else None
    t_extras = {"frames": _t(frames)} if rcfg.enc_dec else None
    want = np.asarray(r_greedy_decode(jp, rcfg, jnp.asarray(prompt), max_new=6, cache_len=32,
                                      extras=r_extras))
    got = greedy_decode(tp, tcfg, torch.from_numpy(prompt), max_new=6, cache_len=32,
                        device="cpu", extras=t_extras)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(CASES))
def test_server_matches_reference(case):
    """Five requests through a 2-slot server, token for token (whisper's
    against the zero memory: a server takes no frames)."""
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


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_1b"])
def test_serve_launcher_runs_on_cpu(arch):
    proc = _launch("--arch", arch, "--smoke", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    requests = [line for line in proc.stdout.splitlines() if line.startswith("request ")]
    assert len(requests) == 8  # --requests 8
    for i, line in enumerate(requests):  # 16 tokens, or fewer ending at EOS 0
        m = re.match(rf"request {i}: (\d+) tokens -> \[", line)
        assert m and 1 <= int(m.group(1)) <= 16, line


# ---------------------------------------------------------------------------
# chip_smoke.py phase 5d, rehearsed on the CPU at the smoke sizes
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_1b"])
def test_chip_smoke_av_phase_rehearsal(arch):
    """Phase 5d's prefill checks (bf16; every flash call checked, none
    launched on the CPU) and its float32 checks on the CPU (the "card"
    side is the CPU too)."""
    smoke = _chip_smoke()
    cpu = torch.device("cpu")
    cfg = TC.get_smoke(arch)
    params = TM.init_params(cfg, 0, device="cpu")
    batch = smoke.av_inputs(cfg, 2, 24, seed=0, device=cpu)
    out = smoke.av_prefill_checks(cfg.name, params, cfg, batch)
    assert out["shape_ok"] and out["finite"] and out["repeat_bit_identical"]
    assert out["flash_launches_checked"] == smoke.av_flash_launches(cfg)
    assert out["flash_vs_plain_by_layer_max_share"] == 0.0
    assert out["prefill_flash_attention_launches"] == 0
    assert smoke.av_flash_launches(cfg) == (4 if cfg.enc_dec else 2)
    cut = smoke.av_cut_f32(cpu, cfg.replace(**F32), teacher=10)
    assert cut["server_tokens_equal"] and cut["teacher_forcing_f32"]["tokens"] == 10
    assert cut["card_vs_cpu_f32_prefill"]["max_abs_err"] == 0
    assert cut["decode_card_vs_cpu_f32"]["max_abs_err"] == 0
    assert cut.get("greedy_tokens_equal", True)
    assert ("greedy_tokens_equal" in cut) == cfg.enc_dec


def test_chip_smoke_av_split_and_decode_bytes():
    smoke = _chip_smoke()
    whisper, internvl2 = TC.get_smoke("whisper_tiny"), TC.get_smoke("internvl2_1b")
    profile = {"device_us": 100.0, "flash_attention_us": 10.0, "range_device_us": {
        "av.encoder": 40.0, "av.attention": 30.0, "av.cross": 8.0, "av.project": 4.0,
        "av.mlp": 25.0, "av.head": 15.0}}
    split = smoke.av_split(profile, whisper)
    assert {k: v["us"] for k, v in split.items()} == {
        "flash_attention": 10.0, "attention projections and layout": 20.0, "mlp": 25.0,
        "head": 15.0, "cross-attention and memory projection": 12.0, "rest": 18.0,
        "encoder, all its parts": 40.0}
    del profile["range_device_us"]["av.cross"], profile["range_device_us"]["av.project"]
    split = smoke.av_split(profile, internvl2)
    assert "cross-attention and memory projection" not in split and split["rest"]["us"] == 30.0
    assert smoke.av_split({**profile, "range_device_us": {}}, internvl2) is None
    # whisper: every parameter but the encoder's, the memory's K / V
    # projections, the token table (8 rows) and the position table (1 row);
    # self K / V of the filled positions and the whole cross memory
    params = TM.init_params(whisper, 0, device="cpu")
    fill, B, it = 5, 8, 2
    D, L = whisper.d_model, whisper.n_layers
    kv = whisper.n_kv_heads * whisper.hd
    per_layer = sum(t.numel() for t in _leaves(params["layers"][0]))
    want = L * (per_layer - 2 * D * kv) + sum(t.numel() for t in _leaves(params["final_norm"]))
    want += D * whisper.vocab_padded + B * D + D  # head, token rows, one position row
    want = want * it + 2 * L * B * (fill + 1) * kv * it + 2 * L * B * whisper.enc_seq * kv * it
    want += B * whisper.vocab_padded * it
    assert smoke.decode_bytes(params, whisper, batch=B, fill=fill) == want
    # internvl2: the tied head reads the whole token table
    params = TM.init_params(internvl2, 0, device="cpu")
    kv = internvl2.n_kv_heads * internvl2.hd
    want = sum(t.numel() for t in _leaves(params)) * it
    want += 2 * internvl2.n_layers * B * (fill + 1) * kv * it + B * internvl2.vocab_padded * it
    assert smoke.decode_bytes(params, internvl2, batch=B, fill=fill) == want


def test_chip_smoke_av_ranges_wrap_and_restore():
    """The profiler's ranges leave the forward unchanged and the model's
    functions as they were."""
    smoke = _chip_smoke()
    cfg = TC.get_smoke("whisper_tiny").replace(**F32)
    params = TM.init_params(cfg, 0, device="cpu")
    batch = smoke.av_inputs(cfg, 1, 9, seed=3, device=torch.device("cpu"))
    want, _ = TM.forward(params, cfg, batch)
    names = ("_encode", "attention_train", "cross_attention", "project_memory", "apply_mlp",
             "lm_logits")
    before = tuple(getattr(TM, n) for n in names)
    with smoke.av_ranges():
        assert TM._encode is not before[0]
        got, _ = TM.forward(params, cfg, batch)
    assert tuple(getattr(TM, n) for n in names) == before
    assert torch.equal(got, want)


def test_chip_smoke_av_launcher_rehearsal():
    """The launcher's runs of phase 5d with the smoke configs on the CPU."""
    smoke = _chip_smoke()
    launches = {name: ([*argv, "--smoke", "--device", "cpu", "--requests", "3",
                        "--max-new", "4"], 3)
                for name, (argv, _) in smoke.AV_LAUNCHES.items()}
    assert {argv[1] for argv, _ in launches.values()} == {"whisper_tiny", "internvl2_1b"}
    out = smoke.run_launcher(launches, "5d")
    assert all(v["requests"] == v["answered"] == 3 for v in out.values())


def test_chip_smoke_flash_cases_hold_the_new_prefills():
    smoke = _chip_smoke()
    assert (12, 1500, 1500, 64, 1, False) in smoke.FLASH_CASES
    assert (28, 2304, 2304, 64, 7, True) in smoke.FLASH_CASES
    assert smoke.FLASH_PREFILLS["whisper-tiny encoder"] == (12, 1500, 64, 1, False)
    assert smoke.FLASH_PREFILLS["internvl2-1b"] == (28, 2304, 64, 7, True)


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
    """float32 on the card (flash_attention's FFMA kernel) against the CPU;
    bfloat16 repeat calls on the card (its tensor-core kernel) bit-identical."""
    rcfg, tcfg = _configs(case, "float32", attn_impl="pallas")
    tp = _port_params(rcfg)
    batch = _tb(_batch(rcfg, FWD_SHAPE, seed=0))
    want, _ = TM.forward(tp, tcfg, batch)
    got, _ = TM.forward(_to(tp, card), tcfg, _to(batch, card))
    _close(_np(got.cpu()), _np(want), 1e-4)
    bcfg = tcfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    bp = TM.init_params(bcfg, 0, device=card)
    a, _ = TM.forward(bp, bcfg, _to(batch, card))
    b, _ = TM.forward(bp, bcfg, _to(batch, card))
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_decode_on_the_card_matches_the_cpu(case, card):
    rcfg, tcfg = _configs(case, "float32", attn_impl="pallas")
    tp = _port_params(rcfg)
    db = _tb(_batch(rcfg, (2, 20), seed=4))
    dp = _to(tp, card)
    on_cpu = TM.init_decode_state(tcfg, 2, 8, device="cpu")
    on_card = TM.init_decode_state(tcfg, 2, 8, device=card)
    if tcfg.enc_dec:
        TM.prefill_memory(tp, tcfg, db["frames"], on_cpu)
        TM.prefill_memory(dp, tcfg, db["frames"].to(card), on_card)
    for t in range(20):
        want, on_cpu = TM.decode_step(tp, tcfg, on_cpu, db["tokens"][:, t])
        got, on_card = TM.decode_step(dp, tcfg, on_card, db["tokens"][:, t].to(card))
        _close(_np(got.cpu()), _np(want), 1e-4)
    for k in ("k", "v", "xk", "xv"):
        if k in on_cpu:
            _close(_np(on_card[k].cpu()), _np(on_cpu[k]), 1e-4)
