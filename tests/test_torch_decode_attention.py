"""The decode attention kernel (``kernels/decode_attention.py``,
``csrc/decode_attention.cu``): one query token a row against the first
``n_valid`` slots of a KV cache, read where it lies.

On the CPU: the plain version against today's masked einsum (``_sdpa`` /
``_attend_cache``) over head dims, group sizes, valid counts and dtypes;
the rule ``n_valid = min(pos + 1, T)`` against the mask ``attention_decode``
builds, through a rolling window and a clamped position; the wrapper's
refusals; the split rule; and ``attention_decode``'s ``splits`` count (0 on
the einsum path).  On the card (marker ``gpu``): the kernel against the
plain version over the same sweep with one split and several, its launches
in a decode step, and greedy float32 tokens against the einsum path's."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as TC
from repro_torch import spans
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.serve.decode import greedy_decode, make_serve_step

B, KV, T = 2, 2, 80
HEAD_DIMS = [64, 128]
GROUPS = [1, 5, 6, 7, 8, 16]  # olmo and stablelm 1, hymba 5, dbrx 6, internvl2 7, qwen3-moe 8, llama3 16
VALID = {"one": 1, "mid": 37, "all": T}
# (atol, rtol).  The plain version computes in float32 and rounds once.
# Today's einsum in float32 differs from it only in the order of its sums
# (at most 1.9e-7 over this sweep).  In bfloat16 today's path also rounds
# the scores (2^-8 of a score: scores of unit-normal q and k reach ~4, so up
# to 0.016 of a logit) and the probabilities (2^-8 each) to bfloat16 before
# p.v, and both round the output (2^-8): one bfloat16 step of the output
# (2^-7 relative) plus 2^-6 for the rounded weights; the sweep reads at most
# 0.0078 (one step at outputs near 1).
TOL = {torch.float32: (1e-6, 1e-5), torch.bfloat16: (2 ** -6, 2 ** -7)}


def _cfg(dtype):
    return TC.get_smoke("olmo_1b").replace(compute_dtype=str(dtype).split(".")[1],
                                           param_dtype="float32")


def _operands(hd, hg, dtype, t=T, seed=0, device="cpu"):
    g = np.random.default_rng(seed)
    q = torch.from_numpy(g.standard_normal((B, KV * hg, hd), dtype=np.float32))
    k = torch.from_numpy(g.standard_normal((B, t, KV, hd), dtype=np.float32))
    v = torch.from_numpy(g.standard_normal((B, t, KV, hd), dtype=np.float32))
    return tuple(x.to(device, dtype) for x in (q, k, v))


def _mask(n_valid, t=T):
    valid = torch.arange(t) < n_valid
    return torch.where(valid, 0.0, A.NEG_INF).to(torch.float32)[None, None, :]


def _einsum_path(q, k, v, n_valid, dtype):
    """Today's masked einsum over the whole cache, through ``_attend_cache``
    off the card (B, 1, H hd)."""
    out, splits = A._attend_cache(q[:, None], k, v, _cfg(dtype), n_valid=n_valid,
                                  mask=lambda: _mask(n_valid, k.shape[1]))
    assert splits == 0
    return out.reshape(q.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("valid", list(VALID))
@pytest.mark.parametrize("hg", GROUPS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plain_version_matches_the_masked_einsum(hd, hg, valid, dtype):
    q, k, v = _operands(hd, hg, dtype, seed=hd + hg)
    n = VALID[valid]
    got = decode_attention_ref(q, k, v, n)
    want = _einsum_path(q, k, v, n, dtype)
    sdpa = A._sdpa(q[:, None], k, v, _mask(n), _cfg(dtype)).reshape(q.shape)
    assert torch.equal(want, sdpa)
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    # the slots past n_valid are never read: garbage there changes nothing
    k2, v2 = k.clone(), v.clone()
    k2[:, n:], v2[:, n:] = float("nan"), 1e30
    assert torch.equal(decode_attention_ref(q, k2, v2, n), got)


def test_the_wrapper_runs_the_plain_version_on_cpu_tensors():
    q, k, v = _operands(64, 6, torch.float32)
    before = DA.launches
    assert torch.equal(DA.decode_attention(q, k, v, 37), decode_attention_ref(q, k, v, 37))
    assert torch.equal(DA.decode_attention(q, k, v, 37, splits=3),
                       decode_attention_ref(q, k, v, 37))
    assert DA.launches == before  # the plain version is no launch


# the position's valid slots against attention_decode's own mask, through a
# rolling window (the cache is the window) and a clamped position (pos >= T)
WINDOW = 16
POSITIONS = [0, 1, 9, 15, 16, 17, 40, 47, 63]


@pytest.mark.parametrize("window", [0, WINDOW], ids=["clamped", "rolling"])
@pytest.mark.parametrize("pos", POSITIONS)
def test_n_valid_is_the_first_slots_the_mask_admits(window, pos, monkeypatch):
    cfg = TC.get_smoke("hymba_1_5b").replace(param_dtype="float32", compute_dtype="float32")
    t = WINDOW
    p = A.attn_params(torch.Generator().manual_seed(1), cfg)
    g = np.random.default_rng(pos)
    x = torch.from_numpy(g.standard_normal((B, 1, cfg.d_model), dtype=np.float32))
    shape = (B, t, cfg.n_kv_heads, cfg.hd)
    ck = torch.from_numpy(g.standard_normal(shape, dtype=np.float32))
    cv = torch.from_numpy(g.standard_normal(shape, dtype=np.float32))
    seen = []
    real = A._attend_cache

    def spy(q, k, v, cfg_, group=None, *, n_valid=None, mask=None):
        seen.append((q, k.clone(), v.clone(), n_valid, mask()))
        return real(q, k, v, cfg_, group, n_valid=n_valid, mask=lambda: seen[-1][-1])

    monkeypatch.setattr(A, "_attend_cache", spy)
    A.attention_decode(p, x, ck, cv, pos, cfg, window=window)
    (q, k, v, n_valid, mask), = seen
    assert n_valid == min(pos + 1, t)
    admitted = (mask[0, 0] == 0).nonzero().flatten().tolist()
    assert admitted == list(range(n_valid))
    Hq = q.shape[2]
    got = decode_attention_ref(q.reshape(B, Hq, cfg.hd), k, v, n_valid)
    want = A._sdpa(q, k, v, mask, cfg).reshape(B, Hq, cfg.hd)
    torch.testing.assert_close(got, want, **dict(zip(("atol", "rtol"), TOL[torch.float32])))


def _bad(kind):
    q, k, v = _operands(64, 2, torch.float32)
    if kind == "q rank":
        return q[:, None], k, v, 5
    if kind == "k rank":
        return q, k[:, :, 0], v, 5
    if kind == "v shape":
        return q, k, v[:, :40], 5
    if kind == "heads not a multiple of KV":
        return q[:, :3], k, v, 5
    if kind == "head dim":
        return q[..., :32], k, v, 5
    if kind == "rows":
        return q[:1], k, v, 5
    if kind == "dtype":
        return q, k.to(torch.bfloat16), v, 5
    if kind == "float16":
        return q.half(), k.half(), v.half(), 5
    if kind == "n_valid 0":
        return q, k, v, 0
    if kind == "n_valid past T":
        return q, k, v, T + 1
    if kind == "n_valid not an int":
        return q, k, v, torch.tensor(5)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["q rank", "k rank", "v shape", "heads not a multiple of KV",
                                  "head dim", "rows", "dtype", "float16", "n_valid 0",
                                  "n_valid past T", "n_valid not an int"])
def test_the_wrapper_refuses_operands_it_cannot_take(kind):
    with pytest.raises((TypeError, ValueError)):
        DA.decode_attention(*_bad(kind))


def _layout(kind):
    """Operands of a layout the kernel may or may not take, and what it
    raises (None: takes it)."""
    L = 3
    cache = torch.zeros((L, B, T, KV, 128), dtype=torch.bfloat16)
    q = torch.zeros((B, 1, KV * 4, 128), dtype=torch.bfloat16).reshape(B, KV * 4, 128)
    if kind == "cache layer views":
        return (q, cache[1], cache[2]), None
    if kind == "a KV head slice":  # the rows of one KV head of a wider cache
        wide = torch.zeros((B, T, 2 * KV, 128), dtype=torch.bfloat16)
        return (q, wide[:, :, 1:1 + KV], wide[:, :, 1:1 + KV]), None
    if kind == "head dim strided":
        t = torch.zeros((B, T, KV, 256), dtype=torch.bfloat16)[..., ::2]
        return (q, t, t), "not contiguous"
    if kind == "rows off 16 bytes":
        t = torch.zeros((B, T, KV, 132), dtype=torch.bfloat16)[..., :128]
        return (q, t, t), "aligned"
    if kind == "base off 16 bytes":
        t = torch.zeros(B * T * KV * 128 + 1, dtype=torch.bfloat16)[1:].view(B, T, KV, 128)
        return (q, t, t), "aligned"
    if kind == "head dim past 128":
        q2 = torch.zeros((B, KV, 136), dtype=torch.bfloat16)
        t = torch.zeros((B, T, KV, 136), dtype=torch.bfloat16)
        return (q2, t, t), "head dim"
    if kind == "head dim not whole chunks":
        q2 = torch.zeros((B, KV, 12), dtype=torch.bfloat16)
        t = torch.zeros((B, T, KV, 12), dtype=torch.bfloat16)
        return (q2, t, t), "head dim"
    if kind == "group past 16":
        q2 = torch.zeros((B, KV * 17, 128), dtype=torch.bfloat16)
        return (q2, cache[0], cache[0]), "query heads"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["cache layer views", "a KV head slice", "head dim strided",
                                  "rows off 16 bytes", "base off 16 bytes", "head dim past 128",
                                  "head dim not whole chunks", "group past 16"])
def test_the_kernel_layout_is_checked_before_a_launch(kind):
    (q, k, v), error = _layout(kind)
    if error is None:
        strides = DA.kernel_strides(q, k, v)
        assert strides == (q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3])
    else:
        with pytest.raises(ValueError, match=error):
            DA.kernel_strides(q, k, v)


@pytest.mark.parametrize("pairs,n_valid,sms,want", [
    (2048, 1984, 132, 1),  # gen.olmo-1b.long: B 128 x KV 16
    (1024, 136, 132, 1),  # gen.dbrx-132b-s8.short: B 128 x KV 8
    (128, 2048, 132, 1),  # olmo-1b at batch 8: its 128 pairs cover the card
    (64, 2048, 132, 2),  # dbrx at batch 8
    (32, 2048, 132, 4),  # qwen3-moe at batch 8
    (8, 1, 132, 1),  # one slot: one tile
    (8, 200, 132, 4),  # four tiles, one a split
    (16, 1000, 132, 8),  # 16 tiles, 2 a split
    (3, 2048, 132, 32),  # 32 tiles for 44 splits wanted
    (14, 700, 132, 6),  # 11 tiles for 9 splits wanted: 2 a split, so 6
])
def test_plan_splits_fills_the_card_with_no_empty_split(pairs, n_valid, sms, want):
    splits = DA.plan_splits(pairs, n_valid, sms)
    tiles = -(-n_valid // DA.TILE)
    per = -(-tiles // splits)
    assert (splits - 1) * per < tiles <= splits * per  # every split holds a tile
    assert splits == want


def test_attention_decode_on_the_cpu_notes_no_split():
    cfg = TC.get_smoke("dbrx_132b").replace(param_dtype="float32", compute_dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    state = M.init_decode_state(cfg, B, 8, device="cpu")
    step = make_serve_step(cfg)
    tok = torch.tensor([3, 4])
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            tok, _, state = step(params, state, tok)
    reads = [s for s in spans.records() if s.name == "attn.cache_read"]
    assert len(reads) == 2 * cfg.n_layers
    assert all(s.counts["splits"] == 0 for s in reads)


# ---------------------------------------------------------------------------
# on the card (marker gpu; skipped without a Hopper card)
# ---------------------------------------------------------------------------


@pytest.fixture
def hopper():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


def _within(got, q, k, v, n_valid):
    """The kernel's output against the plain version computed in float32 on
    the same inputs: float32 sums in another order (and exp2 for exp), so
    1e-5 relative; bfloat16 besides rounds once, at most 2^-8 of the value."""
    want = decode_attention_ref(q.float(), k.float(), v.float(), n_valid)
    got = got.float().cpu()
    want = want.cpu()
    rtol = 1e-5 if q.dtype == torch.float32 else 2 ** -8 + 1e-5
    err = (got - want).abs() - rtol * want.abs()
    assert float(err.max()) <= 2e-6, float(err.max())


CARD_HEAD_DIMS = [8, 16, 64, 96, 128]  # the smoke configs' 8 and 16, padded 96


@pytest.mark.gpu
@pytest.mark.parametrize("several", [False, True], ids=["one split", "several splits"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_the_kernel_matches_the_plain_version(hopper, dtype, several):
    before = DA.launches
    calls = 0
    for hd in CARD_HEAD_DIMS:
        if (hd * (4 if dtype == torch.float32 else 2)) % 16:
            continue
        for hg in GROUPS:
            for t, valid in ((T, (1, 37, T)), (300, (64, 65, 299))):
                q, k, v = _operands(hd, hg, dtype, t=t, seed=hd * hg + t, device=hopper)
                for n in valid:
                    tiles = -(-n // DA.TILE)
                    splits = tiles if several else 1
                    got = DA.decode_attention(q, k, v, n, splits=splits)
                    torch.cuda.synchronize()
                    _within(got, q, k, v, n)
                    calls += 1 + (splits > 1)
    # a cache's layer views and a KV head slice, read through their strides
    cache = torch.randn((3, B, T, 2 * KV, 128), device=hopper).to(dtype)
    q = torch.randn((B, 1, KV * 6, 128), device=hopper).to(dtype).reshape(B, KV * 6, 128)
    for k, v in ((cache[1, :, :, :KV], cache[2, :, :, KV:]),
                 (cache[0, :, :, 1:1 + KV], cache[1, :, :, 1:1 + KV])):
        got = DA.decode_attention(q, k, v, T, splits=2 if several else 1)
        torch.cuda.synchronize()
        _within(got, q, k, v, T)
        calls += 2 if several else 1
    assert DA.launches == before + calls
    # a layout the kernel cannot take raises, and launches nothing
    shifted = torch.empty(k.numel() + 8, dtype=dtype, device=hopper)[1:1 + k.numel()]
    with pytest.raises(ValueError, match="aligned"):
        DA.decode_attention(q, shifted.view(k.shape), v, 50)
    assert DA.launches == before + calls


@pytest.mark.gpu
def test_a_profiler_links_the_kernels_to_their_own_operator(hopper):
    """A trace reader gives a kernel to the operator it was launched under;
    the launch runs as ``metl_torch::decode_attention``, so a range the
    caller has open holds the kernels through that operator's start."""
    from torch.profiler import record_function

    q, k, v = _operands(128, 6, torch.bfloat16, device=hopper)
    DA.decode_attention(q, k, v, T, splits=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("caller"):
            DA.decode_attention(q, k, v, T, splits=2)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    host = {e.correlation_id(): e for e in events  # as bench/metlbench/trace.py reads them
            if e.device_type() != cuda and e.linked_correlation_id() == 0}
    (caller,) = [e for e in host.values() if e.name() == "caller"]
    kernels = [e for e in events if e.device_type() == cuda and "decode_attention" in e.name()]
    assert len(kernels) == 2  # the split kernel and the combine
    launchers = [host.get(e.linked_correlation_id()) for e in kernels]
    names = [e and e.name() for e in launchers]
    assert None not in launchers and "caller" not in names, names
    for e in launchers:  # started inside the caller's range
        assert caller.start_ns() <= e.start_ns() < caller.start_ns() + caller.duration_ns(), names


def _smoke(arch, dtype, device):
    cfg = TC.get_smoke(arch).replace(param_dtype=dtype, compute_dtype=dtype)
    return cfg, M.init_params(cfg, 0, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["olmo_1b", "dbrx_132b"])
def test_a_decode_step_launches_the_kernel_once_a_layer(hopper, arch, dtype):
    cfg, params = _smoke(arch, dtype, hopper)
    state = M.init_decode_state(cfg, B, 8, device=hopper)
    step = make_serve_step(cfg)
    tok = torch.tensor([3, 4], device=hopper)
    for _ in range(3):
        before = DA.launches
        tok, _, state = step(params, state, tok)
        assert DA.launches - before == cfg.n_layers


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo_1b", "dbrx_132b"])
def test_greedy_float32_tokens_equal_the_einsum_paths(hopper, arch, monkeypatch):
    cfg, params = _smoke(arch, "float32", hopper)
    prompt = torch.tensor([[5, 9, 2, 7], [1, 3, 3, 8]])
    before = DA.launches
    got = greedy_decode(params, cfg, prompt, max_new=100, cache_len=128, device=hopper)
    assert DA.launches > before

    def einsum_path(q, k, v, cfg_, group=None, *, n_valid=None, mask=None):
        return A._sdpa(q, k, v, mask() if mask is not None else None, cfg_), 0

    monkeypatch.setattr(A, "_attend_cache", einsum_path)
    before = DA.launches
    want = greedy_decode(params, cfg, prompt, max_new=100, cache_len=128, device=hopper)
    assert DA.launches == before
    assert torch.equal(got.cpu(), want.cpu())

