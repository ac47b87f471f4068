"""The port's kernels and their plain PyTorch versions against the JAX
reference.

On the CPU the plain versions (``repro_torch.kernels.ref``) are held
against the reference's Pallas kernels (run in interpret mode, as
``tests/test_kernels.py`` runs them) and its pure-jnp oracles, on the same
numpy inputs.  The tolerance is exact for the mapping kernels, which only
select values; the model kernels' tolerances are stated with them below.
The CUDA kernels against their plain versions need a Hopper card (marker
``gpu``) and skip here.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.state import StateCoordinator
from repro.core.synthetic import ScenarioConfig, build_scenario
from repro.etl import CDCEvent as RCDCEvent, EventSource as REventSource
from repro.etl import METLApp as RMETLApp
from repro.etl.engines import _chunk_layout as r_chunk_layout
from repro.etl.engines import _pack_columnar as r_pack_columnar
from repro.etl.events import columnarize as r_columnarize
from repro.kernels import ref as jref
from repro.kernels.densify_map import densify_map as pallas_densify_map
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro.kernels.moe_combine import moe_combine as pallas_moe_combine
from repro.kernels.ops import _resolve_items as r_resolve_items
from repro.kernels.segmented_gather import segmented_gather as pallas_segmented_gather

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.densify_map import densify_map as t_densify_map
from repro_torch.kernels.flash_attention import flash_attention as t_flash_attention
from repro_torch.kernels.masked_gather import masked_gather as t_masked_gather
from repro_torch.kernels.moe_combine import moe_combine as t_moe_combine
from repro_torch.kernels.onehot_map import onehot_map as t_onehot_map
from repro_torch.kernels.segmented_gather import segmented_gather as t_segmented_gather

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

SG_SWEEP = [  # the sweep of tests/test_kernels.py::test_segmented_gather_matches_oracle
    (b, n_in, w, nb, s)
    for (b, n_in, w) in [(8, 64, 128), (37, 300, 256), (64, 128, 128)]
    for (nb, s) in [(8, 16), (16, 130)]
]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


def _sg_case(b, n_in, w, n_blocks, s):
    rng = np.random.default_rng(hash((b, n_in, w, n_blocks, s)) % 2**31)
    vals = rng.normal(size=(b, n_in)).astype(np.float32)
    mask = (rng.random((b, n_in)) < 0.7).astype(np.int8)
    src2d = np.full((n_blocks, w), -1, np.int32)
    for blk in range(n_blocks):
        k = int(0.5 * min(n_in, w))
        src2d[blk, rng.choice(w, size=k, replace=False)] = rng.choice(
            n_in, size=k, replace=False
        )
    rows = rng.integers(b, size=s).astype(np.int32)
    blks = rng.integers(n_blocks, size=s).astype(np.int32)
    return vals, mask, rows, blks, src2d


@pytest.fixture
def hopper():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# segmented_gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fill", [0.0, 0.25])
@pytest.mark.parametrize("b,n_in,w,n_blocks,s", SG_SWEEP)
def test_segmented_gather_ref_matches_reference(b, n_in, w, n_blocks, s, fill):
    case = _sg_case(b, n_in, w, n_blocks, s)
    jv, jm = jref.segmented_gather_ref(*map(jnp.asarray, case), fill=fill)
    pv, pm = pallas_segmented_gather(*map(jnp.asarray, case), fill=fill, interpret=True)
    tv, tm = tref.segmented_gather_ref(*map(_t, case), fill=fill)
    _assert_exact(tv.numpy(), jv)
    _assert_exact(tm.numpy(), jm)
    _assert_exact(tv.numpy(), pv)
    _assert_exact(tm.numpy(), pm)


def test_segmented_gather_wrapper_takes_plain_version_on_cpu():
    import repro_torch.kernels.segmented_gather as sg

    case = [_t(a) for a in _sg_case(37, 300, 256, 16, 130)]
    before = sg.launches
    v, m = t_segmented_gather(*case, fill=0.25)
    rv, rm = tref.segmented_gather_ref(*case, fill=0.25)
    _assert_exact(v.numpy(), rv.numpy())
    _assert_exact(m.numpy(), rm.numpy())
    assert sg.launches == before  # the plain version is no kernel launch


def test_kernel_wrappers_refuse_other_devices():
    case = [_t(a).to("meta") for a in _sg_case(8, 64, 128, 8, 16)]
    with pytest.raises(ValueError, match="no segmented_gather kernel"):
        t_segmented_gather(*case)
    packed = torch.zeros(64, dtype=torch.int32, device="meta")
    tab = torch.zeros(4, dtype=torch.int32, device="meta")
    src2d = torch.zeros((8, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no densify_map kernel"):
        t_densify_map(packed, tab, tab, src2d, n_items=8, n_events=8, n_rows=8, k=1)
    vals = torch.zeros((8, 10), dtype=torch.float32, device="meta")
    mask = torch.zeros((8, 10), dtype=torch.int8, device="meta")
    src = torch.zeros(128, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no masked_gather kernel"):
        t_masked_gather(vals, mask, src)
    with pytest.raises(ValueError, match="no onehot_map kernel"):
        t_onehot_map(vals, mask, src)
    q = torch.zeros((4, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        tops.attention(q, q, q)
    with pytest.raises(ValueError, match="no moe_combine kernel"):
        tops.moe_combine(torch.zeros((2, 4, 8), device="meta"),
                         torch.zeros((3, 2, 4), device="meta"))


# ---------------------------------------------------------------------------
# densify_map and the resolve prologue
# ---------------------------------------------------------------------------


def _dm_case(seed, b=24, k=7, n_rows=50, n_blocks=8, w=128):
    rng = np.random.default_rng(seed)
    slot2d = rng.integers(-1, 30, size=(b, k)).astype(np.int32)
    x2d = rng.normal(size=(b, k)).astype(np.float32)
    rows = rng.integers(0, b, size=n_rows).astype(np.int32)
    blks = rng.integers(0, n_blocks, size=n_rows).astype(np.int32)
    src2d = rng.integers(-1, 30, size=(n_blocks, w)).astype(np.int32)
    return slot2d, x2d, rows, blks, src2d


@pytest.mark.parametrize("seed,fill", [(0, 0.5), (1, 0.0), (2, 0.25)])
def test_densify_map_ref_matches_reference(seed, fill):
    case = _dm_case(seed)
    jv, jm = jref.densify_map_ref(*map(jnp.asarray, case), fill=fill)
    pv, pm = pallas_densify_map(*map(jnp.asarray, case), fill=fill, interpret=True)
    tv, tm = tref.densify_map_ref(*map(_t, case), fill=fill)
    _assert_exact(tv.numpy(), jv)
    _assert_exact(tm.numpy(), jm)
    _assert_exact(tv.numpy(), pv)
    _assert_exact(tm.numpy(), pm)


def test_densify_map_ref_last_writer_wins_like_reference():
    slot2d, x2d, _, _, src2d = _dm_case(0)
    k = slot2d.shape[1]
    slot2d[0, :] = 3  # every item of event 0 lands on slot 3
    x2d[0, :] = np.arange(k, dtype=np.float32)
    src2d[0, 0] = 3
    rows = np.zeros(8, np.int32)
    blks = np.zeros(8, np.int32)
    case = (slot2d, x2d, rows, blks, src2d)
    pv, pm = pallas_densify_map(*map(jnp.asarray, case), interpret=True)
    tv, tm = tref.densify_map_ref(*map(_t, case))
    assert float(tv[0, 0]) == float(k - 1)
    _assert_exact(tv.numpy(), pv)
    _assert_exact(tm.numpy(), pm)


def _mk_event(key, o, v, payload, state):
    return RCDCEvent(key=key, op="c", state=state, schema_id=o, version=v,
                     before=None, after=payload, ts=key)


def _packed_chunks():
    """Packed device-densify buffers built by the reference's own
    ``_pack_columnar``: a synthetic stream chunk, and an adversarial chunk
    with foreign, unknown and out-of-range uids."""
    sc = build_scenario(ScenarioConfig(n_schemas=4, versions_per_schema=3,
                                       attrs_per_version=6, n_entities=2,
                                       cdm_attrs=8, seed=5))
    coord = StateCoordinator(sc.registry, sc.dpm)
    app = RMETLApp(coord, engine="fused", device_densify=True)
    plan = app.engine.plan
    reg = sc.registry
    blocks = reg.domain.blocks()
    state = reg.state
    rng = np.random.default_rng(3)
    adversarial = []
    for i in range(40):
        sv = blocks[int(rng.integers(len(blocks)))]
        other = blocks[int(rng.integers(len(blocks)))]
        payload = {u: float(rng.normal()) for u in sv.uids if rng.random() < 0.8}
        payload[other.uids[0]] = 7.0  # foreign when `other` is another column
        payload[[10**7, 2**40, -3][i % 3]] = 1.0
        adversarial.append(_mk_event(i, sv.schema_id, sv.version, payload, state))
    chunks = [
        REventSource(reg, seed=9).slice_columnar(0, 64),
        r_columnarize(adversarial),
    ]
    out = []
    for chunk in chunks:
        app.reset_dedup()  # the two chunks share event keys
        layout = r_chunk_layout(plan, app.triage(chunk))
        s = layout.row_ids.size
        s_pad = 1 << (s - 1).bit_length()
        rows = np.zeros(s_pad, np.int32)
        blks = np.zeros(s_pad, np.int32)
        rows[:s], blks[:s] = layout.row_ids, layout.blk_ids
        packed, ni, b, k = r_pack_columnar(layout, rows, blks)
        out.append((packed, plan, dict(n_items=ni, n_events=b, k=k), s_pad))
    return out


@pytest.mark.parametrize("which", [0, 1])
def test_resolve_items_ref_matches_reference(which):
    packed, plan, sizes, _ = _packed_chunks()[which]
    js, jx = r_resolve_items(jnp.asarray(packed), plan.uid_slot_dev,
                             plan.uid_col_dev, **sizes)
    ts, tx = tref.resolve_items_ref(_t(packed), _t(plan.uid_slot),
                                    _t(plan.uid_col), **sizes)
    _assert_exact(ts.numpy(), js)
    _assert_exact(tx.numpy(), jx)
    assert (ts.numpy() >= 0).any()  # not vacuous


def test_resolve_items_ref_with_empty_uid_table():
    packed, _, sizes, _ = _packed_chunks()[0]
    empty = np.empty(0, np.int32)
    js, jx = r_resolve_items(jnp.asarray(packed), jnp.asarray(empty),
                             jnp.asarray(empty), **sizes)
    ts, tx = tref.resolve_items_ref(_t(packed), _t(empty), _t(empty), **sizes)
    _assert_exact(ts.numpy(), js)
    _assert_exact(tx.numpy(), jx)
    assert (ts.numpy() == -1).all()


@pytest.mark.parametrize("which", [0, 1])
def test_densify_map_packed_matches_reference_composition(which):
    packed, plan, sizes, n_rows = _packed_chunks()[which]
    js, jx = r_resolve_items(jnp.asarray(packed), plan.uid_slot_dev,
                             plan.uid_col_dev, **sizes)
    o = tref.route_offset(sizes["n_items"], sizes["n_events"])
    rows, blks = packed[o : o + n_rows], packed[o + n_rows : o + 2 * n_rows]
    jv, jm = jref.densify_map_ref(js, jx, jnp.asarray(rows), jnp.asarray(blks),
                                  jnp.asarray(plan.src2d))
    tv, tm = t_densify_map(_t(packed), _t(plan.uid_slot), _t(plan.uid_col),
                           _t(np.asarray(plan.src2d)), n_rows=n_rows, **sizes)
    _assert_exact(tv.numpy(), jv)
    _assert_exact(tm.numpy(), jm)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("fill", [0.0, 0.25])
def test_segmented_gather_kernel_matches_plain(hopper, fill):
    for case in SG_SWEEP:
        args = [_t(a).to(hopper) for a in _sg_case(*case)]
        kv, km = t_segmented_gather(*args, fill=fill)
        rv, rm = tref.segmented_gather_ref(*args, fill=fill)
        torch.cuda.synchronize()
        _assert_exact(kv.cpu().numpy(), rv.cpu().numpy())
        _assert_exact(km.cpu().numpy(), rm.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("which", [0, 1])
def test_densify_map_kernel_matches_plain(hopper, which):
    packed, plan, sizes, n_rows = _packed_chunks()[which]
    args = [_t(a).to(hopper) for a in (packed, plan.uid_slot, plan.uid_col,
                                        np.asarray(plan.src2d))]
    kv, km = t_densify_map(*args, n_rows=n_rows, fill=0.25, **sizes)
    rv, rm = tref.densify_map_packed_ref(*args, n_rows=n_rows, fill=0.25, **sizes)
    torch.cuda.synchronize()
    _assert_exact(kv.cpu().numpy(), rv.cpu().numpy())
    _assert_exact(km.cpu().numpy(), rm.cpu().numpy())


# ---------------------------------------------------------------------------
# the model kernels: flash_attention and moe_combine
# ---------------------------------------------------------------------------
#
# Tolerances are the reference's own kernel tests': attention f32 atol 3e-5 /
# rtol 1e-4 and bf16 3e-2 (tests/test_kernels_flash.py), moe_combine f32
# atol 1e-4 and bf16 0.1, rtol 1e-2 (tests/test_kernels.py).  The plain
# versions compute in float32 like the oracles but sum in another order, so
# they are held by these tolerances rather than bit for bit.  The Hopper
# flash kernels are held tighter in bf16 (chip_smoke.FLASH_TOL's limit: one
# bf16 ulp of the output, rtol 1e-2, plus the tensor-core kernel's rounding
# of p to bf16, atol 5e-3; tests/test_torch_flash_tc.py shows its power).
FLASH_BF16_LIMIT = (5e-3, 1e-2)

FLASH_SWEEP = [  # tests/test_kernels_flash.py::test_flash_matches_dense
    (1, 64, 64, 64, 1, True),
    (4, 128, 128, 64, 1, True),
    (8, 300, 300, 64, 2, True),  # unaligned S
    (2, 256, 256, 128, 1, False),
    (6, 64, 512, 64, 3, True),  # long KV (decode-ish), GQA 3:1
    (4, 257, 257, 128, 4, True),  # prime-ish length
]
MOE_SWEEP = [(8, 2, 4, 32), (64, 8, 16, 96), (130, 4, 8, 256), (256, 16, 8, 128)]


def _flash_case(n, s, t, hd, n_rep, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, s, hd)).astype(np.float32)
    k = rng.normal(size=(n // n_rep, t, hd)).astype(np.float32)
    v = rng.normal(size=(n // n_rep, t, hd)).astype(np.float32)
    return q, k, v


def _moe_case(t, e, c, d):
    """tests/test_kernels.py::test_moe_combine_matches_oracle's inputs:
    (expert_out (E, C, D) float32, combine (T, E, C) with two weights a row)."""
    rng = np.random.default_rng(hash((t, e, c, d)) % 2**31)
    eo = rng.normal(size=(e, c, d)).astype(np.float32)
    cw = np.zeros((t, e, c), np.float32)
    for ti in range(t):
        for _ in range(2):
            cw[ti, rng.integers(e), rng.integers(c)] = rng.random()
    return eo, cw


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("n,s,t,hd,n_rep,causal", FLASH_SWEEP)
def test_attention_ref_matches_reference(n, s, t, hd, n_rep, causal):
    case = _flash_case(n, s, t, hd, n_rep)
    want = jref.attention_ref(*map(jnp.asarray, case), causal=causal, n_rep=n_rep)
    pallas = pallas_flash_attention(*map(jnp.asarray, case), causal=causal, n_rep=n_rep,
                                    block_q=64, block_k=128, interpret=True)
    got = tref.attention_ref(*map(_t, case), causal=causal, n_rep=n_rep)
    assert got.dtype == torch.float32 and got.shape == (n, s, hd)
    _close(got.numpy(), want, 3e-5, 1e-4)
    _close(got.numpy(), pallas, 3e-5, 1e-4)


def test_attention_ref_bf16_matches_reference():
    q, k, v = (_t(a).to(torch.bfloat16) for a in _flash_case(4, 128, 128, 64, 2))
    jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (q, k, v))
    want = jref.attention_ref(jq, jk, jv, causal=True, n_rep=2)
    pallas = pallas_flash_attention(jq, jk, jv, causal=True, n_rep=2, block_q=64,
                                    block_k=64, interpret=True)
    got = tref.attention_ref(q, k, v, causal=True, n_rep=2)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, 3e-2, 3e-2)
    _close(got.float().numpy(), pallas, 3e-2, 3e-2)


@pytest.mark.parametrize("s,t,causal", [(64, 2048, True), (100, 100, False), (33, 70, False)])
def test_attention_ref_long_and_ragged_keys_match_reference(s, t, causal):
    """Many key tiles (tests/test_kernels_flash.py's row-exactness case) and
    ragged non-causal T, which the reference kernel refuses
    (``T % block_k``) and the Hopper kernel takes."""
    case = _flash_case(1, s, t, 64, 1, seed=3)
    want = jref.attention_ref(*map(jnp.asarray, case), causal=causal)
    got = tref.attention_ref(*map(_t, case), causal=causal)
    _close(got.numpy(), want, 5e-5, 1e-4)
    if not causal:
        with pytest.raises(ValueError, match="T % block_k"):
            pallas_flash_attention(*map(jnp.asarray, case), causal=False, block_q=64,
                                   block_k=64, interpret=True)


def test_reference_flash_kernel_diverges_for_causal_s_greater_than_ragged_t():
    """A fault of the reference kernel, recorded (ROADMAP queue 3): with
    causal attention, S > T and T no multiple of block_k, it zero-pads the
    keys and only the causal mask hides the padding, so query rows >= T also
    attend the padded zero keys.  The port holds its kernel to the oracle
    ``attention_ref``, which both packages agree on."""
    case = _flash_case(2, 100, 50, 64, 1)
    want = np.asarray(jref.attention_ref(*map(jnp.asarray, case), causal=True))
    pallas = np.asarray(pallas_flash_attention(*map(jnp.asarray, case), causal=True,
                                               block_q=64, block_k=32, interpret=True))
    got = tref.attention_ref(*map(_t, case), causal=True).numpy()
    _close(got, want, 3e-5, 1e-4)
    err = np.abs(pallas - want).max(axis=(0, 2))  # per query row
    assert err[:50].max() < 3e-5  # rows < T see no padding
    assert int(np.argmax(err > 1e-3)) == 50  # the first differing row is T
    assert err[50:].max() > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,e,c,d", MOE_SWEEP)
def test_moe_combine_ref_matches_reference(t, e, c, d, dtype):
    eo, cw = _moe_case(t, e, c, d)
    jeo = jnp.asarray(eo).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = jref.moe_combine_ref(jeo, jnp.asarray(cw))
    pallas = pallas_moe_combine(jnp.asarray(cw), jeo, interpret=True)
    teo = _t(eo).to(getattr(torch, dtype))
    got = tref.moe_combine_ref(teo, _t(cw))
    assert got.dtype == teo.dtype and got.shape == (t, d)
    atol = 1e-4 if dtype == "float32" else 0.1
    _close(got.float().numpy(), want, atol, 1e-2)
    _close(got.float().numpy(), pallas, atol, 1e-2)
    # the op takes (expert_out, combine), the kernel (combine, expert_out)
    assert torch.equal(tops.moe_combine(teo, _t(cw)), got)
    assert torch.equal(t_moe_combine(_t(cw), teo), got)


def test_moe_combine_ref_ignores_the_tf32_flag():
    eo, cw = _moe_case(64, 8, 16, 96)
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        a = tref.moe_combine_ref(_t(eo), _t(cw))
        torch.backends.cuda.matmul.allow_tf32 = False
        b = tref.moe_combine_ref(_t(eo), _t(cw))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert torch.equal(a, b)


def test_model_kernel_wrappers_take_plain_version_on_cpu():
    import repro_torch.kernels.flash_attention as fa
    import repro_torch.kernels.moe_combine as mc

    before = (fa.launches, mc.launches)
    q, k, v = map(_t, _flash_case(4, 30, 20, 16, 2))
    assert torch.equal(tops.attention(q, k, v, causal=False, n_rep=2),
                       tref.attention_ref(q, k, v, causal=False, n_rep=2))
    assert torch.equal(t_flash_attention(q, k, v, n_rep=2),
                       tref.attention_ref(q, k, v, n_rep=2))
    eo, cw = map(_t, _moe_case(8, 2, 4, 32))
    assert torch.equal(t_moe_combine(cw, eo), tref.moe_combine_ref(eo, cw))
    assert (fa.launches, mc.launches) == before  # the plain version is no launch


@pytest.mark.gpu
def test_flash_attention_kernel_matches_plain(hopper):
    import repro_torch.kernels.flash_attention as fa

    bf16 = (torch.bfloat16, *FLASH_BF16_LIMIT)
    cases = [(c, torch.float32, 3e-5, 1e-4) for c in FLASH_SWEEP] + [
        ((4, 128, 128, 64, 2, True), *bf16),
        ((2, 100, 100, 64, 1, False), torch.float32, 3e-5, 1e-4),  # ragged T, non-causal
        ((2, 100, 50, 64, 1, True), torch.float32, 3e-5, 1e-4),  # S > T, ragged T
        ((3, 40, 40, 8, 1, True), torch.float32, 3e-5, 1e-4),  # llama3 smoke hd
        ((4, 33, 33, 16, 2, True), *bf16),  # smoke hd
    ] + [(c, *bf16) for c in [  # the tensor-core kernel
        (2, 100, 100, 64, 1, False), (3, 37, 130, 128, 1, False),  # ragged T, non-causal
        (2, 100, 50, 64, 1, True), (2, 300, 130, 128, 1, True),  # causal S > T, ragged T
        (3, 40, 40, 8, 1, True), (4, 33, 33, 16, 2, True),  # hd 8 / 16
        (4, 257, 257, 64, 1, True), (4, 257, 257, 128, 1, False),  # hd 64 / 128
        (8, 200, 300, 128, 4, True), (32, 130, 130, 64, 16, True),  # GQA n_rep 4 / 16
        (32, 2048, 2048, 128, 1, True),  # the olmo-1b prefill
        # head dims padded to 64 (24, 40) or 128 (72, 120)
        (2, 130, 130, 24, 1, True), (2, 100, 77, 24, 1, False),
        (4, 257, 257, 40, 2, True), (2, 64, 190, 40, 1, False),
        (2, 200, 200, 72, 1, True), (3, 90, 133, 72, 3, False),
        (4, 160, 160, 120, 2, True), (2, 37, 150, 120, 1, False),
    ]] + [((2, 70, 90, 12, 1, True), *bf16)]  # hd % 8: FFMA
    before = fa.launches
    for (n, s, t, hd, n_rep, causal), dtype, atol, rtol in cases:
        q, k, v = (_t(a).to(hopper, dtype) for a in _flash_case(n, s, t, hd, n_rep))
        want_variant = "wgmma" if dtype == torch.bfloat16 and hd % 8 == 0 else "ffma"
        assert fa.kernel_variant(q.dtype, hd) == want_variant
        got = t_flash_attention(q, k, v, causal=causal, n_rep=n_rep)
        want = tref.attention_ref(q, k, v, causal=causal, n_rep=n_rep)
        torch.cuda.synchronize()
        _close(got.float().cpu().numpy(), want.float().cpu().numpy(), atol, rtol)
    assert fa.launches == before + len(cases)
    # an operand off the tensor maps' 16-byte alignment raises, and launches nothing
    q, k, v = (_t(a).to(hopper, torch.bfloat16) for a in _flash_case(4, 130, 130, 128, 2))
    shifted = torch.empty(k.numel() + 1, dtype=k.dtype, device=hopper)[1:].view(k.shape)
    shifted.copy_(k)
    with pytest.raises(ValueError, match="16-byte aligned"):
        t_flash_attention(q, shifted, v, n_rep=2)
    assert fa.launches == before + len(cases)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_combine_kernel_matches_plain(hopper, dtype):
    for shape in MOE_SWEEP:
        eo, cw = (_t(a).to(hopper) for a in _moe_case(*shape))
        eo = eo.to(getattr(torch, dtype))
        got = tops.moe_combine(eo, cw)
        want = tref.moe_combine_ref(eo, cw)
        torch.cuda.synchronize()
        atol = 1e-4 if dtype == "float32" else 0.1
        _close(got.float().cpu().numpy(), want.float().cpu().numpy(), atol, 1e-2)


MOE_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("top_k", smoke.MOE_DENSITIES)
def test_moe_combine_kernel_density_sweep(hopper, top_k):
    """The sparse kernels against the plain version at every chip_smoke
    shape (the reference sweep and the qwen3-moe group) and density, with a
    weightless token; a repeat call bit-identical; two launches a call."""
    import repro_torch.kernels.moe_combine as mc

    before = mc.launches
    for shape in smoke.MOE_CASES:
        cw, eo = smoke.moe_arrays(*shape, top_k=top_k, plant=("empty_token",))
        for cdt, edt in MOE_PAIRS:
            smoke.check_moe_case(_t(cw).to(hopper, cdt), _t(eo).to(hopper, edt))
    torch.cuda.synchronize()
    assert mc.launches == before + 2 * 2 * len(smoke.MOE_CASES) * len(MOE_PAIRS)


@pytest.mark.gpu
@pytest.mark.parametrize("plant", ["nonfinite_expert", "nonfinite_weight"])
def test_moe_combine_kernel_keeps_nonfinite_values(hopper, plant):
    """inf and NaN in expert_out slots no weight names, and in weights: the
    kernel's infs and NaNs are where the plain version's are."""
    for shape in smoke.MOE_CASES:
        cw, eo = smoke.moe_arrays(*shape, top_k=8 if shape[1] == 128 else 2,
                                  plant=("empty_token", plant))
        for cdt, edt in MOE_PAIRS:
            smoke.check_moe_case(_t(cw).to(hopper, cdt), _t(eo).to(hopper, edt))
