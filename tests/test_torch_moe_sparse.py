"""The sparse two-phase algorithm of the Hopper ``moe_combine``, on the CPU.

The CUDA kernels (``csrc/moe_combine.cu``) compute ``out[t, d] =
sum_{e,c} combine[t, e, c] * expert_out[e, c, d]`` on the router's
non-zero weights.  Phase 1 lists, for each tile of ``TILE_T`` tokens, the
``(e, c)`` columns where one of the tile's weights is non-zero (a NaN or
inf weight counts), in ascending order, and flags every column d of
expert_out that holds an inf or a NaN.  Phase 2 sums each tile's listed
terms in that order, ``TILE_K`` at a time into a partial sum that is added
to the total, and every ``E*C`` term instead for the ``TILE_D``
output columns around a flagged one: the function multiplies every weight,
zeros included, so a NaN in a slot no token is routed to still makes its
column NaN in every row (``0 x NaN``).

:func:`emulate_two_phase` repeats that algorithm with PyTorch on the CPU.
It and the port's plain version ``repro_torch.kernels.ref.moe_combine_ref``
are held against the JAX reference ``repro.kernels.ref.moe_combine_ref``
and the Pallas kernel in interpret mode, on numpy inputs made from a seed
(``chip_smoke.moe_arrays``, the builder the card's checks use), at the
reference tests' tolerances: float32 expert_out atol 1e-4, bfloat16 0.1,
rtol 1e-2; infs and NaNs exactly where the reference has them.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.moe_combine import moe_combine as pallas_moe_combine

from repro_torch.kernels import moe_combine as mc
from repro_torch.kernels import ref as tref

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# (T, E, C, D, weights a token (None: every weight), planted values)
CASES = [(*shape, 2, ()) for shape in smoke.MOE_CASES[:-1]] + [  # the reference sweep
    (64, 8, 16, 96, 1, ()),  # one weight a token
    (64, 128, 40, 64, 8, ()),  # qwen3-moe's density (8 of E*C) at a small D
    (64, 16, 20, 96, 4, ()),  # dbrx's: E 16, top 4, C = _capacity(64) at factor 1.25
    (40, 4, 8, 96, None, ()),  # every weight non-zero
    (16, 128, 40, 32, None, ()),  # every weight at qwen3-moe's E*C: 5,120 terms a sum
    (32, 4, 8, 64, 0, ()),  # no weight at all
    (37, 8, 16, 96, 2, ("empty_token",)),  # a token without weight; T % TILE_T != 0
    # inf and NaN in expert_out slots no weight names; D spans two column blocks
    (64, 8, 16, 300, 2, ("empty_token", "nonfinite_expert")),
    (37, 8, 16, 96, 2, ("nonfinite_weight",)),  # a NaN weight and an inf one
]
DTYPES = [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16")]


def tile_terms(w: torch.Tensor, bt: int = mc.TILE_T) -> list:
    """Phase 1's lists: for each tile of ``bt`` rows of w (T, E*C), the
    columns where one of its weights is != 0, ascending."""
    return [torch.nonzero((w[t0:t0 + bt] != 0).any(0)).flatten()
            for t0 in range(0, w.shape[0], bt)]


def emulate_two_phase(combine, expert_out, *, flags=True):
    """The kernels' algorithm on combine (T, E, C) and expert_out (E, C,
    D): (T, D) in ``expert_out.dtype``, each output summed ``TILE_K`` terms
    at a time into a partial sum that is added to the total.
    ``flags=False`` drops phase 1's column flags (every block sums only its
    tile's list)."""
    t, e, c = combine.shape
    k, d = e * c, expert_out.shape[-1]
    w = combine.reshape(t, k).float()
    x = expert_out.reshape(k, d).float()
    bad = ~torch.isfinite(x).all(0) if flags else torch.zeros(d, dtype=torch.bool)
    out = torch.zeros((t, d))
    for tile, terms in enumerate(tile_terms(w)):
        rows = slice(tile * mc.TILE_T, (tile + 1) * mc.TILE_T)
        for d0 in range(0, d, mc.TILE_D):
            cols = slice(d0, d0 + mc.TILE_D)
            ks = torch.arange(k) if bool(bad[cols].any()) else terms
            acc = torch.zeros_like(out[rows, cols])
            for k0 in range(0, len(ks), mc.TILE_K):  # ascending E*C order
                part = torch.zeros_like(acc)
                for kk in ks[k0:k0 + mc.TILE_K].tolist():
                    part = part + w[rows, kk, None] * x[kk, None, cols]
                acc = acc + part
            out[rows, cols] = acc
    return out.to(expert_out.dtype)


def _operands(t, e, c, d, top_k, plant, cdt, edt):
    cw, eo = smoke.moe_arrays(t, e, c, d, top_k=top_k, plant=plant)
    tcw = torch.from_numpy(cw).to(getattr(torch, cdt))
    teo = torch.from_numpy(eo).to(getattr(torch, edt))
    return tcw, teo


def _jax(x: torch.Tensor):
    a = jnp.asarray(x.float().numpy())
    return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a


def _assert_matches(got, want, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], atol=atol, rtol=1e-2)


@pytest.mark.parametrize("cdt,edt", DTYPES)
@pytest.mark.parametrize("t,e,c,d,top_k,plant", CASES)
def test_emulation_and_plain_version_match_reference(t, e, c, d, top_k, plant, cdt, edt):
    cw, eo = _operands(t, e, c, d, top_k, plant, cdt, edt)
    want = np.asarray(jref.moe_combine_ref(_jax(eo), _jax(cw)).astype(jnp.float32))
    pallas = np.asarray(pallas_moe_combine(_jax(cw), _jax(eo), interpret=True)
                        .astype(jnp.float32))
    if any(p.startswith("nonfinite") for p in plant):
        assert np.isnan(want).any()  # the planted values reach the output
    atol = 1e-4 if edt == "float32" else 0.1
    _assert_matches(pallas, want, atol)  # the reference's two forms agree first
    for got in (emulate_two_phase(cw, eo), tref.moe_combine_ref(eo, cw)):
        assert got.dtype == eo.dtype and got.shape == (t, d)
        _assert_matches(got.float().numpy(), want, atol)
        _assert_matches(got.float().numpy(), pallas, atol)


def test_unrouted_nonfinite_slot_makes_its_column_nan_in_every_row():
    """The rule the flags keep: a NaN and an inf in expert_out slots that no
    weight names make their columns NaN in every row, the weightless token's
    included; a sum of each tile's listed terms alone misses it."""
    cw, eo = _operands(64, 8, 16, 300, 2, ("empty_token", "nonfinite_expert"), "float32",
                       "float32")
    flat = cw.reshape(64, -1)
    rows = eo.reshape(flat.shape[1], -1)
    nan_slot, inf_slot = (int(torch.nonzero(~rows[:, col].isfinite())[0]) for col in (5, 1))
    assert not flat[:, nan_slot].any() and not flat[:, inf_slot].any()  # no weight names them
    assert not flat[0].any()
    want = np.asarray(jref.moe_combine_ref(_jax(eo), _jax(cw)))
    assert np.isnan(want[:, [1, 5]]).all() and np.isfinite(np.delete(want, [1, 5], 1)).all()
    _assert_matches(emulate_two_phase(cw, eo).numpy(), want, 1e-4)
    assert torch.isfinite(emulate_two_phase(cw, eo, flags=False)).all()


def test_tile_lists_hold_what_the_density_allows():
    """At qwen3-moe's density a tile's list holds at most 8 x TILE_T of the
    5,120 columns, ascending; at full density every column; with no weight
    none (phase 2 then writes zeros)."""
    cw, _ = smoke.moe_arrays(512, 128, 40, 8, top_k=8, seed=9)
    w = torch.from_numpy(cw).reshape(512, -1)
    lists = tile_terms(w)
    assert len(lists) == 512 // mc.TILE_T
    assert max(len(x) for x in lists) <= 8 * mc.TILE_T
    assert all(bool((x[1:] > x[:-1]).all()) for x in lists)
    assert sum(len(x) for x in lists) >= int(w.ne(0).any(0).sum())
    dense = torch.from_numpy(smoke.moe_arrays(40, 4, 8, 8, top_k=None)[0]).reshape(40, -1)
    assert all(len(x) == 32 for x in tile_terms(dense))
    assert all(len(x) == 0 for x in tile_terms(torch.zeros(40, 32)))
