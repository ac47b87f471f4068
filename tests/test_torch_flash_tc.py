"""The numerics and the routing of the tensor-core ``flash_attention``.

The bfloat16 kernel (``csrc/flash_attention.cu``, ``wgmma``) differs from
the reference's arithmetic in one place: it rounds p to bfloat16 before
p.v, because a wgmma's A operand is bfloat16.  :func:`emulate_wgmma`
repeats its arithmetic on the CPU -- the kernel's 128-row query blocks and
128-key tiles in its order, a float32 online softmax in the log2 domain
(masked scores and the initial max -1e30), p rounded to bfloat16, float32
accumulation, the denominator clamped at 1e-30 and one rounding of the
output -- and is held against the JAX reference ``attention_ref`` at the
bfloat16 shapes ``chip_smoke.py`` checks on the card (``FLASH_CASES``),
within the bfloat16 limit ``chip_smoke.py`` holds the kernel to
(``FLASH_TOL``: atol 5e-3, rtol 1e-2, tighter than the reference tests'
3e-2), and the same limit is shown to refuse the planted faults of
``chip_smoke.flash_fault_ref``.  On the card (marker ``gpu``) the kernel
is held against the emulation, to about one bf16 ulp.

Run as a script, it prints each case's largest error and its share of the
limit (and, with a card, the kernel's against the emulation):

    PYTHONPATH=src python tests/test_torch_flash_tc.py
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

BQ, BK = 128, 128  # the kernel's query block and key tile
NEG_INF = -1e30
BF16_TOL = smoke.FLASH_TOL[torch.bfloat16]  # atol, rtol
CASES = smoke.FLASH_CASES  # (N, S, T, hd, n_rep, causal)
FAULT_CASE = (8, 1024, 1024, 128, 1)  # causal; the faults act from row 512 on
# the kernel against the emulation: one bf16 ulp (2^-7 of the output at
# most), and the few weights whose bf16 rounding flips between the two
# (their scores differ in float32's last bits)
EMULATION_TOL = (1e-3, 2 ** -7)


def emulate_wgmma(q, k, v, *, causal=True, n_rep=1):
    """The tensor-core kernel's arithmetic on bfloat16 q (N, S, hd) and k, v
    (N / n_rep, T, hd); returns (N, S, hd) bfloat16."""
    n, s, hd = q.shape
    t, dev = k.shape[1], q.device
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    kk = k.float().repeat_interleave(n_rep, dim=0)
    vv = v.float().repeat_interleave(n_rep, dim=0)
    out = torch.empty_like(q)
    for q0 in range(0, s, BQ):
        qb = q[:, q0:q0 + BQ].float()
        rows = torch.arange(q0, q0 + qb.shape[1], device=dev)[:, None]
        m = torch.full((n, qb.shape[1], 1), NEG_INF, device=dev)
        l = torch.zeros((n, qb.shape[1], 1), device=dev)
        o = torch.zeros((n, qb.shape[1], hd), device=dev)
        t_end = min(t, q0 + BQ) if causal else t
        for k0 in range(0, t_end, BK):
            keys = torch.arange(k0, k0 + BK, device=dev)[None, :]
            kt, vt = kk[:, k0:k0 + BK], vv[:, k0:k0 + BK]  # TMA: rows past T are zeros
            pad = BK - kt.shape[1]
            kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
            vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
            x = torch.matmul(qb, kt.transpose(1, 2)) * scale_log2
            masked = (keys >= t) | ((keys > rows) if causal else False)
            x = torch.where(masked, NEG_INF, x)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + torch.matmul(p.to(torch.bfloat16).float(), vt)
            m = m_new
        out[:, q0:q0 + BQ] = (o / torch.clamp(l, min=1e-30)).to(torch.bfloat16)
    return out


def _case(n, s, t, hd, n_rep, seed=0):
    """chip_smoke.flash_operands' inputs: normal from a numpy seed, in bf16."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
                 for shape in ((n, s, hd), (n // n_rep, t, hd), (n // n_rep, t, hd)))


def _jax_ref(q, k, v, causal, n_rep):
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    return np.array(jref.attention_ref(jq, jk, jv, causal=causal, n_rep=n_rep).astype(jnp.float32))


def errors(n, s, t, hd, n_rep, causal):
    """Against the JAX reference: the emulated kernel's largest |error|, its
    share of the limit (below 1 passes) and the least atol that would pass
    it at the limit's rtol, and the plain version's (p in float32) largest
    |error|."""
    q, k, v = _case(n, s, t, hd, n_rep)
    want = torch.from_numpy(_jax_ref(q, k, v, causal, n_rep))
    got = emulate_wgmma(q, k, v, causal=causal, n_rep=n_rep)
    plain = tref.attention_ref(q, k, v, causal=causal, n_rep=n_rep).float()
    diff = (got.float() - want).abs()
    return (float(diff.max()), smoke.limit_share(got, want, *BF16_TOL),
            float((diff - BF16_TOL[1] * want.abs()).max()), float((plain - want).abs().max()))


@pytest.mark.parametrize("n,s,t,hd,n_rep,causal", CASES)
def test_emulated_wgmma_arithmetic_matches_reference(n, s, t, hd, n_rep, causal):
    err, share, _, _ = errors(n, s, t, hd, n_rep, causal)
    assert share < 1, f"max abs error {err}, {share:.3g} of the limit {BF16_TOL}"


def test_emulation_rounds_p_before_p_v():
    """The emulation is not the plain version by another name: it differs
    from the float32 p.v, by less than two bf16 ulps of the output's
    largest value (2^-6 of it)."""
    q, k, v = _case(2, 128, 128, 64, 1, seed=4)
    got = emulate_wgmma(q, k, v).float()
    plain = tref.attention_ref(q, k, v).float()
    diff = (got - plain).abs().max().item()
    assert 0 < diff < 2 ** -6 * plain.abs().max().item()


@pytest.mark.parametrize("fault", smoke.FLASH_FAULTS)
def test_bf16_limit_refuses_planted_faults(fault):
    """The limit has power where outputs are small: each planted fault fails
    it, by a wide margin, while the emulated kernel passes at that shape."""
    q, k, v = _case(*FAULT_CASE)
    want = torch.from_numpy(_jax_ref(q, k, v, True, 1))
    assert smoke.limit_share(emulate_wgmma(q, k, v), want, *BF16_TOL) < 1
    assert smoke.limit_share(smoke.flash_fault_ref(q, k, v, fault), want, *BF16_TOL) > 2


@pytest.fixture
def card():
    """The Hopper card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0) with CUDA")
    return torch.device("cuda")


def kernel_vs_emulation(n, s, t, hd, n_rep, causal, device):
    """The kernel's largest |difference| from the emulation on the card and
    its share of ``EMULATION_TOL``."""
    q, k, v = (x.to(device) for x in _case(n, s, t, hd, n_rep))
    got = fa.flash_attention(q, k, v, causal=causal, n_rep=n_rep)
    want = emulate_wgmma(q, k, v, causal=causal, n_rep=n_rep)
    return (float((got.float() - want.float()).abs().max()),
            smoke.limit_share(got, want, *EMULATION_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("n,s,t,hd,n_rep,causal", CASES + [(32, 2048, 2048, 128, 1, True)])
def test_kernel_matches_its_emulation(n, s, t, hd, n_rep, causal, card):
    err, share = kernel_vs_emulation(n, s, t, hd, n_rep, causal, card)
    assert share < 1, f"max abs difference {err}, {share:.3g} of {EMULATION_TOL}"


# ---------------------------------------------------------------------------
# the wrapper's rule: which kernel a CUDA call runs (nothing is launched)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "wgmma"),  # the olmo-1b prefill
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 8, "wgmma"),  # the smoke configs' head dims
    (torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, 12, "ffma"),  # a head dim no multiple of 8
    (torch.bfloat16, 100, "ffma"),
    (torch.bfloat16, 1, "ffma"),
    (torch.float32, 128, "ffma"),  # float32 always: TF32 misses 3e-5
    (torch.float32, 8, "ffma"),
    (torch.float32, 12, "ffma"),
])
def test_kernel_variant_rule(dtype, hd, want):
    assert fa.kernel_variant(dtype, hd) == want


def test_kernel_variant_covers_every_bf16_case_the_card_checks():
    """Every bfloat16 shape ``chip_smoke.py`` checks runs the tensor-core
    kernel, and every attention head dim of the port's configs too."""
    from repro_torch import configs

    hds = {c[3] for c in CASES} | {get(a).hd for a in configs.ARCHS
                                   for get in (configs.get, configs.get_smoke)}
    hds = {hd for hd in hds if hd <= fa.MAX_HEAD_DIM}  # rwkv6's 2560 is no attention head
    assert {fa.kernel_variant(torch.bfloat16, hd) for hd in hds} == {"wgmma"}


def test_cpu_tensors_take_the_plain_version_whatever_the_rule():
    before = fa.launches
    q, k, v = _case(2, 40, 40, 64, 1)
    assert torch.equal(fa.flash_attention(q, k, v), tref.attention_ref(q, k, v))
    assert fa.launches == before


# ---------------------------------------------------------------------------
# build: a library's name covers the headers its source includes
# ---------------------------------------------------------------------------


def test_library_name_covers_included_headers_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "_CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\nint f() { return g(); }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("inline int g() { return 1; }\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    assert [p.name for p in build._inputs("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = build.library_path("k")
    assert first == build.library_path("k")  # stable
    (tmp_path / "other.cuh").write_text("// edited, still not included\n")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("inline int g() { return 2; }\n")  # header of a header
    second = build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("k") not in (first, second)


def test_flash_attention_library_covers_hopper_header():
    names = [p.name for p in build._inputs("flash_attention")]
    assert names[0] == "flash_attention.cu" and "hopper.cuh" in names


if __name__ == "__main__":
    on_card = torch.cuda.is_available()
    print(f"N S T hd n_rep causal | vs the JAX reference: emulated wgmma max abs err, "
          f"share of the limit {BF16_TOL}, atol it needs at rtol {BF16_TOL[1]}; "
          "plain (p in f32) max abs err"
          + (f" | kernel vs emulation on the card: max abs diff, share of {EMULATION_TOL}"
             if on_card else ""))
    for case in CASES:
        row = [f"{x:.6g}" for x in errors(*case)]
        if on_card:
            row += ["|"] + [f"{x:.6g}" for x in kernel_vs_emulation(*case, torch.device("cuda"))]
        print(*case, "|", *row, flush=True)
    if on_card:
        print(32, 2048, 2048, 128, 1, True, "| kernel vs emulation:",
              *(f"{x:.6g}" for x in kernel_vs_emulation(32, 2048, 2048, 128, 1, True,
                                                        torch.device("cuda"))))
    q, k, v = _case(*FAULT_CASE)
    want = torch.from_numpy(_jax_ref(q, k, v, True, 1))
    print(*FAULT_CASE, True, "| share of the limit: emulated wgmma",
          f"{smoke.limit_share(emulate_wgmma(q, k, v), want, *BF16_TOL):.6g}",
          *(f"{f} {smoke.limit_share(smoke.flash_fault_ref(q, k, v, f), want, *BF16_TOL):.6g}"
            for f in smoke.FLASH_FAULTS))
