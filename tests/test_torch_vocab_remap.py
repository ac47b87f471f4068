"""The port's vocabulary remapping (a DMM block applied to parameters)
against the JAX reference, on the CPU: tests/test_vocab_remap.py's cases,
each also held bit for bit against the reference's surgery on the same
weights (``params_from_jax``).  With noise for the fresh rows the two draw
from different generators, so only the fresh rows' shape, dtype and scale
are compared there; every kept row and the head stay bit-exact."""

import numpy as np
import pytest
import jax
import torch

import repro.configs as RC
from repro.core.vocab_remap import remap_vocab_params as r_remap
from repro.core.vocab_remap import vocab_map_from_names as r_vocab_map
from repro.models import model as RM

import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax
from repro_torch.core.vocab_remap import remap_vocab_params, vocab_map_from_names
from repro_torch.models import model as TM

KEY = jax.random.PRNGKey(0)


def _bits(t) -> np.ndarray:
    """A port tensor's or reference array's raw bits, for bit-exact compares."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a.view(np.int32)


def _weights(arch, dtype):
    cfg = RC.get_smoke(arch)
    if dtype == "float32":
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    jp = jax.tree_util.tree_map(np.asarray, RM.init_params(cfg, KEY))
    return cfg, TC.get_smoke(arch).replace(**{k: getattr(cfg, k) for k in (
        "param_dtype", "compute_dtype")}), jp, params_from_jax(jp, device="cpu")


def _permuted(V, fresh, seed=0):
    """Old and new names: a permutation of the old vocabulary, its last
    ``fresh`` slots replaced by new tokens."""
    rng = np.random.default_rng(seed)
    old = [f"t{i}" for i in range(V)]
    perm = rng.permutation(V)
    return old, [old[p] for p in perm[: V - fresh]] + [f"fresh{i}" for i in range(fresh)], perm


def test_vocab_map_from_names():
    src = vocab_map_from_names(["a", "b", "c"], ["c", "x", "a"])
    np.testing.assert_array_equal(src, [2, -1, 0])
    assert src.dtype == np.int32
    old, new, _ = _permuted(64, 5)
    np.testing.assert_array_equal(vocab_map_from_names(old, new), r_vocab_map(old, new))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["olmo_1b", "llama3_405b", "whisper_tiny", "internvl2_1b"])
def test_remap_equals_the_reference_bit_for_bit(arch, dtype):
    """Tied (olmo-1b, internvl2-1b) and untied (llama3-405b, whisper-tiny)
    tables; every other parameter passes through untouched."""
    rcfg, tcfg, jp, tp = _weights(arch, dtype)
    old, new, _ = _permuted(rcfg.vocab, 8, seed=1)
    src = vocab_map_from_names(old, new)
    want = r_remap(jp, src, rcfg, rcfg)
    got = remap_vocab_params(tp, src, tcfg, tcfg)
    for name in want["embed"]:
        assert got["embed"][name].dtype == tp["embed"][name].dtype
        np.testing.assert_array_equal(_bits(got["embed"][name]), _bits(want["embed"][name]))
    assert set(got) == set(tp)
    assert all(got[k] is tp[k] for k in tp if k != "embed")
    assert tp["embed"]["tok"] is not got["embed"]["tok"]  # the input is left as it was


def test_kept_tokens_logits_invariant():
    _, tcfg, _, tp = _weights("olmo_1b", "float32")  # tied embeddings: single table remap
    V = tcfg.vocab
    old, new, perm = _permuted(V, 8)
    src = vocab_map_from_names(old, new)
    params2 = remap_vocab_params(tp, src, tcfg, tcfg)
    # a sequence in old token ids, and its image under the remap
    old_to_new = {int(s): q for q, s in enumerate(src) if s >= 0}
    seq_old = np.asarray([perm[i] for i in range(12)], np.int64)  # all kept
    seq_new = np.asarray([old_to_new[t] for t in seq_old], np.int64)
    lo, _ = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(seq_old[None])})
    ln, _ = TM.forward(params2, tcfg, {"tokens": torch.from_numpy(seq_new[None])})
    # logit of kept token q in the new model == logit of src[q] in the old
    for o, q in list(old_to_new.items())[:64]:
        np.testing.assert_allclose(ln[0, :, q].numpy(), lo[0, :, o].numpy(), atol=1e-5, rtol=1e-5)


def test_fresh_tokens_zero_initialised():
    rcfg, tcfg, jp, tp = _weights("llama3_405b", "bfloat16")  # untied: remaps head too
    V = tcfg.vocab
    src = vocab_map_from_names([f"t{i}" for i in range(V)],
                               [f"t{i}" for i in range(V - 4)] + [f"f{i}" for i in range(4)])
    params2 = remap_vocab_params(tp, src, tcfg, tcfg)
    tok = params2["embed"]["tok"].float()
    assert bool((tok[V - 4: V] == 0).all())
    head = params2["embed"]["head"].float()
    assert bool((head[:, V - 4: V] == 0).all())
    # a fresh scale without a key, and a key at scale 0, are zeros as well
    for kw in ({"fresh_scale": 0.5}, {"fresh_scale": 0.0, "key": torch.Generator()}):
        again = remap_vocab_params(tp, src, tcfg, tcfg, **kw)
        np.testing.assert_array_equal(_bits(again["embed"]["tok"]),
                                      _bits(r_remap(jp, src, rcfg, rcfg)["embed"]["tok"]))


@pytest.mark.parametrize("arch", ["olmo_1b", "llama3_405b"])
def test_fresh_rows_from_a_key(arch):
    """With a key the kept rows and the head equal the reference's bit for
    bit; the fresh rows are standard normal noise at ``fresh_scale``, of the
    table's dtype (the reference's own draws cannot be reproduced)."""
    rcfg, tcfg, jp, tp = _weights(arch, "float32")
    old, new, _ = _permuted(rcfg.vocab, 200, seed=2)
    src = vocab_map_from_names(old, new)
    scale = 0.02
    want = r_remap(jp, src, rcfg, rcfg, fresh_scale=scale, key=jax.random.PRNGKey(5))
    got = remap_vocab_params(tp, src, tcfg, tcfg, fresh_scale=scale,
                             key=torch.Generator().manual_seed(5))
    src_pad = np.full(tcfg.vocab_padded, -1)
    src_pad[: len(src)] = src
    kept, fresh = src_pad >= 0, src_pad < 0
    tok, wtok = got["embed"]["tok"], np.asarray(want["embed"]["tok"])
    assert tok.dtype == tp["embed"]["tok"].dtype and tuple(tok.shape) == wtok.shape
    np.testing.assert_array_equal(_bits(tok)[kept], _bits(wtok)[kept])
    rows = tok[torch.from_numpy(fresh)]
    assert rows.shape[0] == int(fresh.sum()) and bool((rows != 0).all())
    assert abs(float(rows.std()) / scale - 1) < 0.05 and abs(float(rows.mean())) < 0.002
    assert abs(float(rows.std()) - float(np.std(wtok[fresh]))) < 0.05 * scale
    if "head" in want["embed"]:
        np.testing.assert_array_equal(_bits(got["embed"]["head"]), _bits(want["embed"]["head"]))
    # one seed, one draw
    again = remap_vocab_params(tp, src, tcfg, tcfg, fresh_scale=scale,
                               key=torch.Generator().manual_seed(5))
    assert torch.equal(again["embed"]["tok"], tok)


def test_growing_vocabulary_pads_with_fresh_rows():
    """A larger new vocabulary: the slots past ``src`` are fresh, as in the
    reference."""
    rcfg, tcfg, jp, tp = _weights("llama3_405b", "float32")
    big_r, big_t = rcfg.replace(vocab=rcfg.vocab + 300), tcfg.replace(vocab=tcfg.vocab + 300)
    src = np.arange(rcfg.vocab, dtype=np.int32)[::-1].copy()
    want = r_remap(jp, src, rcfg, big_r)
    got = remap_vocab_params(tp, src, tcfg, big_t)
    assert tuple(got["embed"]["tok"].shape) == (big_t.vocab_padded, tcfg.d_model)
    for name in ("tok", "head"):
        np.testing.assert_array_equal(_bits(got["embed"][name]), _bits(want["embed"][name]))


def test_bad_maps_raise():
    _, tcfg, _, tp = _weights("olmo_1b", "float32")
    with pytest.raises(ValueError, match="longer than the new"):
        remap_vocab_params(tp, np.zeros(tcfg.vocab_padded + 1, np.int32), tcfg, tcfg)
    with pytest.raises(ValueError, match="names row"):
        remap_vocab_params(tp, np.array([0, tcfg.vocab_padded], np.int32), tcfg, tcfg)
