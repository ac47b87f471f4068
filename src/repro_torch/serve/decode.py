"""Batched serving: single-token decode against a KV cache.

Counterpart of ``repro.serve.decode``.  ``serve_step`` (one new token with a
cache of ``cache_len`` history) is what every serving step runs.  The
:class:`Server` wraps it with request batching: requests are accumulated into
fixed batch slots, decoded greedily, and retired when EOS or max-new tokens
is hit -- continuous batching over a static window.

The reference's semantics are kept on purpose, quirks included, so the
tokens equal the reference's:

- one decode position for the whole batch (``state["pos"]``): a reused slot
  keeps the previous request's K/V history, and the position (hence the
  cache write slot, clamped at ``cache_len - 1``) advances on every step;
- a slot is prefilled by stepping the whole batch once per prompt token, so
  during another slot's prefill an active slot is fed its last token again;
- the last prompt token is fed once more by the first decode step;
- a :class:`Server` takes no frames: an encoder-decoder's server decodes
  against the zero cross-attention memory of ``init_decode_state`` (a
  uniform softmax over zero values, so cross-attention adds 0).

Prefill for a real deployment is the full-sequence ``forward``
(:func:`repro_torch.models.model.forward` with ``attn_impl="pallas"``).

Over a model mesh (``sh``, a sharding policy over a ``torch.distributed``
mesh) every rank runs the same host admission and steps its own rows:
the decode state is this rank's shard (``init_decode_state(..., sh=sh)``),
the step reads this data rank's tokens, the greedy token comes from the
vocabulary shards over ``model`` (:func:`~repro_torch.sharding.comm.
vocab_argmax`) and the tokens of every data rank's rows are gathered
over ``data``, so every rank sees every slot's token and every rank's
``Server.done`` is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import spans
from ..core.dmm_torch import DeviceLike, resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from ..models.layers import split_group, vocab_start
from ..sharding import comm

__all__ = ["ServeConfig", "Server", "greedy_decode", "make_serve_step"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int = 8
    cache_len: int = 1024
    max_new: int = 32
    eos: int = 0


def make_serve_step(cfg: ModelConfig, sh=None) -> Callable:
    """(params, state, token (B,)) -> (next_token (B,) int32, logits, state).
    The argmax runs over the true vocabulary, ``logits[..., :cfg.vocab]``.

    Under a mesh (``sh``), ``token`` and ``state`` are this rank's (this
    data rank's rows), ``logits`` this rank's rows and vocabulary columns,
    and ``next_token`` this data rank's rows, the argmax over the
    vocabulary shards (as the reference's step leaves its tokens split
    over ``data``; :func:`greedy_decode` and :class:`Server` gather
    them)."""
    group = split_group(sh, cfg, "vocab")

    @torch.no_grad()
    def serve_step(params, state, token):
        with spans.span("serve.step"):
            spans.note("rows", token.shape[0])
            spans.note("pos", state["pos"])
            logits, state = M._decode_step(params, cfg, state, token, sh)
            if group is None:
                nxt = torch.argmax(logits[..., : cfg.vocab], dim=-1)
            else:
                nxt = comm.vocab_argmax(logits, vocab_start(cfg, sh), cfg.vocab, group)
            return nxt.to(torch.int32), logits, state

    return serve_step


def _all_rows(nxt: torch.Tensor, sh, batch: int) -> torch.Tensor:
    """Every row's tokens of a batch of ``batch`` rows from this data
    rank's ``nxt``: gathered over the data axes where the batch splits
    over them (one all-gather), as they are otherwise."""
    if sh is None or not sh.sharded or sh.data_rows(batch) == slice(0, batch):
        return nxt
    return comm.all_gather_rows(nxt, sh.data_group())


def _on_device(params: Dict[str, Any], device: DeviceLike) -> torch.device:
    """``device`` resolved (raises without a card for "cuda"), checked
    against where the parameters live."""
    dev = resolve_device(device)
    have = M.params_device(params)
    if have.type != dev.type:
        raise ValueError(f"parameters are on {have}, serving asked for {dev}")
    return have


def greedy_decode(
    params: Dict[str, Any],
    cfg: ModelConfig,
    prompt: torch.Tensor,  # (B, S0) int
    *,
    max_new: int = 16,
    cache_len: int = 256,
    sh=None,
    device: DeviceLike = "cuda",
    extras: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Prefill by stepping the prompt, then decode greedily.  Returns
    (B, max_new) int32 generated tokens on ``device`` (the card by default;
    the parameters must live there).  An encoder-decoder first encodes
    ``extras["frames"]`` (B, enc_seq, D), moved to that device, into the
    cache's cross-attention memory (:func:`~repro_torch.models.model.
    prefill_memory`).  Under a mesh (``sh``) every rank takes the whole
    prompt and returns every row's tokens; it steps its own rows (module
    docstring)."""
    dev = _on_device(params, device)
    B, S0 = prompt.shape
    prompt = prompt.to(dev)
    rows = sh.data_rows(B) if sh is not None and sh.sharded else slice(0, B)
    state = M.init_decode_state(cfg, B, cache_len, device=dev, sh=sh)
    if cfg.enc_dec:
        state = M.prefill_memory(params, cfg, extras["frames"][rows].to(dev), state, sh)
    step = make_serve_step(cfg, sh)
    tok = prompt[:, 0]
    for t in range(1, S0):  # prefill token-by-token (exactness over speed)
        _, _, state = step(params, state, tok[rows])
        tok = prompt[:, t]
    outs = []
    for _ in range(max_new):
        tok, _, state = step(params, state, tok[rows])
        tok = _all_rows(tok, sh, B)
        outs.append(tok)
    return torch.stack(outs, dim=1)


@dataclasses.dataclass
class _Slot:
    request_id: Optional[int] = None
    remaining: int = 0
    generated: Optional[List[int]] = None


class Server:
    """Continuous batching over a static batch window, on ``device`` (the
    card by default; raises when there is none, or when the parameters live
    elsewhere).  Under a mesh (``sh``) every rank runs one, with the same
    requests submitted in the same order (module docstring)."""

    def __init__(self, params: Dict[str, Any], cfg: ModelConfig, sc: ServeConfig, sh=None, *,
                 device: DeviceLike = "cuda") -> None:
        self.device = _on_device(params, device)
        self.params = params
        self.cfg = cfg
        self.sc = sc
        self.sh = sh
        self.rows = sh.data_rows(sc.batch) if sh is not None and sh.sharded else slice(None)
        self.step = make_serve_step(cfg, sh)
        self.state = M.init_decode_state(cfg, sc.batch, sc.cache_len, device=self.device, sh=sh)
        self.slots = [_Slot() for _ in range(sc.batch)]
        self.tokens = np.zeros((sc.batch,), np.int32)
        self.queue: List[Tuple[int, List[int]]] = []
        self.done: Dict[int, List[int]] = {}
        self.steps = 0  # device steps run (prefill and decode)
        self._next_id = 0

    def submit(self, prompt_tokens: List[int]) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, list(prompt_tokens)))
        return rid

    def _admit(self) -> None:
        for slot_i, slot in enumerate(self.slots):
            if slot.request_id is None and self.queue:
                rid, prompt = self.queue.pop(0)
                slot.request_id = rid
                slot.remaining = self.sc.max_new
                slot.generated = []
                # prefill this slot by feeding its prompt (other slots idle)
                for t in prompt:
                    self.tokens[slot_i] = t
                    self._device_step()

    def _device_step(self) -> None:
        token = torch.tensor(self.tokens[self.rows], device=self.device)  # a copy
        nxt, _, self.state = self.step(self.params, self.state, token)
        self._last = _all_rows(nxt, self.sh, self.sc.batch).cpu().numpy()
        self.steps += 1

    def run(self, n_steps: int) -> None:
        for _ in range(n_steps):
            self._admit()
            if all(s.request_id is None for s in self.slots):
                return
            self._device_step()
            for i, slot in enumerate(self.slots):
                if slot.request_id is None:
                    continue
                tok = int(self._last[i])
                slot.generated.append(tok)
                self.tokens[i] = tok
                slot.remaining -= 1
                if slot.remaining <= 0 or tok == self.sc.eos:
                    self.done[slot.request_id] = slot.generated
                    self.slots[i] = _Slot()
