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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.dmm_torch import DeviceLike, resolve_device
from ..models import model as M
from ..models.config import ModelConfig

__all__ = ["ServeConfig", "Server", "greedy_decode", "make_serve_step"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int = 8
    cache_len: int = 1024
    max_new: int = 32
    eos: int = 0


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, state, token (B,)) -> (next_token (B,) int32, logits, state).
    The argmax runs over the true vocabulary, ``logits[..., :cfg.vocab]``."""

    def serve_step(params, state, token):
        logits, state = M.decode_step(params, cfg, state, token)
        nxt = torch.argmax(logits[..., : cfg.vocab], dim=-1).to(torch.int32)
        return nxt, logits, state

    return serve_step


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
    device: DeviceLike = "cuda",
    extras: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Prefill by stepping the prompt, then decode greedily.  Returns
    (B, max_new) int32 generated tokens on ``device`` (the card by default;
    the parameters must live there).  An encoder-decoder first encodes
    ``extras["frames"]`` (B, enc_seq, D), moved to that device, into the
    cache's cross-attention memory (:func:`~repro_torch.models.model.
    prefill_memory`)."""
    dev = _on_device(params, device)
    B, S0 = prompt.shape
    prompt = prompt.to(dev)
    state = M.init_decode_state(cfg, B, cache_len, device=dev)
    if cfg.enc_dec:
        state = M.prefill_memory(params, cfg, extras["frames"].to(dev), state)
    step = make_serve_step(cfg)
    tok = prompt[:, 0]
    for t in range(1, S0):  # prefill token-by-token (exactness over speed)
        _, _, state = step(params, state, tok)
        tok = prompt[:, t]
    outs = []
    for _ in range(max_new):
        tok, _, state = step(params, state, tok)
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
    elsewhere)."""

    def __init__(self, params: Dict[str, Any], cfg: ModelConfig, sc: ServeConfig, *,
                 device: DeviceLike = "cuda") -> None:
        self.device = _on_device(params, device)
        self.params = params
        self.cfg = cfg
        self.sc = sc
        self.step = make_serve_step(cfg)
        self.state = M.init_decode_state(cfg, sc.batch, sc.cache_len, device=self.device)
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
        token = torch.tensor(self.tokens, device=self.device)  # a copy
        nxt, _, self.state = self.step(self.params, self.state, token)
        self._last = nxt.cpu().numpy()
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
