"""Serving engine: batched prefill + decode with preallocated caches.

A transcription of ``repro/serve/engine.py``, for every registered
family.  The engine keeps a fixed-capacity batch; requests are admitted
into free slots and prefilled token by token through ``lm.decode_step`` (a
plain einsum against the KV cache, or one plain step of a recurrence, whose
cache is a fixed-size state).  ``capture_prefill`` is the batched prefill:
one ``forward`` through the flash-attention or WKV kernel in every
attention or WKV layer, then the cache filled by replaying the decode steps.

Behaviours of the reference are kept on purpose, so that generated token
ids match it (ROADMAP C lists them as reference-side caveats):

* ``_prefill_slot`` runs the whole batch at slot ``i``'s position, so it
  overwrites the other slots' cache rows at that position (ssm: it advances
  the other slots' recurrent states with token 0);
* ``step`` decodes every active slot at the first active slot's position;
* ``capture_prefill`` does not serve the audio and vlm families (C8): it
  prefills without their frames or vision tokens, where the JAX package
  fails (``KeyError`` / ``AssertionError``), so here it raises;
* whisper's decode cross-attends to cache K/V that nothing writes (C8).

The cache is updated in place (``models/transformer.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm, transformer


@dataclass
class Request:
    """One generation request: prompt tokens in, generated tokens out."""

    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Single-host continuous-batching engine on the parameters' device."""

    def __init__(self, cfg: ArchConfig, params, batch_capacity: int, max_seq: int):
        """Preallocate a ``batch_capacity`` x ``max_seq`` KV cache on the
        parameters' device."""
        self.cfg = cfg
        self.params = params
        self.B = batch_capacity
        self.S = max_seq
        self.device = params["embed"]["table"].device
        self.cache = lm.init_cache(cfg, batch_capacity, max_seq, device=self.device)
        self.pos = np.zeros(batch_capacity, np.int32)
        self.slots: list[Request | None] = [None] * batch_capacity
        self._step = lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg)

    # -- admission -----------------------------------------------------------
    def admit(self, req: Request) -> bool:
        """Place ``req`` into a free batch slot and prefill it; False if full."""
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = req
                self._prefill_slot(i, req)
                return True
        return False

    def _prefill_slot(self, i: int, req: Request) -> None:
        """Feed the prompt token-by-token into slot ``i`` (the whole batch
        runs at ``pos[i]``, as in the reference)."""
        for tok in req.prompt:
            token = torch.zeros((self.B,), dtype=torch.int32, device=self.device)
            token[i] = int(tok)
            _, self.cache = self._step(self.params, self.cache, token, int(self.pos[i]))
            self.pos[i] += 1

    # -- decode loop ----------------------------------------------------------
    def step(self, greedy: bool = True) -> None:
        """Advance every active slot by one decode token; retire finished slots."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        token = np.zeros((self.B,), np.int32)
        for i in active:
            last = self.slots[i].out[-1] if self.slots[i].out else int(self.slots[i].prompt[-1])
            token[i] = last
        pos = int(self.pos[active[0]])  # homogeneous-pos batches in examples
        logits, self.cache = self._step(
            self.params, self.cache, torch.from_numpy(token).to(self.device), pos)
        nxt = torch.argmax(logits, dim=-1).cpu()  # greedy either way, as in the reference
        for i in active:
            r = self.slots[i]
            r.out.append(int(nxt[i]))
            self.pos[i] += 1
            if len(r.out) >= r.max_new or self.pos[i] >= self.S - 1:
                r.done = True
                self.slots[i] = None

    def run(self, requests: list[Request]) -> list[Request]:
        """Drive admission + decode until every request completes; return them."""
        pending = list(requests)
        done: list[Request] = []
        while pending or any(s is not None for s in self.slots):
            while pending and self.admit(pending[0]):
                pending.pop(0)
            self.step()
            done.extend(r for r in requests if r.done and r not in done)
        return done


def capture_prefill(cfg: ArchConfig, params, tokens, max_seq: int):
    """Batched prefill that also returns the filled cache.

    tokens: (B, P) int tensor on the parameters' device.  One forward
    through the flash or WKV kernel gives the last-position logits (B, 1, V);
    the cache is filled by replaying the decode steps position by position.
    Raises ``ValueError`` for the audio and vlm families (ROADMAP C8)."""
    if cfg.family in ("audio", "vlm"):
        raise ValueError(
            f"{cfg.name}: capture_prefill does not serve the {cfg.family} family: it "
            "prefills tokens alone, without the frames or vision tokens this family "
            "needs, and the JAX package's fails there too (ROADMAP caveat C8)")
    B, P = tokens.shape
    cache = lm.init_cache(cfg, B, max_seq, device=tokens.device)
    logits = transformer.prefill(params, tokens, cfg)
    for t in range(P):
        _, cache = lm.decode_step(params, cache, tokens[:, t], t, cfg)
    return logits, cache
