"""Batched LM serving with slot-based continuous batching, the port of
``repro.serving.engine``.

Correctness model (right-padding; see ``models/transformer.py``):

* Requests are right-padded into a fixed prompt buffer; the plain causal
  mask is per-request correct during prefill, because padding keys live
  at positions the real queries never attend to.
* At decode, request ``b`` generates at position ``len_b + t``, written
  into slot ``position`` (full cache) or ``position % W`` (ring). A
  stale slot (prefill garbage at index g >= len_b) only becomes causally
  visible when the query reaches position g, the exact step at which
  the new token is written into slot g (g % W) before attention runs,
  so garbage is never attended. Stored per-slot positions drive the
  causal/window mask; -1 marks empty slots.

``Engine`` implements continuous batching: a fixed number of slots;
finished requests release their slot mid-flight and a queued request is
prefilled into it (a [1, P] prefill + an in-place cache splice) while
the other slots keep decoding. The engine runs on the device its
parameters live on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer as T


def _prefill(params, tokens, cache, valid_len, cfg):
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    return T.forward_with_cache(params, tokens, cfg, cache, positions,
                                valid_len=valid_len)


def _decode(params, tokens, cache, positions, cfg):
    logits, cache = T.forward_with_cache(params, tokens[:, None], cfg,
                                         cache, positions[:, None])
    return logits[:, 0], cache


def _splice(batch_cache: dict, one_cache: dict, slot: int) -> dict:
    """Copy a single-request cache into slot ``slot`` of the batch cache,
    in place: every leaf by name (a layer's k and v, or MLA's ckv and
    kr; the position rows)."""
    for key, val in batch_cache.items():
        if key == "layers":
            for lb, lo in zip(val, one_cache["layers"]):
                for name, t in lb.items():
                    t[slot:slot + 1].copy_(lo[name])
        else:
            val[slot:slot + 1].copy_(one_cache[key])
    return batch_cache


def _void_padding(cache: dict, lengths) -> None:
    """Mark the slots past each request's real prompt empty again (-1):
    prefill wrote positions for the whole buffer."""
    for i, n in enumerate(lengths):
        cache["pos"][i, int(n):] = -1
        if "pos_local" in cache:
            row = cache["pos_local"][i]
            row.masked_fill_(row >= int(n), -1)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis (over every padded-vocab row; the first
    index on ties), int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_top_p(logits: torch.Tensor, generator: torch.Generator,
                 p: float = 0.9, temp: float = 1.0) -> torch.Tensor:
    """Nucleus sampling, vectorised over the batch: keep the smallest
    prefix of the (stably) sorted tokens whose probability mass reaches
    ``p`` (always the top one), draw from it with ``generator``. p -> 0
    is ``greedy``."""
    logits = logits.float() / max(temp, 1e-6)
    sorted_idx = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, sorted_idx)
    probs = torch.softmax(sorted_logits, dim=-1)
    mask = torch.cumsum(probs, dim=-1) - probs > p
    sorted_logits = torch.where(mask, -1e30, sorted_logits)
    choice = torch.multinomial(torch.softmax(sorted_logits, dim=-1), 1,
                               generator=generator)
    return torch.gather(sorted_idx, -1, choice)[:, 0].to(torch.int32)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # int32 [len]
    max_new: int
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Continuous-batching serving engine.

    Slots decode in lockstep (one batched decode step per tick); empty or
    finished slots are refilled from the queue by a single-request
    prefill and a cache splice. Per-request positions make slots of
    mixed progress correct.
    """

    def __init__(self, params: dict, cfg: T.LMConfig, *, slots: int = 4,
                 prompt_buf: int = 64, cache_buf: int = 256,
                 eos_id: int = -1):
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.slots = slots
        self.prompt_buf = prompt_buf
        self.cache_buf = cache_buf
        self.eos_id = eos_id
        self.cache = T.init_cache(cfg, slots, cache_buf, device=self.device)
        self.active: list[Optional[Request]] = [None] * slots
        self.lengths = np.zeros(slots, np.int32)    # tokens in cache
        self.last_token = np.zeros(slots, np.int32)
        self.queue: list[Request] = []
        self._uid = 0

    def submit(self, prompt, max_new: int = 32) -> int:
        self._uid += 1
        self.queue.append(Request(self._uid, np.asarray(prompt, np.int32),
                                  max_new))
        return self._uid

    # -- internals ---------------------------------------------------------

    def _admit(self) -> None:
        """Fill free slots from the queue (prefill + splice)."""
        for s in range(self.slots):
            if self.active[s] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            plen = len(req.prompt)
            if plen > self.prompt_buf:
                raise ValueError(f"prompt of {plen} tokens exceeds the "
                                 f"buffer of {self.prompt_buf}")
            toks = np.zeros((1, self.prompt_buf), np.int32)
            toks[0, :plen] = req.prompt
            one_cache = T.init_cache(self.cfg, 1, self.cache_buf,
                                     device=self.device)
            logits, one_cache = _prefill(
                self.params, torch.from_numpy(toks).to(self.device),
                one_cache, torch.tensor([plen], dtype=torch.int32,
                                        device=self.device), self.cfg)
            _void_padding(one_cache, [plen])
            _splice(self.cache, one_cache, s)
            self.active[s] = req
            self.lengths[s] = plen
            self.last_token[s] = int(greedy(logits[:, plen - 1])[0])
            req.out_tokens.append(int(self.last_token[s]))

    def _retire(self) -> None:
        for s, req in enumerate(self.active):
            if req is None:
                continue
            hit_eos = req.out_tokens and req.out_tokens[-1] == self.eos_id
            if len(req.out_tokens) >= req.max_new or hit_eos or \
                    self.lengths[s] + 1 >= self.cache_buf:
                req.done = True
                self.active[s] = None

    def step(self) -> None:
        """One engine tick: admit, decode every active slot, retire."""
        self._admit()
        if not any(r is not None for r in self.active):
            return
        logits, self.cache = _decode(
            self.params, torch.from_numpy(self.last_token).to(self.device),
            self.cache, torch.from_numpy(self.lengths).to(self.device),
            self.cfg)
        nxt = greedy(logits).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.lengths[s] += 1
            self.last_token[s] = nxt[s]
            req.out_tokens.append(int(nxt[s]))
        self._retire()

    def run(self) -> list[Request]:
        """Drain queue and slots; returns the completed requests in the
        order they finished."""
        finished: list[Request] = []
        seen: set[int] = set()
        all_reqs = list(self.queue)
        while self.queue or any(r is not None for r in self.active):
            self.step()
            for r in all_reqs:
                if r.done and r.uid not in seen:
                    seen.add(r.uid)
                    finished.append(r)
        return finished


def generate(params: dict, cfg: T.LMConfig, prompts: np.ndarray,
             max_new: int = 16, cache_buf: int = 0) -> np.ndarray:
    """Batched greedy generation without continuous batching: prompts
    [B, P] right-padded with -1; returns int32 [B, max_new]."""
    dev = params["embed"].device
    b, p = prompts.shape
    lengths = np.asarray((prompts >= 0).sum(axis=1), np.int32)
    toks = np.where(prompts >= 0, prompts, 0).astype(np.int32)
    cache = T.init_cache(cfg, b, cache_buf or (p + max_new), device=dev)
    lens = torch.from_numpy(lengths).to(dev)
    logits, cache = _prefill(params, torch.from_numpy(toks).to(dev), cache,
                             lens, cfg)
    _void_padding(cache, lengths)
    last = greedy(logits[torch.arange(b, device=dev), lens.long() - 1])
    out = [last.cpu().numpy()]
    positions = lens.clone()
    for _ in range(max_new - 1):
        logits1, cache = _decode(params, last, cache, positions, cfg)
        last = greedy(logits1)
        out.append(last.cpu().numpy())
        positions += 1
    return np.stack(out, axis=1)
