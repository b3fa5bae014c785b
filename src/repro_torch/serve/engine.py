"""Serving: batched prefill, single-token decode steps, greedy decoding and
the continuous and disaggregated batchers.

``ContinuousBatcher`` decodes a fixed pool of cache slots in lock-step;
between steps, finished requests free their slot and queued requests are
prefilled into free slots (per-row positions, so every slot advances
independently).  ``DisaggregatedBatcher`` splits that further: a prefill
front-end turns pending requests into handoff packets (prefilled cache row
+ first token) and the decode loop only splices ready rows.  Greedy tokens
equal what ``greedy_decode`` produces for each request alone, as long as
every op of a decode step gives a row the same bits whatever the batch
around it: the port's own ops do by construction (the norms' kernel sums
a row in a fixed order, Mamba2's C . state is ``c_dot_state``, the decode
kernels' splits follow the cache, not the batch); the matrix products do
on the CPU in bfloat16, and cuBLAS did at every shape ``chip_smoke.py``
serves, without promising it.

Everything here runs under ``torch.inference_mode()`` on the device of the
parameters.  Decode steps write the caches in place.

A VLM config (``num_modal_tokens`` > 0) serves its prompts after a prefix
of zero modal embeddings (``prompt_batch``), as the JAX engine does, so
its first decode position is the prompt length plus the prefix.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import (cache_from_prefill, decode_step, forward,
                                init_cache)


def prompt_batch(cfg: ModelConfig, params: Any, prompt: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """The prefill batch of a (b, s) prompt: its tokens and, for a VLM
    config, zero modal embeddings (b, num_modal_tokens, d) in the
    embeddings' dtype (engine.py:51-58 and launch/serve.py:38-41 of the JAX
    package, which feed zeros where a vision tower would)."""
    batch = {"tokens": prompt}
    if cfg.num_modal_tokens:
        embed = params["embed"]
        batch["modal_embeds"] = torch.zeros(
            (prompt.shape[0], cfg.num_modal_tokens, cfg.d_model),
            dtype=embed.dtype, device=embed.device)
    return batch


@torch.inference_mode()
def prefill(cfg: ModelConfig, params: Any, batch: Dict[str, torch.Tensor],
            cache_len: int) -> Tuple[torch.Tensor, Any]:
    """Run the full prompt; return (last-token logits (b, 1, V),
    decode-ready cache)."""
    logits, caches = forward(cfg, params, batch, want_cache=True,
                             last_only=True)
    return logits, cache_from_prefill(cfg, caches, cache_len)


@torch.inference_mode()
def serve_step(cfg: ModelConfig, params: Any, tokens: torch.Tensor,
               cache: Any, pos) -> Tuple[torch.Tensor, Any]:
    """One decode step: tokens (b, 1) -> (logits (b, 1, V), cache)."""
    return decode_step(cfg, params, tokens, cache, pos)


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    """(b, 1, V) -> (b, 1) greedy tokens (first maximum on ties)."""
    return torch.argmax(logits[:, -1, :], dim=-1, keepdim=True)


@torch.inference_mode()
def greedy_decode(cfg: ModelConfig, params: Any, prompt: torch.Tensor,
                  n_steps: int, cache_len: int) -> torch.Tensor:
    """Batch-at-once autoregressive loop: prompt (b, s) -> tokens
    (b, n_steps)."""
    logits, cache = prefill(cfg, params, prompt_batch(cfg, params, prompt),
                            cache_len)
    tok = _argmax(logits)
    toks = [tok]
    pos = prompt.shape[1] + cfg.num_modal_tokens
    for i in range(n_steps - 1):
        logits, cache = serve_step(cfg, params, tok, cache, pos + i)
        tok = _argmax(logits)
        toks.append(tok)
    return torch.cat(toks, dim=1)


# ----------------------------------------------------- continuous batching --

@dataclass
class ServeRequest:
    """One decode request: a prompt and a token budget."""
    request_id: int
    prompt: torch.Tensor                    # (prompt_len,) integer
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)   # generated so far

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens


class ContinuousBatcher:
    """Slot-based continuous batching over one model replica.

    ``slots`` caches decode together; between steps, finished requests
    release their slot and pending requests are admitted into free slots
    (prefill, then the new row is copied into the slot's cache row).  All
    rows step with their own absolute position, so admissions never stall
    the running batch -- idle-slot rows compute garbage that is masked out
    and overwritten at the next admission.  The caches live on the device
    and in the dtype of the parameters.
    """

    @torch.inference_mode()
    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int,
                 cache_len: int):
        self.cfg, self.params = cfg, params
        self.slots, self.cache_len = slots, cache_len
        embed = params["embed"]
        self.device = embed.device
        self.cache = init_cache(cfg, slots, cache_len, dtype=embed.dtype,
                                device=self.device)
        self.tokens = torch.zeros((slots, 1), dtype=torch.long,
                                  device=self.device)
        self.pos = np.zeros((slots,), np.int64)       # next absolute position
        self.active: List[Optional[ServeRequest]] = [None] * slots
        self.pending: Deque[ServeRequest] = deque()
        self.finished: Dict[int, ServeRequest] = {}
        self.decode_steps = 0
        self.prefills = 0

    # ------------------------------------------------------------ intake --
    def submit(self, request: ServeRequest) -> None:
        if request.prompt.ndim != 1:
            raise ValueError("prompt must be a 1-D token vector")
        if (request.prompt.shape[0] + self.cfg.num_modal_tokens
                + request.max_new_tokens) > self.cache_len:
            # reject up front: an oversized prompt must never reach a slot
            # (a partial splice would corrupt the row for later tenants)
            raise ValueError(
                f"request {request.request_id} cannot fit the cache:"
                f" {request.prompt.shape[0]} prompt"
                f" + {self.cfg.num_modal_tokens} modal"
                f" + {request.max_new_tokens} new > {self.cache_len}")
        self.pending.append(request)

    def _prefill_one(self, req: ServeRequest) -> Tuple[int, Any]:
        """Run one request's prompt; returns (first token, cache row)."""
        batch = prompt_batch(self.cfg, self.params,
                             req.prompt[None].to(self.device))
        logits, row_cache = prefill(self.cfg, self.params, batch,
                                    self.cache_len)
        self.prefills += 1
        return int(_argmax(logits)[0, 0]), row_cache

    def _splice(self, slot: int, req: ServeRequest, tok: int,
                row_cache: Any) -> None:
        """Copy a prefilled cache row + first token into ``slot`` (axis 1 is
        the batch axis of every (nb, b, ...) cache leaf; a Mamba2 row's conv
        window and float32 state are copied whole, into leaves of their own
        dtypes, so the copy is exact)."""
        for j_name, sub in row_cache.items():
            for name, row in sub.items():
                self.cache[j_name][name][:, slot] = row[:, 0]
        self.tokens[slot, 0] = tok
        self.pos[slot] = req.prompt.shape[0] + self.cfg.num_modal_tokens
        self.active[slot] = req

    def _admit(self) -> None:
        """Fill free slots from the pending queue (between decode steps)."""
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.pending:
                continue
            req = self.pending.popleft()
            tok, row_cache = self._prefill_one(req)
            req.tokens.append(tok)
            if req.done:                     # budget of one: no decode steps
                self.finished[req.request_id] = req
                continue
            self._splice(slot, req, tok, row_cache)

    # ------------------------------------------------------------- drive --
    def _backlog(self) -> bool:
        """Anything still waiting upstream of the decode slots?"""
        return bool(self.pending)

    @torch.inference_mode()
    def step(self) -> bool:
        """Admit, then run one lock-step decode over all slots.  Returns
        False once no request is active or pending."""
        self._admit()
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return self._backlog()
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, self.cache = decode_step(self.cfg, self.params, self.tokens,
                                         self.cache, pos)
        self.decode_steps += 1
        # one batched feed-back: idle-slot rows carry garbage regardless
        # (masked out and overwritten at admission), so no scatter needed
        self.tokens = _argmax(logits)
        harvested = self.tokens[:, 0].cpu().numpy()
        for slot in live:
            req = self.active[slot]
            req.tokens.append(int(harvested[slot]))
            self.pos[slot] += 1
            if req.done:                    # slot frees for the next admit
                self.finished[req.request_id] = req
                self.active[slot] = None
        return True

    def run(self) -> Dict[int, List[int]]:
        """Drain every submitted request; returns {request_id: tokens}."""
        while self.step():
            pass
        return {rid: req.tokens for rid, req in sorted(self.finished.items())}


# -------------------------------------------------- disaggregated serving --

class DisaggregatedBatcher(ContinuousBatcher):
    """Prefill/decode-disaggregated continuous batching.

    A prefill front-end drains the pending queue into ``ready`` handoff
    packets (prefilled cache row + first token), and the decode loop only
    splices ready rows into free slots; it never runs a prompt forward.
    Here the front-end is driven from ``step`` for determinism.  Token
    outputs equal ``ContinuousBatcher``'s: prefill math does not depend on
    when it runs, and per-row positions make results independent of slot
    assignment.
    """

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int,
                 cache_len: int):
        super().__init__(cfg, params, slots=slots, cache_len=cache_len)
        #: handoff packets: (request, first token, prefilled cache row)
        self.ready: Deque[Tuple[ServeRequest, int, Any]] = deque()
        self.handoffs = 0                    # rows transferred to decode

    def prefill_step(self) -> bool:
        """Front-end: prefill one pending request into a handoff packet.
        Returns False when the pending queue is empty."""
        if not self.pending:
            return False
        req = self.pending.popleft()
        tok, row_cache = self._prefill_one(req)
        req.tokens.append(tok)
        if req.done:                         # budget of one: no decode steps
            self.finished[req.request_id] = req
            return True
        self.ready.append((req, tok, row_cache))
        return True

    def _admit(self) -> None:
        """Decode-side admission: splice *ready* rows only."""
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.ready:
                continue
            req, tok, row_cache = self.ready.popleft()
            self._splice(slot, req, tok, row_cache)
            self.handoffs += 1

    def _backlog(self) -> bool:
        return bool(self.pending or self.ready)

    def step(self) -> bool:
        """Drive the front-end just far enough to cover the free slots,
        then run one decode step over the ready-spliced batch."""
        free = self.active.count(None)
        while len(self.ready) < free and self.pending:
            self.prefill_step()
        return super().step()
