"""Continuous-batching inference engine over the paged KV cache.

Port of ``ray_tpu/serve/engine/engine.py`` (vLLM LLMEngine/Scheduler
analog).  The loop schedules per iteration: a new request joins the live
batch at the next step boundary and a finished one frees its slot and pages
at once, so one replica decodes up to ``max_batch`` sequences per forward,
each at its own position, with tokens streamed to callers through
per-sequence asyncio queues.

Admission reserves the worst case ``ceil((prompt + max_new) / page)``
pages up front (see kv_cache.py), so a sequence admitted is a sequence
that finishes.  Prefill runs one sequence per call (B=1, padded to
``max_prompt_len``); decode runs the whole batch (``[max_batch]``) with
inactive slots parked on scratch page 0.  Device work runs on a
single-thread executor, so the event loop keeps serving admissions and
cancellations while the card computes, and the one lane keeps the pool
updates (made in place) ordered.

The model is GPT or LLaMA (``EngineConfig.model``); both prefill dense and
decode against the paged pools.  Not ported yet: the chaos hook of the
reference's decode loop and ``LLMServer`` (both need the serve runtime).
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import logging
import time
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt import (GPTConfig, gpt_decode_step, gpt_init,
                                      gpt_prefill, init_paged_cache)
from ray_tpu_torch.models.llama import (LlamaConfig, llama_decode_step,
                                        llama_init, llama_init_paged_cache,
                                        llama_prefill)
from ray_tpu_torch.serve.engine.kv_cache import PageAllocator, table_row

logger = logging.getLogger(__name__)

_DONE = object()

# model name -> (config class, init, prefill, decode step, paged cache)
_MODELS = {
    "gpt": (GPTConfig, gpt_init, gpt_prefill, gpt_decode_step,
            init_paged_cache),
    "llama": (LlamaConfig, llama_init, llama_prefill, llama_decode_step,
              llama_init_paged_cache),
}


class DeadlineExceeded(TimeoutError):
    """A request's end-to-end deadline passed before it finished."""


@dataclasses.dataclass
class EngineConfig:
    model: str = "gpt"                 # "gpt" | "llama"
    model_config: Any = None           # GPTConfig/LlamaConfig; tiny default
    page_size: int = 8
    num_pages: int = 128               # pool size; page 0 is scratch
    max_batch: int = 8                 # decode slots per step
    max_prompt_len: int = 64           # multiple of page_size
    max_new_tokens: int = 32           # per-request cap
    eos_token: Optional[int] = None
    dtype: Any = None                  # KV pool dtype (default: model's)
    device: DeviceLike = None          # None: the first CUDA card


class _Sequence:
    __slots__ = ("prompt", "max_new", "pages", "row", "queue", "generated",
                 "pos", "last_token", "cancelled", "slot", "prefilled",
                 "deadline")

    def __init__(self, prompt: List[int], max_new: int,
                 deadline: Optional[float] = None):
        self.prompt = prompt
        self.max_new = max_new
        self.deadline = deadline       # absolute epoch seconds, or None
        self.pages: List[int] = []
        self.row: Optional[np.ndarray] = None
        self.queue: asyncio.Queue = asyncio.Queue()
        self.generated = 0
        self.pos = len(prompt)         # next KV write position
        self.last_token: Optional[int] = None
        self.cancelled = False
        self.slot: Optional[int] = None
        self.prefilled = False


class InferenceEngine:
    """Paged continuous-batching engine; see module docstring."""

    def __init__(self, config: EngineConfig, params: Any = None,
                 rng_seed: int = 0):
        cfg = config
        if cfg.max_prompt_len % cfg.page_size:
            raise ValueError("max_prompt_len must be a multiple of "
                             f"page_size ({cfg.page_size})")
        if cfg.model not in _MODELS:
            raise ValueError(f"unknown engine model '{cfg.model}'")
        config_cls, init_fn, self._prefill_fn, self._decode_fn, cache_fn = \
            _MODELS[cfg.model]
        mc = cfg.model_config or config_cls.tiny(
            seq=cfg.max_prompt_len + cfg.max_new_tokens)
        if not isinstance(mc, config_cls):
            raise TypeError(f"model '{cfg.model}' takes a "
                            f"{config_cls.__name__}, got "
                            f"{type(mc).__name__}")
        if mc.max_seq_len < cfg.max_prompt_len + cfg.max_new_tokens:
            raise ValueError(
                f"model max_seq_len {mc.max_seq_len} < max_prompt_len + "
                f"max_new_tokens ({cfg.max_prompt_len + cfg.max_new_tokens})")

        self.config = cfg
        self.model_config = mc
        self.device = resolve_device(cfg.device)
        self._params = params if params is not None else \
            init_fn(rng_seed, mc, self.device)
        self._k_pages, self._v_pages = cache_fn(
            mc, cfg.num_pages, cfg.page_size, cfg.dtype, self.device)
        self._alloc = PageAllocator(cfg.num_pages)
        self._maxp = -(-(cfg.max_prompt_len + cfg.max_new_tokens)
                       // cfg.page_size)

        self._waiting: collections.deque = collections.deque()
        self._active: Dict[int, _Sequence] = {}   # slot -> sequence
        self._free_slots: List[int] = list(range(cfg.max_batch - 1, -1, -1))
        self._wake = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        self._steps = 0
        # Single lane for device work: the card serializes anyway, and one
        # lane keeps the in-place pool updates ordered.
        self._exec = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="rt-engine")

    # ------------------------------------------------------------- public

    async def generate(self, tokens: Sequence[int],
                       max_new_tokens: Optional[int] = None,
                       deadline: Optional[float] = None
                       ) -> AsyncIterator[int]:
        """Admit one sequence; yields generated token ids as they decode.
        Closing the iterator early (client disconnect) cancels the
        sequence and frees its pages at the next step boundary.  An
        absolute ``deadline`` (epoch seconds) bounds the whole request:
        expiry raises DeadlineExceeded to the consumer AND retires the
        sequence inside the batch loop."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("empty prompt")
        if len(tokens) > self.config.max_prompt_len:
            raise ValueError(f"prompt length {len(tokens)} exceeds "
                             f"max_prompt_len {self.config.max_prompt_len}")
        max_new = min(max_new_tokens or self.config.max_new_tokens,
                      self.config.max_new_tokens)
        self._ensure_loop()
        seq = _Sequence(tokens, max_new, deadline)
        self._waiting.append(seq)
        self._wake.set()
        try:
            while True:
                if seq.deadline is None:
                    item = await seq.queue.get()
                else:
                    rem = seq.deadline - time.time()
                    if rem <= 0:
                        raise DeadlineExceeded(
                            "deadline expired while decoding")
                    try:
                        item = await asyncio.wait_for(seq.queue.get(), rem)
                    except asyncio.TimeoutError:
                        raise DeadlineExceeded(
                            "deadline expired while decoding") from None
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            seq.cancelled = True
            self._wake.set()

    def stats(self) -> Dict[str, int]:
        return {"active": len(self._active), "waiting": len(self._waiting),
                "free_pages": self._alloc.free_pages, "steps": self._steps}

    def close(self):
        if self._loop_task is not None:
            self._loop_task.cancel()
            self._loop_task = None
        self._exec.shutdown(wait=False)

    # ----------------------------------------------------------- internals

    def _ensure_loop(self):
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(
                self._run_loop())

    def _pages_needed(self, seq: _Sequence) -> int:
        return -(-(len(seq.prompt) + seq.max_new) // self.config.page_size)

    @staticmethod
    def _deadline_expired(seq: _Sequence) -> bool:
        return seq.deadline is not None and time.time() > seq.deadline

    def _admit(self):
        while self._waiting and self._free_slots:
            seq = self._waiting[0]
            if seq.cancelled:
                self._waiting.popleft()
                continue
            if self._deadline_expired(seq):
                # Expired while queued: reject instead of spending pages
                # and decode steps on a request nobody is waiting for.
                self._waiting.popleft()
                seq.queue.put_nowait(DeadlineExceeded(
                    "deadline expired while waiting for admission"))
                continue
            need = self._pages_needed(seq)
            if not self._alloc.can_alloc(need):
                if not self._active:
                    # Nothing will ever free up: the request exceeds the
                    # whole pool.  Fail it instead of parking forever.
                    self._waiting.popleft()
                    seq.queue.put_nowait(MemoryError(
                        f"request needs {need} KV pages, pool has "
                        f"{self._alloc.free_pages} free and 0 active"))
                    continue
                break   # head-of-line waits for a retire
            self._waiting.popleft()
            seq.pages = self._alloc.alloc(need)
            seq.row = table_row(seq.pages, self._maxp)
            seq.slot = self._free_slots.pop()
            self._active[seq.slot] = seq

    def _retire(self, seq: _Sequence, done: bool = True):
        self._active.pop(seq.slot, None)
        self._free_slots.append(seq.slot)
        seq.slot = None
        if seq.pages:
            self._alloc.free(seq.pages)
            seq.pages = []
        if done and not seq.cancelled:
            seq.queue.put_nowait(_DONE)

    def _push(self, seq: _Sequence, token: int) -> bool:
        """Deliver one token; returns True when the sequence is finished
        (EOS or max_new reached)."""
        seq.generated += 1
        seq.last_token = token
        if not seq.cancelled:
            seq.queue.put_nowait(token)
        eos = self.config.eos_token
        return seq.generated >= seq.max_new or \
            (eos is not None and token == eos)

    def _prefill(self, seq: _Sequence) -> int:
        """Executor side: prefill one sequence, return its first token."""
        toks = np.zeros((1, self.config.max_prompt_len), np.int64)
        toks[0, : len(seq.prompt)] = seq.prompt
        dev = self.device
        logits, self._k_pages, self._v_pages = self._prefill_fn(
            self._params, self.model_config, torch.from_numpy(toks).to(dev),
            len(seq.prompt), self._k_pages, self._v_pages,
            torch.from_numpy(seq.row[None]).to(dev))
        return int(torch.argmax(logits[0]))

    def _decode(self, token: np.ndarray, pos: np.ndarray,
                tables: np.ndarray) -> np.ndarray:
        """Executor side: one batched decode step, next token per slot."""
        dev = self.device
        logits, self._k_pages, self._v_pages = self._decode_fn(
            self._params, self.model_config, torch.from_numpy(token).to(dev),
            torch.from_numpy(pos).to(dev), self._k_pages, self._v_pages,
            torch.from_numpy(tables).to(dev))
        return torch.argmax(logits, dim=-1).cpu().numpy()

    async def _run_loop(self):
        loop = asyncio.get_running_loop()
        cfg = self.config
        while True:
            try:
                for seq in [s for s in self._active.values() if s.cancelled]:
                    self._retire(seq, done=False)
                # Deadline sweep: an expired sequence stops decoding now;
                # its slot and pages free for live requests.
                for seq in [s for s in self._active.values()
                            if self._deadline_expired(s)]:
                    self._retire(seq, done=False)
                    if not seq.cancelled:
                        seq.queue.put_nowait(DeadlineExceeded(
                            "deadline expired while decoding"))
                self._admit()
                if not self._active:
                    if self._waiting:
                        continue   # admission makes progress every pass
                    self._wake.clear()
                    # Re-check: generate() may have appended between the
                    # test above and the clear.
                    if not self._waiting:
                        await self._wake.wait()
                    continue

                # Prefill new admissions one at a time (B=1, one shape).
                for seq in [s for s in self._active.values()
                            if not s.prefilled]:
                    tok = await loop.run_in_executor(self._exec,
                                                     self._prefill, seq)
                    seq.prefilled = True
                    if self._push(seq, tok) or seq.cancelled:
                        self._retire(seq, done=not seq.cancelled)

                if not self._active:
                    continue
                # One batched decode step over every live slot.  Inactive
                # slots run token 0 at pos 0 against an all-zero table
                # row: their writes land in scratch page 0.
                token = np.zeros((cfg.max_batch,), np.int64)
                pos = np.zeros((cfg.max_batch,), np.int64)
                tables = np.zeros((cfg.max_batch, self._maxp), np.int64)
                for slot, seq in self._active.items():
                    token[slot] = seq.last_token
                    pos[slot] = seq.pos
                    tables[slot] = seq.row
                nxt = await loop.run_in_executor(self._exec, self._decode,
                                                 token, pos, tables)
                self._steps += 1
                for slot, seq in list(self._active.items()):
                    seq.pos += 1
                    if self._push(seq, int(nxt[slot])) or seq.cancelled:
                        self._retire(seq, done=not seq.cancelled)
            except asyncio.CancelledError:
                raise
            except Exception as e:   # noqa: BLE001 - the loop must survive
                logger.exception("inference engine step failed")
                for seq in list(self._active.values()):
                    self._retire(seq, done=False)
                    seq.queue.put_nowait(e)
                while self._waiting:
                    self._waiting.popleft().queue.put_nowait(e)
