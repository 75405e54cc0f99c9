"""Continuous-batching inference engine on PyTorch.

An asyncio front (request queue, per-request token streams) bridged to a
**dispatch thread** that owns every device call, so prefill and decode never
stall the caller's event loop; tokens hop back with one
``call_soon_threadsafe`` per step.

- Admission (``_admit_batch``): priority, then FIFO; requests that share a
  prefill bucket and a prefix-cache posture (hit or cold) prefill together,
  up to ``prefill_max_batch`` rows padded to the bucket, in one call. A hit
  row prefills only its suffix, through the paged chunk kernel; the first
  token is sampled on the device.
- Chunked prefill (``_chunk_round``): a prompt longer than every bucket
  (but within ``max_seq_len - 1``) is admitted to ``_chunking`` and
  prefills one bucket-sized chunk per loop iteration through the history
  path, each chunk attending over the pages the earlier ones wrote. Rows
  carry absolute positions, so long prompts at different offsets share
  one round of up to ``prefill_max_batch`` rows. Decode never touches a
  chunking slot.
- Decode is serial: one step per dispatch over the active slots, retired
  before the next dispatch. The JAX engine's overlapped pipeline and
  super-steps are defined to give the same greedy streams as this.
- There are no context-width buckets (the JAX engine's ``_ctx_bucket_for``
  and ``_hist_ctx_for``, which bounded XLA's static gather): the attention
  kernels walk only the pages each row uses.

The engine runs on ``config.device`` ("cuda" by default) and raises at
construction when that device is absent; it never moves to the CPU by
itself. ``quant="int8"`` serves int8 weights; ``kv_quant="int8"`` stores
the KV pool as int8 pages with per-page scales (``num_pages`` is then a
byte budget counted in compute-dtype pages, which holds about twice as
many int8 pages: ``num_kv_pages``). MoE models (Mixtral) pick their FFN
formulation with ``moe_impl`` and ``moe_block``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

import numpy as np
import torch

from ..utils import new_id
from .kv import PageAllocator, init_kv_state, kv_page_bytes, num_pages_for_budget
from .models import MODEL_CONFIGS, LlamaConfig
from .models.llama import decode_step, init_params, prefill, prefill_with_history
from .sampling import SamplingParams, sample_tokens
from .tokenizer import load_tokenizer

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class EngineConfig:
    model: str = "llama3-tiny"
    max_batch: int = 8              # decode slots
    max_seq_len: int = 2048
    page_size: int = 128
    num_pages: int = 512
    prefill_buckets: tuple[int, ...] = (128, 512, 2048)
    prefill_max_batch: int = 4      # admissions fused into one prefill call
    dtype: str = "bfloat16"
    max_queue: int = 1024
    # prefix cache: reuse resident KV pages for shared full-page prompt
    # prefixes; only each request's suffix pays prefill
    prefix_cache: bool = True
    device: str = "cuda"
    seed: int = 0                   # random weights and the sampler
    # weight-only quantization: "" (full precision) or "int8" (quantize.py;
    # random weights quantize as they are drawn, one expert at a time)
    quant: str = ""
    # MoE FFN formulation (models/configs.py moe_impl): dense | grouped |
    # grouped_pallas; moe_block overrides the kernel row-block AND the
    # T*k >= E*block gate. "" / 0 keep the model config's.
    moe_impl: str = ""
    moe_block: int = 0
    # KV pool storage: "" (the compute dtype) or "int8" (int8 pages with
    # per-(layer, page, kv-head) scales); under int8, num_pages is a byte
    # budget in compute-dtype pages
    kv_quant: str = ""


@dataclass
class GenRequest:
    request_id: str
    prompt_ids: list[int]
    max_tokens: int = 128
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_ids: tuple[int, ...] = ()
    # admission class: 0 = interactive, 1 = background; lower admits first
    priority: int = 0
    # unbounded: a bounded queue could drop the end-of-stream sentinel
    stream: asyncio.Queue = field(default_factory=asyncio.Queue)
    created: float = field(default_factory=time.time)
    # filled by the engine
    slot: int = -1
    generated: list[int] = field(default_factory=list)
    finish_reason: str | None = None
    first_token_ts: float = 0.0
    # prefix-cache admission state: probed cached-history length and the
    # (suffix) bucket; bucket -1 means not yet probed. ``chunked``: the
    # prompt (or its suffix after ``hist``) exceeds every bucket and
    # prefills in chunk rounds; ``chunk_pos`` counts the tokens prefilled
    chunked: bool = False
    chunk_pos: int = 0
    hist: int = 0
    bucket: int = -1


class EngineStats:
    def __init__(self) -> None:
        self.requests = 0
        self.prompt_tokens = 0
        self.completion_tokens = 0
        self.decode_steps = 0
        self.prefill_batches = 0
        self.prefill_requests = 0
        self.queue_depth = 0
        self.chunking = 0             # long prompts mid-chunk-prefill
        self.prefill_ms_total = 0.0   # host wall of prefill dispatches (synced)
        self.decode_ms_total = 0.0    # host wall of decode dispatches (synced)


def _resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("EngineConfig.device is 'cuda' but CUDA is not "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch path explicitly")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class TorchEngine:
    """Owns params + the KV pool on one device; device work runs on the
    dispatch thread, token emission hops back to the asyncio loop.

    ``params``: a parameter tree to serve as given, full precision or
    already quantized (e.g. from ``models.convert.params_from_jax``);
    seeded random weights otherwise, quantized when ``config.quant``."""

    def __init__(self, config: EngineConfig,
                 params: dict[str, Any] | None = None):
        self.config = config
        self.device = _resolve_device(config.device)
        if config.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {config.dtype!r}")
        self.dtype = _DTYPES[config.dtype]
        if config.quant not in ("", "int8"):
            raise ValueError(f"unsupported quant mode {config.quant!r}")
        if config.kv_quant not in ("", "int8"):
            raise ValueError(f"unsupported kv_quant mode {config.kv_quant!r}")
        if config.moe_impl not in ("", "dense", "grouped", "grouped_pallas"):
            # a typo must not silently serve the dense path
            raise ValueError(
                f"moe_impl must be dense|grouped|grouped_pallas, "
                f"got {config.moe_impl!r}")
        self.model_config: LlamaConfig = MODEL_CONFIGS[config.model]
        overrides: dict[str, Any] = {}
        if config.moe_impl:
            overrides["moe_impl"] = config.moe_impl
        if config.moe_block:
            overrides["moe_block"] = config.moe_block
        if overrides:
            self.model_config = dataclasses.replace(self.model_config,
                                                    **overrides)
        self.tokenizer = load_tokenizer(vocab_size=self.model_config.vocab_size)
        self.stats = EngineStats()
        if params is None:
            init_gen = torch.Generator(device=self.device)
            init_gen.manual_seed(config.seed)
            params = init_params(self.model_config, init_gen, self.dtype,
                                 self.device, quant=config.quant)
        self.params = params
        max_pages_per_slot = config.max_seq_len // config.page_size
        self.num_kv_pages = config.num_pages
        if config.kv_quant:
            budget = config.num_pages * kv_page_bytes(
                self.model_config, config.page_size, self.dtype)
            self.num_kv_pages = num_pages_for_budget(
                self.model_config, config.page_size, budget, self.dtype,
                config.kv_quant)
        self.kv = init_kv_state(self.model_config, self.num_kv_pages,
                                config.page_size, config.max_batch,
                                max_pages_per_slot, dtype=self.dtype,
                                device=self.device, quant=config.kv_quant)
        self.allocator = PageAllocator(self.num_kv_pages, config.page_size,
                                       config.max_batch, max_pages_per_slot)
        self._sample_gen = torch.Generator(device=self.device)
        self._sample_gen.manual_seed(config.seed + 1)
        self._work: queue.Queue[GenRequest] = queue.Queue(maxsize=config.max_queue)
        self._pending: deque[GenRequest] = deque()   # dispatch thread only
        self._running: dict[int, GenRequest] = {}    # slot -> request
        self._chunking: dict[int, GenRequest] = {}   # slot -> mid-chunk-prefill
        self._emit_buf: list[list[Any]] = []
        self._cancels: set[str] = set()
        self._cancel_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop_event = threading.Event()
        self._wake = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = False

    # ------------------------------------------------------------- lifecycle

    async def start(self) -> None:
        if self._started:
            return
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("previous dispatch thread still running")
        self._started = True
        self._loop = asyncio.get_running_loop()
        self._stop_event = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._device_loop,
                                        name="torch-engine-dispatch",
                                        daemon=True)
        self._thread.start()

    async def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        self._stop_event.set()
        self._wake.set()
        thread = self._thread
        if thread is not None:
            await asyncio.to_thread(thread.join, 30.0)
            if thread.is_alive():
                logger.error("dispatch thread failed to stop within 30s")
                return  # keep self._thread so start() refuses a double start
        self._thread = None

    def request_cancel(self, request_id: str) -> bool:
        """Thread-safe: ask the dispatch thread to end a generation; its
        stream then terminates with ``finish_reason="cancelled"``. Returns
        False when no pending or running request has that id."""
        for _ in range(8):
            try:
                known = any(r.request_id == request_id
                            for bucket in (list(self._pending),
                                           list(self._running.values()),
                                           list(self._chunking.values()))
                            for r in bucket)
                break
            except RuntimeError:  # a table changed mid-snapshot: retry
                continue
        else:
            known = True
        if not known:
            return False
        with self._cancel_lock:
            self._cancels.add(request_id)
        self._wake.set()
        return True

    # ------------------------------------------------------------- submission

    async def submit(self, request: GenRequest) -> GenRequest:
        if self._started and (self._thread is None
                              or not self._thread.is_alive()):
            raise RuntimeError("engine dispatch thread is not running")
        self.stats.requests += 1
        self.stats.prompt_tokens += len(request.prompt_ids)
        while True:
            try:
                self._work.put_nowait(request)
                self._wake.set()
                break
            except queue.Full:  # backpressure without blocking the loop
                await asyncio.sleep(0.005)
        self.stats.queue_depth = self._work.qsize() + len(self._pending)
        return request

    async def generate(self, prompt_ids: list[int],
                       **kwargs) -> AsyncIterator[int]:
        """Submit and yield token ids as they decode."""
        request = GenRequest(request_id=new_id(), prompt_ids=prompt_ids,
                             **kwargs)
        await self.submit(request)
        while True:
            token = await request.stream.get()
            if token is None:
                break
            yield token

    # --------------------------------------------------------- dispatch thread

    def _device_loop(self) -> None:
        """Owns every device call. Each iteration: take new work, apply
        cancels, admit one prefill group when a slot is free, advance every
        chunking prompt by one chunk round, run one decode step over the
        running slots, then flush the emitted tokens."""
        try:
            with torch.inference_mode():
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                while not self._stop_event.is_set():
                    self._drain_work()
                    did_work = False
                    if self._cancels:
                        self._apply_cancels()
                        did_work = True
                    occupied = len(self._running) + len(self._chunking)
                    if self._pending and occupied < self.config.max_batch:
                        did_work = self._admit_batch() or did_work
                    if self._chunking:
                        self._chunk_round()
                        did_work = True
                    if self._running:
                        self._decode_step()
                        did_work = True
                    self.stats.queue_depth = (self._work.qsize()
                                              + len(self._pending))
                    self.stats.chunking = len(self._chunking)
                    self._flush_emits()
                    if not did_work:
                        self._wait_for_work()
        except Exception:
            logger.exception("torch engine dispatch thread crashed")
            self._fail_outstanding("error")
        else:
            self._fail_outstanding("cancelled")
        finally:
            self._flush_emits()

    def _wait_for_work(self) -> None:
        self._wake.clear()
        if self._work.qsize() or self._stop_event.is_set():
            return
        self._wake.wait(0.05)

    def _drain_work(self) -> None:
        while True:
            try:
                self._pending.append(self._work.get_nowait())
            except queue.Empty:
                return

    def _fail_outstanding(self, reason: str) -> None:
        self._drain_work()
        for request in list(self._running.values()):
            if request.finish_reason is None:
                request.finish_reason = reason
            self._finish(request)
        for request in list(self._chunking.values()):
            if request.finish_reason is None:
                request.finish_reason = reason
            self._finish(request)
        while self._pending:
            request = self._pending.popleft()
            if request.finish_reason is None:
                request.finish_reason = reason
            self._post_tokens(request, [], done=True)

    def _apply_cancels(self) -> None:
        with self._cancel_lock:
            ids, self._cancels = self._cancels, set()
        for request in [*self._running.values(), *self._chunking.values()]:
            if request.request_id in ids and request.finish_reason is None:
                request.finish_reason = "cancelled"
                self._finish(request)
        kept: deque[GenRequest] = deque()
        for request in self._pending:
            if request.request_id in ids and request.finish_reason is None:
                request.finish_reason = "cancelled"
                self._post_tokens(request, [], done=True)
            else:
                kept.append(request)
        self._pending = kept

    # -------------------------------------------------------------- admission

    def _bucket_for(self, length: int) -> int | None:
        for bucket in sorted(self.config.prefill_buckets):
            if length <= bucket:
                return bucket
        return None

    def _assign_bucket(self, request: GenRequest) -> int:
        """Request's prefill bucket (0 = cannot be served). A prefix-cache
        hit buckets by SUFFIX length, and only when that lands a strictly
        smaller bucket than a dense prefill of the whole prompt (the history
        path costs more per padded token). A prompt (or a hit's suffix)
        longer than every bucket is ``chunked``, from its cached history
        on, and takes the largest bucket. The probe takes no page
        references; the real match happens at admission."""
        if request.bucket != -1:
            return request.bucket
        config = self.config
        ids = request.prompt_ids
        request.hist = 0
        request.chunked = False
        if len(ids) + 1 > config.max_seq_len:
            # the prompt plus >= 1 generated token must fit the block table
            request.bucket = 0
            return 0
        dense_bucket = self._bucket_for(len(ids))
        if config.prefix_cache:
            hist = self.allocator.probe_prefix(ids)
            bucket = self._bucket_for(len(ids) - hist) if hist else None
            if hist and (bucket is None or dense_bucket is None
                         or bucket < dense_bucket):
                request.hist = hist
                request.chunked = bucket is None
                request.bucket = bucket or max(config.prefill_buckets)
                return request.bucket
        request.chunked = dense_bucket is None
        request.bucket = dense_bucket or max(config.prefill_buckets)
        return request.bucket

    def _admit_batch(self) -> bool:
        """Admit up to prefill_max_batch requests in ONE prefill call: the
        head's bucket and hit posture, or (a chunked head) other chunked
        requests, which then prefill in ``_chunk_round``. At most
        prefill_max_batch prompts chunk at once: a chunked request beyond
        that steps aside so the requests behind it can still admit."""
        config = self.config
        if len({r.priority for r in self._pending}) > 1:
            # stable sort: FIFO holds within each priority class
            self._pending = deque(sorted(self._pending,
                                         key=lambda r: r.priority))
        free_slots = [s for s in range(config.max_batch)
                      if s not in self._running and s not in self._chunking]
        deferred: list[GenRequest] = []
        head: GenRequest | None = None
        while self._pending:
            candidate = self._pending[0]
            if self._assign_bucket(candidate) == 0:
                self._pending.popleft()
                candidate.finish_reason = "length"
                self._post_tokens(candidate, [], done=True)
                continue
            if (candidate.chunked
                    and len(self._chunking) >= config.prefill_max_batch):
                deferred.append(self._pending.popleft())
                continue
            head = candidate
            break
        if head is None or not free_slots:
            self._pending.extendleft(reversed(deferred))
            return False
        bucket = head.bucket
        with_hist = head.hist > 0
        group: list[GenRequest] = []
        skipped: list[GenRequest] = []
        limit = min(len(free_slots), config.prefill_max_batch)
        if head.chunked:
            limit = min(limit, config.prefill_max_batch - len(self._chunking))
        while self._pending and len(group) < limit:
            request = self._pending.popleft()
            if head.chunked:
                # chunk rounds batch rows at any offset, hit or not
                ok = self._assign_bucket(request) != 0 and request.chunked
            else:
                ok = (self._assign_bucket(request) == bucket
                      and (request.hist > 0) == with_hist
                      and not request.chunked)
            (group if ok else skipped).append(request)
        # FIFO for other buckets; capacity-blocked chunkers go first
        self._pending.extendleft(reversed(skipped))
        self._pending.extendleft(reversed(deferred))

        admitted: list[GenRequest] = []
        for request in group:
            total = min(len(request.prompt_ids) + request.max_tokens,
                        config.max_seq_len)
            slot = free_slots[len(admitted)]
            shared: list[int] = []
            if request.hist:
                hist, shared = self.allocator.match_prefix(request.prompt_ids)
                if hist != request.hist:
                    # the cache moved since the probe: re-probe later
                    self.allocator.release_prefix(shared)
                    request.bucket = -1
                    self._pending.appendleft(request)
                    continue
            if not self.allocator.allocate_slot(slot, total,
                                                prefix_pages=shared):
                # page pressure: release the match and retry later
                self.allocator.release_prefix(shared)
                request.bucket = -1
                self._pending.appendleft(request)
                continue
            request.slot = slot
            if request.chunked:
                # the chunk rounds own it until its prompt is prefilled
                request.chunk_pos = request.hist
                self._chunking[slot] = request
            else:
                self._running[slot] = request
            admitted.append(request)
        if not admitted:
            return False
        self._sync_tables()
        if head.chunked:
            return True   # the device work happens in _chunk_round

        started = time.monotonic()
        tokens, positions, last_idx, slot_ids, sampling = self._pack_rows(
            [(r, r.hist, len(r.prompt_ids)) for r in admitted], bucket)
        step = prefill_with_history if with_hist else prefill
        logits, self.kv = step(self.params, self.model_config, tokens,
                               positions, self.kv, slot_ids,
                               last_idx=last_idx)
        first = sample_tokens(logits, sampling, self._sample_gen).tolist()
        if config.prefix_cache:
            # register the full prompt pages for later prompts to share
            for request in admitted:
                self.allocator.register_prefix(request.slot,
                                               request.prompt_ids)
        elapsed_ms = (time.monotonic() - started) * 1000
        self.stats.prefill_ms_total += elapsed_ms
        self.stats.prefill_batches += 1
        self.stats.prefill_requests += len(admitted)
        for request, token in zip(admitted, first):
            self._emit(request, int(token))
        return True

    def _chunk_round(self) -> None:
        """Advance every chunking prompt by ONE chunk, in one batched call
        of the history path: chunk i attends over chunks 0..i-1 (and any
        cached prefix) already in the slot's pages. S is the smallest
        bucket that covers the widest remaining span. Samples taken
        mid-prompt predict known prompt tokens and are discarded; a row
        whose prompt completes registers its prefix, moves to decode and
        emits its first token."""
        config = self.config
        batch = list(self._chunking.values())[:config.prefill_max_batch]
        widest = max(len(r.prompt_ids) - r.chunk_pos for r in batch)
        S = self._bucket_for(widest) or max(config.prefill_buckets)
        started = time.monotonic()
        rows = []
        for request in batch:
            start = request.chunk_pos
            end = min(start + S, len(request.prompt_ids))
            rows.append((request, start, end))
            request.chunk_pos = end
        tokens, positions, last_idx, slot_ids, sampling = self._pack_rows(
            rows, S)
        logits, self.kv = prefill_with_history(
            self.params, self.model_config, tokens, positions, self.kv,
            slot_ids, last_idx=last_idx)
        sampled = sample_tokens(logits, sampling, self._sample_gen).tolist()
        self.stats.prefill_ms_total += (time.monotonic() - started) * 1000
        self.stats.prefill_batches += 1
        for request, token in zip(batch, sampled):
            if request.chunk_pos < len(request.prompt_ids):
                continue
            del self._chunking[request.slot]
            # register BEFORE emitting: a first token that ends the request
            # frees the slot's pages, and registration would cache nothing
            if config.prefix_cache:
                self.allocator.register_prefix(request.slot,
                                               request.prompt_ids)
            self.stats.prefill_requests += 1
            self._running[request.slot] = request
            self._emit(request, int(token))

    def _pack_rows(self, rows: list[tuple[GenRequest, int, int]], S: int):
        """Pack each (request, start, end) prompt span into [B, S] device
        tensors at absolute positions, padded to S: padding has position -1
        (its KV write goes to the trash page) and the pad token."""
        B = len(rows)
        tokens = np.full((B, S), self.tokenizer.pad_id, dtype=np.int64)
        positions = np.full((B, S), -1, dtype=np.int32)
        last_idx = np.zeros((B,), dtype=np.int64)
        for i, (request, start, end) in enumerate(rows):
            tokens[i, :end - start] = request.prompt_ids[start:end]
            positions[i, :end - start] = np.arange(start, end)
            last_idx[i] = end - start - 1
        requests = [r for r, _, _ in rows]
        return (self._to_device(tokens), self._to_device(positions),
                self._to_device(last_idx),
                self._to_device(np.array([r.slot for r in requests], np.int64)),
                self._sampling(requests))

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _sampling(self, rows: list[GenRequest]) -> SamplingParams:
        return SamplingParams(
            self._to_device(np.array([r.temperature for r in rows], np.float32)),
            self._to_device(np.array([r.top_k for r in rows], np.int32)),
            self._to_device(np.array([r.top_p for r in rows], np.float32)))

    # ----------------------------------------------------------------- decode

    def _decode_step(self) -> None:
        """One decode step over every running slot: write each row's last
        token's KV, attend over its pages, sample the next token."""
        rows: list[GenRequest] = []
        for slot in sorted(self._running):
            request = self._running[slot]
            n_ctx = len(request.prompt_ids) + len(request.generated)
            # the input token sits at position n_ctx - 1; a slot that cannot
            # grow to hold it (page pool exhausted) ends with "length"
            if self.allocator.grow_slot(slot, n_ctx) < n_ctx:
                request.finish_reason = request.finish_reason or "length"
                self._finish(request)
                continue
            rows.append(request)
        if not rows:
            return
        self._sync_tables()
        started = time.monotonic()
        n_ctx = np.array([len(r.prompt_ids) + len(r.generated) for r in rows],
                         dtype=np.int32)
        tokens = self._to_device(np.array([r.generated[-1] for r in rows],
                                          np.int64))
        logits, self.kv = decode_step(
            self.params, self.model_config, tokens,
            self._to_device(n_ctx - 1), self.kv,
            self._to_device(np.array([r.slot for r in rows], np.int64)),
            self._to_device(n_ctx))
        sampled = sample_tokens(logits, self._sampling(rows),
                                self._sample_gen).tolist()
        self.stats.decode_ms_total += (time.monotonic() - started) * 1000
        self.stats.decode_steps += 1
        for request, token in zip(rows, sampled):
            self._emit(request, int(token))

    def _sync_tables(self) -> None:
        """Upload the block table when the allocator changed a row."""
        if self.allocator.dirty:
            self.kv.block_tables.copy_(self.allocator.tables())

    # --------------------------------------------------------------- emission

    def _emit(self, request: GenRequest, token: int) -> None:
        request.generated.append(token)
        self.stats.completion_tokens += 1
        if request.first_token_ts == 0.0:
            request.first_token_ts = time.time()
        stop = token == self.tokenizer.eos_id or token in request.stop_ids
        done = stop or len(request.generated) >= request.max_tokens
        if done and request.finish_reason is None:
            request.finish_reason = "stop" if stop else "length"
        if done:
            self._running.pop(request.slot, None)
            self.allocator.free_slot(request.slot)
        self._post_tokens(request, [token], done=done)

    def _finish(self, request: GenRequest) -> None:
        self._running.pop(request.slot, None)
        self._chunking.pop(request.slot, None)
        self.allocator.free_slot(request.slot)
        self._post_tokens(request, [], done=True)

    def _post_tokens(self, request: GenRequest, tokens: list[int],
                     done: bool) -> None:
        """Queue tokens for the consumer; posts merge per request and reach
        the loop in one hop per step (``_flush_emits``)."""
        buf = self._emit_buf
        if buf and buf[-1][0] is request and not buf[-1][2]:
            buf[-1][1].extend(tokens)
            buf[-1][2] = done
        else:
            buf.append([request, list(tokens), done])

    def _flush_emits(self) -> None:
        if not self._emit_buf:
            return
        batch, self._emit_buf = self._emit_buf, []

        def _put() -> None:
            for request, tokens, done in batch:
                for token in tokens:
                    request.stream.put_nowait(token)
                if done:
                    request.stream.put_nowait(None)

        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(_put)
                return
            except RuntimeError:
                pass  # loop shut down mid-flight
        _put()
