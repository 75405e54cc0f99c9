"""The ``tpu_local`` provider over the PyTorch engine: OpenAI chat request
dicts in, OpenAI responses or stream chunks out, plus embeddings and harm
classification on a small encoder. ("tpu_local" is the provider's name at
the gateway, not a hardware claim.)"""

from __future__ import annotations

import asyncio
import hashlib
import time
from collections import OrderedDict
from typing import Any, AsyncIterator

import numpy as np
import torch

from ..observability import current_tenant
from ..utils import new_id
from .engine import GenRequest, TorchEngine
from .models import ENCODER_CONFIGS
from .models.encoder import encode as encoder_forward
from .models.encoder import init_encoder_params
from .provider import LLMProvider, LLMUnavailable, make_chat_response
from .tokenizer import load_tokenizer, render_chat
from .tool_calls import parse_tool_calls

# the seed of the encoder's random weights (the JAX provider's PRNGKey(7))
ENCODER_SEED = 7


class _EncoderBatcher:
    """Coalesces concurrent embed/classify calls into one encoder forward.

    Classifier traffic arrives one text per tool call; submitted rows queue
    up and a worker drains up to ``max_batch`` per forward (waiting at most
    ``max_wait_ms`` for company), padded by ``encode_batch``."""

    def __init__(self, encode_batch, max_batch: int = 32,
                 max_wait_ms: float = 2.0):
        self._encode_batch = encode_batch  # list[list[int]] -> (emb, logits)
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._queue: asyncio.Queue = asyncio.Queue()
        self._worker_task: asyncio.Task | None = None

    async def submit(self, ids: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """(embedding [D], class logits [C]) of one token row."""
        if self._worker_task is None or self._worker_task.done():
            self._worker_task = asyncio.ensure_future(self._worker())
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((ids, future))
        return await future

    async def stop(self) -> None:
        if self._worker_task is not None:
            self._worker_task.cancel()
            try:
                await self._worker_task
            except asyncio.CancelledError:
                pass
            self._worker_task = None
        # strand nothing: queued submitters must not await forever
        while not self._queue.empty():
            _, future = self._queue.get_nowait()
            if not future.done():
                future.cancel()

    async def _worker(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            batch = [await self._queue.get()]
            try:
                deadline = loop.time() + self.max_wait
                while len(batch) < self.max_batch:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(self._queue.get(),
                                                            remaining))
                    except asyncio.TimeoutError:
                        break
                rows = [ids for ids, _ in batch]
                try:
                    embeddings, logits = await asyncio.to_thread(
                        self._encode_batch, rows)
                except Exception as exc:
                    for _, future in batch:
                        if not future.done():
                            future.set_exception(exc)
                    continue
                for i, (_, future) in enumerate(batch):
                    if not future.done():
                        future.set_result((embeddings[i], logits[i]))
            except asyncio.CancelledError:
                # stop() mid-batch: fail the in-flight futures, then exit
                for _, future in batch:
                    if not future.done():
                        future.cancel()
                raise


class TorchLocalProvider(LLMProvider):
    """Chat over a :class:`TorchEngine` or an ``EnginePool`` (the same
    submit surface; a pool's "unavailable" terminal raises
    ``LLMUnavailable``); ``embed``/``classify`` over the
    encoder ``embedding_model`` (seeded random weights in f32, on the
    engine's device). ``tracer`` and ``metrics`` are optional handles,
    duck-typed as the JAX provider's."""

    provider_type = "tpu_local"

    def __init__(self, name: str, engine: TorchEngine,
                 embedding_model: str = "encoder-tiny",
                 tracer=None, metrics=None,
                 encoder_max_batch: int = 32,
                 encoder_max_wait_ms: float = 2.0,
                 encoder_min_seq: int = 32):
        self.name = name
        self.engine = engine
        self.tracer = tracer
        self.metrics = metrics
        self.encoder_config = ENCODER_CONFIGS[embedding_model]
        self.encoder_device = engine.device
        generator = torch.Generator(device=self.encoder_device)
        generator.manual_seed(ENCODER_SEED)
        self.encoder_params = init_encoder_params(self.encoder_config, generator,
                                                  device=self.encoder_device)
        self.encoder_tokenizer = load_tokenizer(
            vocab_size=self.encoder_config.vocab_size)
        self.encoder_min_seq = max(8, encoder_min_seq)
        self._batcher = _EncoderBatcher(self._encode_batch,
                                        max_batch=encoder_max_batch,
                                        max_wait_ms=encoder_max_wait_ms)
        # moderation granularity (classify): "full" covers max_windows x
        # window tokens spread over the text, "sample" head and tail
        self.classify_window = 128
        self.classify_coverage = "full"
        self.classify_max_windows = 8
        # verdicts are a pure function of (weights, text): identical texts
        # skip the encoder (LRU-bounded)
        self._classify_cache: "OrderedDict[tuple, float]" = OrderedDict()
        self.classify_cache_size = 8192

    # ------------------------------------------------------------------ chat

    def _prepare(self, request: dict[str, Any]) -> GenRequest:
        tools = request.get("tools")
        if request.get("tool_choice") == "none":
            tools = None
        prompt = render_chat(request.get("messages", []), tools=tools)
        prompt_ids = self.engine.tokenizer.encode(prompt)
        max_ctx = self.engine.config.max_seq_len
        # truncation keeps room for the requested completion (capped at a
        # quarter of the context), so a near-full prompt is not clamped to
        # a one-token answer
        requested = int(request.get("max_tokens") or 128)
        reserve = max(1, min(requested, max_ctx // 4))
        prompt_ids = prompt_ids[-(max_ctx - reserve):]
        max_tokens = min(requested, max_ctx - len(prompt_ids))
        priority = {"interactive": 0, "batch": 1}.get(
            str(request.get("priority") or "interactive"), 0)
        return GenRequest(
            request_id=new_id(),
            prompt_ids=prompt_ids,
            max_tokens=max(1, max_tokens),
            temperature=float(request.get("temperature") or 0.0),
            top_k=int(request.get("top_k") or 0),
            top_p=float(request.get("top_p") or 1.0),
            priority=priority,
            tenant=current_tenant() or "",
        )

    def _request_span(self, request: dict[str, Any], gen: GenRequest):
        """Open the llm.request span (its parent: whatever span is current
        on the asyncio side) and hand its context to the engine, whose
        dispatch thread parents llm.queue/prefill/decode to it."""
        if self.tracer is None:
            return None, None
        span_ctx = self.tracer.span("llm.request", {
            "gen_ai.system": "tpu_local",
            "gen_ai.request.model": request.get("model", self.engine.config.model),
            "gen_ai.usage.prompt_tokens": len(gen.prompt_ids),
            "gen_ai.request.max_tokens": gen.max_tokens,
        })
        span = span_ctx.__enter__()
        gen.trace_ctx = span.context()
        return span_ctx, span

    def _count_request(self, model: str, prompt_tokens: int,
                       completion_tokens: int, status: str = "ok") -> None:
        if self.metrics is None:
            return
        self.metrics.llm_tokens.labels(model=model, kind="prompt").inc(prompt_tokens)
        self.metrics.llm_tokens.labels(model=model, kind="completion").inc(
            completion_tokens)
        self.metrics.llm_requests.labels(model=model, status=status).inc()

    def _count_error(self, model: str, span, exc: BaseException) -> None:
        if self.metrics is not None:
            self.metrics.llm_requests.labels(model=model, status="error").inc()
        if span is not None:
            # the span exits without exc_info: mark it here
            span.record_exception(exc)

    @staticmethod
    def _wants_tools(request: dict[str, Any]) -> bool:
        return bool(request.get("tools")) and request.get("tool_choice") != "none"

    async def chat(self, request: dict[str, Any]) -> dict[str, Any]:
        gen = self._prepare(request)
        model = request.get("model", self.engine.config.model)
        span_ctx, span = self._request_span(request, gen)
        try:
            await self.engine.submit(gen)
            tokens: list[int] = []
            while True:
                token = await gen.stream.get()
                if token is None:
                    break
                tokens.append(token)
            if gen.finish_reason == "unavailable":
                # a pool with no replica left to finish it: a clean 503 +
                # Retry-After rather than a partial completion
                raise LLMUnavailable("serving capacity temporarily unavailable "
                                     "(pool failover budget exhausted)")
            text = self.engine.tokenizer.decode(tokens)
            self._count_request(model, len(gen.prompt_ids), len(tokens))
            if span is not None:
                span.set_attribute("gen_ai.usage.completion_tokens", len(tokens))
                span.set_attribute("gen_ai.response.finish_reason",
                                   gen.finish_reason or "stop")
            tool_calls = parse_tool_calls(text) if self._wants_tools(request) else None
            return make_chat_response(
                model, text, prompt_tokens=len(gen.prompt_ids),
                completion_tokens=len(tokens),
                finish_reason=gen.finish_reason or "stop", tool_calls=tool_calls)
        except (asyncio.CancelledError, GeneratorExit):
            raise  # the client went away: not a serving error
        except BaseException as exc:
            self._count_error(model, span, exc)
            raise
        finally:
            if span_ctx:
                span_ctx.__exit__(None, None, None)

    async def chat_stream(self, request: dict[str, Any]
                          ) -> AsyncIterator[dict[str, Any]]:
        gen = self._prepare(request)
        model = request.get("model", self.engine.config.model)
        span_ctx, span = self._request_span(request, gen)
        try:
            async for chunk in self._chat_stream_inner(request, gen, model):
                yield chunk
            self._count_request(model, len(gen.prompt_ids), len(gen.generated))
            if span is not None:
                span.set_attribute("gen_ai.usage.completion_tokens",
                                   len(gen.generated))
                span.set_attribute("gen_ai.response.finish_reason",
                                   gen.finish_reason or "stop")
                span.set_attribute("llm.stream", True)
        except (asyncio.CancelledError, GeneratorExit):
            raise  # a disconnect mid-stream is not a serving error
        except BaseException as exc:
            self._count_error(model, span, exc)
            raise
        finally:
            if span_ctx:
                span_ctx.__exit__(None, None, None)

    async def _chat_stream_inner(self, request: dict[str, Any], gen: GenRequest,
                                 model: str) -> AsyncIterator[dict[str, Any]]:
        await self.engine.submit(gen)
        created = int(time.time())
        chunk_id = f"chatcmpl-{new_id()[:24]}"
        # a completion that OPENS with JSON is probably a tool call: buffer
        # it instead of streaming fragments; plain text streams as it comes
        buffering = self._wants_tools(request)
        emitted: list[str] = []
        pending: list[int] = []
        delivered = False
        while True:
            token = await gen.stream.get()
            if token is None:
                break
            pending.append(token)
            text = self.engine.tokenizer.decode(pending)
            if text and not text.endswith("�"):  # complete utf-8 runs
                pending = []
                if buffering:
                    emitted.append(text)
                    head = "".join(emitted).lstrip()
                    if head and head[0] not in "{[":
                        buffering = False  # plain answer: replay + stream
                        for chunk in emitted:
                            delivered = True
                            yield self._chunk(chunk_id, created, model,
                                              {"content": chunk})
                        emitted = []
                    continue
                delivered = True
                yield self._chunk(chunk_id, created, model, {"content": text})
        if gen.finish_reason == "unavailable":
            if not delivered:
                # nothing reached the client: raise, so the HTTP surface
                # answers a clean 503 + Retry-After (it awaits the first
                # chunk before sending headers)
                raise LLMUnavailable("serving capacity temporarily unavailable "
                                     "(pool failover budget exhausted)")
            # tokens already streamed: end with a structured terminal chunk
            # (finish_reason and an error object with the retry advice)
            yield {
                "id": chunk_id, "object": "chat.completion.chunk",
                "created": created, "model": model,
                "choices": [{"index": 0, "delta": {}, "finish_reason": "unavailable"}],
                "error": {"message": "serving capacity lost mid-stream (pool "
                                     "failover budget exhausted); retry with the "
                                     "partial output discarded",
                          "type": "overloaded_error", "code": 503, "retry_after_s": 1},
            }
            return
        if buffering and emitted:
            full = "".join(emitted)
            calls = parse_tool_calls(full)
            if calls:
                deltas = [{**call, "index": i} for i, call in enumerate(calls)]
                yield self._chunk(chunk_id, created, model,
                                  {"tool_calls": deltas})
                yield self._chunk(chunk_id, created, model, {}, "tool_calls")
                return
            yield self._chunk(chunk_id, created, model, {"content": full})
        yield self._chunk(chunk_id, created, model, {},
                          gen.finish_reason or "stop")

    @staticmethod
    def _chunk(chunk_id: str, created: int, model: str, delta: dict[str, Any],
               finish_reason: str | None = None) -> dict[str, Any]:
        return {
            "id": chunk_id, "object": "chat.completion.chunk",
            "created": created, "model": model,
            "choices": [{"index": 0, "delta": delta,
                         "finish_reason": finish_reason}],
        }

    # ------------------------------------------------------------ embeddings

    def _seq_bucket(self, longest: int) -> int:
        """The smallest power-of-two sequence width (from
        ``encoder_min_seq``) covering ``longest``, at most the encoder's
        max_seq_len: short texts do not pay full-length attention."""
        seq = self.encoder_min_seq
        while seq < longest and seq < self.encoder_config.max_seq_len:
            seq *= 2
        return min(seq, self.encoder_config.max_seq_len)

    def _encode_batch(self, rows: list[list[int]]) -> tuple[np.ndarray, np.ndarray]:
        """One encoder forward over ``rows``, batch and sequence padded to
        powers of two as the JAX provider pads them (a bounded set of
        shapes); rows longer than max_seq_len are cut."""
        max_len = self.encoder_config.max_seq_len
        encoded = [ids[:max_len] for ids in rows]
        batch = 1
        while batch < len(rows):
            batch *= 2
        seq = self._seq_bucket(max((len(ids) for ids in encoded), default=1))
        tokens = np.zeros((batch, seq), dtype=np.int64)
        mask = np.zeros((batch, seq), dtype=bool)
        for i, ids in enumerate(encoded):
            tokens[i, :len(ids)] = ids
            mask[i, :len(ids)] = True
        device = self.encoder_device
        with torch.inference_mode():
            embeddings, logits = encoder_forward(
                self.encoder_params, self.encoder_config,
                torch.from_numpy(tokens).to(device), torch.from_numpy(mask).to(device))
            return (embeddings[:len(rows)].float().cpu().numpy(),
                    logits[:len(rows)].float().cpu().numpy())

    def _tokenize(self, text: str) -> list[int]:
        return self.encoder_tokenizer.encode(text, add_bos=False)

    async def embed(self, texts: list[str], model: str | None = None
                    ) -> list[list[float]]:
        results = await asyncio.gather(
            *[self._batcher.submit(self._tokenize(t)) for t in texts])
        return [embedding.tolist() for embedding, _ in results]

    async def classify(self, texts: list[str],
                       coverage: str | None = None) -> list[float]:
        """Harm probability per text. A text longer than
        ``classify_window`` tokens is scored over windows (the score is the
        max over them): ``coverage="full"`` (default) strides windows over
        the whole text, at most ``classify_max_windows`` spread from head
        to tail; ``"sample"`` takes the head and tail windows."""
        coverage = coverage or self.classify_coverage
        W = self.classify_window
        cached: dict[int, float] = {}
        keys: dict[int, tuple] = {}
        jobs: list[tuple[int, list[int]]] = []   # (text index, window ids)
        for i, text in enumerate(texts):
            key = (hashlib.sha256(text.encode()).digest(), coverage, W,
                   self.classify_max_windows)
            hit = self._classify_cache.get(key)
            if hit is not None:
                self._classify_cache.move_to_end(key)
                cached[i] = hit
                continue
            keys[i] = key
            ids = self._tokenize(text)
            if len(ids) <= W:
                jobs.append((i, ids))
            elif coverage == "full":
                starts = list(range(0, len(ids), W))
                if len(starts) > self.classify_max_windows:
                    # keep windows spread over the whole text, head and
                    # tail included: the first N would let a long benign
                    # prefix hide a harmful tail
                    k = max(2, self.classify_max_windows)
                    starts = [starts[round(j * (len(starts) - 1) / (k - 1))]
                              for j in range(k)]
                for s in starts:
                    jobs.append((i, ids[s:s + W]))
            else:  # sample: head + tail
                jobs.append((i, ids[:W]))
                jobs.append((i, ids[-W:]))
        results = await asyncio.gather(
            *[self._batcher.submit(ids) for _, ids in jobs])
        scores = [0.0] * len(texts)
        for (i, _), (_, logits) in zip(jobs, results):
            probs = np.exp(logits - logits.max())
            probs = probs / probs.sum()
            scores[i] = max(scores[i], float(probs[1]))
        for i, score in cached.items():
            scores[i] = score
        for i, key in keys.items():
            self._classify_cache[key] = scores[i]
            while len(self._classify_cache) > self.classify_cache_size:
                self._classify_cache.popitem(last=False)
        return scores

    async def warmup(self) -> None:
        """Run the encoder once at every (batch, sequence) shape the batcher
        can pad to, so that library handles and workspaces exist before
        classifier traffic."""
        batch = 1
        while batch <= self._batcher.max_batch:
            seq = self.encoder_min_seq
            while True:
                await asyncio.to_thread(self._encode_batch, [[1] * seq] * batch)
                if seq >= self.encoder_config.max_seq_len:
                    break
                seq *= 2
            batch *= 2

    async def models(self) -> list[str]:
        return [self.engine.config.model]

    async def shutdown(self) -> None:
        await self._batcher.stop()
        await self.engine.stop()
