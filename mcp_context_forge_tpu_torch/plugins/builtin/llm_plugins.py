"""The four engine-backed plugins (a copy of the JAX package's
``plugins/builtin/llm_plugins.py``): a prompt-embedding result cache, a
summarizer of long tool output, and two harm classifiers, all routed through
the app's ``llm_registry`` (the local engine's ``embed``, ``chat`` and
``classify``).

Each degrades as the JAX plugins do: with no registry, or when the engine
call raises, the cache falls back to hashed bag-of-words vectors and the
classifiers to a wordlist; the summarizer passes output through untouched
without a registry.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import math
import re
import time
from typing import Any

from ..framework import Plugin, PluginViolation

logger = logging.getLogger(__name__)


def _result_text(result: dict[str, Any]) -> str:
    parts = []
    for item in result.get("content", []):
        if isinstance(item, dict) and item.get("type") == "text":
            parts.append(item.get("text", ""))
    return "\n".join(parts)


def _bow_vector(text: str, dim: int = 256) -> list[float]:
    """Hashed bag-of-words embedding (the reference's actual cache vectorizer)."""
    vec = [0.0] * dim
    for token in re.findall(r"[a-z0-9]+", text.lower()):
        vec[int(hashlib.md5(token.encode()).hexdigest(), 16) % dim] += 1.0  # a feature hash, not a credential
    norm = math.sqrt(sum(v * v for v in vec)) or 1.0
    return [v / norm for v in vec]


def _cosine(a: list[float], b: list[float]) -> float:
    if len(a) != len(b):
        return 0.0
    dot = sum(x * y for x, y in zip(a, b))
    na = math.sqrt(sum(x * x for x in a)) or 1.0
    nb = math.sqrt(sum(x * x for x in b)) or 1.0
    return dot / (na * nb)


class ResponseCacheByPromptPlugin(Plugin):
    """Approximate result cache: cosine similarity over prompt embeddings.

    config: {threshold: 0.92, ttl_seconds: 300, max_entries: 512,
             use_engine: true}"""

    def __init__(self, config, ctx=None):
        super().__init__(config, ctx)
        self._entries: list[tuple[list[float], float, dict[str, Any]]] = []

    async def _embed(self, text: str) -> list[float]:
        registry = getattr(self.ctx, "llm_registry", None) if self.ctx else None
        if registry is not None and self.config.config.get("use_engine", True):
            try:
                vectors = await registry.embed([text])
                return vectors[0]
            except Exception as exc:
                logger.debug("engine embed failed, falling back to BoW: %s", exc)
        return _bow_vector(text)

    async def tool_pre_invoke(self, name, arguments, headers, context):
        prompt = json.dumps({"tool": name, "args": arguments}, sort_keys=True)
        vector = await self._embed(prompt)
        threshold = float(self.config.config.get("threshold", 0.92))
        ttl = float(self.config.config.get("ttl_seconds", 300))
        now = time.monotonic()
        self._entries = [e for e in self._entries if now - e[1] < ttl]
        best, best_sim = None, 0.0
        for entry_vec, _, result in self._entries:
            sim = _cosine(vector, entry_vec)
            if sim > best_sim:
                best, best_sim = result, sim
        if best is not None and best_sim >= threshold:
            context.metadata["cache_hit"] = True
            import copy
            return {"result": copy.deepcopy(best)}
        context.metadata["prompt_vector"] = vector
        return None

    async def tool_post_invoke(self, name, result, context):
        if context.metadata.get("cache_hit"):
            return None
        vector = context.metadata.get("prompt_vector")
        if vector is not None and not result.get("isError"):
            max_entries = int(self.config.config.get("max_entries", 512))
            if len(self._entries) >= max_entries:
                self._entries.pop(0)
            import copy
            self._entries.append((vector, time.monotonic(), copy.deepcopy(result)))
        return None


class SummarizerPlugin(Plugin):
    """Summarizes long tool output through the tpu_local chat model.

    Latency budget (SURVEY §7.2 #2): summarization is deterministic
    (temperature 0) over the tool output, so identical outputs MUST
    summarize identically — a result-hash cache skips the engine for
    repeats, and a singleflight table coalesces CONCURRENT identical
    calls onto one in-flight engine chat (a burst of N calls over the
    same tool output pays one decode, not N). Engine calls are tagged
    ``priority: batch`` so interactive chat admits first under slot
    contention.

    config: {threshold_chars: 2000, max_tokens: 256, model: null,
             prompt: "...", cache: true, cache_ttl_seconds: 600,
             cache_max_entries: 256}"""

    def __init__(self, config, ctx=None):
        super().__init__(config, ctx)
        # key -> (summary, monotonic deadline); insertion-ordered for LRU
        self._cache: "dict[str, tuple[str, float]]" = {}
        self._inflight: dict[str, asyncio.Future] = {}

    def _key(self, prompt: str, text: str, max_tokens: int) -> str:
        raw = json.dumps([self.config.config.get("model"), prompt,
                          max_tokens, text])
        return hashlib.sha256(raw.encode()).hexdigest()

    async def _summarize(self, registry, prompt: str, text: str,
                         max_tokens: int) -> str:
        response = await registry.chat({
            "model": self.config.config.get("model"),
            "messages": [
                {"role": "system", "content": prompt},
                {"role": "user", "content": text},
            ],
            "max_tokens": max_tokens,
            "temperature": 0.0,
            "priority": "batch",
        })
        return response["choices"][0]["message"]["content"]

    async def tool_post_invoke(self, name, result, context):
        threshold = int(self.config.config.get("threshold_chars", 2000))
        text = _result_text(result)
        if len(text) < threshold or result.get("isError"):
            return None
        registry = getattr(self.ctx, "llm_registry", None) if self.ctx else None
        if registry is None:
            return None  # no engine: pass through untouched
        prompt = self.config.config.get(
            "prompt", "Summarize the following tool output concisely, keeping key "
                      "facts, numbers and identifiers:")
        text = text[:16000]
        max_tokens = int(self.config.config.get("max_tokens", 256))

        if not self.config.config.get("cache", True):
            summary = await self._summarize(registry, prompt, text, max_tokens)
            return {"content": [{"type": "text", "text": summary}],
                    "isError": False, "_summarized": True}

        key = self._key(prompt, text, max_tokens)
        ttl = float(self.config.config.get("cache_ttl_seconds", 600))
        while True:
            hit = self._cache.get(key)
            if hit is not None and hit[1] > time.monotonic():
                self._cache.pop(key)    # true LRU: a hit refreshes recency
                self._cache[key] = hit
                context.metadata["summary_cache_hit"] = True
                return {"content": [{"type": "text", "text": hit[0]}],
                        "isError": False, "_summarized": True}

            flight = self._inflight.get(key)
            if flight is None:
                break  # become the leader below
            try:
                summary = await flight  # coalesce onto the in-flight call
                context.metadata["summary_cache_hit"] = True
                return {"content": [{"type": "text", "text": summary}],
                        "isError": False, "_summarized": True}
            except asyncio.CancelledError:
                if flight.cancelled():
                    continue  # only the LEADER's client died: retry —
                              # this follower may become the new leader
                raise         # this follower's own task was cancelled

        flight = asyncio.get_running_loop().create_future()
        self._inflight[key] = flight
        try:
            summary = await self._summarize(registry, prompt, text,
                                            max_tokens)
        except BaseException as exc:
            # BaseException: a CancelledError (client disconnect) must
            # not strand a forever-pending future in _inflight — every
            # later identical call would await it until restart
            if isinstance(exc, Exception):
                flight.set_exception(exc)
                # an unawaited exception-holding future must not warn
                flight.exception()
            else:
                flight.cancel()
            self._inflight.pop(key, None)
            raise
        max_entries = int(self.config.config.get("cache_max_entries", 256))
        if max_entries > 0:
            while len(self._cache) >= max_entries:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = (summary, time.monotonic() + ttl)
        flight.set_result(summary)
        # cache first, THEN retire the flight: a caller arriving in
        # between finds one or the other, never neither
        self._inflight.pop(key, None)
        return {"content": [{"type": "text", "text": summary}],
                "isError": False, "_summarized": True}


_HARM_WORDLIST = {
    "kill yourself", "build a bomb", "make a weapon", "child sexual",
    "credit card dump", "ransomware payload",
}


class _ClassifierMixin(Plugin):
    async def _score(self, text: str) -> float:
        """Harm probability in [0,1] — tpu_local classifier, wordlist fallback."""
        registry = getattr(self.ctx, "llm_registry", None) if self.ctx else None
        if registry is not None and self.config.config.get("use_engine", True):
            classify = getattr(registry, "classify", None)
            if classify is not None:
                try:
                    scores = await classify([text])
                    return float(scores[0])
                except Exception as exc:
                    logger.debug("engine classify failed, wordlist fallback: %s", exc)
        lowered = text.lower()
        return 1.0 if any(w in lowered for w in _HARM_WORDLIST) else 0.0


class ContentModerationPlugin(_ClassifierMixin):
    """Blocks tool calls whose inputs are flagged (reference providers
    IBM Watson/Granite/OpenAI/Azure/AWS → replaced by tpu_local classify).

    config: {threshold: 0.8, use_engine: true}"""

    async def tool_pre_invoke(self, name, arguments, headers, context):
        threshold = float(self.config.config.get("threshold", 0.8))
        score = await self._score(json.dumps(arguments))
        if score >= threshold:
            raise PluginViolation(
                f"Input flagged by content moderation (score={score:.2f})",
                code="CONTENT_MODERATION")
        return None


class HarmfulContentDetectorPlugin(_ClassifierMixin):
    """Flags/blocks harmful tool output (reference harmful_content_detector).

    config: {threshold: 0.8, action: "block"|"annotate", use_engine: true}"""

    async def tool_post_invoke(self, name, result, context):
        threshold = float(self.config.config.get("threshold", 0.8))
        text = _result_text(result)
        if not text:
            return None
        score = await self._score(text)
        if score < threshold:
            return None
        if self.config.config.get("action", "block") == "block":
            raise PluginViolation(
                f"Output flagged as harmful (score={score:.2f})", code="HARMFUL_CONTENT")
        result.setdefault("annotations", {})["harm_score"] = score
        return result
