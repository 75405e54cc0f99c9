"""LLM providers behind the /v1 surface (copies of the JAX package's): the
errors the surface maps to HTTP statuses, the ``LLMProvider`` interface,
the registry that resolves a model alias to its provider, and the OpenAI
wire shapes the providers share."""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from typing import Any, AsyncIterator

from ..utils import new_id


class LLMError(Exception):
    pass


class LLMUnavailable(LLMError):
    """Serving capacity is temporarily gone (no routable engine, overload).
    The HTTP surface maps this to 503 + Retry-After instead of a bare
    error."""

    def __init__(self, message: str, retry_after_s: int = 1) -> None:
        super().__init__(message)
        self.retry_after_s = max(1, int(retry_after_s))


class LLMProvider(ABC):
    """One backend capable of chat and/or embeddings (OpenAI wire shapes)."""

    name: str = "provider"
    provider_type: str = "abstract"

    @abstractmethod
    async def chat(self, request: dict[str, Any]) -> dict[str, Any]:
        """OpenAI ChatCompletionRequest dict -> ChatCompletionResponse dict."""

    async def chat_stream(self, request: dict[str, Any]
                          ) -> AsyncIterator[dict[str, Any]]:
        """Yield OpenAI chat.completion.chunk dicts. Default: one-shot."""
        response = await self.chat(request)
        choice = response["choices"][0]
        yield {
            "id": response["id"], "object": "chat.completion.chunk",
            "created": response["created"], "model": response["model"],
            "choices": [{"index": 0,
                         "delta": {"role": "assistant",
                                   "content": choice["message"]["content"]},
                         "finish_reason": choice.get("finish_reason")}],
        }

    async def embed(self, texts: list[str], model: str | None = None
                    ) -> list[list[float]]:
        raise LLMError(f"Provider {self.name} does not support embeddings")

    async def models(self) -> list[str]:
        return []

    async def shutdown(self) -> None:
        return None


class LLMProviderRegistry:
    """model alias -> provider resolution + lifecycle."""

    def __init__(self) -> None:
        self._providers: dict[str, LLMProvider] = {}
        self._aliases: dict[str, str] = {}  # model alias -> provider name
        self.default_chat_model: str | None = None
        self.default_embed_model: str | None = None

    def register(self, provider: LLMProvider, models: list[str],
                 default_chat: bool = False, default_embed: bool = False) -> None:
        self._providers[provider.name] = provider
        for model in models:
            self._aliases[model] = provider.name
        if default_chat and models:
            self.default_chat_model = models[0]
        if default_embed and models:
            self.default_embed_model = models[-1]

    def resolve(self, model: str | None) -> tuple[LLMProvider, str]:
        model = model or self.default_chat_model
        if model is None:
            raise LLMError("No model specified and no default configured")
        name = self._aliases.get(model)
        if name is None:
            # the default provider serves an unknown model id as its own
            if self.default_chat_model and self.default_chat_model in self._aliases:
                name = self._aliases[self.default_chat_model]
            else:
                raise LLMError(f"Unknown model {model!r}")
        return self._providers[name], model

    def list_models(self) -> list[dict[str, Any]]:
        return [{"id": alias, "object": "model", "owned_by": provider}
                for alias, provider in sorted(self._aliases.items())]

    async def chat(self, request: dict[str, Any]) -> dict[str, Any]:
        provider, model = self.resolve(request.get("model"))
        return await provider.chat({**request, "model": model})

    async def chat_stream(self, request: dict[str, Any]
                          ) -> AsyncIterator[dict[str, Any]]:
        provider, model = self.resolve(request.get("model"))
        async for chunk in provider.chat_stream({**request, "model": model}):
            yield chunk

    async def embed(self, texts: list[str], model: str | None = None
                    ) -> list[list[float]]:
        provider, resolved = self.resolve(model or self.default_embed_model)
        return await provider.embed(texts, model=resolved)

    async def classify(self, texts: list[str]) -> list[float]:
        """Harm scores via the first provider exposing a classifier head."""
        for provider in self._providers.values():
            classify = getattr(provider, "classify", None)
            if classify is not None:
                return await classify(texts)
        raise LLMError("No provider supports classification")

    async def shutdown(self) -> None:
        for provider in self._providers.values():
            try:
                await provider.shutdown()
            except Exception:
                pass


def make_chat_response(model: str, text: str, prompt_tokens: int = 0,
                       completion_tokens: int = 0,
                       finish_reason: str = "stop",
                       tool_calls: list[dict[str, Any]] | None = None
                       ) -> dict[str, Any]:
    message: dict[str, Any] = {"role": "assistant", "content": text}
    if tool_calls:
        # OpenAI wire shape: content null, calls carried structurally,
        # finish_reason tells the client to execute and continue
        message = {"role": "assistant", "content": None,
                   "tool_calls": tool_calls}
        finish_reason = "tool_calls"
    return {
        "id": f"chatcmpl-{new_id()[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": message,
            "finish_reason": finish_reason,
        }],
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
        },
    }
