"""LLM providers behind the /v1 surface (copies of the JAX package's): the
errors the surface maps to HTTP statuses, the ``LLMProvider`` interface,
the outbound providers (``OpenAICompatProvider`` for OpenAI-shaped
endpoints; ``DialectProvider`` for the Azure OpenAI, Anthropic, Ollama,
Bedrock, Vertex and watsonx families, with each family's request builder
and response and stream translation), the registry that resolves a model
alias to its provider, and the OpenAI wire shapes the providers share.

The outbound providers load httpx and one verifying SSL context when they
are built (``utils/outbound.py``), as the JAX package imports httpx at
module load: the methods that post only make a client from them, so a
provider's first post pays no import and no CA-bundle load on the event
loop. ``services/llm_provider_service.py`` builds them from the provider
table off the loop."""

from __future__ import annotations

import json
import time
from abc import ABC, abstractmethod
from typing import Any, AsyncIterator

from ..utils import new_id
from ..utils.outbound import httpx_module, verified_context


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


class _OutboundProvider(LLMProvider):
    """A provider that posts over httpx: the module and the SSL context are
    loaded at construction, each post makes a client from them."""

    def __init__(self, timeout: float) -> None:
        self.timeout = timeout
        self._httpx = httpx_module()
        self._verify = verified_context()

    def _client(self):
        return self._httpx.AsyncClient(timeout=self.timeout, verify=self._verify)


class OpenAICompatProvider(_OutboundProvider):
    """Passthrough to an external OpenAI-compatible endpoint (openai,
    ollama's OpenAI route, groq, together, ...)."""

    provider_type = "openai_compatible"

    def __init__(self, name: str, api_base: str, api_key: str = "",
                 timeout: float = 120.0):
        super().__init__(timeout)
        self.name = name
        self.api_base = api_base.rstrip("/")
        self.api_key = api_key

    def _headers(self) -> dict[str, str]:
        headers = {"content-type": "application/json"}
        if self.api_key:
            headers["authorization"] = f"Bearer {self.api_key}"
        return headers

    async def chat(self, request: dict[str, Any]) -> dict[str, Any]:
        async with self._client() as client:
            resp = await client.post(f"{self.api_base}/chat/completions",
                                     json={**request, "stream": False},
                                     headers=self._headers())
            resp.raise_for_status()
            return resp.json()

    async def embed(self, texts: list[str], model: str | None = None) -> list[list[float]]:
        async with self._client() as client:
            resp = await client.post(f"{self.api_base}/embeddings",
                                     json={"input": texts, "model": model or "default"},
                                     headers=self._headers())
            resp.raise_for_status()
            data = resp.json().get("data", [])
            return [d["embedding"] for d in data]


class DialectProvider(_OutboundProvider):
    """Per-family request translation onto non-OpenAI provider APIs, and
    of their responses back (the gateway's own surface stays OpenAI-shaped
    either way).

    Families: ``azure_openai`` (deployment URL + api-key header),
    ``anthropic`` (/v1/messages, system extraction), ``ollama`` (native
    /api/chat with options), ``bedrock`` (Converse API; bearer API-key
    auth — SigV4 signing is the caller's proxy concern), ``google_vertex``
    (:generateContent contents/parts), ``watsonx`` (/ml/v1/text/chat with
    project_id). ``cohere``/``mistral``/``groq``/``together`` ride
    OpenAICompatProvider unchanged.

    config keys (per family): deployment, resource_name, api_version,
    anthropic_version, project, location, project_id, auth_header.
    """

    def __init__(self, name: str, dialect: str, api_base: str = "",
                 api_key: str = "", config: dict[str, Any] | None = None,
                 timeout: float = 120.0):
        if dialect not in ("azure_openai", "anthropic", "ollama", "bedrock",
                          "google_vertex", "watsonx"):
            raise LLMError(f"unknown provider dialect {dialect!r}")
        super().__init__(timeout)
        self.name = name
        self.provider_type = dialect
        self.dialect = dialect
        self.api_base = api_base.rstrip("/")
        self.api_key = api_key
        self.config = config or {}

    # ------------------------------------------------------------- builders

    def build_request(self, request: dict[str, Any]
                      ) -> tuple[str, dict[str, str], dict[str, Any]]:
        """OpenAI-shape request dict -> (url, headers, body) per family."""
        return getattr(self, f"_build_{self.dialect}")(request)

    @staticmethod
    def _split_system(messages: list[dict[str, Any]]
                      ) -> tuple[str, list[dict[str, Any]]]:
        system, rest = [], []
        for message in messages:
            if message.get("role") == "system":
                system.append(message.get("content") or "")
            else:
                rest.append(message)
        return "\n".join(system), rest

    def _build_azure_openai(self, request):
        deployment = (self.config.get("deployment")
                      or self.config.get("deployment_name")
                      or request.get("model", ""))
        api_version = self.config.get("api_version", "2024-02-15-preview")
        base = self.api_base
        if not base and self.config.get("resource_name"):
            base = f"https://{self.config['resource_name']}.openai.azure.com"
        url = (f"{base}/openai/deployments/{deployment}/chat/completions"
               f"?api-version={api_version}")
        headers = {"content-type": "application/json",
                   "api-key": self.api_key}
        body = {key: value for key, value in request.items()
                if key not in ("model", "stream")}
        return url, headers, body

    def _build_anthropic(self, request):
        url = f"{self.api_base or 'https://api.anthropic.com'}/v1/messages"
        headers = {"content-type": "application/json",
                   "x-api-key": self.api_key,
                   "anthropic-version": self.config.get("anthropic_version",
                                                        "2023-06-01")}
        system, messages = self._split_system(request.get("messages", []))
        body = {"model": request.get("model"),
                "messages": [{"role": m["role"], "content": m.get("content") or ""}
                             for m in messages],
                "max_tokens": request.get("max_tokens") or 4096}
        if system:
            body["system"] = system
        if request.get("temperature") is not None:
            body["temperature"] = request["temperature"]
        return url, headers, body

    def _build_ollama(self, request):
        url = f"{self.api_base or 'http://localhost:11434'}/api/chat"
        body = {"model": request.get("model"),
                "messages": [{"role": m["role"], "content": m.get("content") or ""}
                             for m in request.get("messages", [])],
                "stream": False}
        options = {}
        if request.get("temperature") is not None:
            options["temperature"] = request["temperature"]
        if request.get("max_tokens"):
            options["num_predict"] = request["max_tokens"]
        if options:
            body["options"] = options
        return url, {"content-type": "application/json"}, body

    def _build_bedrock(self, request):
        model_id = request.get("model", "")
        url = f"{self.api_base}/model/{model_id}/converse"
        headers = {"content-type": "application/json"}
        if self.api_key:  # Bedrock API keys ride Authorization: Bearer
            headers["authorization"] = f"Bearer {self.api_key}"
        system, messages = self._split_system(request.get("messages", []))
        body: dict[str, Any] = {
            "messages": [{"role": m["role"],
                          "content": [{"text": m.get("content") or ""}]}
                         for m in messages]}
        if system:
            body["system"] = [{"text": system}]
        inference: dict[str, Any] = {}
        if request.get("max_tokens"):
            inference["maxTokens"] = request["max_tokens"]
        if request.get("temperature") is not None:
            inference["temperature"] = request["temperature"]
        if inference:
            body["inferenceConfig"] = inference
        return url, headers, body

    def _build_google_vertex(self, request):
        project = self.config.get("project", "")
        location = self.config.get("location", "us-central1")
        model = request.get("model", "")
        url = (f"{self.api_base}/v1/projects/{project}/locations/{location}"
               f"/publishers/google/models/{model}:generateContent")
        headers = {"content-type": "application/json"}
        if self.api_key:
            headers["authorization"] = f"Bearer {self.api_key}"
        system, messages = self._split_system(request.get("messages", []))
        contents = [{"role": "model" if m["role"] == "assistant" else "user",
                     "parts": [{"text": m.get("content") or ""}]}
                    for m in messages]
        body: dict[str, Any] = {"contents": contents}
        if system:
            body["systemInstruction"] = {"parts": [{"text": system}]}
        generation: dict[str, Any] = {}
        if request.get("max_tokens"):
            generation["maxOutputTokens"] = request["max_tokens"]
        if request.get("temperature") is not None:
            generation["temperature"] = request["temperature"]
        if generation:
            body["generationConfig"] = generation
        return url, headers, body

    def _build_watsonx(self, request):
        version = self.config.get("api_version", "2024-05-31")
        url = f"{self.api_base}/ml/v1/text/chat?version={version}"
        headers = {"content-type": "application/json"}
        if self.api_key:
            headers["authorization"] = f"Bearer {self.api_key}"
        body = {"model_id": request.get("model"),
                "project_id": self.config.get("project_id", ""),
                "messages": request.get("messages", [])}
        if request.get("max_tokens"):
            body["max_tokens"] = request["max_tokens"]
        if request.get("temperature") is not None:
            body["temperature"] = request["temperature"]
        return url, headers, body

    # ----------------------------------------------------------- transforms

    def transform_response(self, model: str,
                           data: dict[str, Any]) -> dict[str, Any]:
        """Provider-family response -> OpenAI ChatCompletionResponse."""
        if self.dialect in ("azure_openai", "watsonx"):
            # both answer OpenAI-shaped chat choices already
            data.setdefault("model", model)
            return data
        if self.dialect == "anthropic":
            text = "".join(block.get("text", "")
                           for block in data.get("content", [])
                           if block.get("type") == "text")
            usage = data.get("usage", {})
            out = make_chat_response(
                model, text,
                prompt_tokens=usage.get("input_tokens", 0),
                completion_tokens=usage.get("output_tokens", 0),
                finish_reason={"end_turn": "stop", "max_tokens": "length"}.get(
                    data.get("stop_reason"), "stop"))
            return out
        if self.dialect == "ollama":
            return make_chat_response(
                model, (data.get("message") or {}).get("content", ""),
                prompt_tokens=data.get("prompt_eval_count", 0),
                completion_tokens=data.get("eval_count", 0),
                finish_reason="stop" if data.get("done") else "length")
        if self.dialect == "bedrock":
            message = ((data.get("output") or {}).get("message") or {})
            text = "".join(block.get("text", "")
                           for block in message.get("content", []))
            usage = data.get("usage", {})
            return make_chat_response(
                model, text,
                prompt_tokens=usage.get("inputTokens", 0),
                completion_tokens=usage.get("outputTokens", 0),
                finish_reason={"end_turn": "stop", "max_tokens": "length"}.get(
                    data.get("stopReason"), "stop"))
        if self.dialect == "google_vertex":
            candidates = data.get("candidates") or [{}]
            parts = ((candidates[0].get("content") or {}).get("parts") or [])
            text = "".join(part.get("text", "") for part in parts)
            usage = data.get("usageMetadata", {})
            return make_chat_response(
                model, text,
                prompt_tokens=usage.get("promptTokenCount", 0),
                completion_tokens=usage.get("candidatesTokenCount", 0),
                finish_reason={"STOP": "stop", "MAX_TOKENS": "length"}.get(
                    candidates[0].get("finishReason"), "stop"))
        raise LLMError(f"no transform for dialect {self.dialect!r}")

    async def chat(self, request: dict[str, Any]) -> dict[str, Any]:
        url, headers, body = self.build_request(request)
        async with self._client() as client:
            resp = await client.post(url, json=body, headers=headers)
            resp.raise_for_status()
            return self.transform_response(request.get("model", ""), resp.json())

    # ------------------------------------------------------------ streaming

    @staticmethod
    def _chunk(chunk_id: str, model: str, text: str | None,
               finish: str | None = None) -> dict[str, Any]:
        """One OpenAI stream chunk. ``chunk_id`` is per-STREAM: every
        delta of a completion must share the id (clients aggregate by it;
        same convention as tpu_provider.chat_stream)."""
        delta: dict[str, Any] = {}
        if text:
            delta = {"role": "assistant", "content": text}
        return {"id": chunk_id,
                "object": "chat.completion.chunk",
                "created": int(time.time()), "model": model,
                "choices": [{"index": 0, "delta": delta,
                             "finish_reason": finish}]}

    async def chat_stream(self, request: dict[str, Any]
                          ) -> AsyncIterator[dict[str, Any]]:
        """Streamed chat translated back to OpenAI chunk shape. Native per
        family:
        anthropic SSE content_block_delta events, ollama ndjson lines,
        azure/watsonx OpenAI-shaped SSE passthrough, bedrock ConverseStream
        AWS event-stream binary frames (utils/eventstream.py), vertex
        streamGenerateContent with ``alt=sse``.

        Invariant for ALL dialects: the stream terminates with a
        finish_reason chunk even when the upstream closes early —
        consumers key turn-end on the terminal chunk."""
        finished = False
        last_id: str | None = None
        async for chunk in self._dispatch_stream(request):
            last_id = chunk.get("id") or last_id
            for choice in chunk.get("choices", []):
                if choice.get("finish_reason"):
                    finished = True
            yield chunk
        if not finished:
            yield self._chunk(last_id or f"chatcmpl-{new_id()[:24]}",
                              request.get("model", ""), None, "stop")

    async def _dispatch_stream(self, request: dict[str, Any]
                               ) -> AsyncIterator[dict[str, Any]]:
        if self.dialect == "bedrock":
            async for chunk in self._bedrock_stream(request):
                yield chunk
            return
        if self.dialect == "google_vertex":
            async for chunk in self._vertex_stream(request):
                yield chunk
            return
        model = request.get("model", "")
        url, headers, body = self.build_request(request)
        if self.dialect == "watsonx":
            # watsonx streams on a SIBLING endpoint, not a body flag
            url = url.replace("/ml/v1/text/chat?", "/ml/v1/text/chat_stream?")
        body["stream"] = True
        chunk_id = f"chatcmpl-{new_id()[:24]}"
        async with self._client() as client:
            async with client.stream("POST", url, json=body,
                                     headers=headers) as resp:
                resp.raise_for_status()
                async for line in resp.aiter_lines():
                    line = line.strip()
                    if not line:
                        continue
                    if self.dialect == "ollama":       # ndjson, one obj/line
                        event = json.loads(line)
                        if event.get("error"):
                            raise LLMError(f"ollama stream: {event['error']}")
                        text = (event.get("message") or {}).get("content", "")
                        if text:
                            yield self._chunk(chunk_id, model, text)
                        if event.get("done"):
                            finish = ("length"
                                      if event.get("done_reason") == "length"
                                      else "stop")
                            yield self._chunk(chunk_id, model, None, finish)
                            return
                        continue
                    if not line.startswith("data:"):
                        continue                       # SSE comments/events
                    payload = line[5:].strip()
                    if payload == "[DONE]":
                        return
                    event = json.loads(payload)
                    if self.dialect == "anthropic":
                        kind = event.get("type")
                        if kind == "error":
                            # mid-stream abort (overloaded etc.): surface it
                            # — swallowing would masquerade as a clean,
                            # short completion
                            raise LLMError(
                                "anthropic stream error: "
                                f"{(event.get('error') or {}).get('type')}")
                        if kind == "content_block_delta":
                            text = (event.get("delta") or {}).get("text", "")
                            if text:
                                yield self._chunk(chunk_id, model, text)
                        elif kind == "message_delta":
                            stop = (event.get("delta") or {}).get("stop_reason")
                            if stop:
                                yield self._chunk(
                                    chunk_id, model, None,
                                    {"end_turn": "stop",
                                     "max_tokens": "length"}.get(stop, "stop"))
                        elif kind == "message_stop":
                            return
                    else:  # azure_openai / watsonx: OpenAI-shaped chunks
                        event.setdefault("model", model)
                        yield event

    async def _bedrock_stream(self, request: dict[str, Any]
                              ) -> AsyncIterator[dict[str, Any]]:
        """Bedrock ConverseStream: the sibling ``converse-stream`` endpoint
        answers application/vnd.amazon.eventstream binary frames; event
        payloads are JSON keyed by ``:event-type`` (contentBlockDelta /
        messageStop / metadata; exceptions ride ``:message-type``)."""
        from ..utils.eventstream import iter_frames

        model = request.get("model", "")
        url, headers, body = self.build_request(request)
        url = url.replace("/converse", "/converse-stream")
        chunk_id = f"chatcmpl-{new_id()[:24]}"
        async with self._client() as client:
            async with client.stream("POST", url, json=body,
                                     headers=headers) as resp:
                resp.raise_for_status()
                async for frame_headers, payload in iter_frames(
                        resp.aiter_bytes()):
                    if frame_headers.get(":message-type") == "exception":
                        raise LLMError(
                            "bedrock stream exception: "
                            f"{frame_headers.get(':exception-type')}")
                    event_type = frame_headers.get(":event-type")
                    event = json.loads(payload) if payload else {}
                    if event_type == "contentBlockDelta":
                        text = (event.get("delta") or {}).get("text", "")
                        if text:
                            yield self._chunk(chunk_id, model, text)
                    elif event_type == "messageStop":
                        yield self._chunk(
                            chunk_id, model, None,
                            {"end_turn": "stop", "max_tokens": "length"}.get(
                                event.get("stopReason"), "stop"))
                        return

    async def _vertex_stream(self, request: dict[str, Any]
                             ) -> AsyncIterator[dict[str, Any]]:
        """Vertex ``streamGenerateContent?alt=sse``: SSE lines each holding
        a GenerateContentResponse with incremental candidate parts."""
        model = request.get("model", "")
        url, headers, body = self.build_request(request)
        url = url.replace(":generateContent", ":streamGenerateContent")
        url += ("&" if "?" in url else "?") + "alt=sse"
        chunk_id = f"chatcmpl-{new_id()[:24]}"
        async with self._client() as client:
            async with client.stream("POST", url, json=body,
                                     headers=headers) as resp:
                resp.raise_for_status()
                finish: str | None = None
                async for line in resp.aiter_lines():
                    line = line.strip()
                    if not line.startswith("data:"):
                        continue
                    payload = line[5:].strip()
                    if payload == "[DONE]":
                        break
                    event = json.loads(payload)
                    candidates = event.get("candidates") or [{}]
                    parts = ((candidates[0].get("content") or {})
                             .get("parts") or [])
                    text = "".join(part.get("text", "") for part in parts)
                    if text:
                        yield self._chunk(chunk_id, model, text)
                    reason = candidates[0].get("finishReason")
                    if reason:
                        finish = {"STOP": "stop",
                                  "MAX_TOKENS": "length"}.get(reason, "stop")
                yield self._chunk(chunk_id, model, None, finish or "stop")


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
