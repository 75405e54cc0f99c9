"""The ``tpu_local`` chat provider over the PyTorch engine: OpenAI chat
request dicts in, OpenAI responses or stream chunks out. ("tpu_local" is
the provider's name at the gateway, not a hardware claim.)"""

from __future__ import annotations

import time
from typing import Any, AsyncIterator

from ..utils import new_id
from .engine import GenRequest, TorchEngine
from .provider import make_chat_response
from .tokenizer import render_chat
from .tool_calls import parse_tool_calls


class TorchLocalProvider:
    provider_type = "tpu_local"

    def __init__(self, name: str, engine: TorchEngine):
        self.name = name
        self.engine = engine

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
        )

    @staticmethod
    def _wants_tools(request: dict[str, Any]) -> bool:
        return bool(request.get("tools")) and request.get("tool_choice") != "none"

    async def chat(self, request: dict[str, Any]) -> dict[str, Any]:
        gen = self._prepare(request)
        model = request.get("model", self.engine.config.model)
        await self.engine.submit(gen)
        tokens: list[int] = []
        while True:
            token = await gen.stream.get()
            if token is None:
                break
            tokens.append(token)
        text = self.engine.tokenizer.decode(tokens)
        tool_calls = parse_tool_calls(text) if self._wants_tools(request) else None
        return make_chat_response(
            model, text, prompt_tokens=len(gen.prompt_ids),
            completion_tokens=len(tokens),
            finish_reason=gen.finish_reason or "stop", tool_calls=tool_calls)

    async def chat_stream(self, request: dict[str, Any]
                          ) -> AsyncIterator[dict[str, Any]]:
        gen = self._prepare(request)
        model = request.get("model", self.engine.config.model)
        await self.engine.submit(gen)
        created = int(time.time())
        chunk_id = f"chatcmpl-{new_id()[:24]}"
        # a completion that OPENS with JSON is probably a tool call: buffer
        # it instead of streaming fragments; plain text streams as it comes
        buffering = self._wants_tools(request)
        emitted: list[str] = []
        pending: list[int] = []
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
                            yield self._chunk(chunk_id, created, model,
                                              {"content": chunk})
                        emitted = []
                    continue
                yield self._chunk(chunk_id, created, model, {"content": text})
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
