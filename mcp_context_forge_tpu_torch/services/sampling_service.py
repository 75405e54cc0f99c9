"""MCP ``sampling/createMessage`` and ``completion/complete`` (a copy of the
JAX package's ``services/sampling_service.py``): sampling is served by the
app's own engine through ``ctx.llm_registry``, not sent back to the client;
completion offers a prompt argument's stored suggestions, or the enabled
resource URIs under a prefix."""

from __future__ import annotations

from typing import Any

from ..db.core import from_json
from ..jsonrpc import INVALID_PARAMS, JSONRPCError
from .base import AppContext


class SamplingHandler:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx

    async def create_message(self, params: dict[str, Any],
                             user: str | None = None) -> dict[str, Any]:
        registry = self.ctx.llm_registry
        if registry is None:
            raise JSONRPCError(INVALID_PARAMS, "Sampling unavailable: tpu_local engine disabled")
        messages = params.get("messages", [])
        if not messages:
            raise JSONRPCError(INVALID_PARAMS, "sampling requires messages")
        chat_messages = []
        system = params.get("systemPrompt")
        if system:
            chat_messages.append({"role": "system", "content": system})
        for message in messages:
            content = message.get("content", {})
            text = content.get("text", "") if isinstance(content, dict) else str(content)
            chat_messages.append({"role": message.get("role", "user"), "content": text})
        response = await registry.chat({
            "messages": chat_messages,
            "max_tokens": int(params.get("maxTokens", 256)),
            "temperature": float(params.get("temperature", 0.0)),
        })
        choice = response["choices"][0]
        return {
            "role": "assistant",
            "content": {"type": "text", "text": choice["message"]["content"]},
            "model": response["model"],
            "stopReason": "endTurn" if choice.get("finish_reason") == "stop" else "maxTokens",
        }


class CompletionService:
    """Argument completion for prompts and resources (``completion/complete``)."""

    def __init__(self, ctx: AppContext):
        self.ctx = ctx

    async def complete(self, params: dict[str, Any]) -> dict[str, Any]:
        ref = params.get("ref", {})
        argument = params.get("argument", {})
        arg_name = argument.get("name", "")
        prefix = argument.get("value", "")
        values: list[str] = []
        if ref.get("type") == "ref/prompt":
            row = await self.ctx.db.fetchone(
                "SELECT arguments FROM prompts WHERE name=? AND enabled=1",
                (ref.get("name", ""),))
            if row:
                for arg in from_json(row["arguments"], []):
                    if arg.get("name") == arg_name:
                        values = [v for v in arg.get("suggestions", [])
                                  if str(v).startswith(prefix)]
        elif ref.get("type") == "ref/resource":
            rows = await self.ctx.db.fetchall(
                "SELECT uri FROM resources WHERE uri LIKE ? AND enabled=1 LIMIT 20",
                (prefix + "%",))
            values = [r["uri"] for r in rows]
        return {"completion": {"values": values[:100], "total": len(values),
                               "hasMore": len(values) > 100}}
