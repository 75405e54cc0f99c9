"""The interactive chat agent with native OpenAI function calling (a copy of
the JAX package's ``services/chat_service.py``, which runs the BASELINE's
federated multi-tool ReAct loop):

- the gateway's tool catalog, scoped to the session's virtual server if it
  names one, goes to the model as an OpenAI ``tools`` array, and the model
  answers with ``tool_calls`` (streamed whole by the app's engine, or as
  indexed fragments by a pass-through provider);
- tool calls run through ``ToolService.invoke_tool`` (the plugin chain
  included), a step's calls concurrently; their results are ``tool``
  messages in call order;
- tokens stream as events as they decode;
- sessions live in the coordination KV store, so that with a tcp or file
  bus any worker continues a session.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Any, AsyncIterator

from ..coordination.kv import KVStore, MemoryKVStore
from ..utils.ids import new_id
from .base import AppContext, NotFoundError, ValidationFailure

SYSTEM_PROMPT = ("You are a helpful tool-using assistant. Prefer calling the "
                 "available functions to look up facts; answer directly when "
                 "no function applies.")


@dataclass
class ChatSession:
    id: str
    user: str
    model: str | None = None
    server_id: str | None = None   # restricts the tools to a virtual server
    max_steps: int = 5
    messages: list[dict[str, Any]] = field(default_factory=list)
    created: float = field(default_factory=time.time)
    last_used: float = field(default_factory=time.time)


def merge_tool_call_fragments(calls_by_index: dict[int, dict[str, Any]],
                              fragments: list[dict[str, Any]], last_idx: int) -> int:
    """Merge one delta's ``tool_calls`` fragments into ``calls_by_index``;
    returns the index of the call the last fragment touched. OpenAI streams
    a call as fragments keyed by ``index``: the first carries its id and
    name, later ones append to its arguments. A fragment without an index
    continues the current call, unless it carries an id or a name: then it
    opens a new call at the next unused index (not the count of calls, which
    collides with sparse explicit indices)."""
    for frag in fragments:
        idx = frag.get("index")
        if idx is None:
            fn0 = frag.get("function") or {}
            if frag.get("id") or fn0.get("name"):
                idx = max(calls_by_index, default=-1) + 1
            else:
                idx = last_idx
        last_idx = idx
        call = calls_by_index.setdefault(
            idx, {"id": "", "type": "function", "function": {"name": "", "arguments": ""}})
        if frag.get("id"):
            call["id"] = frag["id"]
        fn = frag.get("function", {})
        if fn.get("name"):
            call["function"]["name"] = fn["name"]
        if fn.get("arguments"):
            call["function"]["arguments"] += fn["arguments"]
    return last_idx


class ChatService:
    def __init__(self, ctx: AppContext, tool_service, server_service,
                 kv: KVStore | None = None, session_ttl: float = 3600.0):
        self.ctx = ctx
        self.tools = tool_service
        self.servers = server_service
        self._kv = kv if kv is not None else MemoryKVStore()
        self.session_ttl = session_ttl

    # ------------------------------------------------------------- sessions

    @staticmethod
    def _key(session_id: str) -> str:
        return f"chat:{session_id}"

    async def _save(self, session: ChatSession) -> None:
        await self._kv.set(self._key(session.id), asdict(session), ttl=self.session_ttl)

    async def connect(self, user: str, model: str | None = None,
                      server_id: str | None = None,
                      max_steps: int | None = None) -> ChatSession:
        if max_steps is None:   # an explicit request wins over the setting
            max_steps = getattr(getattr(self.ctx, "settings", None),
                                "llmchat_max_steps", 5) or 5
        session = ChatSession(id=new_id(), user=user, model=model,
                              server_id=server_id, max_steps=max_steps)
        await self._save(session)
        return session

    async def get_session(self, session_id: str, user: str) -> ChatSession:
        raw = await self._kv.get(self._key(session_id))
        if raw is None or raw.get("user") != user:
            raise NotFoundError("Chat session not found")
        session = ChatSession(**raw)
        session.last_used = time.time()
        return session

    async def disconnect(self, session_id: str, user: str) -> None:
        raw = await self._kv.get(self._key(session_id))
        if raw is not None and raw.get("user") == user:
            await self._kv.delete(self._key(session_id))

    # ----------------------------------------------------------------- chat

    async def _tool_defs(self, session: ChatSession,
                         auth_teams: list[str]) -> list[dict[str, Any]]:
        tools = await self.tools.list_tools(team_ids=auth_teams)
        if session.server_id:
            allowed = set(await self.servers.server_tool_names(session.server_id))
            tools = [t for t in tools if t.name in allowed]
        return [{"type": "function",
                 "function": {"name": t.name,
                              "description": t.description or "",
                              "parameters": t.input_schema
                              or {"type": "object", "properties": {}}}}
                for t in tools]

    async def _run_tool(self, call: dict[str, Any], user: str) -> dict[str, Any]:
        """Run ONE tool call; returns the OpenAI ``tool`` message."""
        fn = call.get("function", {})
        try:
            arguments = json.loads(fn.get("arguments") or "{}")
        except json.JSONDecodeError:
            arguments = {}
        try:
            result = await self.tools.invoke_tool(fn.get("name", ""), arguments, user=user)
            observation = _result_text(result)[:4000]
        except Exception as exc:
            observation = f"ERROR: {type(exc).__name__}: {exc}"
        return {"role": "tool", "tool_call_id": call.get("id", ""), "content": observation}

    async def chat(self, session_id: str, user: str, text: str,
                   auth_teams: list[str] | None = None) -> AsyncIterator[dict[str, Any]]:
        """Run one user turn; yields events
        {type: token|tool_call|tool_result|answer|error, ...}."""
        registry = self.ctx.llm_registry
        if registry is None:
            raise ValidationFailure("tpu_local engine is not enabled")
        session = await self.get_session(session_id, user)
        tools = await self._tool_defs(session, auth_teams or [])
        session.messages.append({"role": "user", "content": text})

        with self.ctx.tracer.span("llmchat.turn", {
                "session": session.id, "user": user,
                "gen_ai.request.model": session.model or "default",
                "llm.tools_offered": len(tools)}) as turn_span:
            # stub tracers' spans may lack set_attribute
            set_attr = getattr(turn_span, "set_attribute", lambda *a: None)
            total_tool_calls = 0
            for step in range(session.max_steps):
                request = {
                    "model": session.model,
                    "messages": [{"role": "system", "content": SYSTEM_PROMPT},
                                 *session.messages],
                    "tools": tools,
                    "max_tokens": 512,
                    "temperature": 0.0,
                }
                content_parts: list[str] = []
                calls_by_index: dict[int, dict[str, Any]] = {}
                last_idx = 0
                usage: dict[str, Any] = {}
                async for chunk in registry.chat_stream(request):
                    usage = chunk.get("usage") or usage
                    for choice in chunk.get("choices", []):
                        delta = choice.get("delta", {})
                        piece = delta.get("content")
                        if piece:
                            content_parts.append(piece)
                            yield {"type": "token", "text": piece}
                        last_idx = merge_tool_call_fragments(
                            calls_by_index, delta.get("tool_calls", []), last_idx)
                tool_calls = [calls_by_index[i] for i in sorted(calls_by_index)]
                reply = "".join(content_parts)

                if not tool_calls:
                    session.messages.append({"role": "assistant", "content": reply})
                    await self._save(session)
                    set_attr("llm.steps", step + 1)
                    set_attr("llm.tool_calls", total_tool_calls)
                    yield {"type": "answer", "text": reply, "usage": usage}
                    return

                total_tool_calls += len(tool_calls)
                for call in tool_calls:
                    fn = call.get("function", {})
                    yield {"type": "tool_call", "id": call.get("id"), "tool": fn.get("name"),
                           "arguments": fn.get("arguments"), "step": step}
                session.messages.append({"role": "assistant", "content": reply or None,
                                         "tool_calls": tool_calls})
                # a step's calls run concurrently; results append in call
                # order, so tool_call_id pairing stays deterministic
                results = await asyncio.gather(
                    *[self._run_tool(call, user) for call in tool_calls])
                for call, message in zip(tool_calls, results):
                    yield {"type": "tool_result", "id": call.get("id"),
                           "tool": call.get("function", {}).get("name"),
                           "text": message["content"][:500], "step": step}
                    session.messages.append(message)
                await self._save(session)
            # max_steps exhausted: the span still carries the counters
            set_attr("llm.steps", session.max_steps)
            set_attr("llm.tool_calls", total_tool_calls)
            yield {"type": "error", "message": f"Agent exceeded {session.max_steps} steps"}


def _result_text(result: dict[str, Any]) -> str:
    parts = []
    for item in result.get("content", []):
        if isinstance(item, dict) and item.get("type") == "text":
            parts.append(item.get("text", ""))
    return "\n".join(parts)
