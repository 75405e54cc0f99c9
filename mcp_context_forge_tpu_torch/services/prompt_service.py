"""The prompt registry (a copy of the JAX package's
``services/prompt_service.py``): CRUD over the ``prompts`` table (each write
publishes ``prompts.changed``; a template that does not compile is
refused), and ``render_prompt``, MCP ``prompts/get``: the required
arguments checked, the template rendered by jinja2's
``SandboxedEnvironment`` with ``StrictUndefined`` (a registered template
reaches no attribute or import), one user message; a federated prompt
without a template is the owning gateway's ``prompts/get``. A
``tool_metrics`` row (or the metrics buffer's entry) per render.
"""

from __future__ import annotations

from typing import Any

from jinja2 import StrictUndefined
from jinja2.sandbox import SandboxedEnvironment

from ..clients.mcp_client import MCPSession
from ..db.core import from_json, to_json
from ..schemas import PromptArgument, PromptCreate, PromptRead, PromptUpdate
from ..utils.ids import new_id
from .base import AppContext, ConflictError, NotFoundError, ValidationFailure, now
from .tool_service import _auth_headers

_env = SandboxedEnvironment(undefined=StrictUndefined, autoescape=False)


def _row_to_read(row: dict[str, Any]) -> PromptRead:
    return PromptRead(
        id=row["id"], name=row["name"], description=row["description"],
        template=row["template"],
        # unknown keys in a stored argument are ignored, as pydantic ignores them
        arguments=[PromptArgument.model_validate(a) for a in from_json(row["arguments"], [])],
        gateway_id=row["gateway_id"], enabled=bool(row["enabled"]),
        tags=from_json(row["tags"], []), team_id=row["team_id"],
        owner_email=row["owner_email"], visibility=row["visibility"],
        created_at=row["created_at"], updated_at=row["updated_at"],
    )


class PromptService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx

    async def register_prompt(self, prompt: PromptCreate) -> PromptRead:
        if len(prompt.template) > self.ctx.settings.max_prompt_size:
            raise ValidationFailure("prompt template too large")
        existing = await self.ctx.db.fetchone(
            "SELECT id FROM prompts WHERE name=? AND COALESCE(gateway_id,'')=?",
            (prompt.name, prompt.gateway_id or ""))
        if existing:
            raise ConflictError(f"Prompt {prompt.name!r} already exists")
        _env.from_string(prompt.template)  # compile check up-front
        pid = new_id()
        ts = now()
        await self.ctx.db.execute(
            "INSERT INTO prompts (id, name, description, template, arguments, gateway_id,"
            " enabled, tags, team_id, owner_email, visibility, created_at, updated_at)"
            " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (pid, prompt.name, prompt.description, prompt.template,
             to_json([a.model_dump() for a in prompt.arguments]), prompt.gateway_id,
             int(prompt.enabled), to_json(prompt.tags), prompt.team_id,
             prompt.owner_email, prompt.visibility, ts, ts))
        await self.ctx.bus.publish("prompts.changed", {"action": "register", "id": pid})
        return await self.get_prompt(pid)

    async def get_prompt(self, prompt_id: str) -> PromptRead:
        row = await self.ctx.db.fetchone("SELECT * FROM prompts WHERE id=?", (prompt_id,))
        if not row:
            raise NotFoundError(f"Prompt {prompt_id} not found")
        return _row_to_read(row)

    async def list_prompts(self, include_inactive: bool = False) -> list[PromptRead]:
        sql = "SELECT * FROM prompts"
        if not include_inactive:
            sql += " WHERE enabled=1"
        return [_row_to_read(r) for r in await self.ctx.db.fetchall(sql + " ORDER BY name")]

    async def update_prompt(self, prompt_id: str, update: PromptUpdate) -> PromptRead:
        row = await self.ctx.db.fetchone("SELECT * FROM prompts WHERE id=?", (prompt_id,))
        if not row:
            raise NotFoundError(f"Prompt {prompt_id} not found")
        fields = update.model_dump(exclude_unset=True)
        sets, params = [], []
        for key, value in fields.items():
            if key == "arguments":
                value = to_json(value)
            elif key == "tags":
                value = to_json(value)
            elif key == "enabled":
                value = int(value)
            elif key == "template" and value is not None:
                _env.from_string(value)
            sets.append(f"{key}=?")
            params.append(value)
        if sets:
            sets.append("updated_at=?")
            params.extend([now(), prompt_id])
            await self.ctx.db.execute(f"UPDATE prompts SET {', '.join(sets)} WHERE id=?", params)  # the columns are the update schema's field names
        await self.ctx.bus.publish("prompts.changed", {"action": "update", "id": prompt_id})
        return await self.get_prompt(prompt_id)

    async def delete_prompt(self, prompt_id: str) -> None:
        rows = await self.ctx.db.execute("SELECT id FROM prompts WHERE id=?", (prompt_id,))
        if not rows:
            raise NotFoundError(f"Prompt {prompt_id} not found")
        await self.ctx.db.execute("DELETE FROM prompts WHERE id=?", (prompt_id,))
        await self.ctx.bus.publish("prompts.changed", {"action": "delete", "id": prompt_id})

    async def render_prompt(self, name: str, arguments: dict[str, Any] | None = None
                            ) -> dict[str, Any]:
        """MCP ``prompts/get``: render to messages. Federated prompts proxy."""
        import time as _time

        started = _time.monotonic()
        try:
            result = await self._render_prompt(name, arguments)
        except Exception:
            await self._record_metric(name, (_time.monotonic() - started) * 1000,
                                      False)
            raise
        await self._record_metric(name, (_time.monotonic() - started) * 1000,
                                  True)
        return result

    async def _record_metric(self, name: str, duration_ms: float,
                             success: bool) -> None:
        """Per-entity invocation metrics (the upstream gateway's PromptMetric rows)."""
        buffer = self.ctx.extras.get("metrics_buffer")
        if buffer is not None:
            buffer.add(name, duration_ms, success, entity_type="prompt")
            return
        try:
            await self.ctx.db.execute(
                "INSERT INTO tool_metrics (tool_id, ts, duration_ms, success,"
                " entity_type) VALUES (?,?,?,?,'prompt')",
                (name, now(), duration_ms, int(success)))
        except Exception:
            pass

    async def _render_prompt(self, name: str,
                             arguments: dict[str, Any] | None = None
                             ) -> dict[str, Any]:
        row = await self.ctx.db.fetchone(
            "SELECT * FROM prompts WHERE name=? AND enabled=1"
            " ORDER BY gateway_id IS NOT NULL", (name,))
        if not row:
            raise NotFoundError(f"Prompt {name!r} not found")
        if row["gateway_id"] and not row["template"]:
            gateway = await self.ctx.db.fetchone("SELECT * FROM gateways WHERE id=?",
                                                 (row["gateway_id"],))
            if not gateway:
                raise NotFoundError("Owning gateway missing")
            headers = _auth_headers(gateway, self.ctx.settings.auth_encryption_secret)
            async with MCPSession(url=gateway["url"], transport=gateway["transport"],
                                  headers=headers,
                                  timeout=self.ctx.settings.federation_timeout,
                                  verify_ssl=not self.ctx.settings.skip_ssl_verify,
                                  client=self.ctx.http_client) as session:
                return await session.get_prompt(name, arguments)
        args = arguments or {}
        declared = from_json(row["arguments"], [])
        missing = [a["name"] for a in declared if a.get("required") and a["name"] not in args]
        if missing:
            raise ValidationFailure(f"Missing required prompt arguments: {missing}")
        try:
            text = _env.from_string(row["template"]).render(**args)
        except Exception as exc:
            raise ValidationFailure(f"Prompt render failed: {exc}") from exc
        return {
            "description": row["description"] or "",
            "messages": [{"role": "user", "content": {"type": "text", "text": text}}],
        }
