"""The A2A (agent-to-agent) service (a copy of the JAX package's
``services/a2a_service.py``): agent CRUD over the ``a2a_agents`` table with
the ``a2a_max_agents`` cap; ``invoke_agent`` by name or slug, under the
``a2a.invoke`` span, with the UAID hop limit and the plugins'
``agent_pre_invoke``/``agent_post_invoke`` hooks, routed by agent type:

- ``tpu_local``: the app's own engine through ``ctx.llm_registry``, charged
  to the flight recorder's ``engine`` phase;
- ``openai``/``anthropic``: an OpenAI- or Anthropic-shaped chat POST to the
  agent's ``endpoint_url`` through ``ctx.http_client``, the decrypted key as
  its bearer token or ``x-api-key``;
- ``jsonrpc``/``custom``: A2A ``message/send`` with the
  ``x-contextforge-uaid-hop`` header one past the inbound hop.

Tasks (``a2a_tasks``) run an invocation in the background; a cancel aborts
the local run, or publishes ``a2a.task.cancel`` for the worker that owns it.
Cancelling the run does not abort an engine request it already submitted:
that request decodes to its end, as in the JAX package."""

from __future__ import annotations

import asyncio
import json
from typing import Any

from ..db.core import from_json, to_json
from ..observability.phases import phase
from ..schemas import A2AAgentCreate, A2AAgentRead
from ..utils.crypto import decrypt_field, encrypt_field
from ..utils.ids import new_id, slugify
from .base import AppContext, ConflictError, NotFoundError, ValidationFailure, now
from .tool_service import _auth_headers

MAX_UAID_HOPS = 3


def _row_to_read(row: dict[str, Any]) -> A2AAgentRead:
    return A2AAgentRead(
        id=row["id"], name=row["name"], slug=row["slug"],
        description=row["description"], endpoint_url=row["endpoint_url"],
        agent_type=row["agent_type"], protocol_version=row["protocol_version"],
        capabilities=from_json(row["capabilities"], {}),
        enabled=bool(row["enabled"]), reachable=bool(row["reachable"]),
        tags=from_json(row["tags"], []), team_id=row["team_id"],
        owner_email=row["owner_email"], visibility=row["visibility"],
        created_at=row["created_at"], updated_at=row["updated_at"])


def _task_row(row: dict[str, Any]) -> dict[str, Any]:
    out = dict(row)
    out["input"] = from_json(row["input"])
    out["output"] = from_json(row["output"])
    return out


class A2AService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx
        self._task_runs: dict[str, asyncio.Task] = {}
        self.ctx.bus.subscribe("a2a.task.cancel", self._on_task_cancel)

    # ------------------------------------------------------------------ CRUD

    async def register_agent(self, agent: A2AAgentCreate) -> A2AAgentRead:
        existing = await self.ctx.db.fetchone("SELECT id FROM a2a_agents WHERE name=?",
                                              (agent.name,))
        if existing:
            raise ConflictError(f"Agent {agent.name!r} already exists")
        cap = self.ctx.settings.a2a_max_agents
        if cap:
            count = await self.ctx.db.fetchone("SELECT COUNT(*) AS n FROM a2a_agents")
            if count and int(count["n"]) >= cap:
                raise ValidationFailure(
                    f"Agent registry is at capacity ({cap}; a2a_max_agents)")
        aid = new_id()
        ts = now()
        auth_value = (encrypt_field(agent.auth_value, self.ctx.settings.auth_encryption_secret)
                      if agent.auth_value else None)
        await self.ctx.db.execute(
            "INSERT INTO a2a_agents (id, name, slug, description, endpoint_url,"
            " agent_type, protocol_version, capabilities, config, auth_type,"
            " auth_value, enabled, tags, team_id, owner_email, visibility,"
            " created_at, updated_at) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (aid, agent.name, slugify(agent.name), agent.description,
             agent.endpoint_url, agent.agent_type, agent.protocol_version,
             to_json(agent.capabilities), to_json(agent.config), agent.auth_type,
             auth_value, int(agent.enabled), to_json(agent.tags), agent.team_id,
             agent.owner_email, agent.visibility, ts, ts))
        await self.ctx.bus.publish("a2a.changed", {"action": "register", "id": aid})
        return await self.get_agent(aid)

    async def get_agent(self, agent_id: str) -> A2AAgentRead:
        row = await self.ctx.db.fetchone("SELECT * FROM a2a_agents WHERE id=?", (agent_id,))
        if not row:
            raise NotFoundError(f"Agent {agent_id} not found")
        return _row_to_read(row)

    async def list_agents(self, include_inactive: bool = False) -> list[A2AAgentRead]:
        sql = "SELECT * FROM a2a_agents"
        if not include_inactive:
            sql += " WHERE enabled=1"
        return [_row_to_read(r) for r in await self.ctx.db.fetchall(sql + " ORDER BY name")]

    async def delete_agent(self, agent_id: str) -> None:
        rows = await self.ctx.db.execute("SELECT id FROM a2a_agents WHERE id=?", (agent_id,))
        if not rows:
            raise NotFoundError(f"Agent {agent_id} not found")
        await self.ctx.db.execute("DELETE FROM a2a_agents WHERE id=?", (agent_id,))
        await self.ctx.bus.publish("a2a.changed", {"action": "delete", "id": agent_id})

    async def toggle_agent(self, agent_id: str, enabled: bool) -> A2AAgentRead:
        await self.ctx.db.execute("UPDATE a2a_agents SET enabled=?, updated_at=? WHERE id=?",
                                  (int(enabled), now(), agent_id))
        return await self.get_agent(agent_id)

    # ------------------------------------------------------------- invocation

    async def _enabled_row(self, name: str) -> dict[str, Any]:
        row = await self.ctx.db.fetchone(
            "SELECT * FROM a2a_agents WHERE (name=? OR slug=?) AND enabled=1", (name, name))
        if not row:
            raise NotFoundError(f"Agent {name!r} not found")
        return row

    async def invoke_agent(self, name: str, payload: dict[str, Any],
                           user: str | None = None, hop: int = 0) -> Any:
        """Invoke by name or slug; payload normalized per agent type."""
        row = await self._enabled_row(name)
        if hop > MAX_UAID_HOPS:
            raise ValidationFailure(f"UAID hop limit exceeded ({hop})")
        pm = self.ctx.plugin_manager
        with self.ctx.tracer.span("a2a.invoke", {"agent.name": name,
                                                 "agent.type": row["agent_type"]}):
            if pm is not None:
                payload = await pm.agent_pre_invoke(name, payload, user=user)
            agent_type = row["agent_type"]
            if agent_type == "tpu_local":
                result = await self._invoke_tpu_local(row, payload)
            elif agent_type in ("openai", "anthropic"):
                result = await self._invoke_chat_provider(row, payload, agent_type)
            elif agent_type in ("jsonrpc", "custom"):
                result = await self._invoke_jsonrpc(row, payload, hop)
            else:
                raise ValidationFailure(f"Unknown agent type {agent_type!r}")
            if pm is not None:
                result = await pm.agent_post_invoke(name, result, user=user)
            await self._record_metric(row["id"], True)
            return result

    def _extract_messages(self, payload: dict[str, Any]) -> list[dict[str, Any]]:
        """A2A payload shapes as chat messages: ``messages`` as given, a v1
        ``message`` ({role, parts: [{kind: text, text}]}) or a plain string,
        a ``prompt``, else the payload's JSON as one user message."""
        if "messages" in payload:
            return payload["messages"]
        message = payload.get("message")
        if isinstance(message, dict):
            parts = message.get("parts", [])
            text = " ".join(p.get("text", "") for p in parts
                            if isinstance(p, dict) and p.get("kind") in ("text", None))
            return [{"role": message.get("role", "user"), "content": text}]
        if isinstance(message, str):
            return [{"role": "user", "content": message}]
        if "prompt" in payload:
            return [{"role": "user", "content": str(payload["prompt"])}]
        return [{"role": "user", "content": json.dumps(payload)}]

    async def _invoke_tpu_local(self, row: dict[str, Any],
                                payload: dict[str, Any]) -> dict[str, Any]:
        registry = self.ctx.llm_registry
        if registry is None:
            raise ValidationFailure("tpu_local engine is not enabled")
        config = from_json(row["config"], {})
        with phase("engine"):   # the flight recorder charges the engine, not residue
            response = await registry.chat({
                "model": config.get("model"),
                "messages": self._extract_messages(payload),
                "max_tokens": config.get("max_tokens", 256),
                "temperature": payload.get("temperature", config.get("temperature", 0.0)),
            })
        return self._as_a2a_reply(response["choices"][0]["message"]["content"])

    async def _invoke_chat_provider(self, row: dict[str, Any], payload: dict[str, Any],
                                    provider_kind: str) -> dict[str, Any]:
        """openai/anthropic-typed agents: a chat POST to ``endpoint_url``."""
        config = from_json(row["config"], {})
        auth = decrypt_field(row["auth_value"], self.ctx.settings.auth_encryption_secret) or {}
        headers = {"content-type": "application/json"}
        api_key = auth.get("api_key") or auth.get("token", "")
        if provider_kind == "anthropic":
            if api_key:
                headers["x-api-key"] = api_key
            headers["anthropic-version"] = "2023-06-01"
            body = {"model": config.get("model", "claude-3-5-sonnet-latest"),
                    "max_tokens": config.get("max_tokens", 256),
                    "messages": self._extract_messages(payload)}
            resp = await self.ctx.http_client.post(row["endpoint_url"], json=body,
                                                   headers=headers)
            resp.raise_for_status()
            data = resp.json()
            return self._as_a2a_reply("".join(b.get("text", "") for b in data.get("content", [])))
        if api_key:
            headers["authorization"] = f"Bearer {api_key}"
        body = {"model": config.get("model", "gpt-4o-mini"),
                "messages": self._extract_messages(payload),
                "max_tokens": config.get("max_tokens", 256)}
        resp = await self.ctx.http_client.post(row["endpoint_url"], json=body, headers=headers)
        resp.raise_for_status()
        data = resp.json()
        return self._as_a2a_reply(data["choices"][0]["message"]["content"])

    async def _invoke_jsonrpc(self, row: dict[str, Any], payload: dict[str, Any],
                              hop: int) -> Any:
        """JSON-RPC ``message/send`` (the A2A protocol) with the UAID hop."""
        headers = {"content-type": "application/json", "x-contextforge-uaid-hop": str(hop + 1)}
        headers.update(_auth_headers(row, self.ctx.settings.auth_encryption_secret))
        message = payload.get("message")
        if not (isinstance(message, dict) and "parts" in message):
            # a free-form payload becomes a v1 message
            if isinstance(message, str):
                text = message
            elif message is not None:
                text = json.dumps(message)
            else:
                text = json.dumps(payload)
            message = {"role": "user", "parts": [{"kind": "text", "text": text}],
                       "messageId": new_id()}
        body = {"jsonrpc": "2.0", "id": new_id()[:8], "method": "message/send",
                "params": {"message": message}}
        resp = await self.ctx.http_client.post(row["endpoint_url"], json=body, headers=headers,
                                               timeout=self.ctx.settings.tool_timeout)
        resp.raise_for_status()
        data = resp.json()
        if "error" in data:
            raise ValidationFailure(f"Agent error: {data['error']}")
        return data.get("result", data)

    # ------------------------------------------------------------- task store

    async def create_task(self, agent_name: str, payload: dict[str, Any],
                          user: str | None = None) -> dict[str, Any]:
        agent_id = (await self._enabled_row(agent_name))["id"]
        task_id = new_id()
        ts = now()
        await self.ctx.db.execute(
            "INSERT INTO a2a_tasks (id, agent_id, state, input, created_by,"
            " created_at, updated_at) VALUES (?,?,?,?,?,?,?)",
            (task_id, agent_id, "submitted", to_json(payload), user, ts, ts))

        async def _run() -> None:
            # submitted -> working is guarded: a cancel that landed first wins
            await self.ctx.db.execute(
                "UPDATE a2a_tasks SET state='working', updated_at=?"
                " WHERE id=? AND state='submitted'", (now(), task_id))
            current = await self.ctx.db.fetchone("SELECT state FROM a2a_tasks WHERE id=?",
                                                 (task_id,))
            if not current or current["state"] != "working":
                return
            try:
                # by the stored id: a rename between submit and run must not fail it
                agent_row = await self.ctx.db.fetchone("SELECT name FROM a2a_agents WHERE id=?",
                                                       (agent_id,))
                if not agent_row:
                    raise NotFoundError("Agent was deleted")
                result = await self.invoke_agent(agent_row["name"], payload, user=user)
                # a cancel (maybe from another worker) is not overwritten
                await self.ctx.db.execute(
                    "UPDATE a2a_tasks SET state='completed', output=?,"
                    " updated_at=? WHERE id=? AND state='working'",
                    (to_json(result), now(), task_id))
            except Exception as exc:
                await self.ctx.db.execute(
                    "UPDATE a2a_tasks SET state='failed', error=?, updated_at=?"
                    " WHERE id=? AND state='working'",
                    (f"{type(exc).__name__}: {exc}", now(), task_id))

        task = asyncio.get_running_loop().create_task(_run())
        self._task_runs[task_id] = task
        task.add_done_callback(lambda _: self._task_runs.pop(task_id, None))
        return await self.get_task(task_id)

    async def get_task(self, task_id: str) -> dict[str, Any]:
        row = await self.ctx.db.fetchone("SELECT * FROM a2a_tasks WHERE id=?", (task_id,))
        if not row:
            raise NotFoundError(f"Task {task_id} not found")
        return _task_row(row)

    async def list_tasks(self, agent_name: str | None = None,
                         limit: int = 100) -> list[dict[str, Any]]:
        if agent_name:
            rows = await self.ctx.db.fetchall(
                "SELECT t.* FROM a2a_tasks t JOIN a2a_agents a ON a.id=t.agent_id"
                " WHERE a.name=? OR a.slug=? ORDER BY t.created_at DESC LIMIT ?",
                (agent_name, agent_name, limit))
        else:
            rows = await self.ctx.db.fetchall(
                "SELECT * FROM a2a_tasks ORDER BY created_at DESC LIMIT ?", (limit,))
        return [_task_row(row) for row in rows]

    async def cancel_task(self, task_id: str) -> dict[str, Any]:
        run = self._task_runs.pop(task_id, None)
        if run is not None and not run.done():
            run.cancel()
        else:
            # the run may live on another worker: its owner aborts it
            await self.ctx.bus.publish("a2a.task.cancel", {"task_id": task_id})
        await self.ctx.db.execute(
            "UPDATE a2a_tasks SET state='cancelled', updated_at=? WHERE id=?"
            " AND state IN ('submitted','working')", (now(), task_id))
        return await self.get_task(task_id)

    async def _on_task_cancel(self, topic: str, message: dict[str, Any]) -> None:
        run = self._task_runs.pop(message.get("task_id", ""), None)
        if run is not None and not run.done():
            run.cancel()

    @staticmethod
    def _as_a2a_reply(text: str) -> dict[str, Any]:
        return {"message": {"role": "agent", "parts": [{"kind": "text", "text": text}],
                            "messageId": new_id()}}

    async def _record_metric(self, agent_id: str, success: bool) -> None:
        # the JAX service's metrics-buffer branch is left out: no port app
        # sets that buffer, and ToolService writes its rows the same way
        try:
            await self.ctx.db.execute(
                "INSERT INTO tool_metrics (tool_id, ts, duration_ms, success,"
                " entity_type) VALUES (?,?,?,?,'a2a')",
                (agent_id, now(), 0.0, int(success)))
        except Exception:
            pass
