"""The resource registry (a copy of the JAX package's
``services/resource_service.py``): CRUD over the ``resources`` table (each
write publishes ``resources.changed``), ``read_resource`` (inline content
for a local row, the owning gateway's ``resources/read`` through
``clients/mcp_client.py`` for a federated one; a ``{var}`` template matches
a URI segment-wise), the templates listing, ``resources/subscribe``
rows, and a ``tool_metrics`` row (or the metrics buffer's entry) per
read.
"""

from __future__ import annotations

import base64
from typing import Any

from ..clients.mcp_client import MCPSession
from ..db.core import from_json, to_json
from ..schemas import ResourceCreate, ResourceRead, ResourceUpdate
from ..utils.ids import new_id
from .base import AppContext, ConflictError, NotFoundError, ValidationFailure, now
from .tool_service import _auth_headers


def _row_to_read(row: dict[str, Any]) -> ResourceRead:
    return ResourceRead(
        id=row["id"], uri=row["uri"], name=row["name"], description=row["description"],
        mime_type=row["mime_type"], uri_template=row["uri_template"], size=row["size"],
        gateway_id=row["gateway_id"], enabled=bool(row["enabled"]),
        tags=from_json(row["tags"], []), team_id=row["team_id"],
        owner_email=row["owner_email"], visibility=row["visibility"],
        created_at=row["created_at"], updated_at=row["updated_at"],
    )


class ResourceService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx

    async def register_resource(self, res: ResourceCreate) -> ResourceRead:
        existing = await self.ctx.db.fetchone(
            "SELECT id FROM resources WHERE uri=? AND COALESCE(gateway_id,'')=?",
            (res.uri, res.gateway_id or ""))
        if existing:
            raise ConflictError(f"Resource {res.uri!r} already exists")
        rid = new_id()
        ts = now()
        size = len(res.content.encode()) if res.content else None
        cap = self.ctx.settings.max_resource_size
        if cap and size and size > cap:
            raise ValidationFailure(
                f"Resource content is {size} bytes (max_resource_size {cap})")
        allowed_mimes = self.ctx.settings.allowed_resource_mime_types
        if allowed_mimes and res.mime_type \
                and res.mime_type not in allowed_mimes:
            raise ValidationFailure(
                f"mime_type {res.mime_type!r} not in "
                "allowed_resource_mime_types")
        await self.ctx.db.execute(
            "INSERT INTO resources (id, uri, name, description, mime_type, uri_template,"
            " content, is_binary, size, gateway_id, enabled, tags, team_id, owner_email,"
            " visibility, created_at, updated_at) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (rid, res.uri, res.name, res.description, res.mime_type, res.uri_template,
             res.content, int(res.is_binary), size, res.gateway_id, int(res.enabled),
             to_json(res.tags), res.team_id, res.owner_email, res.visibility, ts, ts))
        await self.ctx.bus.publish("resources.changed", {"action": "register", "id": rid})
        return await self.get_resource(rid)

    async def get_resource(self, resource_id: str) -> ResourceRead:
        row = await self.ctx.db.fetchone("SELECT * FROM resources WHERE id=?", (resource_id,))
        if not row:
            raise NotFoundError(f"Resource {resource_id} not found")
        return _row_to_read(row)

    async def list_resources(self, include_inactive: bool = False) -> list[ResourceRead]:
        sql = "SELECT * FROM resources"
        if not include_inactive:
            sql += " WHERE enabled=1"
        return [_row_to_read(r) for r in await self.ctx.db.fetchall(sql + " ORDER BY uri")]

    async def update_resource(self, resource_id: str, update: ResourceUpdate) -> ResourceRead:
        row = await self.ctx.db.fetchone("SELECT * FROM resources WHERE id=?", (resource_id,))
        if not row:
            raise NotFoundError(f"Resource {resource_id} not found")
        fields = update.model_dump(exclude_unset=True)
        sets, params = [], []
        for key, value in fields.items():
            if key == "tags":
                value = to_json(value)
            elif key == "enabled":
                value = int(value)
            sets.append(f"{key}=?")
            params.append(value)
            if key == "content" and value is not None:
                sets.append("size=?")
                params.append(len(str(value).encode()))
        if sets:
            sets.append("updated_at=?")
            params.extend([now(), resource_id])
            await self.ctx.db.execute(f"UPDATE resources SET {', '.join(sets)} WHERE id=?", params)  # the columns are the update schema's field names
        await self.ctx.bus.publish("resources.changed", {"action": "update", "id": resource_id,
                                                         "uri": row["uri"]})
        return await self.get_resource(resource_id)

    async def delete_resource(self, resource_id: str) -> None:
        rows = await self.ctx.db.execute("SELECT id FROM resources WHERE id=?", (resource_id,))
        if not rows:
            raise NotFoundError(f"Resource {resource_id} not found")
        await self.ctx.db.execute("DELETE FROM resources WHERE id=?", (resource_id,))
        await self.ctx.bus.publish("resources.changed", {"action": "delete", "id": resource_id})

    async def read_resource(self, uri: str,
                            request_headers: dict[str, str] | None = None) -> dict[str, Any]:
        """Return MCP ``resources/read`` contents for a URI.

        Local rows serve inline content; federated rows proxy to the owning
        gateway. Plugin resource hooks wrap this call at the dispatcher level.
        """
        import time as _time

        started = _time.monotonic()
        try:
            result = await self._read_resource(uri, request_headers)
        except Exception:
            await self._record_metric(uri, (_time.monotonic() - started) * 1000,
                                      False)
            raise
        await self._record_metric(uri, (_time.monotonic() - started) * 1000,
                                  True)
        return result

    async def _record_metric(self, uri: str, duration_ms: float,
                             success: bool) -> None:
        """Per-entity invocation metrics (the upstream gateway's ResourceMetric rows)."""
        perf = self.ctx.extras.get("perf_tracker")
        if perf is not None:
            perf.record("resource.read", duration_ms / 1000.0)
        buffer = self.ctx.extras.get("metrics_buffer")
        if buffer is not None:
            buffer.add(uri, duration_ms, success, entity_type="resource")
            return
        try:
            await self.ctx.db.execute(
                "INSERT INTO tool_metrics (tool_id, ts, duration_ms, success,"
                " entity_type) VALUES (?,?,?,?,'resource')",
                (uri, now(), duration_ms, int(success)))
        except Exception:
            pass

    async def _read_resource(self, uri: str,
                             request_headers: dict[str, str] | None = None
                             ) -> dict[str, Any]:
        row = await self.ctx.db.fetchone(
            "SELECT * FROM resources WHERE uri=? AND enabled=1 ORDER BY gateway_id IS NOT NULL",
            (uri,))
        if not row:
            row = await self._match_template(uri)
        if not row:
            raise NotFoundError(f"Resource {uri!r} not found")
        if row["gateway_id"]:
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
                return await session.read_resource(uri)
        content = row["content"] or ""
        entry: dict[str, Any] = {"uri": uri, "mimeType": row["mime_type"] or "text/plain"}
        if row["is_binary"]:
            entry["blob"] = content if _is_b64(content) else base64.b64encode(
                content.encode()).decode()
        else:
            entry["text"] = content
        return {"contents": [entry]}

    async def _match_template(self, uri: str) -> dict[str, Any] | None:
        """RFC6570-lite: match {var} templates segment-wise."""
        rows = await self.ctx.db.fetchall(
            "SELECT * FROM resources WHERE uri_template IS NOT NULL AND enabled=1")
        for row in rows:
            if _template_matches(row["uri_template"], uri):
                return row
        return None

    async def list_templates(self) -> list[dict[str, Any]]:
        rows = await self.ctx.db.fetchall(
            "SELECT * FROM resources WHERE uri_template IS NOT NULL AND enabled=1")
        return [{"uriTemplate": r["uri_template"], "name": r["name"],
                 "description": r["description"], "mimeType": r["mime_type"]} for r in rows]

    # subscriptions (resources/subscribe + notifications/resources/updated)
    async def subscribe(self, uri: str, session_id: str) -> None:
        await self.ctx.db.execute(
            "INSERT INTO resource_subscriptions (id, uri, session_id, created_at)"
            " VALUES (?,?,?,?)", (new_id(), uri, session_id, now()))

    async def unsubscribe(self, uri: str, session_id: str) -> None:
        await self.ctx.db.execute(
            "DELETE FROM resource_subscriptions WHERE uri=? AND session_id=?",
            (uri, session_id))

    async def subscribers(self, uri: str) -> list[str]:
        rows = await self.ctx.db.fetchall(
            "SELECT session_id FROM resource_subscriptions WHERE uri=?", (uri,))
        return [r["session_id"] for r in rows]


def _is_b64(s: str) -> bool:
    try:
        base64.b64decode(s, validate=True)
        return True
    except Exception:
        return False


def _template_matches(template: str, uri: str) -> bool:
    import re
    pattern = re.escape(template)
    pattern = re.sub(r"\\\{[^}]+\\\}", "[^/]+", pattern)
    return re.fullmatch(pattern, uri) is not None
