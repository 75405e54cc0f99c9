"""Virtual servers (a copy of the JAX package's ``services/server_service.py``):
named compositions of tools, resources and prompts exposed as one MCP
endpoint; ``server_tool_names`` scopes ``tools/list`` and ``tools/call``."""

from __future__ import annotations

from typing import Any

from ..db.core import from_json, to_json
from ..schemas import ServerCreate, ServerRead, ServerUpdate
from ..utils.ids import new_id
from .base import AppContext, ConflictError, NotFoundError, now


class ServerService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx

    async def _associations(self, server_id: str) -> tuple[list[str], list[str], list[str]]:
        tools = [r["tool_id"] for r in await self.ctx.db.fetchall(
            "SELECT tool_id FROM server_tools WHERE server_id=?", (server_id,))]
        resources = [r["resource_id"] for r in await self.ctx.db.fetchall(
            "SELECT resource_id FROM server_resources WHERE server_id=?", (server_id,))]
        prompts = [r["prompt_id"] for r in await self.ctx.db.fetchall(
            "SELECT prompt_id FROM server_prompts WHERE server_id=?", (server_id,))]
        return tools, resources, prompts

    async def _row_to_read(self, row: dict[str, Any]) -> ServerRead:
        tools, resources, prompts = await self._associations(row["id"])
        return ServerRead(
            id=row["id"], name=row["name"], description=row["description"],
            icon=row["icon"], associated_tools=tools, associated_resources=resources,
            associated_prompts=prompts, enabled=bool(row["enabled"]),
            tags=from_json(row["tags"], []), team_id=row["team_id"],
            owner_email=row["owner_email"], visibility=row["visibility"],
            created_at=row["created_at"], updated_at=row["updated_at"])

    async def register_server(self, server: ServerCreate) -> ServerRead:
        existing = await self.ctx.db.fetchone("SELECT id FROM servers WHERE name=?",
                                              (server.name,))
        if existing:
            raise ConflictError(f"Server {server.name!r} already exists")
        sid = new_id()
        ts = now()
        await self.ctx.db.execute(
            "INSERT INTO servers (id, name, description, icon, enabled, tags, team_id,"
            " owner_email, visibility, created_at, updated_at) VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            (sid, server.name, server.description, server.icon, int(server.enabled),
             to_json(server.tags), server.team_id, server.owner_email,
             server.visibility, ts, ts))
        await self._set_associations(sid, server.associated_tools,
                                     server.associated_resources, server.associated_prompts)
        await self.ctx.bus.publish("servers.changed", {"action": "register", "id": sid})
        return await self.get_server(sid)

    async def _set_associations(self, server_id: str, tools: list[str] | None,
                                resources: list[str] | None, prompts: list[str] | None) -> None:
        db = self.ctx.db
        if tools is not None:
            await db.execute("DELETE FROM server_tools WHERE server_id=?", (server_id,))
            for tid in tools:
                await db.execute("INSERT OR IGNORE INTO server_tools (server_id, tool_id)"
                                 " VALUES (?,?)", (server_id, tid))
        if resources is not None:
            await db.execute("DELETE FROM server_resources WHERE server_id=?", (server_id,))
            for rid in resources:
                await db.execute("INSERT OR IGNORE INTO server_resources (server_id, resource_id)"
                                 " VALUES (?,?)", (server_id, rid))
        if prompts is not None:
            await db.execute("DELETE FROM server_prompts WHERE server_id=?", (server_id,))
            for pid in prompts:
                await db.execute("INSERT OR IGNORE INTO server_prompts (server_id, prompt_id)"
                                 " VALUES (?,?)", (server_id, pid))

    async def get_server(self, server_id: str) -> ServerRead:
        row = await self.ctx.db.fetchone("SELECT * FROM servers WHERE id=?", (server_id,))
        if not row:
            raise NotFoundError(f"Server {server_id} not found")
        return await self._row_to_read(row)

    async def list_servers(self, include_inactive: bool = False) -> list[ServerRead]:
        sql = "SELECT * FROM servers"
        if not include_inactive:
            sql += " WHERE enabled=1"
        rows = await self.ctx.db.fetchall(sql + " ORDER BY name")
        return [await self._row_to_read(r) for r in rows]

    async def update_server(self, server_id: str, update: ServerUpdate) -> ServerRead:
        row = await self.ctx.db.fetchone("SELECT * FROM servers WHERE id=?", (server_id,))
        if not row:
            raise NotFoundError(f"Server {server_id} not found")
        fields = update.model_dump(exclude_unset=True)
        assoc_tools = fields.pop("associated_tools", None)
        assoc_resources = fields.pop("associated_resources", None)
        assoc_prompts = fields.pop("associated_prompts", None)
        sets, params = [], []
        for key, value in fields.items():
            if key == "tags":
                value = to_json(value)
            elif key == "enabled":
                value = int(value)
            sets.append(f"{key}=?")
            params.append(value)
        if sets:
            sets.append("updated_at=?")
            params.extend([now(), server_id])
            await self.ctx.db.execute(f"UPDATE servers SET {', '.join(sets)} WHERE id=?", params)  # column names: the schema's fields
        await self._set_associations(server_id, assoc_tools, assoc_resources, assoc_prompts)
        await self.ctx.bus.publish("servers.changed", {"action": "update", "id": server_id})
        return await self.get_server(server_id)

    async def delete_server(self, server_id: str) -> None:
        rows = await self.ctx.db.execute("SELECT id FROM servers WHERE id=?", (server_id,))
        if not rows:
            raise NotFoundError(f"Server {server_id} not found")
        await self.ctx.db.execute("DELETE FROM servers WHERE id=?", (server_id,))
        await self.ctx.bus.publish("servers.changed", {"action": "delete", "id": server_id})

    async def server_tool_names(self, server_id: str) -> list[str]:
        rows = await self.ctx.db.fetchall(
            "SELECT t.custom_name, t.original_name FROM tools t"
            " JOIN server_tools st ON st.tool_id = t.id WHERE st.server_id=? AND t.enabled=1",
            (server_id,))
        return [r["custom_name"] or r["original_name"] for r in rows]
