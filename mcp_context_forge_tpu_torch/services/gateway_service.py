"""Federation (a copy of the JAX package's ``services/gateway_service.py``):
peer gateway registration, which connects over streamable HTTP or SSE, runs
``initialize`` and the tools/resources/prompts listings and keeps the peer's
catalog in the tables (``_activate``, ``_sync_catalog``); refresh; the
registration wizard's dry-run probe (``test_gateway``); and the
leader-gated health loop, which deactivates a peer after
``gateway_failure_threshold`` failed probes and reactivates it on recovery.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from ..clients.mcp_client import MCPSession
from ..db.core import from_json, to_json
from ..schemas import GatewayCreate, GatewayRead, GatewayUpdate
from ..utils.crypto import encrypt_field
from ..utils.ids import new_id
from .base import AppContext, ConflictError, NotFoundError, now

logger = logging.getLogger(__name__)


def _row_to_read(row: dict[str, Any]) -> GatewayRead:
    return GatewayRead(
        id=row["id"], name=row["name"], url=row["url"], description=row["description"],
        transport=row["transport"], auth_type=row["auth_type"],
        enabled=bool(row["enabled"]), reachable=bool(row["reachable"]),
        state=row["state"], capabilities=from_json(row["capabilities"], {}),
        last_seen=row["last_seen"], tags=from_json(row["tags"], []),
        team_id=row["team_id"], owner_email=row["owner_email"],
        visibility=row["visibility"], created_at=row["created_at"],
        updated_at=row["updated_at"],
    )


class GatewayService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx
        self._health_task: asyncio.Task | None = None

    # ------------------------------------------------------------------ CRUD

    async def register_gateway(self, gw: GatewayCreate, sync: bool = True) -> GatewayRead:
        """Insert as pending, then connect and sync the peer catalog:
        before returning by default, in a background task with
        ``sync=False``."""
        existing = await self.ctx.db.fetchone(
            "SELECT id FROM gateways WHERE name=? OR url=?", (gw.name, gw.url))
        if existing:
            raise ConflictError(f"Gateway {gw.name!r} (or URL) already registered")
        from ..utils.ssrf import ensure_url_allowed
        await ensure_url_allowed(self.ctx.settings, gw.url)
        gid = new_id()
        ts = now()
        auth_value = (encrypt_field(gw.auth_value, self.ctx.settings.auth_encryption_secret)
                      if gw.auth_value else None)
        await self.ctx.db.execute(
            "INSERT INTO gateways (id, name, url, description, transport, auth_type,"
            " auth_value, enabled, state, passthrough_headers, tags, team_id,"
            " owner_email, visibility, created_at, updated_at)"
            " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (gid, gw.name, gw.url, gw.description, gw.transport, gw.auth_type,
             auth_value, int(gw.enabled), "pending", to_json(gw.passthrough_headers),
             to_json(gw.tags), gw.team_id, gw.owner_email, gw.visibility, ts, ts),
        )
        if sync:
            await self._activate(gid)
        else:
            asyncio.get_running_loop().create_task(self._activate(gid))
        return await self.get_gateway(gid)

    async def get_gateway(self, gateway_id: str) -> GatewayRead:
        row = await self.ctx.db.fetchone("SELECT * FROM gateways WHERE id=?", (gateway_id,))
        if not row:
            raise NotFoundError(f"Gateway {gateway_id} not found")
        return _row_to_read(row)

    async def list_gateways(self, include_inactive: bool = False) -> list[GatewayRead]:
        sql = "SELECT * FROM gateways"
        if not include_inactive:
            sql += " WHERE enabled=1"
        return [_row_to_read(r) for r in await self.ctx.db.fetchall(sql + " ORDER BY name")]

    async def update_gateway(self, gateway_id: str, update: GatewayUpdate) -> GatewayRead:
        row = await self.ctx.db.fetchone("SELECT * FROM gateways WHERE id=?", (gateway_id,))
        if not row:
            raise NotFoundError(f"Gateway {gateway_id} not found")
        fields = update.model_dump(exclude_unset=True)
        if fields.get("url"):
            from ..utils.ssrf import ensure_url_allowed
            await ensure_url_allowed(self.ctx.settings, fields["url"])
        sets, params = [], []
        for key, value in fields.items():
            if key == "auth_value" and value is not None:
                value = encrypt_field(value, self.ctx.settings.auth_encryption_secret)
            elif key in ("passthrough_headers", "tags"):
                value = to_json(value)
            elif key == "enabled":
                value = int(value)
            sets.append(f"{key}=?")
            params.append(value)
        if sets:
            sets.append("updated_at=?")
            params.extend([now(), gateway_id])
            await self.ctx.db.execute(f"UPDATE gateways SET {', '.join(sets)} WHERE id=?", params)  # column names: the schema's fields
        await self.ctx.bus.publish("gateways.changed", {"action": "update", "id": gateway_id})
        return await self.get_gateway(gateway_id)

    async def delete_gateway(self, gateway_id: str) -> None:
        rows = await self.ctx.db.execute("SELECT id FROM gateways WHERE id=?", (gateway_id,))
        if not rows:
            raise NotFoundError(f"Gateway {gateway_id} not found")
        await self.ctx.db.execute("DELETE FROM gateways WHERE id=?", (gateway_id,))
        await self.ctx.bus.publish("gateways.changed", {"action": "delete", "id": gateway_id})

    # ------------------------------------------------------- connect + sync

    async def test_gateway(self, url: str, transport: str = "streamablehttp",
                           auth_type: str | None = None,
                           auth_value: str | None = None) -> dict[str, Any]:
        """Dry-run connectivity probe for the registration wizard: connect
        + initialize + count tools WITHOUT persisting anything, within
        ``gateway_validation_timeout``. Always returns
        a result dict — failures are data, not exceptions, so the UI can
        show them inline before the operator commits the registration."""
        if not url.lower().startswith(("http://", "https://")):
            return {"ok": False, "error": "URL must be http(s)"}
        from ..services.base import ValidationFailure
        from ..utils.ssrf import ensure_url_allowed
        try:
            await ensure_url_allowed(self.ctx.settings, url)
        except ValidationFailure as exc:
            return {"ok": False, "error": str(exc)}
        row = {"url": url, "transport": transport, "auth_type": auth_type,
               "auth_value": (encrypt_field(
                   auth_value, self.ctx.settings.auth_encryption_secret)
                   if auth_value else None),
               "passthrough_headers": None, "id": "", "name": "(test)"}
        started = time.monotonic()

        async def _probe() -> dict:
            async with await self._connect(row) as session:
                tools = await session.list_tools()
                return {
                    "ok": True,
                    "latency_ms": round(
                        (time.monotonic() - started) * 1000, 1),
                    "server_info": session.server_info,
                    "capabilities": sorted(session.capabilities),
                    "tool_count": len(tools),
                }

        try:
            return await asyncio.wait_for(
                _probe(), self.ctx.settings.gateway_validation_timeout)
        except Exception as exc:
            return {"ok": False,
                    "latency_ms": round((time.monotonic() - started) * 1000, 1),
                    "error": f"{type(exc).__name__}: {exc}"}

    async def _connect(self, row: dict[str, Any]) -> MCPSession:
        from ..observability.faults import fault_point
        from .tool_service import resolve_auth_headers
        # fault point federation.peer.request (scope = peer URL): the
        # connect/initialize leg — activation, health probes, and the
        # registration wizard all ride it, so an injected peer outage
        # degrades every federation surface the way a real one does
        act = fault_point("federation.peer.request", scope=row.get("url", ""))
        if act is not None:
            await act.async_apply()
        headers = await resolve_auth_headers(self.ctx, row)
        session = MCPSession(url=row["url"], transport=row["transport"], headers=headers,
                             timeout=self.ctx.settings.federation_timeout,
                             verify_ssl=not self.ctx.settings.skip_ssl_verify,
                             client=self.ctx.http_client)
        await session.connect()
        return session

    async def _activate(self, gateway_id: str) -> None:
        row = await self.ctx.db.fetchone("SELECT * FROM gateways WHERE id=?", (gateway_id,))
        if not row:
            return
        try:
            async with await self._connect(row) as session:
                tools = await session.list_tools()
                resources, prompts = [], []
                if session.capabilities.get("resources") is not None:
                    try:
                        resources = await session.list_resources()
                    except Exception:
                        pass
                if session.capabilities.get("prompts") is not None:
                    try:
                        prompts = await session.list_prompts()
                    except Exception:
                        pass
                await self._sync_catalog(gateway_id, session.capabilities, tools,
                                         resources, prompts)
            await self.ctx.db.execute(
                "UPDATE gateways SET state='active', reachable=1, failure_count=0,"
                " last_seen=?, updated_at=? WHERE id=?", (now(), now(), gateway_id))
            await self.ctx.bus.publish("gateways.changed", {"action": "activated", "id": gateway_id})
        except Exception as exc:
            logger.warning("gateway %s activation failed: %s", gateway_id, exc)
            await self.ctx.db.execute(
                "UPDATE gateways SET state='failed', reachable=0,"
                " failure_count=failure_count+1, updated_at=? WHERE id=?",
                (now(), gateway_id))
            await self.ctx.bus.publish("gateways.changed", {"action": "failed", "id": gateway_id})

    async def _sync_catalog(self, gateway_id: str, capabilities: dict[str, Any],
                            tools: list[dict[str, Any]], resources: list[dict[str, Any]],
                            prompts: list[dict[str, Any]]) -> None:
        """Upsert the peer's tools/resources/prompts locally; tools the
        peer no longer lists are deleted."""
        db = self.ctx.db
        ts = now()
        await db.execute("UPDATE gateways SET capabilities=? WHERE id=?",
                         (to_json(capabilities), gateway_id))
        seen = []
        for tool in tools:
            tname = tool.get("name", "")
            if not tname:
                continue
            seen.append(tname)
            await db.execute(
                "INSERT INTO tools (id, original_name, description, integration_type,"
                " input_schema, output_schema, annotations, gateway_id, enabled,"
                " created_at, updated_at) VALUES (?,?,?,?,?,?,?,?,?,?,?)"
                " ON CONFLICT(original_name, COALESCE(gateway_id,'')) DO UPDATE SET"
                " description=excluded.description, input_schema=excluded.input_schema,"
                " output_schema=excluded.output_schema, annotations=excluded.annotations,"
                " updated_at=excluded.updated_at",
                (new_id(), tname, tool.get("description"), "MCP",
                 to_json(tool.get("inputSchema", {})),
                 to_json(tool.get("outputSchema")) if tool.get("outputSchema") else None,
                 to_json(tool.get("annotations", {})), gateway_id, 1, ts, ts))
        if seen:
            marks = ",".join("?" for _ in seen)
            await db.execute(
                f"DELETE FROM tools WHERE gateway_id=? AND original_name NOT IN ({marks})",
                [gateway_id, *seen])
        else:
            await db.execute("DELETE FROM tools WHERE gateway_id=?", (gateway_id,))
        for res in resources:
            await db.execute(
                "INSERT INTO resources (id, uri, name, description, mime_type, gateway_id,"
                " enabled, created_at, updated_at) VALUES (?,?,?,?,?,?,?,?,?)"
                " ON CONFLICT(uri, COALESCE(gateway_id,'')) DO UPDATE SET"
                " name=excluded.name, description=excluded.description,"
                " mime_type=excluded.mime_type, updated_at=excluded.updated_at",
                (new_id(), res.get("uri", ""), res.get("name", ""), res.get("description"),
                 res.get("mimeType"), gateway_id, 1, ts, ts))
        for prompt in prompts:
            await db.execute(
                "INSERT INTO prompts (id, name, description, template, arguments, gateway_id,"
                " enabled, created_at, updated_at) VALUES (?,?,?,?,?,?,?,?,?)"
                " ON CONFLICT(name, COALESCE(gateway_id,'')) DO UPDATE SET"
                " description=excluded.description, arguments=excluded.arguments,"
                " updated_at=excluded.updated_at",
                (new_id(), prompt.get("name", ""), prompt.get("description"), "",
                 to_json(prompt.get("arguments", [])), gateway_id, 1, ts, ts))
        await self.ctx.bus.publish("tools.changed", {"action": "sync", "gateway_id": gateway_id})

    # ------------------------------------------------------------ health loop

    async def start_health_loop(self) -> None:
        if self._health_task is None:
            self._health_task = asyncio.create_task(self._health_loop())

    async def stop_health_loop(self) -> None:
        if self._health_task is not None:
            self._health_task.cancel()
            try:
                await self._health_task
            except asyncio.CancelledError:
                pass
            self._health_task = None

    async def _health_loop(self) -> None:
        interval = self.ctx.settings.gateway_health_interval
        elector = self.ctx.extras.get("leader_elector")
        while True:
            try:
                if elector is None or elector.is_leader:
                    await self.check_health_of_gateways()
            except Exception as exc:
                logger.warning("health loop error: %s", exc)
            await asyncio.sleep(interval)

    async def check_health_of_gateways(self) -> dict[str, bool]:
        """Ping every enabled gateway; deactivate after threshold failures,
        reactivate on recovery."""
        rows = await self.ctx.db.fetchall("SELECT * FROM gateways WHERE enabled=1")
        results: dict[str, bool] = {}
        # bounded fan-out (max_concurrent_health_checks): N slow
        # peers must not serialize into an N*timeout sweep, but an
        # unbounded gather over hundreds of peers would burst sockets
        semaphore = asyncio.Semaphore(
            max(1, self.ctx.settings.max_concurrent_health_checks))

        async def probe(row) -> bool:
            async with semaphore:
                try:
                    async with await self._connect(row):
                        return True
                except Exception:
                    return False

        probed = await asyncio.gather(*[probe(row) for row in rows])
        from ..observability.degradation import get_degradation
        degradation = get_degradation()
        for row, ok in zip(rows, probed):
            results[row["id"]] = ok
            # health probes double as the federation breaker's recovery
            # evidence: a successful probe closes the peer's breaker so
            # proxied calls resume without waiting for live traffic
            breaker = degradation.breaker("federation", key=row["id"])
            if ok:
                breaker.record_success()
            else:
                breaker.record_failure("health probe failed")
            if ok:
                await self.ctx.db.execute(
                    "UPDATE gateways SET reachable=1, state='active', failure_count=0,"
                    " last_seen=?, updated_at=? WHERE id=?", (now(), now(), row["id"]))
                if not row["reachable"]:
                    await self.ctx.bus.publish("gateways.changed",
                                               {"action": "reactivated", "id": row["id"]})
            else:
                failures = row["failure_count"] + 1
                state = "failed" if failures >= self.ctx.settings.gateway_failure_threshold \
                    else row["state"]
                await self.ctx.db.execute(
                    "UPDATE gateways SET reachable=0, state=?, failure_count=?,"
                    " updated_at=? WHERE id=?", (state, failures, now(), row["id"]))
                if state == "failed" and row["state"] != "failed":
                    await self.ctx.bus.publish("gateways.changed",
                                               {"action": "deactivated", "id": row["id"]})
        return results

    async def refresh_gateway(self, gateway_id: str) -> GatewayRead:
        """Re-sync the peer catalog on demand."""
        await self._activate(gateway_id)
        return await self.get_gateway(gateway_id)
