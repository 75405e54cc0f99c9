"""Audit trail + security events + SIEM export.

A copy of the JAX package's ``services/audit_service.py``.

Reference: `services/audit_trail_service.py` (+ `AuditTrail` db.py:6605),
`security_logger.py` (+ `SecurityEvent` db.py:6239), and
`siem_export_service.py` (1.3k LoC; OpenSearch bulk export). In-tree: one
service that records admin mutations + auth events into ``audit_trail`` and
ships batches to an optional SIEM HTTP sink (OpenSearch ``_bulk`` shape).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any

from ..db.core import to_json
from .base import AppContext, now

logger = logging.getLogger(__name__)


class AuditService:
    def __init__(self, ctx: AppContext, siem_url: str = "",
                 flush_interval: float = 30.0):
        self.ctx = ctx
        self.siem_url = siem_url
        self.flush_interval = flush_interval
        self._task: asyncio.Task | None = None
        self._cursor = 0

    async def record(self, actor: str | None, action: str,
                     entity_type: str | None = None, entity_id: str | None = None,
                     details: dict[str, Any] | None = None) -> None:
        try:
            await self.ctx.db.execute(
                "INSERT INTO audit_trail (ts, actor, action, entity_type,"
                " entity_id, details) VALUES (?,?,?,?,?,?)",
                (now(), actor, action, entity_type, entity_id,
                 to_json(details) if details else None))
        except Exception:  # auditing must never break the request
            logger.debug("audit write failed", exc_info=True)

    async def search(self, actor: str | None = None, action: str | None = None,
                     limit: int = 200) -> list[dict[str, Any]]:
        sql = "SELECT * FROM audit_trail"
        clauses, params = [], []
        if actor:
            clauses.append("actor=?")
            params.append(actor)
        if action:
            clauses.append("action LIKE ?")
            params.append(action + "%")
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        sql += " ORDER BY id DESC LIMIT ?"
        params.append(limit)
        return await self.ctx.db.fetchall(sql, params)

    # ------------------------------------------------------------ SIEM export

    async def start(self) -> None:
        if self.siem_url and self._task is None:
            row = await self.ctx.db.fetchone("SELECT COALESCE(MAX(id),0) AS m"
                                             " FROM audit_trail")
            self._cursor = int(row["m"]) if row else 0
            self._task = asyncio.create_task(self._export_loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _export_loop(self) -> None:
        while True:
            await asyncio.sleep(self.flush_interval)
            try:
                await self.export_once()
            except Exception as exc:
                logger.warning("SIEM export failed: %s", exc)

    async def export_once(self) -> int:
        rows = await self.ctx.db.fetchall(
            "SELECT * FROM audit_trail WHERE id > ? ORDER BY id LIMIT 500",
            (self._cursor,))
        if not rows:
            return 0
        # OpenSearch _bulk NDJSON shape
        lines = []
        for row in rows:
            lines.append(json.dumps({"index": {"_index": "mcpforge-audit"}}))
            lines.append(json.dumps(dict(row), default=str))
        body = "\n".join(lines) + "\n"
        resp = await self.ctx.http_client.post(
            self.siem_url.rstrip("/") + "/_bulk", content=body,
            headers={"content-type": "application/x-ndjson"})
        resp.raise_for_status()
        self._cursor = rows[-1]["id"]
        return len(rows)
