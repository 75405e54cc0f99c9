"""Pooled upstream MCP sessions (a copy of the JAX package's
``services/upstream_sessions.py``): one initialized session per (url,
transport, auth fingerprint) is reused across tools/calls instead of paying
``initialize`` and a connection each time. The pool is bounded, sessions
idle past ``idle_ttl`` are swept, and a session whose transport broke is
invalidated so that the next call reconnects.
"""

from __future__ import annotations

import asyncio
import hashlib
import time
from dataclasses import dataclass, field

from ..clients.mcp_client import MCPSession


@dataclass
class _Entry:
    session: MCPSession
    last_used: float = field(default_factory=time.monotonic)
    lock: asyncio.Lock = field(default_factory=asyncio.Lock)


class UpstreamSessionRegistry:
    SWEEP_INTERVAL = 60.0

    def __init__(self, ctx, max_sessions: int = 128, idle_ttl: float = 300.0):
        self.ctx = ctx
        self.max_sessions = max_sessions
        self.idle_ttl = idle_ttl
        self._entries: dict[str, _Entry] = {}
        self._lock = asyncio.Lock()
        self._sweeper: asyncio.Task | None = None

    async def start(self) -> None:
        if self._sweeper is None:
            async def _loop() -> None:
                while True:
                    await asyncio.sleep(self.SWEEP_INTERVAL)
                    try:
                        await self.sweep()
                    except Exception:
                        pass
            self._sweeper = asyncio.create_task(_loop())

    async def stop(self) -> None:
        if self._sweeper is not None:
            self._sweeper.cancel()
            try:
                await self._sweeper
            except asyncio.CancelledError:
                pass
            self._sweeper = None
        await self.close_all()

    @staticmethod
    def _key(url: str, transport: str, headers: dict[str, str]) -> str:
        fingerprint = hashlib.sha256(
            repr(sorted(headers.items())).encode()).hexdigest()[:16]
        return f"{transport}:{url}:{fingerprint}"

    async def acquire(self, url: str, transport: str,
                      headers: dict[str, str]) -> tuple[str, MCPSession]:
        key = self._key(url, transport, headers)
        async with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.last_used = time.monotonic()
                return key, entry.session
        session = MCPSession(url=url, transport=transport, headers=headers,
                             timeout=self.ctx.settings.tool_timeout,
                             verify_ssl=not self.ctx.settings.skip_ssl_verify,
                             client=self.ctx.http_client)
        await session.connect()
        evicted: MCPSession | None = None
        async with self._lock:
            existing = self._entries.get(key)
            if existing is not None:  # lost the race; use theirs
                evicted = session
                existing.last_used = time.monotonic()
                key_session = key, existing.session
            else:
                if len(self._entries) >= self.max_sessions:
                    evicted = self._pop_evictable_locked()
                self._entries[key] = _Entry(session)
                key_session = key, session
        if evicted is not None:  # network close outside the lock
            asyncio.get_running_loop().create_task(self._close_quietly(evicted))
        return key_session

    def _pop_evictable_locked(self) -> MCPSession | None:
        """Evict the LRU entry, but only if it has been idle a grace period —
        a session acquired moments ago may have a call in flight. Soft cap:
        when everything is hot we run over max_sessions briefly."""
        grace = 30.0
        now = time.monotonic()
        candidates = [(e.last_used, k) for k, e in self._entries.items()
                      if now - e.last_used > grace]
        if not candidates:
            return None
        _, oldest = min(candidates)
        return self._entries.pop(oldest).session

    @staticmethod
    async def _close_quietly(session: MCPSession) -> None:
        try:
            await session.close()
        except Exception:
            pass

    async def invalidate(self, key: str) -> None:
        async with self._lock:
            entry = self._entries.pop(key, None)
        if entry is not None:
            try:
                await entry.session.close()
            except Exception:
                pass

    async def sweep(self) -> None:
        cutoff = time.monotonic() - self.idle_ttl
        async with self._lock:
            stale = [k for k, e in self._entries.items() if e.last_used < cutoff]
            entries = [self._entries.pop(k) for k in stale]
        for entry in entries:
            try:
                await entry.session.close()
            except Exception:
                pass

    async def close_all(self) -> None:
        async with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for entry in entries:
            try:
                await entry.session.close()
            except Exception:
                pass
