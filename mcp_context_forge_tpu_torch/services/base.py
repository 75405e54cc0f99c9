"""The services' shared context and base helpers (a copy of the JAX
package's ``services/base.py``)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

from ..utils.ids import new_id

if TYPE_CHECKING:  # avoid import cycles
    from ..coordination.bus import EventBus
    from ..coordination.leases import LeaseManager
    from ..db import Database
    from ..observability.metrics import PrometheusRegistry
    from ..observability.tracing import Tracer
    from ..plugins.framework import PluginManager
    from ..tpu_local.provider import LLMProviderRegistry


class NotFoundError(Exception):
    pass


class ConflictError(Exception):
    pass


class ValidationFailure(Exception):
    pass


@dataclass
class AppContext:
    """The bundle handed to every service and plugin (built with the app)."""

    settings: Any
    db: "Database"
    bus: "EventBus"
    leases: "LeaseManager"
    tracer: "Tracer"
    metrics: "PrometheusRegistry"
    plugin_manager: "PluginManager | None" = None
    llm_registry: "LLMProviderRegistry | None" = None
    worker_id: str = field(default_factory=lambda: new_id()[:12])
    extras: dict[str, Any] = field(default_factory=dict)
    _http_client: Any = None
    _aiohttp_client: Any = None

    @property
    def http_client(self):
        """The shared outbound httpx pool: one SSL context and connection
        pool for every upstream call (a client per call costs ~25 ms). The
        app builds it at startup, in a worker thread (``utils/outbound.py``:
        httpx's import and the CA bundle's load stay off the loop)."""
        if self._http_client is None:
            from ..utils.outbound import httpx_module, verified_context
            from ..utils.sslctx import outbound_ssl

            httpx = httpx_module()
            ssl_ctx = outbound_ssl(self.settings)
            self._http_client = httpx.AsyncClient(
                timeout=httpx.Timeout(
                    self.settings.tool_timeout,
                    connect=self.settings.http_connect_timeout),
                verify=ssl_ctx if ssl_ctx is not None else verified_context(),
                limits=httpx.Limits(
                    max_connections=self.settings.http_max_connections,
                    max_keepalive_connections=self.settings.http_max_keepalive),
            )
        return self._http_client

    @property
    def aiohttp_client(self):
        """The shared aiohttp ClientSession of the REST hot path (lower
        per-request overhead than httpx)."""
        if self._aiohttp_client is None:
            import aiohttp

            from ..utils.sslctx import outbound_ssl

            ssl_arg = outbound_ssl(self.settings)
            self._aiohttp_client = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.settings.tool_timeout),
                connector=aiohttp.TCPConnector(
                    limit=self.settings.outbound_pool_limit,
                    limit_per_host=self.settings.outbound_pool_limit_per_host,
                    ssl=ssl_arg))
        return self._aiohttp_client

    async def close_http_client(self) -> None:
        if self._http_client is not None:
            await self._http_client.aclose()
            self._http_client = None
        if self._aiohttp_client is not None:
            await self._aiohttp_client.close()
            self._aiohttp_client = None


def now() -> float:
    return time.time()
