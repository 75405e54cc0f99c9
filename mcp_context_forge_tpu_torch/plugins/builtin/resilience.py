"""Resilience and ops plugins (a copy of the JAX package's
``plugins/builtin/resilience.py``): ``circuit_breaker``,
``cached_tool_result``, ``watchdog`` and ``webhook_notification``.

The webhook sends the JAX plugin's POST, but not as JAX does it: JAX imports
httpx with the module and opens a new ``httpx.AsyncClient`` on the event
loop for every post (its import and its CA bundle's load stall the loop), and
keeps no reference to the task that posts. Here the post goes through the
app's shared ``ctx.http_client`` (built at startup, in a worker thread) when
there is an app context, and otherwise through one client of the plugin's
own, built in a worker thread through ``utils/outbound.py``; each task is
held until it ends and cancelled at shutdown.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import time
from typing import Any

from ...utils.outbound import httpx_module, verified_context
from ..framework import Plugin, PluginViolation

logger = logging.getLogger(__name__)


class CircuitBreakerPlugin(Plugin):
    """Opens a per-tool circuit after consecutive failures.

    config: {failure_threshold: 5, reset_seconds: 30}"""

    def __init__(self, config, ctx=None):
        super().__init__(config, ctx)
        self._failures: dict[str, int] = {}
        self._opened_at: dict[str, float] = {}

    async def tool_pre_invoke(self, name, arguments, headers, context):
        threshold = int(self.config.config.get("failure_threshold", 5))
        reset = float(self.config.config.get("reset_seconds", 30))
        opened = self._opened_at.get(name)
        if opened is not None:
            if time.monotonic() - opened < reset:
                raise PluginViolation(f"Circuit open for tool {name!r}",
                                      code="CIRCUIT_OPEN")
            self._opened_at.pop(name, None)   # half-open: allow a probe
            self._failures[name] = threshold - 1
        return None

    async def tool_post_invoke(self, name, result, context):
        if result.get("isError"):
            count = self._failures.get(name, 0) + 1
            self._failures[name] = count
            if count >= int(self.config.config.get("failure_threshold", 5)):
                self._opened_at[name] = time.monotonic()
        else:
            self._failures.pop(name, None)
        return None


class CachedToolResultPlugin(Plugin):
    """Exact-match result cache keyed on (tool, arguments).

    config: {ttl_seconds: 60, max_entries: 1024}"""

    def __init__(self, config, ctx=None):
        super().__init__(config, ctx)
        self._cache: dict[str, tuple[float, dict[str, Any]]] = {}

    def _key(self, name: str, arguments: dict[str, Any]) -> str:
        blob = json.dumps({"t": name, "a": arguments}, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()

    async def tool_pre_invoke(self, name, arguments, headers, context):
        import copy
        ttl = float(self.config.config.get("ttl_seconds", 60))
        entry = self._cache.get(self._key(name, arguments))
        if entry and time.monotonic() - entry[0] < ttl:
            context.metadata["cache_hit"] = True
            # deep copy: downstream post hooks mutate results in place
            return {"result": copy.deepcopy(entry[1])}
        context.metadata["cache_args"] = dict(arguments)
        return None

    async def tool_post_invoke(self, name, result, context):
        import copy
        if context.metadata.get("cache_hit"):
            return None
        args = context.metadata.get("cache_args")
        if args is not None and not result.get("isError"):
            max_entries = int(self.config.config.get("max_entries", 1024))
            if len(self._cache) >= max_entries:
                oldest = min(self._cache.items(), key=lambda kv: kv[1][0])[0]
                self._cache.pop(oldest, None)
            self._cache[self._key(name, args)] = (time.monotonic(), copy.deepcopy(result))
        return None


class WatchdogPlugin(Plugin):
    """Logs tool calls that exceed a latency budget.

    config: {max_ms: 5000}"""

    async def tool_pre_invoke(self, name, arguments, headers, context):
        context.metadata["watchdog_start"] = time.monotonic()
        return None

    async def tool_post_invoke(self, name, result, context):
        start = context.metadata.get("watchdog_start")
        if start is not None:
            elapsed_ms = (time.monotonic() - start) * 1000
            if elapsed_ms > float(self.config.config.get("max_ms", 5000)):
                logger.warning("watchdog: tool %s took %.0f ms", name, elapsed_ms)
        return None


class WebhookNotificationPlugin(Plugin):
    """Fire-and-forget POST to a webhook on tool completion.

    config: {url: str, events: ["success","error"]}"""

    def __init__(self, config, ctx=None):
        super().__init__(config, ctx)
        self._tasks: set[asyncio.Task] = set()  # strong refs: the loop holds tasks weakly
        self._client = None     # the plugin's own client, when there is no app context
        self._client_lock = asyncio.Lock()

    async def _poster(self):
        """The app's shared client, or the plugin's own: httpx's import and
        the client's SSL context are made in a worker thread, once."""
        if self.ctx is not None and hasattr(self.ctx, "http_client"):
            return self.ctx.http_client
        async with self._client_lock:
            if self._client is None:
                def build():
                    return httpx_module().AsyncClient(timeout=5.0, verify=verified_context())

                self._client = await asyncio.to_thread(build)
        return self._client

    async def tool_post_invoke(self, name, result, context):
        url = self.config.config.get("url")
        if not url:
            return None
        events = self.config.config.get("events", ["success", "error"])
        kind = "error" if result.get("isError") else "success"
        if kind not in events:
            return None
        body = {"tool": name, "event": kind, "user": context.user, "ts": time.time()}

        async def _fire() -> None:
            try:
                client = await self._poster()
                await client.post(url, json=body, timeout=5.0)
            except Exception as exc:
                logger.debug("webhook failed: %s", exc)

        task = asyncio.get_running_loop().create_task(_fire())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return None

    async def shutdown(self) -> None:
        tasks = list(self._tasks)
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        client, self._client = self._client, None
        if client is not None:
            await client.aclose()
