"""Plugin framework: hooks, modes, payload policies, manager (a copy of the
JAX package's ``plugins/framework.py``).

Twelve hook points and four modes: enforce / enforce_ignore_error /
permissive / disabled. The manager, not plugin code, enforces which fields
a plugin may replace per hook. Each hook's wall charges the request's
"plugins" phase and the ``plugin_duration`` histogram.
"""

from __future__ import annotations

import asyncio
import importlib
import logging
import time
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import TYPE_CHECKING, Any

from ..observability import phases as request_phases

if TYPE_CHECKING:
    from ..gateway.auth import AuthContext
    from ..services.base import AppContext

logger = logging.getLogger(__name__)


class HookType(str, Enum):
    TOOL_PRE_INVOKE = "tool_pre_invoke"
    TOOL_POST_INVOKE = "tool_post_invoke"
    PROMPT_PRE_FETCH = "prompt_pre_fetch"
    PROMPT_POST_FETCH = "prompt_post_fetch"
    RESOURCE_PRE_FETCH = "resource_pre_fetch"
    RESOURCE_POST_FETCH = "resource_post_fetch"
    AGENT_PRE_INVOKE = "agent_pre_invoke"
    AGENT_POST_INVOKE = "agent_post_invoke"
    HTTP_PRE_REQUEST = "http_pre_request"
    HTTP_POST_REQUEST = "http_post_request"
    HTTP_AUTH_RESOLVE_USER = "http_auth_resolve_user"
    HTTP_AUTH_CHECK_PERMISSION = "http_auth_check_permission"


class PluginMode(str, Enum):
    ENFORCE = "enforce"                      # violation blocks; errors block
    ENFORCE_IGNORE_ERROR = "enforce_ignore_error"  # violation blocks; errors skipped
    PERMISSIVE = "permissive"                # violations logged only
    DISABLED = "disabled"


class PluginViolation(Exception):
    """Raised by a plugin to block the request (enforce modes)."""

    def __init__(self, reason: str, code: str = "POLICY_VIOLATION",
                 details: dict[str, Any] | None = None):
        super().__init__(reason)
        self.reason = reason
        self.code = code
        self.details = details or {}


@dataclass
class PluginContext:
    """Per-call context handed to hooks."""

    user: str | None = None
    tool_name: str | None = None
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass
class PluginConfig:
    name: str
    kind: str  # import path "package.module.ClassName" or builtin short name
    mode: PluginMode = PluginMode.ENFORCE
    priority: int = 100  # lower runs first
    hooks: list[str] = field(default_factory=list)  # restrict; empty = all declared
    tools: list[str] = field(default_factory=list)  # condition: only these tools
    config: dict[str, Any] = field(default_factory=dict)


class Plugin:
    """Base class. Subclasses override the hooks they implement.

    Pre-hooks return a (possibly modified) payload dict or None (no change);
    raising PluginViolation blocks the call in enforce modes.
    """

    def __init__(self, config: PluginConfig, ctx: "AppContext | None" = None):
        self.config = config
        self.ctx = ctx

    async def initialize(self) -> None:  # optional async setup
        return None

    async def shutdown(self) -> None:
        return None

    # -- hook signatures (all optional) --
    async def tool_pre_invoke(self, name: str, arguments: dict[str, Any],
                              headers: dict[str, str], context: PluginContext
                              ) -> dict[str, Any] | None:
        return None

    async def tool_post_invoke(self, name: str, result: dict[str, Any],
                               context: PluginContext) -> dict[str, Any] | None:
        return None

    async def prompt_pre_fetch(self, name: str, arguments: dict[str, Any],
                               context: PluginContext) -> dict[str, Any] | None:
        return None

    async def prompt_post_fetch(self, name: str, result: dict[str, Any],
                                context: PluginContext) -> dict[str, Any] | None:
        return None

    async def resource_pre_fetch(self, uri: str, context: PluginContext) -> str | None:
        return None

    async def resource_post_fetch(self, uri: str, result: dict[str, Any],
                                  context: PluginContext) -> dict[str, Any] | None:
        return None

    async def agent_pre_invoke(self, agent: str, payload: dict[str, Any],
                               context: PluginContext) -> dict[str, Any] | None:
        return None

    async def agent_post_invoke(self, agent: str, result: Any,
                                context: PluginContext) -> Any | None:
        return None

    async def http_pre_request(self, method: str, path: str, headers: dict[str, str],
                               context: PluginContext) -> None:
        return None

    async def http_post_request(self, method: str, path: str, status: int,
                                context: PluginContext) -> None:
        return None

    async def http_auth_resolve_user(self, headers: dict[str, str]) -> "AuthContext | None":
        return None

    async def http_auth_check_permission(self, auth: "AuthContext",
                                         permission: str) -> bool | None:
        return None

    def implements(self, hook: HookType) -> bool:
        own = getattr(type(self), hook.value, None)
        base = getattr(Plugin, hook.value, None)
        if own is None or own is base:
            return False
        if self.config.hooks and hook.value not in self.config.hooks:
            return False
        return True


# Built-in plugin registry: short name -> import path (filled by builtin pkg)
BUILTIN_PLUGINS: dict[str, str] = {}


def register_builtin(name: str, path: str) -> None:
    BUILTIN_PLUGINS[name] = path


def _resolve_class(kind: str):
    path = BUILTIN_PLUGINS.get(kind, kind)
    module_name, _, class_name = path.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, class_name)


class PluginManager:
    """Loads plugins from YAML config; executes hook chains in priority order.

    Runtime enable/disable + mode overrides propagate over the event bus
    (reference: Redis pub/sub invalidation, plugins/__init__.py:40-110).
    """

    def __init__(self, ctx: "AppContext | None" = None):
        self.ctx = ctx
        self.plugins: list[Plugin] = []
        self._by_hook: dict[HookType, list[Plugin]] = {}

    @classmethod
    async def load(cls, ctx: "AppContext", config_path: str | None = None) -> "PluginManager":
        """A manager over the YAML config file (``plugin_config_file``) when
        it exists (PyYAML is imported only then, and its absence raises),
        subscribed to the ``plugins.control`` and
        ``plugins.bindings.changed`` bus topics."""
        from . import builtin  # noqa: F401 - populates BUILTIN_PLUGINS
        manager = cls(ctx)
        path = Path(config_path or ctx.settings.plugin_config_file)
        if path.exists():
            import yaml

            # one small config read before the gateway serves traffic
            raw = yaml.safe_load(path.read_text()) or {}
            for entry in raw.get("plugins", []):
                config = PluginConfig(
                    name=entry.get("name", entry.get("kind", "plugin")),
                    kind=entry["kind"],
                    mode=PluginMode(entry.get("mode", "enforce")),
                    priority=int(entry.get("priority", 100)),
                    hooks=list(entry.get("hooks", [])),
                    tools=list(entry.get("tools", [])),
                    config=dict(entry.get("config", {})),
                )
                await manager.add_plugin(config)
        if ctx.bus is not None:
            ctx.bus.subscribe("plugins.control", manager._on_control)

            async def _on_bindings_changed(topic, message):
                await manager.load_bindings()

            ctx.bus.subscribe("plugins.bindings.changed", _on_bindings_changed)
        return manager

    async def add_plugin(self, config: PluginConfig) -> Plugin:
        cls_ = _resolve_class(config.kind)
        plugin = cls_(config, self.ctx)
        await plugin.initialize()
        self.plugins.append(plugin)
        self._reindex()
        return plugin

    async def remove_plugin(self, name: str) -> bool:
        for plugin in list(self.plugins):
            if plugin.config.name == name:
                self.plugins.remove(plugin)
                try:
                    await plugin.shutdown()
                except Exception:
                    pass
                self._reindex()
                return True
        return False

    async def load_bindings(self) -> int:
        """(Re)load DB-backed plugin bindings (reference: per-tool/per-team
        bindings, db.py:6856/6932 + tool_plugin_binding_service). A binding
        instantiates a builtin under the name ``binding:<id>`` scoped to its
        tool; team/global scopes apply unscoped."""
        if self.ctx is None:
            return 0
        rows = await self.ctx.db.fetchall(
            "SELECT * FROM plugin_bindings WHERE enabled=1")
        # drop previously-loaded bindings, then re-add
        for plugin in list(self.plugins):
            if plugin.config.name.startswith("binding:"):
                await self.remove_plugin(plugin.config.name)
        import json as _json
        count = 0
        for row in rows:
            try:
                config = PluginConfig(
                    name=f"binding:{row['id']}",
                    kind=row["plugin_name"],
                    mode=PluginMode(row["mode"] or "enforce"),
                    tools=[row["scope_id"]] if row["scope_type"] == "tool"
                          and row["scope_id"] else [],
                    config=_json.loads(row["config"]) if row["config"] else {})
                await self.add_plugin(config)
                count += 1
            except Exception as exc:
                logger.warning("plugin binding %s failed to load: %s",
                               row["id"], exc)
        return count

    async def shutdown(self) -> None:
        for plugin in self.plugins:
            try:
                await plugin.shutdown()
            except Exception:
                pass

    def _reindex(self) -> None:
        self.plugins.sort(key=lambda p: p.config.priority)
        self._by_hook = {
            hook: [p for p in self.plugins
                   if p.config.mode != PluginMode.DISABLED and p.implements(hook)]
            for hook in HookType
        }

    async def _on_control(self, topic: str, message: dict[str, Any]) -> None:
        """Bus message: {"name": ..., "mode": "disabled"|...}."""
        name = message.get("name")
        mode = message.get("mode")
        for plugin in self.plugins:
            if plugin.config.name == name and mode:
                plugin.config.mode = PluginMode(mode)
        self._reindex()

    def has_hooks_for(self, hook: HookType) -> bool:
        return bool(self._by_hook.get(hook))

    def _chain(self, hook: HookType, tool_name: str | None = None) -> list[Plugin]:
        chain = self._by_hook.get(hook, [])
        if tool_name is not None:
            chain = [p for p in chain if not p.config.tools or tool_name in p.config.tools]
        return chain

    async def _run(self, plugin: Plugin, hook: HookType, coro) -> Any:
        started = time.monotonic()
        try:
            # per-request attribution: every hook's wall charges the
            # "plugins" phase of the flight-recorder clock (no-op when
            # no request is being recorded); self-time nesting keeps an
            # auth-resolve hook from double-counting inside "auth"
            with request_phases.phase("plugins"):
                return await coro
        except PluginViolation:
            if plugin.config.mode in (PluginMode.ENFORCE, PluginMode.ENFORCE_IGNORE_ERROR):
                raise
            logger.warning("plugin %s violation ignored (permissive)", plugin.config.name)
            return None
        except Exception as exc:
            if plugin.config.mode == PluginMode.ENFORCE:
                raise
            logger.warning("plugin %s error ignored: %s", plugin.config.name, exc)
            return None
        finally:
            if self.ctx is not None:
                self.ctx.metrics.plugin_duration.labels(
                    plugin=plugin.config.name, hook=hook.value).observe(
                    time.monotonic() - started)

    # ------------------------------------------------------------ hook chains
    # Payload policy is enforced here: each hook only lets plugins replace the
    # fields the reference policy allows (policy.py:23-44).

    async def tool_pre_invoke(self, name: str, arguments: dict[str, Any],
                              headers: dict[str, str], user: str | None = None
                              ) -> tuple[str, dict[str, Any], dict[str, str],
                                         dict[str, Any] | None, PluginContext]:
        """Returns (name, arguments, headers, early_result, context).

        A pre-hook may return {"result": ...} to short-circuit the invocation
        (e.g. a cache hit); the context threads through to post hooks."""
        context = PluginContext(user=user, tool_name=name)
        for plugin in self._chain(HookType.TOOL_PRE_INVOKE, name):
            out = await self._run(plugin, HookType.TOOL_PRE_INVOKE,
                                  plugin.tool_pre_invoke(name, arguments, headers, context))
            if out:
                if "result" in out:
                    return name, arguments, headers, out["result"], context
                name = out.get("name", name)
                arguments = out.get("arguments", arguments)
                headers = out.get("headers", headers)
        return name, arguments, headers, None, context

    async def tool_post_invoke(self, name: str, result: dict[str, Any],
                               user: str | None = None,
                               context: PluginContext | None = None) -> dict[str, Any]:
        context = context or PluginContext(user=user, tool_name=name)
        for plugin in self._chain(HookType.TOOL_POST_INVOKE, name):
            out = await self._run(plugin, HookType.TOOL_POST_INVOKE,
                                  plugin.tool_post_invoke(name, result, context))
            if out is not None:
                result = out
        return result

    async def prompt_pre_fetch(self, name: str, arguments: dict[str, Any],
                               user: str | None = None) -> tuple[str, dict[str, Any]]:
        context = PluginContext(user=user)
        for plugin in self._chain(HookType.PROMPT_PRE_FETCH):
            out = await self._run(plugin, HookType.PROMPT_PRE_FETCH,
                                  plugin.prompt_pre_fetch(name, arguments, context))
            if out:
                name = out.get("name", name)
                arguments = out.get("arguments", arguments)
        return name, arguments

    async def prompt_post_fetch(self, name: str, result: dict[str, Any],
                                user: str | None = None) -> dict[str, Any]:
        context = PluginContext(user=user)
        for plugin in self._chain(HookType.PROMPT_POST_FETCH):
            out = await self._run(plugin, HookType.PROMPT_POST_FETCH,
                                  plugin.prompt_post_fetch(name, result, context))
            if out is not None:
                result = out
        return result

    async def resource_pre_fetch(self, uri: str, user: str | None = None) -> str:
        context = PluginContext(user=user)
        for plugin in self._chain(HookType.RESOURCE_PRE_FETCH):
            out = await self._run(plugin, HookType.RESOURCE_PRE_FETCH,
                                  plugin.resource_pre_fetch(uri, context))
            if out:
                uri = out
        return uri

    async def resource_post_fetch(self, uri: str, result: dict[str, Any],
                                  user: str | None = None) -> dict[str, Any]:
        context = PluginContext(user=user)
        for plugin in self._chain(HookType.RESOURCE_POST_FETCH):
            out = await self._run(plugin, HookType.RESOURCE_POST_FETCH,
                                  plugin.resource_post_fetch(uri, result, context))
            if out is not None:
                result = out
        return result

    async def agent_pre_invoke(self, agent: str, payload: dict[str, Any],
                               user: str | None = None) -> dict[str, Any]:
        context = PluginContext(user=user)
        for plugin in self._chain(HookType.AGENT_PRE_INVOKE):
            out = await self._run(plugin, HookType.AGENT_PRE_INVOKE,
                                  plugin.agent_pre_invoke(agent, payload, context))
            if out is not None:
                payload = out
        return payload

    async def agent_post_invoke(self, agent: str, result: Any,
                                user: str | None = None) -> Any:
        context = PluginContext(user=user)
        for plugin in self._chain(HookType.AGENT_POST_INVOKE):
            out = await self._run(plugin, HookType.AGENT_POST_INVOKE,
                                  plugin.agent_post_invoke(agent, result, context))
            if out is not None:
                result = out
        return result

    async def http_pre_request(self, method: str, path: str, headers: dict[str, str],
                               user: str | None = None) -> None:
        context = PluginContext(user=user)
        for plugin in self._chain(HookType.HTTP_PRE_REQUEST):
            await self._run(plugin, HookType.HTTP_PRE_REQUEST,
                            plugin.http_pre_request(method, path, headers, context))

    async def http_post_request(self, method: str, path: str, status: int,
                                user: str | None = None) -> None:
        context = PluginContext(user=user)
        for plugin in self._chain(HookType.HTTP_POST_REQUEST):
            await self._run(plugin, HookType.HTTP_POST_REQUEST,
                            plugin.http_post_request(method, path, status, context))

    async def http_auth_resolve_user(self, headers: dict[str, str]) -> "AuthContext | None":
        for plugin in self._chain(HookType.HTTP_AUTH_RESOLVE_USER):
            out = await self._run(plugin, HookType.HTTP_AUTH_RESOLVE_USER,
                                  plugin.http_auth_resolve_user(headers))
            if out is not None:
                return out
        return None

    async def http_auth_check_permission(self, auth: "AuthContext",
                                         permission: str) -> bool | None:
        for plugin in self._chain(HookType.HTTP_AUTH_CHECK_PERMISSION):
            out = await self._run(plugin, HookType.HTTP_AUTH_CHECK_PERMISSION,
                                  plugin.http_auth_check_permission(auth, permission))
            if out is not None:
                return out
        return None
