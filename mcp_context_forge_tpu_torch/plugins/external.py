"""External (out-of-process) plugins over stdio MCP (a copy of the JAX
package's ``plugins/external.py``).

- ``StdioPluginProcess`` spawns the plugin server as a subprocess and speaks
  newline-delimited JSON-RPC (MCP) on its stdio; it restarts a crashed
  server on the next call.
- ``ExternalPlugin`` (kind ``external``) is a framework ``Plugin`` whose hook
  methods forward to the subprocess as MCP ``tools/call`` with the hook name
  as the tool. Discovery: ``tools/list`` at initialize; the advertised tool
  names are the hooks the plugin implements.

Hook wire contract (the plugin server's tool result content[0].text is a
JSON object):
  {"continue": true}                          no change
  {"modified": {...hook payload fields...}}   rewrite (policy-checked by
                                              the manager like any plugin)
  {"violation": {"reason": ..., "code": ...}} block the request

Config (PluginConfig.config):
  command: ["python", "-m", "...plugins.servers.opa_policy", ...]   required
  cwd / env: optional spawn environment
  timeout_s: per-hook call timeout (default: the ``external_plugin_timeout``
             setting, 10 s)

The servers under ``plugins/servers/`` speak the same contract as the JAX
package's, so either package's host drives either package's servers.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Any

from .framework import HookType, Plugin, PluginConfig, PluginContext, PluginViolation

logger = logging.getLogger(__name__)


class StdioPluginProcess:
    """JSON-RPC over a subprocess's stdio, with crash restart.

    Requests are MULTIPLEXED over the pipe by JSON-RPC id: any number of
    hook calls may be in flight at once, a single reader task routes each
    response line to its waiter, so no call waits behind a slower one on
    the host's side. Whether calls actually overlap is then the SERVER's
    choice (the plugin-server SDK handles each request as its own task)."""

    def __init__(self, command: list[str], cwd: str | None = None,
                 env: dict[str, str] | None = None, timeout_s: float = 10.0):
        self.command = command
        self.cwd = cwd
        self.env = env
        self.timeout_s = timeout_s
        self._proc: asyncio.subprocess.Process | None = None
        self._next_id = 0
        self._futures: dict[int, asyncio.Future] = {}
        self._reader: asyncio.Task | None = None
        self._restart_lock = asyncio.Lock()  # serializes restart, not requests
        self._ready = False  # initialize handshake completed on this proc

    async def start(self) -> None:
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        self._proc = await asyncio.create_subprocess_exec(
            *self.command, cwd=self.cwd, env=env,
            stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL,
            # a modified tool_post_invoke payload comes back as ONE line;
            # the 64 KiB default would kill the reader (mirrors sdk.py)
            limit=64 * 1024 * 1024)
        self._reader = asyncio.ensure_future(self._read_loop(self._proc))

    async def stop(self) -> None:
        proc = self._proc
        self._proc = None
        reader = self._reader
        self._reader = None
        if reader is not None:
            reader.cancel()
            try:
                await reader
            except (asyncio.CancelledError, Exception):
                pass
        self._fail_pending(ConnectionError("external plugin process stopped"))
        if proc is not None and proc.returncode is None:
            proc.terminate()
            try:
                await asyncio.wait_for(proc.wait(), timeout=5.0)
            except asyncio.TimeoutError:
                proc.kill()
                await proc.wait()

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.returncode is None

    def _fail_pending(self, exc: Exception) -> None:
        for future in list(self._futures.values()):
            if not future.done():
                future.set_exception(exc)
        self._futures.clear()

    async def _read_loop(self, proc: asyncio.subprocess.Process) -> None:
        """Single consumer of the pipe: routes responses to waiters by id."""
        try:
            while True:
                line = await proc.stdout.readline()
                if not line:
                    break  # EOF — process exited
                try:
                    message = json.loads(line)
                except json.JSONDecodeError:
                    continue  # stray stdout noise from the plugin
                future = self._futures.pop(message.get("id"), None)
                if future is None or future.done():
                    continue
                if "error" in message:
                    future.set_exception(RuntimeError(
                        f"external plugin error: {message['error']}"))
                else:
                    future.set_result(message.get("result", {}))
        finally:
            if self._proc is proc:  # crash, not an orderly stop/restart
                self._fail_pending(
                    ConnectionError("external plugin process exited"))

    async def request(self, method: str,
                      params: dict[str, Any] | None = None) -> dict[str, Any]:
        if method == "initialize":
            # the explicit startup handshake (ExternalPlugin.initialize)
            result = await self._roundtrip(method, params)
            self._ready = True
            return result
        if not self.alive or not self._ready:
            async with self._restart_lock:
                if not self.alive or not self._ready:
                    # crash restart: a spec-conforming MCP server rejects
                    # requests before initialize, so the handshake completes
                    # UNDER the lock — concurrent requests wait on it and
                    # re-check, never racing ahead of initialize. stop()
                    # first: a half-alive previous process (e.g. handshake
                    # timed out) must not leak as a zombie with a live
                    # reader task
                    self._ready = False
                    await self.stop()
                    await self.start()
                    await self._roundtrip("initialize", {
                        "protocolVersion": "2025-06-18", "capabilities": {},
                        "clientInfo": {"name": "mcpforge-plugin-host",
                                       "version": "1"}})
                    self._ready = True
        return await self._roundtrip(method, params)

    async def _roundtrip(self, method: str,
                         params: dict[str, Any] | None = None) -> dict[str, Any]:
        proc = self._proc
        assert proc is not None
        self._next_id += 1
        rid = self._next_id
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._futures[rid] = future
        frame = {"jsonrpc": "2.0", "id": rid, "method": method,
                 "params": params or {}}
        try:
            # one write() per frame: whole lines, no interleaving between tasks
            proc.stdin.write(
                json.dumps(frame, separators=(",", ":")).encode() + b"\n")
            await proc.stdin.drain()
            return await asyncio.wait_for(future, self.timeout_s)
        finally:
            self._futures.pop(rid, None)


class ExternalPlugin(Plugin):
    """Routes hooks to an out-of-process stdio MCP plugin server."""

    def __init__(self, config: PluginConfig, ctx=None):
        super().__init__(config, ctx)
        command = config.config.get("command")
        if not command:
            raise ValueError(f"external plugin {config.name}: 'command' required")
        default_timeout = getattr(
            getattr(ctx, "settings", None), "external_plugin_timeout", 10.0)
        self._proc = StdioPluginProcess(
            list(command), cwd=config.config.get("cwd"),
            env=config.config.get("env"),
            timeout_s=float(config.config.get("timeout_s", default_timeout)))
        self._hooks: set[str] = set()

    async def initialize(self) -> None:
        await self._proc.start()
        await self._proc.request("initialize", {
            "protocolVersion": "2025-06-18", "capabilities": {},
            "clientInfo": {"name": "mcpforge-plugin-host", "version": "1"}})
        tools = (await self._proc.request("tools/list")).get("tools", [])
        hook_names = {h.value for h in HookType}
        self._hooks = {t["name"] for t in tools if t.get("name") in hook_names}
        logger.info("external plugin %s: hooks %s", self.config.name,
                    sorted(self._hooks))

    async def shutdown(self) -> None:
        await self._proc.stop()

    def implements(self, hook: HookType) -> bool:
        if hook.value not in self._hooks:
            return False
        if self.config.hooks and hook.value not in self.config.hooks:
            return False
        return True

    # ------------------------------------------------------------- dispatch

    async def _call(self, hook: str, payload: dict[str, Any]) -> dict[str, Any] | None:
        result = await self._proc.request("tools/call",
                                          {"name": hook, "arguments": payload})
        content = result.get("content") or []
        text = content[0].get("text", "{}") if content else "{}"
        if result.get("isError"):  # SDK crash text is plain, not JSON
            raise RuntimeError(f"external plugin {self.config.name}: {text}")
        try:
            verdict = json.loads(text)
        except json.JSONDecodeError:
            raise RuntimeError(
                f"external plugin {self.config.name} returned non-JSON verdict")
        violation = verdict.get("violation")
        if violation:
            raise PluginViolation(violation.get("reason", "blocked"),
                                  code=violation.get("code", "EXTERNAL_POLICY"),
                                  details=violation.get("details") or {})
        return verdict.get("modified")

    async def _call_replacing(self, hook: str, payload: dict[str, Any],
                              field: str):
        """Post-style hooks: the manager expects the replacement VALUE (the
        new result/payload), not the modified-fields dict — unwrap it."""
        modified = await self._call(hook, payload)
        return modified.get(field) if modified else None

    @staticmethod
    def _ctx(context: PluginContext) -> dict[str, Any]:
        return {"user": context.user, "tool_name": context.tool_name,
                "metadata": context.metadata}

    async def tool_pre_invoke(self, name, arguments, headers, context):
        return await self._call("tool_pre_invoke", {
            "name": name, "arguments": arguments, "headers": headers,
            "context": self._ctx(context)})

    async def tool_post_invoke(self, name, result, context):
        return await self._call_replacing("tool_post_invoke", {
            "name": name, "result": result, "context": self._ctx(context)},
            "result")

    async def prompt_pre_fetch(self, name, arguments, context):
        return await self._call("prompt_pre_fetch", {
            "name": name, "arguments": arguments, "context": self._ctx(context)})

    async def prompt_post_fetch(self, name, result, context):
        return await self._call_replacing("prompt_post_fetch", {
            "name": name, "result": result, "context": self._ctx(context)},
            "result")

    async def resource_pre_fetch(self, uri, context):
        out = await self._call("resource_pre_fetch",
                               {"uri": uri, "context": self._ctx(context)})
        return out.get("uri") if out else None

    async def resource_post_fetch(self, uri, result, context):
        return await self._call_replacing("resource_post_fetch", {
            "uri": uri, "result": result, "context": self._ctx(context)},
            "result")

    async def agent_pre_invoke(self, agent, payload, context):
        return await self._call_replacing("agent_pre_invoke", {
            "agent": agent, "payload": payload, "context": self._ctx(context)},
            "payload")

    async def agent_post_invoke(self, agent, result, context):
        return await self._call_replacing("agent_post_invoke", {
            "agent": agent, "result": result, "context": self._ctx(context)},
            "result")
