"""The transport bridge (a copy of the JAX package's ``translate.py``): a
stdio MCP server exposed over HTTP, or a remote HTTP MCP endpoint spoken on
stdio.

- ``stdio->http``: spawn a stdio MCP server and serve it at ``/mcp``
  (streamable HTTP, JSON answers) on a local port;
- ``http->stdio``: speak MCP on this process's stdio, forwarding each
  message to a remote streamable-HTTP endpoint.

``python -m mcp_context_forge_tpu_torch.translate --stdio "python -m mcp_servers.text_server" --port 9000``
``python -m mcp_context_forge_tpu_torch.translate --connect http://gw:4444/mcp``
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from typing import Any

from aiohttp import web


class StdioServerBridge:
    """Own a stdio MCP subprocess; correlate JSON-RPC ids across clients."""

    def __init__(self, command: str):
        self.command = command
        self._process: asyncio.subprocess.Process | None = None
        self._pending: dict[str, asyncio.Future] = {}
        self._next_id = 1
        self._reader_task: asyncio.Task | None = None
        self._lock = asyncio.Lock()

    async def start(self) -> None:
        self._process = await asyncio.create_subprocess_shell(
            self.command,
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=sys.stderr,
        )
        self._reader_task = asyncio.create_task(self._read_loop())

    async def stop(self) -> None:
        if self._reader_task:
            self._reader_task.cancel()
        if self._process:
            if self._process.stdin:
                try:
                    self._process.stdin.close()
                    await self._process.stdin.wait_closed()
                except Exception:
                    pass
            if self._process.returncode is None:
                self._process.terminate()
                try:
                    await asyncio.wait_for(self._process.wait(), timeout=5)
                except asyncio.TimeoutError:
                    self._process.kill()
                    await self._process.wait()

    async def _read_loop(self) -> None:
        assert self._process and self._process.stdout
        while True:
            line = await self._process.stdout.readline()
            if not line:
                break
            try:
                message = json.loads(line)
            except json.JSONDecodeError:
                continue
            key = str(message.get("id"))
            future = self._pending.pop(key, None)
            if future is not None and not future.done():
                future.set_result(message)
        # subprocess died (EOF): fail everything in flight immediately
        error = ConnectionError("stdio MCP server exited")
        for future in self._pending.values():
            if not future.done():
                future.set_exception(error)
        self._pending.clear()

    async def request(self, message: dict[str, Any],
                      timeout: float = 60.0) -> dict[str, Any] | None:
        """Forward one JSON-RPC message; returns the response (None for
        notifications). Ids are rewritten to avoid cross-client collisions."""
        assert self._process and self._process.stdin
        is_notification = "id" not in message
        original_id = message.get("id")
        if not is_notification:
            async with self._lock:
                bridge_id = f"b{self._next_id}"
                self._next_id += 1
            message = {**message, "id": bridge_id}
            future: asyncio.Future = asyncio.get_running_loop().create_future()
            self._pending[bridge_id] = future
        data = json.dumps(message, separators=(",", ":")) + "\n"
        try:
            self._process.stdin.write(data.encode())
            await self._process.stdin.drain()
            if is_notification:
                return None
            response = await asyncio.wait_for(future, timeout=timeout)
        finally:
            if not is_notification:
                self._pending.pop(bridge_id, None)
        response["id"] = original_id
        return response


def build_bridge_app(bridge: StdioServerBridge) -> web.Application:
    app = web.Application()

    async def handle_mcp(request: web.Request) -> web.Response:
        try:
            payload = json.loads(await request.read())
        except json.JSONDecodeError:
            return web.json_response({"jsonrpc": "2.0", "id": None,
                                      "error": {"code": -32700,
                                                "message": "Parse error"}},
                                     status=400)
        messages = payload if isinstance(payload, list) else [payload]
        responses = []
        for message in messages:
            response = await bridge.request(message)
            if response is not None:
                responses.append(response)
        if not responses:
            return web.Response(status=202)
        return web.json_response(responses if isinstance(payload, list)
                                 else responses[0])

    async def health(request: web.Request) -> web.Response:
        return web.json_response({"status": "healthy"})

    app.router.add_post("/mcp", handle_mcp)
    app.router.add_get("/health", health)
    return app


async def run_stdio_to_http(command: str, host: str, port: int) -> None:
    bridge = StdioServerBridge(command)
    await bridge.start()
    app = build_bridge_app(bridge)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    print(f"bridging stdio server to http://{host}:{port}/mcp", file=sys.stderr)
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await bridge.stop()
        await runner.cleanup()


async def run_http_to_stdio(endpoint: str, headers: dict[str, str]) -> None:
    """Speak MCP on stdio; forward to a remote streamable-HTTP endpoint."""
    import httpx

    async with httpx.AsyncClient(timeout=60.0) as client:
        loop = asyncio.get_running_loop()
        reader = asyncio.StreamReader()
        await loop.connect_read_pipe(lambda: asyncio.StreamReaderProtocol(reader),
                                     sys.stdin)
        session_id: str | None = None
        while True:
            line = await reader.readline()
            if not line:
                break
            try:
                message = json.loads(line)
            except json.JSONDecodeError:
                continue
            send_headers = {"content-type": "application/json",
                            "accept": "application/json, text/event-stream",
                            **headers}
            if session_id:
                send_headers["mcp-session-id"] = session_id
            try:
                response = await client.post(endpoint, json=message,
                                             headers=send_headers)
            except Exception as exc:
                if "id" in message:
                    sys.stdout.write(json.dumps({
                        "jsonrpc": "2.0", "id": message.get("id"),
                        "error": {"code": -32000,
                                  "message": f"gateway unreachable: {exc}"}}) + "\n")
                    sys.stdout.flush()
                continue
            sid = response.headers.get("mcp-session-id")
            if sid:
                session_id = sid
            if "id" not in message or response.status_code == 202:
                continue
            content_type = response.headers.get("content-type", "")
            if content_type.startswith("text/event-stream"):
                # SSE reply: the JSON-RPC messages ride data: lines
                for block in response.text.split("\n\n"):
                    for line in block.splitlines():
                        if line.startswith("data: "):
                            sys.stdout.write(line[6:] + "\n")
                sys.stdout.flush()
                continue
            try:
                body = response.json()
            except Exception:
                body = {"jsonrpc": "2.0", "id": message.get("id"),
                        "error": {"code": -32000,
                                  "message": f"HTTP {response.status_code}: "
                                             f"{response.text[:200]}"}}
            sys.stdout.write(json.dumps(body, separators=(",", ":")) + "\n")
            sys.stdout.flush()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="mcpforge-translate")
    parser.add_argument("--stdio", help="command of a stdio MCP server to expose")
    parser.add_argument("--connect", help="remote /mcp endpoint to expose on stdio")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=9000)
    parser.add_argument("--header", action="append", default=[],
                        help="extra header K:V for --connect")
    args = parser.parse_args(argv)
    if bool(args.stdio) == bool(args.connect):
        parser.error("exactly one of --stdio / --connect is required")
    if args.stdio:
        asyncio.run(run_stdio_to_http(args.stdio, args.host, args.port))
    else:
        headers = dict(h.split(":", 1) for h in args.header)
        asyncio.run(run_http_to_stdio(args.connect, headers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
