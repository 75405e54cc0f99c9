"""Helpers of the database-backed auth parity tests
(``test_torch_auth_service.py``, ``test_torch_teams_rbac.py``,
``test_torch_auth_layers.py``, ``test_torch_oauth_sso.py``,
``test_torch_audit_compliance.py``):

- ``Pair``: the JAX gateway (``build_app``, the engine off) and the port's
  ``build_llm_app`` (a CPU ``TorchEngine`` on llama3-test, never asked to
  generate here), both from one settings object, each over its own
  in-memory database, served by aiohttp test servers on one loop;
- ``Session``: one app's side of a request sequence, recording each answer
  as (method, path, status, masked body); ``on_both`` runs a case on each
  app, JAX first, and asserts the two masked results equal (``same``: a
  unified diff on a mismatch);
- ``mask``: ids, JWTs, times, latencies and ports replaced by stable
  placeholders, so the two records compare exactly;
- ``SmtpStub`` (an SMTP server that speaks enough of RFC 5321 for
  ``smtplib``) and ``stub_server`` (an aiohttp app on 127.0.0.1).
"""

import asyncio
import base64
import dataclasses
import difflib
import json
import pprint
import re
import time

import aiohttp
import numpy as np
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from mcp_context_forge_tpu.config import load_settings
from mcp_context_forge_tpu.gateway.app import build_app
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app

ENV = {
    "MCPFORGE_DATABASE_URL": "sqlite:///:memory:",
    "MCPFORGE_TPU_LOCAL_ENABLED": "false",
    "MCPFORGE_TPU_LOCAL_MODEL": "llama3-test",
    "MCPFORGE_TPU_LOCAL_MAX_BATCH": "2",
    "MCPFORGE_TPU_LOCAL_MAX_SEQ_LEN": "128",
    "MCPFORGE_TPU_LOCAL_PAGE_SIZE": "16",
    "MCPFORGE_TPU_LOCAL_NUM_PAGES": "32",
    "MCPFORGE_TPU_LOCAL_PREFILL_BUCKETS": "64",
    "MCPFORGE_TPU_LOCAL_DTYPE": "float32",
    "MCPFORGE_GATEWAY_HEALTH_INTERVAL": "3600",
    "MCPFORGE_PLUGINS_ENABLED": "false",
    "MCPFORGE_MAX_TOOL_RETRIES": "1",
    "MCPFORGE_RETRY_BASE_DELAY": "0",
    "MCPFORGE_RETRY_MAX_DELAY": "0",
}
HEX = re.compile(r"[0-9a-f]{32}")
JWT = re.compile(r"eyJ[A-Za-z0-9_\-]+\.[A-Za-z0-9_\-]+\.[A-Za-z0-9_\-]+")
PORT = re.compile(r"127\.0\.0\.1:\d+")
STATE = re.compile(r"state=[A-Za-z0-9_\-]+")
TIMES = {"created_at", "updated_at", "last_used", "ts", "joined_at", "granted_at",
         "expires_at", "generated_at", "last_login", "revoked_at", "accepted_at",
         "response_ms", "period_start", "period_end"}
TOKEN_KEYS = {"token", "state", "next_cursor"}


def mask(value, ids: dict):
    """``value`` with its run-specific parts replaced: 32-hex ids by their
    order of first sight, JWTs, the values of time keys (None kept),
    urlsafe invitation tokens, ports and SSO states."""
    if isinstance(value, (list, tuple)):
        return type(value)(mask(v, ids) for v in value)
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            if k in TIMES:
                out[k] = None if v is None else "<t>"
            elif k in TOKEN_KEYS and isinstance(v, str):
                out[k] = "<jwt>" if JWT.fullmatch(v) else "<token>"
            else:
                out[k] = mask(v, ids)
        return out
    if isinstance(value, str):
        value = JWT.sub("<jwt>", value)
        value = PORT.sub("127.0.0.1:<port>", value)
        value = STATE.sub("state=<state>", value)
        return HEX.sub(lambda m: ids.setdefault(m.group(0), f"<id{len(ids)}>"), value)
    return value


def seeded_people(seed: int, n: int) -> list[tuple[str, str]]:
    """``n`` (email, password) pairs from ``default_rng(seed)``; each
    password passes the default policy."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out = []
    for i in range(n):
        local = "".join(rng.choice(letters, 6))
        word = "".join(rng.choice(letters, 8))
        out.append((f"{local}{i}@corp{seed}.example",
                    f"{word.capitalize()}{int(rng.integers(100, 999))}x"))
    return out


class Pair:
    """The JAX gateway and the port's app over one settings object."""

    def __init__(self, **overrides):
        env = {**ENV, **{f"MCPFORGE_{k.upper()}": str(v) for k, v in overrides.items()}}
        self.settings = load_settings(env=env, env_file=None)
        self.loop = asyncio.new_event_loop()
        self.clients: dict = {}
        self.run(self._start())

    async def _start(self) -> None:
        ref = await build_app(self.settings)
        config = dataclasses.replace(EngineConfig.from_settings(self.settings), device="cpu")
        for name, app in (("jax", ref),
                          ("port", build_llm_app(self.settings, engine=TorchEngine(config)))):
            client = TestClient(TestServer(app))
            await client.start_server()
            self.clients[name] = client

    def run(self, coro, timeout: float = 120):
        return self.loop.run_until_complete(asyncio.wait_for(coro, timeout))

    def app(self, name: str) -> web.Application:
        return self.clients[name].server.app

    def close(self) -> None:
        for client in self.clients.values():
            self.run(client.close())
        self.loop.close()


def basic(user: str, password: str) -> dict:
    return {"Authorization": aiohttp.BasicAuth(user, password).encode()}


def bearer(token: str) -> dict:
    return {"Authorization": f"Bearer {token}"}


class Session:
    """One app's side of a sequence: each answer recorded as (method, path
    with ids masked, status, masked body)."""

    def __init__(self, pair: Pair, name: str):
        self.pair, self.name = pair, name
        self.client = pair.clients[name]
        self.app = pair.app(name)
        self.settings = pair.settings
        self.admin = basic(self.settings.basic_auth_user, self.settings.basic_auth_password)
        self.ids: dict = {}
        self.out: list = []
        self.headers = None   # the last answer's headers

    async def call(self, method: str, path: str, body=None, headers=None, record=True,
                   **kwargs):
        resp = await getattr(self.client, method)(
            path, json=body, headers=self.admin if headers is None else headers, **kwargs)
        self.headers = resp.headers
        if resp.content_type == "application/json":
            payload = await resp.json()
        else:
            payload = await resp.text()
        if record:
            self.out.append((method, mask(path, self.ids), resp.status,
                             mask(payload, self.ids)))
        return resp.status, payload

    async def rows(self, sql: str, params=()) -> list:
        rows = await self.app["ctx"].db.fetchall(sql, params)
        return mask([dict(r) for r in rows], self.ids)


def same(got: dict):
    """Assert the port's record equals the JAX app's; on a mismatch the
    message is a unified diff of the two."""
    if got["port"] != got["jax"]:
        diff = difflib.unified_diff(pprint.pformat(got["jax"], width=100).splitlines(),
                                    pprint.pformat(got["port"], width=100).splitlines(),
                                    "jax", "port", lineterm="")
        raise AssertionError("the port differs from the JAX app:\n" + "\n".join(diff))
    return got["port"]


def on_both(pair: Pair, case):
    """``case(session)`` on each app, the JAX app first; the port's masked
    result, asserted equal to the JAX app's."""
    got = {}
    for name in ("jax", "port"):
        session = Session(pair, name)
        got[name] = mask(pair.run(case(session)), session.ids)
    return same(got)


async def drain(app: web.Application) -> None:
    """Wait for the app's background token-usage and mail tasks."""
    pending = list(app["_token_usage_tasks"])
    if pending:
        await asyncio.gather(*pending, return_exceptions=True)


async def stub_server(routes: dict) -> TestClient:
    """An aiohttp app on 127.0.0.1: ``routes`` maps (method, path) to a
    handler."""
    app = web.Application()
    for (method, path), handler in routes.items():
        app.router.add_route(method, path, handler)
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


def id_token(claims: dict) -> str:
    """An unsigned id_token carrying ``claims`` (the SSO code reads it
    unverified, having fetched it itself from the IdP)."""
    header = base64.urlsafe_b64encode(b'{"alg":"RS256"}').rstrip(b"=")
    payload = base64.urlsafe_b64encode(json.dumps(claims).encode()).rstrip(b"=")
    return (header + b"." + payload + b".sig").decode()


class SmtpStub:
    """One SMTP conversation at a time; records (from, to, data)."""

    def __init__(self) -> None:
        self.messages: list[dict] = []
        self._server: asyncio.AbstractServer | None = None
        self.port = 0

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def wait(self, n: int, timeout_s: float = 10.0) -> None:
        deadline = time.monotonic() + timeout_s
        while len(self.messages) < n and time.monotonic() < deadline:
            await asyncio.sleep(0.02)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        msg = {"from": "", "to": [], "data": ""}

        async def say(line: str) -> None:
            writer.write((line + "\r\n").encode())
            await writer.drain()

        await say("220 smtp-stub ready")
        while True:
            raw = await reader.readline()
            if not raw:
                break
            line = raw.decode().strip()
            verb = line.split(":", 1)[0].split(" ", 1)[0].upper()
            if verb in ("EHLO", "HELO"):
                await say("250 smtp-stub")
            elif verb == "MAIL":
                msg["from"] = line.split(":", 1)[1].strip()
                await say("250 ok")
            elif verb == "RCPT":
                msg["to"].append(line.split(":", 1)[1].strip())
                await say("250 ok")
            elif verb == "DATA":
                await say("354 go ahead")
                body = []
                while True:
                    data_line = await reader.readline()
                    if data_line.strip() == b".":
                        break
                    body.append(data_line.decode())
                msg["data"] = "".join(body)
                self.messages.append(dict(msg))
                msg = {"from": "", "to": [], "data": ""}
                await say("250 accepted")
            elif verb == "QUIT":
                await say("221 bye")
                break
            else:
                await say("250 ok")
        writer.close()
