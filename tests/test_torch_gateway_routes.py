"""The gateway routes of the port's ``build_llm_app`` against the JAX
gateway's, on the CPU (aiohttp): the same request sequence to
``/llm/providers``, ``/llm/providers/{id}/models``, ``/llm/models``,
``/plugins``, ``/plugins/{name}/mode`` and ``/plugins/bindings`` answers the
same status codes and bodies (ids and times masked), with the same
permissions; ``/admin/tenants/usage`` lists the same rollup rows once both
rollups flushed the same ledger adds; the middleware runs a test plugin's
``http_auth_resolve_user`` and ``http_pre_request`` hooks; and a
``build_llm_app`` on the default tier-1 settings writes no ``mcpforge.db``
into the working directory."""

import asyncio
import dataclasses
import os
import re

import aiohttp
import pytest
from aiohttp.test_utils import TestClient, TestServer

from mcp_context_forge_tpu.config import load_settings
from mcp_context_forge_tpu.gateway.app import build_app
from mcp_context_forge_tpu.plugins import framework as jax_fw
from mcp_context_forge_tpu.services.auth_service import AuthContext as JaxAuthContext
from mcp_context_forge_tpu.utils import jwt as jax_jwt
from mcp_context_forge_tpu_torch.config import load_settings as port_load_settings
from mcp_context_forge_tpu_torch.gateway.auth import AuthContext
from mcp_context_forge_tpu_torch.plugins import framework as fw
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
}
HEX = re.compile(r"[0-9a-f]{32}")
TIMES = {"created_at", "updated_at", "window_start", "window_end"}


def _resolver_kinds():
    """A plugin per package that resolves ``x-test-user`` to an admin and
    records each ``http_pre_request``."""
    seen = {"jax": [], "port": []}
    for name, framework, auth_cls in (("jax", jax_fw, JaxAuthContext),
                                      ("port", fw, AuthContext)):
        class Resolver(framework.Plugin):
            calls = seen[name]
            context_cls = auth_cls

            async def http_auth_resolve_user(self, headers):
                user = headers.get("x-test-user") or headers.get("X-Test-User")
                return self.context_cls(user=user, is_admin=True, via="plugin") if user else None

            async def http_pre_request(self, method, path, headers, context):
                self.calls.append((method, path, context.user))

        globals()[f"{name.capitalize()}Resolver"] = Resolver
        framework.register_builtin("test_resolver", f"{__name__}.{name.capitalize()}Resolver")
    return seen


SEEN = _resolver_kinds()


@pytest.fixture(scope="module")
def apps():
    settings = load_settings(env=ENV, env_file=None)
    loop = asyncio.new_event_loop()

    async def build():
        ref_app = await build_app(settings)
        config = dataclasses.replace(EngineConfig.from_settings(settings), device="cpu")
        port_app = build_llm_app(settings, engine=TorchEngine(config))
        clients = []
        for app in (ref_app, port_app):
            client = TestClient(TestServer(app))
            await client.start_server()
            clients.append(client)
        return clients

    clients = loop.run_until_complete(build())
    yield loop, settings, clients
    for client in clients:
        loop.run_until_complete(client.close())
    loop.close()


def _basic(settings) -> dict:
    auth = aiohttp.BasicAuth(settings.basic_auth_user, settings.basic_auth_password)
    return {"Authorization": auth.encode()}


def _mask(value, ids: dict):
    if isinstance(value, list):
        return [_mask(v, ids) for v in value]
    if isinstance(value, dict):
        return {k: ("<t>" if k in TIMES else _mask(v, ids)) for k, v in value.items()}
    if isinstance(value, str):
        return HEX.sub(lambda m: ids.setdefault(m.group(0), f"<id{len(ids)}>"), value)
    return value


async def _sequence(client, settings, scoped: str) -> list:
    """One request sequence; each answer as (status, masked body). Ids
    are masked in order of first appearance, so the same sequence masks
    alike on both apps."""
    admin = _basic(settings)
    ids: dict = {}
    out = []
    state: dict = {}

    async def call(method, path, headers=None, **kwargs):
        path = path.format(**state)
        resp = await getattr(client, method)(path, headers=admin if headers is None else headers,
                                             **kwargs)
        body = await resp.json() if resp.content_type == "application/json" else await resp.text()
        out.append((method, HEX.sub("<id>", path), resp.status, _mask(body, ids)))
        return body

    await call("get", "/plugins")
    created = await call("post", "/plugins/bindings", json={
        "plugin_name": "content_moderation", "scope_type": "global",
        "config": {"use_engine": False, "threshold": 0.5}})
    state["binding"] = created["id"]
    await call("post", "/plugins/bindings", json={"plugin_name": "summarizer",
                                                  "scope_type": "tool", "scope_id": "fetch",
                                                  "mode": "permissive"})
    await call("get", "/plugins")
    await call("get", "/plugins/bindings")
    await call("post", "/plugins/binding:{binding}/mode", json={"mode": "permissive"})
    await call("post", "/plugins/binding:{binding}/mode", json={"mode": "loud"})
    await call("get", "/plugins")
    await call("delete", "/plugins/bindings/{binding}")
    await call("get", "/plugins")
    await call("get", "/plugins", headers={})
    await call("get", "/plugins", headers={"Authorization": f"Bearer {scoped}"})
    provider = await call("post", "/llm/providers", json={
        "name": "loop", "provider_type": "openai_compatible",
        "api_base": "http://127.0.0.1:9/v1", "config": {"api_key": "sk-test"}})
    state["provider"] = provider["id"]
    await call("post", "/llm/providers", json={"name": "loop",
                                               "provider_type": "openai_compatible"})
    await call("post", "/llm/providers", json={"name": "odd", "provider_type": "mystery"})
    await call("get", "/llm/providers")
    await call("post", "/llm/providers/{provider}/models", json={"model_id": "llama3-test",
                                                                 "alias": "loop-8b"})
    await call("post", "/llm/providers/{provider}/models", json={"model_id": "x",
                                                                 "alias": "loop-8b"})
    await call("post", "/llm/providers/" + "0" * 32 + "/models", json={"alias": "y"})
    await call("get", "/llm/models")
    await call("get", "/llm/models", headers={"Authorization": f"Bearer {scoped}"})
    await call("delete", "/llm/providers/{provider}")
    await call("delete", "/llm/providers/{provider}")
    await call("get", "/llm/providers")
    return out


def test_route_sequence_equal_jax(apps):
    loop, settings, clients = apps
    scoped = jax_jwt.create_token({"sub": "ci@example.com", "scopes": ["tools.read"]},
                                  settings.jwt_secret_key, audience=settings.jwt_audience,
                                  issuer=settings.jwt_issuer)
    want, got = (loop.run_until_complete(_sequence(c, settings, scoped)) for c in clients)
    assert got == want
    statuses = [status for _, _, status, _ in got]
    assert statuses == [200, 201, 201, 200, 200, 204, 422, 200, 204, 200, 401, 403,
                        201, 409, 422, 200, 201, 409, 404, 200, 403, 204, 404, 200]


def test_tenant_usage_lists_the_same_rollups(apps):
    loop, settings, clients = apps

    async def one(client):
        app = client.server.app
        ledger = app["tenant_ledger"]
        ledger.add("team:a", requests=2, prompt_tokens=30, generated_tokens=6,
                   cache_hit_tokens=16, kv_page_seconds=0.5)
        ledger.add("user:b", requests=1, prompt_tokens=4)
        written = await app["tenant_usage_rollup"].flush()
        resp = await client.get("/admin/tenants/usage?limit=3", headers=_basic(settings))
        return written, resp.status, await resp.json()

    want, got = (loop.run_until_complete(one(c)) for c in clients)
    assert got[:2] == want[:2] == (2, 200)
    assert set(got[2]) == set(want[2])
    assert _mask(got[2]["rollups"], {}) == _mask(want[2]["rollups"], {})
    assert {r["tenant"]: r["prompt_tokens"] for r in got[2]["rollups"]} == \
        {"team:a": 30, "user:b": 4}
    assert got[2]["rollup_interval_s"] == want[2]["rollup_interval_s"]
    assert got[2]["rollups_written"] == want[2]["rollups_written"] >= 2


def test_middleware_runs_the_auth_and_pre_request_hooks(apps):
    loop, settings, clients = apps

    async def one(client, name):
        app = client.server.app
        manager = app["plugin_manager"]
        framework = jax_fw if name == "jax" else fw
        await manager.add_plugin(framework.PluginConfig(name="resolver", kind="test_resolver"))
        try:
            resp = await client.get("/plugins", headers={"X-Test-User": "plugin@example.com"})
            body = await resp.json()
            refused = await client.get("/plugins")
        finally:
            await manager.remove_plugin("resolver")
        return resp.status, [HEX.sub("<id>", p["name"]) for p in body], refused.status

    want = loop.run_until_complete(one(clients[0], "jax"))
    got = loop.run_until_complete(one(clients[1], "port"))
    assert got == want
    assert got[0] == 200 and "resolver" in got[1] and got[2] == 401
    assert SEEN["port"] == SEEN["jax"] == [("GET", "/plugins", "plugin@example.com")]


def test_default_settings_write_no_database_file(tmp_path, monkeypatch):
    """Tier-1's settings (``MCPFORGE_DATABASE_URL`` in-memory, from the
    test harness): the app starts, migrates and serves without a file in
    the working directory; a file URL puts the database where it names."""
    monkeypatch.chdir(tmp_path)
    settings = port_load_settings(env={k: v for k, v in ENV.items()
                                       if k != "MCPFORGE_DATABASE_URL"}, env_file=None)
    assert settings.database_url == os.environ["MCPFORGE_DATABASE_URL"]
    target = tmp_path / "named" / "gateway.db"
    target.parent.mkdir()
    named = dataclasses.replace(settings, database_url=f"sqlite:///{target}")

    async def serve(settings):
        config = dataclasses.replace(EngineConfig.from_settings(settings), device="cpu")
        client = TestClient(TestServer(build_llm_app(settings, engine=TorchEngine(config))))
        await client.start_server()
        try:
            resp = await client.get("/llm/models", headers=_basic(settings))
            return resp.status
        finally:
            await client.close()

    for each in (settings, named):
        assert asyncio.run(serve(each)) == 200
    assert sorted(p.name for p in tmp_path.iterdir()) == ["named"]
    assert target.exists()
