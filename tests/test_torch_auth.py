"""Authentication of the port's /v1 app against the JAX gateway's, on the
CPU. The port's ``utils/jwt.py`` and the JAX package's mint tokens that
decode in the other, and both refuse the same bad tokens. The two /v1 apps,
built from the same settings (the port's engine on the JAX engine's
weights), give the same status, ``www-authenticate`` and body for: no
credentials, a wrong Basic password, the right Basic credentials, a JWT for
a subject with no users row, a JWT scoped without ``llm.chat``, a JWT
minted for another audience, and ``auth_required`` off. Through the
database: a Bearer for the platform admin is the admin (an ``llm.admin``
route answers 200), a revoked API token and a deactivated user answer 401,
and a user made by ``POST /admin/users`` chats with Basic credentials and
then with an API token it minted, the same tokens in both apps."""

import asyncio
import base64
import dataclasses
import time

import aiohttp
import jax
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from mcp_context_forge_tpu.config import load_settings
from mcp_context_forge_tpu.gateway.app import build_app
from mcp_context_forge_tpu.utils import jwt as jax_jwt
from mcp_context_forge_tpu_torch.gateway import auth
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app
from mcp_context_forge_tpu_torch.utils import jwt as port_jwt
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

ENV = {
    "MCPFORGE_DATABASE_URL": "sqlite:///:memory:",
    "MCPFORGE_TPU_LOCAL_ENABLED": "true",
    "MCPFORGE_TPU_LOCAL_MODEL": "llama3-test",
    "MCPFORGE_TPU_LOCAL_MAX_BATCH": "2",
    "MCPFORGE_TPU_LOCAL_MAX_SEQ_LEN": "128",
    "MCPFORGE_TPU_LOCAL_PAGE_SIZE": "16",
    "MCPFORGE_TPU_LOCAL_NUM_PAGES": "32",
    "MCPFORGE_TPU_LOCAL_PREFILL_BUCKETS": "64",
    "MCPFORGE_TPU_LOCAL_DTYPE": "float32",
    "MCPFORGE_GATEWAY_HEALTH_INTERVAL": "3600",
}
SETTINGS = load_settings(env=ENV, env_file=None)
SECRET = SETTINGS.jwt_secret_key
CLAIMS = dict(audience=SETTINGS.jwt_audience, issuer=SETTINGS.jwt_issuer)
MODULES = {"jax": jax_jwt, "port": port_jwt}


@pytest.mark.parametrize("alg", ["HS256", "HS384", "HS512"])
@pytest.mark.parametrize("minter,reader", [("jax", "port"), ("port", "jax")])
def test_tokens_cross_decode(minter, reader, alg):
    claims = {"sub": "someone@example.com", "scopes": ["llm.chat"], "iat": 1700000000,
              "exp": int(time.time()) + 600}
    token = MODULES[minter].create_token(claims, SECRET, algorithm=alg, **CLAIMS)
    other = MODULES[reader].create_token(claims, SECRET, algorithm=alg, **CLAIMS)
    assert token == other   # the same bytes: the same header, payload and signature
    payload = MODULES[reader].decode(token, SECRET, algorithms=(alg,), **CLAIMS)
    assert payload == MODULES[minter].decode(token, SECRET, algorithms=(alg,), **CLAIMS)
    assert payload["sub"] == "someone@example.com" and payload["aud"] == CLAIMS["audience"]


def _alg_none(module) -> str:
    token = module.create_token({"sub": "x"}, SECRET, **CLAIMS)
    _, payload, _ = token.split(".")
    header = base64.urlsafe_b64encode(b'{"alg":"none","typ":"JWT"}').rstrip(b"=").decode()
    return f"{header}.{payload}."


BAD_TOKENS = {
    "expired": lambda m: m.create_token({"sub": "x", "exp": int(time.time()) - 10},
                                        SECRET, **CLAIMS),
    "wrong_secret": lambda m: m.create_token({"sub": "x"}, "another-secret-of-length", **CLAIMS),
    "wrong_audience": lambda m: m.create_token({"sub": "x"}, SECRET, audience="elsewhere",
                                               issuer=CLAIMS["issuer"]),
    "wrong_issuer": lambda m: m.create_token({"sub": "x"}, SECRET, audience=CLAIMS["audience"],
                                             issuer="someone-else"),
    "alg_none": _alg_none,
    "malformed": lambda m: "not.a-token",
}


@pytest.mark.parametrize("case", sorted(BAD_TOKENS))
@pytest.mark.parametrize("minter", ["jax", "port"])
def test_bad_tokens_refused_by_both(minter, case):
    token = BAD_TOKENS[case](MODULES[minter])
    messages = []
    for module in (jax_jwt, port_jwt):
        with pytest.raises(module.JWTError) as info:
            module.decode(token, SECRET, algorithms=("HS256",), **CLAIMS)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    with pytest.raises(auth.AuthError):
        auth.resolve_bearer(SETTINGS, token)


def test_resolution_without_a_database():
    admin = auth.resolve_header(SETTINGS, "Basic " + base64.b64encode(
        f"{SETTINGS.basic_auth_user}:{SETTINGS.basic_auth_password}".encode()).decode())
    assert (admin.user, admin.is_admin, admin.via) == (SETTINGS.platform_admin_email, True,
                                                       "basic")
    assert admin.permissions == auth.PERMISSIONS
    plain = auth.resolve_bearer(SETTINGS, port_jwt.create_token(
        {"sub": "someone@example.com", "jti": "k1"}, SECRET, **CLAIMS))
    assert plain.permissions == auth.DEFAULT_USER_PERMISSIONS and not plain.is_admin
    assert plain.token_jti == "k1" and plain.can("llm.chat") and not plain.can("llm.admin")
    scoped = auth.resolve_bearer(SETTINGS, port_jwt.create_token(
        {"sub": "ci@example.com", "scopes": ["tools.read", "no.such.permission"]},
        SECRET, **CLAIMS))
    assert scoped.scoped and scoped.permissions == {"tools.read"}
    with pytest.raises(auth.PermissionDenied, match="Missing permission: llm.chat"):
        scoped.require("llm.chat")
    for header, message in [("", "Authentication required"),
                            ("Basic abc", "Malformed basic credentials"),
                            ("Bearer " + port_jwt.create_token({"scopes": ["llm.chat"]},
                                                               SECRET, **CLAIMS),
                             "Token missing subject")]:
        with pytest.raises(auth.AuthError, match=message):
            auth.resolve_header(SETTINGS, header)


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


def _run(loop, coro):
    return loop.run_until_complete(asyncio.wait_for(coro, 120))


@pytest.fixture(scope="module")
def clients(loop):
    """(JAX gateway client, port app client), both built from SETTINGS."""
    async def build():
        ref_app = await build_app(SETTINGS)
        config = dataclasses.replace(EngineConfig.from_settings(SETTINGS), device="cpu")
        engine = TorchEngine(config, params=params_from_jax(
            jax.device_get(ref_app["tpu_engine"].params), MODEL_CONFIGS[config.model],
            device="cpu", dtype=torch.float32))
        out = []
        for app in (ref_app, build_llm_app(SETTINGS, engine=engine)):
            client = TestClient(TestServer(app))
            await client.start_server()
            out.append(client)
        return out

    pair = _run(loop, build())
    yield pair
    for client in pair:
        _run(loop, client.close())


def _bearer(claims: dict, **kwargs) -> dict:
    return {"Authorization": "Bearer " + jax_jwt.create_token(
        claims, SECRET, **{**CLAIMS, **kwargs})}


CHAT = {"model": "llama3-test", "max_tokens": 4,
        "messages": [{"role": "user", "content": "who are you?"}]}
CASES = {
    "none": ({}, 401),
    "wrong_password": ({"Authorization": aiohttp.BasicAuth("admin", "wrong").encode()}, 401),
    "basic_admin": ({"Authorization": aiohttp.BasicAuth(
        SETTINGS.basic_auth_user, SETTINGS.basic_auth_password).encode()}, 200),
    "jwt_no_users_row": (_bearer({"sub": "nobody-yet@example.com"}), 200),
    "jwt_scoped_without_llm_chat": (_bearer({"sub": "ci@example.com",
                                             "scopes": ["tools.read"]}), 403),
    "jwt_wrong_audience": (_bearer({"sub": "nobody-yet@example.com"},
                                   audience="elsewhere"), 401),
}


def _both(loop, clients, headers: dict):
    async def one(client):
        resp = await client.post("/v1/chat/completions", json=CHAT, headers=headers)
        return resp.status, resp.headers.get("www-authenticate"), await resp.json()

    return [_run(loop, one(client)) for client in clients]


@pytest.mark.parametrize("case", list(CASES))
def test_apps_agree_on_admission(loop, clients, case):
    headers, status = CASES[case]
    ref, port = _both(loop, clients, headers)
    assert ref[0] == port[0] == status, (ref, port)
    assert port[1] == ref[1] == ("Bearer" if status == 401 else None)
    if status == 200:
        assert port[2]["choices"] == ref[2]["choices"]
        assert port[2]["usage"] == ref[2]["usage"]
    else:
        assert port[2] == ref[2]


def test_auth_required_off_admits_anonymous(loop, clients, monkeypatch):
    """Both apps read the setting per request from the settings they were
    built with."""
    monkeypatch.setattr(SETTINGS, "auth_required", False)
    ref, port = _both(loop, clients, {})
    assert ref[0] == port[0] == 200
    assert port[2]["choices"] == ref[2]["choices"]


# -- the database-backed resolution (fault 1 and the slice as a whole) -------


def _admin():
    return {"Authorization": aiohttp.BasicAuth(SETTINGS.basic_auth_user,
                                               SETTINGS.basic_auth_password).encode()}


def _each(loop, clients, sequence):
    """``sequence(client)`` on the JAX app, then on the port's."""
    return [_run(loop, sequence(client)) for client in clients]


def test_admin_subject_bearer_is_admin(loop, clients):
    """Fault 1: a Bearer JWT for the platform admin resolves to the admin's
    users row (written at startup), so an ``llm.admin`` route answers 200 in
    both apps; the parent port gave it the default user's permissions and a
    403."""
    async def sequence(client):
        resp = await client.get("/llm/providers", headers=_bearer(
            {"sub": SETTINGS.platform_admin_email}))
        row = await client.server.app["ctx"].db.fetchone(
            "SELECT is_admin, is_active, auth_provider FROM users WHERE email=?",
            (SETTINGS.platform_admin_email,))
        return resp.status, await resp.json(), dict(row)

    ref, port = _each(loop, clients, sequence)
    assert ref == port and port[0] == 200
    assert port[2] == {"is_admin": 1, "is_active": 1, "auth_provider": "local"}


def test_revoked_token_and_deactivated_user_refused(loop, clients):
    """Fault 1: a revoked API token and a deactivated user's JWT answer 401
    before the engine in both apps (the parent port admitted both)."""
    email, password = "deactivated-76@corp.example", "Seeded-Passw0rd-76"

    async def sequence(client):
        out = []
        resp = await client.post("/auth/tokens", json={"name": "chat",
                                                       "permissions": ["llm.chat"]},
                                 headers=_admin())
        made = await resp.json()
        out.append(resp.status)
        resp = await client.delete(f"/auth/tokens/{made['id']}", headers=_admin())
        out.append(resp.status)
        resp = await client.post("/v1/chat/completions", json=CHAT,
                                 headers={"Authorization": f"Bearer {made['token']}"})
        out.append((resp.status, resp.headers.get("www-authenticate"), await resp.json()))
        resp = await client.post("/admin/users", json={"email": email, "password": password},
                                 headers=_admin())
        out.append(resp.status)
        resp = await client.post(f"/admin/users/{email}/toggle", headers=_admin())
        out.append((resp.status, await resp.json()))
        for headers in (_bearer({"sub": email}), {
                "Authorization": aiohttp.BasicAuth(email, password).encode()}):
            resp = await client.post("/v1/chat/completions", json=CHAT, headers=headers)
            out.append((resp.status, await resp.json()))
        return out

    ref, port = _each(loop, clients, sequence)
    assert port == ref
    assert port[2] == (401, "Bearer", {"detail": "Token revoked"})
    assert port[5] == (401, {"detail": "User deactivated"})
    assert port[6] == (401, {"detail": "Invalid credentials"})


def test_db_user_chat_through_both_apps(loop, clients):
    """The slice as a whole: a user made by ``POST /admin/users`` chats on
    /v1 with Basic credentials (one argon2 verify), then, granted
    ``tokens.manage`` by a role, mints an ``llm.chat`` API token and chats
    with it; both replies, in both apps, are the same tokens, and the token's
    usage row lists the chat."""
    email, password = "chatter-77@corp.example", "Seeded-Passw0rd-77"
    chat = {**CHAT, "max_tokens": 6, "messages": [{"role": "user", "content": "name a tool"}]}

    async def sequence(client):
        admin = _admin()
        await client.post("/admin/users", json={"email": email, "password": password},
                          headers=admin)
        me = {"Authorization": aiohttp.BasicAuth(email, password).encode()}
        resp = await client.post("/v1/chat/completions", json=chat, headers=me)
        by_basic = (resp.status, (await resp.json())["choices"])
        role = await (await client.post("/rbac/roles", json={
            "name": "token-makers-77", "permissions": ["tokens.manage"]}, headers=admin)).json()
        await client.post(f"/rbac/users/{email}/roles", json={"role_id": role["id"]},
                          headers=admin)
        made = await (await client.post("/auth/tokens", json={
            "name": "chat", "permissions": ["llm.chat"]}, headers=me)).json()
        resp = await client.post("/v1/chat/completions", json=chat,
                                 headers={"Authorization": f"Bearer {made['token']}"})
        by_token = (resp.status, (await resp.json())["choices"])
        for task in list(client.server.app["_token_usage_tasks"]):
            await task
        usage = await (await client.get(f"/auth/tokens/{made['id']}/usage",
                                        headers=me)).json()
        return by_basic, by_token, [(e["method"], e["path"], e["status"])
                                    for e in usage["entries"]]

    ref, port = _each(loop, clients, sequence)
    assert port == ref
    assert port[0][0] == port[1][0] == 200 and port[0][1] == port[1][1]
    assert port[2] == [("POST", "/v1/chat/completions", 200)]
