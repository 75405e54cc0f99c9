"""Authentication of the port's /v1 app against the JAX gateway's, on the
CPU. The port's ``utils/jwt.py`` and the JAX package's mint tokens that
decode in the other, and both refuse the same bad tokens. The two /v1 apps,
built from the same settings (the port's engine on the JAX engine's
weights), give the same status, ``www-authenticate`` and body for: no
credentials, a wrong Basic password, the right Basic credentials, a JWT for
a subject with no users row, a JWT scoped without ``llm.chat``, a JWT
minted for another audience, and ``auth_required`` off."""

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
