"""The port's three database-backed middleware layers, the audit rows of its
request log, and its ``/auth/*`` and ``/admin/users*`` routes, against the
JAX gateway's, on the CPU. Both apps (one pair for the module, over one
settings object and an SMTP stub on 127.0.0.1) get the same requests,
built from seeded emails and passwords; every status and body is compared,
and the rows each wrote, with ids, JWTs, tokens and times masked:

- ``MIDDLEWARES``: JAX's names in JAX's order, the three layers where JAX
  has them;
- ``csrf``: a Basic POST declared cross-site (``Sec-Fetch-Site``, a foreign
  ``Origin``) is 403 ``CSRF_CROSS_SITE``, a trusted origin and a Bearer
  pass, ``csrf_check_referer`` refuses a POST that declares nothing
  (``CSRF_NO_PROVENANCE``), the double-submit cookie must be echoed and
  verify (``CSRF_TOKEN_INVALID``), safe methods, exempt paths and
  ``csrf_enabled`` off pass;
- ``password_change``: a flagged user reaches only ``/auth/password``; a
  scoped token is exempt; the rotation lifts the flag; enforcement off;
- ``token_usage``: a row per API-token request (admitted, a 403 and the
  401 of a revoked token marked blocked, none for an unrouted path, a
  forged jti or a Basic login), listed by ``/auth/tokens/{id}/usage``; and the drain at
  cleanup: a row still being written when the app stops is in the database
  file afterwards, in both apps;
- ``request_logging``: an ``audit_trail`` row for each successful POST, PUT
  or DELETE of the REST surface, none for a refusal or ``/rpc``;
- ``/auth/login``, ``/auth/tokens*``, ``/auth/password``, ``/admin/users*``
  and ``/admin/config``; the reset flow over the SMTP stub (request, the
  mailed token, the page, a weak and a good reset, the old JWT refused, the
  confirmation mail, an unknown account answered alike) and the lockout
  mail."""

import asyncio
import email
import re
import sqlite3

import pytest
from aiohttp.test_utils import TestClient, TestServer

from mcp_context_forge_tpu.gateway import middleware as jax_mw
from mcp_context_forge_tpu.services import csrf_service as jax_csrf
from mcp_context_forge_tpu.utils import jwt as jax_jwt
from mcp_context_forge_tpu_torch.gateway import middleware as port_mw
from torch_auth_pair import (Pair, Session, SmtpStub, basic, bearer, drain, mask, on_both,
                             same, seeded_people)

RESET_TOKEN = re.compile(r"token=([A-Za-z0-9_\-%]+)")


@pytest.fixture(scope="module")
def pair():
    pair = Pair(smtp_use_tls="false", smtp_host="127.0.0.1", password_reset_rate_limit=50)
    pair.smtp = SmtpStub()
    pair.run(pair.smtp.start())
    pair.settings.smtp_port = pair.smtp.port
    yield pair
    pair.run(pair.smtp.stop())
    pair.close()


def statuses(out) -> list[int]:
    return [answer[2] for answer in out]


def jwt_for(settings, claims: dict) -> dict:
    return bearer(jax_jwt.create_token(claims, settings.jwt_secret_key,
                                       audience=settings.jwt_audience,
                                       issuer=settings.jwt_issuer))


def test_middlewares_in_jax_order():
    want = [m.__name__ for m in jax_mw.MIDDLEWARES]
    got = [m.__name__ for m in port_mw.MIDDLEWARES]
    assert got == want
    assert (got.index("token_usage_middleware") < got.index("error_middleware")
            < got.index("auth_middleware") < got.index("csrf_middleware")
            < got.index("password_change_middleware") < got.index("request_logging_middleware"))


CHECK = "/rbac/permissions/check"


def test_csrf_layer(pair, monkeypatch):
    settings = pair.settings

    async def case(session):
        admin_email = settings.platform_admin_email
        body = {"user_email": admin_email, "permission": "llm.chat"}
        admin = session.admin
        for extra in ({"Sec-Fetch-Site": "cross-site"}, {"Origin": "http://evil.example"},
                      {"Sec-Fetch-Site": "same-origin"}, {}):
            await session.call("post", CHECK, body, headers={**admin, **extra})
        await session.call("post", CHECK, body, headers={
            **jwt_for(settings, {"sub": admin_email}), "Sec-Fetch-Site": "cross-site"})
        await session.call("get", "/admin/audit?limit=0", headers={
            **admin, "Sec-Fetch-Site": "cross-site"})
        monkeypatch.setattr(settings, "csrf_trusted_origins_csv", "http://evil.example")
        await session.call("post", CHECK, body, headers={**admin,
                                                         "Origin": "http://evil.example"})
        monkeypatch.setattr(settings, "csrf_trusted_origins_csv", "")
        monkeypatch.setattr(settings, "csrf_check_referer", True)
        await session.call("post", CHECK, body, headers=admin)
        await session.call("post", CHECK, body, headers={**admin,
                                                         "Referer": "http://x.example/"})
        monkeypatch.setattr(settings, "csrf_check_referer", False)
        good = jax_csrf.mint(admin_email, settings.jwt_secret_key)
        other = jax_csrf.mint("someone@corp.example", settings.jwt_secret_key)
        for cookie, echoed in ((good, None), (good, good), (other, other), (good, other)):
            headers = {**admin, "Cookie": f"{settings.csrf_cookie_name}={cookie}"}
            if echoed:
                headers[settings.csrf_header_name] = echoed
            await session.call("post", CHECK, body, headers=headers)
        monkeypatch.setattr(settings, "csrf_exempt_paths_csv", "/rbac/permissions")
        await session.call("post", CHECK, body, headers={**admin,
                                                         "Sec-Fetch-Site": "cross-site"})
        monkeypatch.setattr(settings, "csrf_exempt_paths_csv", "")
        monkeypatch.setattr(settings, "csrf_enabled", False)
        await session.call("post", CHECK, body, headers={**admin,
                                                         "Sec-Fetch-Site": "cross-site"})
        monkeypatch.setattr(settings, "csrf_enabled", True)
        return session.out

    out = on_both(pair, case)
    assert statuses(out) == [403, 403, 200, 200, 200, 200, 200, 403, 200, 403, 200, 403,
                             403, 200, 200]
    assert out[0][3]["code"] == "CSRF_CROSS_SITE" and out[7][3]["code"] == "CSRF_NO_PROVENANCE"
    assert out[9][3]["code"] == "CSRF_TOKEN_INVALID"


def test_password_change_layer(pair, monkeypatch):
    settings = pair.settings
    (user, password), (_, new_password) = seeded_people(70, 2)

    async def case(session):
        await session.call("post", "/admin/users", {
            "email": user, "password": password, "require_password_change": True})
        me = basic(user, password)
        await session.call("get", "/tools", headers=me)
        await session.call("get", "/tools", headers=jwt_for(settings, {"sub": user}))
        await session.call("get", "/tools", headers=jwt_for(
            settings, {"sub": user, "scopes": ["tools.read"]}))
        monkeypatch.setattr(settings, "password_change_enforcement_enabled", False)
        await session.call("get", "/tools", headers=me)
        monkeypatch.setattr(settings, "password_change_enforcement_enabled", True)
        await session.call("post", "/auth/password", {"old_password": "Wrong-pass-123",
                                                      "new_password": new_password}, headers=me)
        await session.call("post", "/auth/password", {"old_password": password,
                                                      "new_password": "weak"}, headers=me)
        await session.call("post", "/auth/password", {"old_password": password,
                                                      "new_password": new_password}, headers=me)
        await session.call("get", "/tools", headers=basic(user, new_password))
        await session.call("post", f"/admin/users/{user}/require-password-change")
        await session.call("get", "/tools", headers=basic(user, new_password))
        await session.call("post", "/admin/users/nobody@corp.example/require-password-change")
        return {"answers": session.out,
                "row": await session.rows("SELECT password_change_required FROM users"
                                          " WHERE email=?", (user,))}

    out = on_both(pair, case)
    assert statuses(out["answers"]) == [201, 403, 403, 200, 200, 401, 422, 200, 200, 200, 403,
                                        404]
    assert out["answers"][1][3]["code"] == "PASSWORD_CHANGE_REQUIRED"


def test_token_usage_layer(pair, monkeypatch):
    settings = pair.settings
    (user, password), = seeded_people(71, 1)

    async def case(session):
        await session.call("post", "/admin/users", {"email": user, "password": password},
                           record=False)
        # the admin mints: tokens.manage
        _, made = await session.call("post", "/auth/tokens", {
            "name": "reader", "permissions": ["tools.read"]})
        reader = bearer(made["token"])
        await session.call("get", "/tools", headers=reader)
        await session.call("get", "/admin/audit", headers=reader)
        await session.call("get", "/no/such/route", headers=reader)
        await session.call("get", "/tools", headers=basic(user, password))
        forged = jax_jwt.create_token({"sub": user, "jti": "f" * 32}, "another-secret-abc",
                                      audience=settings.jwt_audience, issuer=settings.jwt_issuer)
        await session.call("get", "/tools", headers=bearer(forged))
        await session.call("delete", f"/auth/tokens/{made['id']}")
        await session.call("get", "/tools", headers=reader)
        monkeypatch.setattr(settings, "token_usage_logging_enabled", False)
        await session.call("get", "/tools", headers=reader)
        monkeypatch.setattr(settings, "token_usage_logging_enabled", True)
        await drain(session.app)
        await session.call("get", f"/auth/tokens/{made['id']}/usage")
        await session.call("get", "/auth/tokens/" + "0" * 32 + "/usage")
        await session.call("get", f"/auth/tokens/{made['id']}/usage",
                           headers=basic(user, password))
        await session.call("get", "/auth/tokens")
        rows = await session.rows(
            "SELECT user_email, method, path, status, blocked, block_reason, client_ip"
            " FROM token_usage_logs WHERE token_jti=(SELECT jti FROM api_tokens WHERE id=?)"
            " ORDER BY id", (made["id"],))
        return {"answers": session.out, "rows": rows}

    out = on_both(pair, case)
    # the unrouted path resolves no identity: no row, as in JAX
    assert [(r["status"], r["blocked"]) for r in out["rows"]] == [
        (200, 0), (403, 1), (401, 1)]
    assert statuses(out["answers"])[-4:] == [200, 404, 403, 200]


def test_request_logging_audit_rows(pair):
    async def case(session):
        first = await session.rows("SELECT COALESCE(MAX(id), 0) AS m FROM audit_trail")
        _, team = await session.call("post", "/teams", {"name": "audited-72"})
        await session.call("post", "/teams", {"name": "audited-72"})
        await session.call("post", "/rpc", {"jsonrpc": "2.0", "id": 1, "method": "tools/list"})
        _, role = await session.call("post", "/rbac/roles", {"name": "audited-72",
                                                              "permissions": ["tools.read"]})
        await session.call("put", f"/rbac/roles/{role['id']}", {"description": "changed"})
        await session.call("delete", f"/rbac/roles/{role['id']}")
        await session.call("delete", f"/teams/{team['id']}")
        rows = await session.rows("SELECT actor, action, entity_type, entity_id, details"
                                  " FROM audit_trail WHERE id > ? ORDER BY id",
                                  (first[0]["m"],))
        return {"answers": session.out, "rows": rows}

    out = on_both(pair, case)
    assert [r["action"] for r in out["rows"]] == [
        "POST /teams", "POST /rbac/roles", "PUT /rbac/roles/<id1>", "DELETE /rbac/roles/<id1>",
        "DELETE /teams/<id0>"]


def test_auth_and_admin_user_routes(pair, monkeypatch):
    monkeypatch.setattr(pair.settings, "auth_max_failed_attempts", 3)
    (user, password), (other, other_pw) = seeded_people(73, 2)

    async def case(session):
        await session.call("post", "/admin/users", {"email": user, "password": password,
                                                    "full_name": "Seeded User"})
        await session.call("post", "/admin/users", {"email": user, "password": password})
        await session.call("post", "/admin/users", {"email": other, "password": "weak"})
        await session.call("post", "/admin/users", {"email": other, "password": other_pw},
                           headers=basic(user, password))
        await session.call("post", "/auth/login", {"email": user, "password": password},
                           headers={})
        await session.call("post", "/auth/login", {"username": user, "password": password},
                           headers={})
        for _ in range(3):
            await session.call("post", "/auth/login", {"email": user, "password": "Wrong-123A"},
                               headers={})
        await session.call("post", "/auth/login", {"email": user, "password": password},
                           headers={})
        await session.call("post", f"/admin/users/{user}/toggle")
        await session.call("post", f"/admin/users/{user}/toggle")
        await session.call("post", "/admin/users/nobody@corp.example/toggle")
        status, users = await session.call("get", "/admin/users", record=False)
        status, config = await session.call("get", "/admin/config", record=False)
        await session.call("get", "/admin/config", headers=basic(other, other_pw))
        await session.call("get", "/auth/tokens", headers={})
        return {"answers": session.out,
                "users": [u for u in users if u["email"] in (user, other)],
                "config": config}

    out = on_both(pair, case)
    assert statuses(out["answers"]) == [201, 409, 422, 403, 200, 200, 401, 401, 401, 401,
                                        200, 200, 404, 401, 401]
    assert out["answers"][9][3]["detail"] == "Account locked"
    secret = next(c for c in out["config"] if c["name"] == "jwt_secret_key")
    assert secret["value"] == "***redacted***"


def mails_to(pair, address: str) -> list:
    out = []
    for message in pair.smtp.messages:
        parsed = email.message_from_string(message["data"])
        if parsed["To"] == address:
            out.append((parsed["Subject"], parsed.get_payload(decode=True).decode()))
    return out


def test_reset_flow_and_lockout_mail_over_smtp(pair, monkeypatch):
    settings = pair.settings
    for name, value in (("smtp_enabled", True), ("password_reset_enabled", True),
                        ("account_lockout_notification_enabled", True),
                        ("auth_max_failed_attempts", 2)):
        monkeypatch.setattr(settings, name, value)
    (user, password), (_, new_password), (locked, locked_pw) = seeded_people(74, 3)
    got = {}
    for name in ("jax", "port"):
        session = Session(pair, name)

        async def case():
            await session.call("post", "/admin/users", {"email": user, "password": password})
            old = jwt_for(settings, {"sub": user, "iat": 1_700_000_000})
            await session.call("get", "/tools", headers=old)
            before = len(pair.smtp.messages)
            await session.call("post", "/auth/password/reset-request", {"email": user},
                               headers={})
            await session.call("post", "/auth/password/reset-request",
                               {"email": "nobody@corp.example"}, headers={})
            await session.call("post", "/auth/password/reset-request", ["x"], headers={})
            await pair.smtp.wait(before + 1)
            await drain(session.app)
            subject, body = mails_to(pair, user)[-1]
            token = RESET_TOKEN.search(body).group(1)
            status, page = await session.call("get", f"/auth/password/reset?token={token}",
                                              headers={}, record=False)
            session.out.append(("page", status, "Choose a new password" in page))
            await session.call("post", "/auth/password/reset",
                               {"token": token, "new_password": "weak"}, headers={})
            await session.call("post", "/auth/password/reset",
                               {"token": token, "new_password": new_password}, headers={})
            await session.call("post", "/auth/password/reset",
                               {"token": token, "new_password": new_password}, headers={})
            await session.call("get", "/tools", headers=old)
            await session.call("get", "/tools", headers=basic(user, new_password))
            await drain(session.app)
            await pair.smtp.wait(before + 2)
            # the lockout mail
            await session.call("post", "/admin/users", {"email": locked, "password": locked_pw})
            for _ in range(2):
                await session.call("post", "/auth/login", {"email": locked,
                                                           "password": "Wrong-pass-9"},
                                   headers={})
            await pair.smtp.wait(before + 3)
            await asyncio.sleep(0.05)
            monkeypatch.setattr(settings, "password_reset_enabled", False)
            await session.call("post", "/auth/password/reset-request", {"email": user},
                               headers={})
            await session.call("get", "/auth/password/reset", headers={})
            monkeypatch.setattr(settings, "password_reset_enabled", True)
            subjects = [s for s, _ in mails_to(pair, user) + mails_to(pair, locked)]
            return {"answers": session.out, "subjects": subjects,
                    "nobody": mails_to(pair, "nobody@corp.example"),
                    "mail": mask(body.replace(token, "<reset>"), {})}

        got[name] = mask(pair.run(case()), session.ids)
        # the next app's users are new to its own database, not to the stub
        pair.smtp.messages.clear()
    out = same(got)
    codes = [a[2] if a[0] != "page" else a[1] for a in out["answers"]]
    # a weak password, the reset, the spent token (401), the old JWT (401)
    assert codes == [201, 200, 202, 202, 400, 200, 422, 200, 401, 401, 200, 201, 401, 401,
                     404, 404]
    assert len(out["subjects"]) == 3 and out["nobody"] == []
    assert "locked" in out["subjects"][-1]


def test_token_usage_drained_before_the_database_closes(tmp_path, monkeypatch):
    """A token-usage row still being written when the app stops is in the
    database file afterwards: the cleanup drains the task set before the
    database closes (both apps, each over a file of its own)."""
    import dataclasses

    from mcp_context_forge_tpu.config import load_settings
    from mcp_context_forge_tpu.gateway.app import build_app
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
    from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app
    from torch_auth_pair import ENV

    counts = {}
    loop = asyncio.new_event_loop()
    try:
        for name in ("jax", "port"):
            path = tmp_path / f"{name}.db"
            settings = load_settings(env={**ENV, "MCPFORGE_DATABASE_URL": f"sqlite:///{path}"},
                                     env_file=None)

            async def run():
                if name == "jax":
                    app = await build_app(settings)
                else:
                    config = dataclasses.replace(EngineConfig.from_settings(settings),
                                                 device="cpu")
                    app = build_llm_app(settings, engine=TorchEngine(config))
                client = TestClient(TestServer(app))
                await client.start_server()
                db = app["ctx"].db
                execute = db.execute

                async def slow_execute(sql, params=()):
                    if sql.startswith("INSERT INTO token_usage_logs"):
                        await asyncio.sleep(0.3)
                    return await execute(sql, params)

                admin = basic(settings.basic_auth_user, settings.basic_auth_password)
                resp = await client.post("/auth/tokens", json={"name": "t",
                                                               "permissions": ["tools.read"]},
                                         headers=admin)
                token = (await resp.json())["token"]
                monkeypatch.setattr(db, "execute", slow_execute)
                resp = await client.get("/tools", headers=bearer(token))
                assert resp.status == 200
                pending = len(app["_token_usage_tasks"])
                await client.close()
                return pending

            pending = loop.run_until_complete(asyncio.wait_for(run(), 120))
            monkeypatch.undo()
            with sqlite3.connect(path) as conn:
                rows = conn.execute("SELECT count(*) FROM token_usage_logs").fetchone()[0]
            counts[name] = (pending, rows)
    finally:
        loop.close()
    assert counts["port"] == counts["jax"] == (1, 1)
