"""The port's ``AuthService`` (``services/auth_service.py``) against the JAX
package's, on the CPU. Each case runs the same calls, on seeded emails and
passwords (``default_rng``), against the JAX gateway's service and the
port app's (one pair for the module, each over its own in-memory database
laid out the same way by the same calls), and records each call's result,
or its exception's class name and message, with the rows it wrote. The two
records compare exactly once ids, JWTs and times are masked:

- the password policy's refusals, one per rule, and ``create_user``;
- the lockout (``auth_max_failed_attempts``), its 401 while locked, its
  expiry, and the counter's reset after an expired lock;
- reset tokens: issue, the rate limit, the policy, single use, expiry, SSO
  and unknown accounts, and ``tokens_valid_after``;
- API tokens: the grantor's caps, the lifetime cap, list, revoke (the
  ``tokens.revoked`` event on the bus) and the last-use stamp;
- every ``resolve_bearer`` / ``resolve_basic`` case: no users row, the
  platform admin, scoped (with and without ``admin.all``), deactivated,
  invalidated by a reset, revoked, the cached Basic digest and its drop on
  a failure, and the resolution cache's invalidation after a role grant;
- ``effective_permissions`` over global and team-scoped roles."""

import dataclasses
import time

import pytest

from mcp_context_forge_tpu.utils import jwt as jax_jwt
from torch_auth_pair import Pair, mask, seeded_people


@pytest.fixture(scope="module")
def pair():
    pair = Pair(auth_cache_user_ttl=30, auth_cache_role_ttl=30, auth_cache_teams_ttl=30)
    yield pair
    pair.close()


async def outcome(coro):
    try:
        result = await coro
    except Exception as exc:
        return (type(exc).__name__, str(exc))
    if dataclasses.is_dataclass(result):
        result = {k: sorted(v) if isinstance(v, set) else v
                  for k, v in dataclasses.asdict(result).items()}
    if isinstance(result, tuple) and result and isinstance(result[0], set):
        result = (sorted(result[0]), *result[1:])
    return ("ok", result)


def _sync(fn, *args):
    async def run():
        return fn(*args)
    return run()


class Side:
    """One package's service, database and bus events."""

    def __init__(self, app):
        self.app = app
        self.svc = app["auth_service"]
        self.db = app["ctx"].db
        self.settings = app["ctx"].settings
        self.events: list = []

    async def row(self, sql, params=()):
        row = await self.db.fetchone(sql, params)
        return dict(row) if row else None

    def jwt(self, claims, **kwargs):
        s = self.settings
        return jax_jwt.create_token(claims, s.jwt_secret_key, audience=s.jwt_audience,
                                    issuer=s.jwt_issuer, **kwargs)


def run_both(pair, case):
    got = {}
    for name in ("jax", "port"):
        side = Side(pair.app(name))
        got[name] = mask(pair.run(case(side)), {})
    return got


def agree(pair, case):
    got = run_both(pair, case)
    assert got["port"] == got["jax"]
    return got["port"]


def _people(seed, n):
    return seeded_people(seed, n)


# ---------------------------------------------------------------- cases

POLICY = ["short1A", "alllowercase123", "ALLUPPERCASE123", "NoDigitsHereAtAll",
          "Password123456", "Welcome12345A", "Letmein!2024A", "A" * 300 + "a1",
          "Good-Passw0rd-Here", "Abcdefgh1234"]


def test_password_policy_refusals(pair):
    email, _ = _people(1, 1)[0]

    async def case(side):
        out = [await outcome(_sync(side.svc.validate_password_policy, pw, email))
               for pw in POLICY]
        local = email.split("@")[0]
        out.append(await outcome(_sync(side.svc.validate_password_policy,
                                       f"X{local}12345678", email)))
        return out

    out = agree(pair, case)
    # refused: too short, no upper, no lower, no digit, a denylisted word
    # under its padding, too long, derived from the email; the rest pass
    assert [kind for kind, _ in out] == ["ValidationFailure"] * 5 + ["ok", "ok"] + [
        "ValidationFailure", "ok", "ok", "ValidationFailure"]


def test_create_user_and_conflict(pair):
    (email, password), (bad, _) = _people(2, 2)

    async def case(side):
        return [await outcome(side.svc.create_user(email, password, full_name="Seeded")),
                await outcome(side.svc.create_user(email, password)),
                await outcome(side.svc.create_user(bad, "weak", enforce_policy=True)),
                await side.row("SELECT email, full_name, is_admin, is_active,"
                               " auth_provider, password_change_required, failed_login_attempts"
                               " FROM users WHERE email=?", (email,)),
                await side.row("SELECT email FROM users WHERE email=?", (bad,))]

    out = agree(pair, case)
    assert out[0] == ("ok", None) and out[1][0] == "ConflictError"


def test_lockout_and_expiry(pair, monkeypatch):
    monkeypatch.setattr(pair.settings, "auth_max_failed_attempts", 3)
    monkeypatch.setattr(pair.settings, "auth_lockout_seconds", 60.0)
    email, password = _people(3, 1)[0]

    async def case(side):
        await side.svc.create_user(email, password)
        out = [await outcome(side.svc.verify_password(email, "Wrong-pass-123"))
               for _ in range(3)]
        out.append(await side.row("SELECT failed_login_attempts, locked_until IS NOT NULL"
                                  " AS locked FROM users WHERE email=?", (email,)))
        out.append(await outcome(side.svc.verify_password(email, password)))
        # the lock runs out
        await side.db.execute("UPDATE users SET locked_until=? WHERE email=?",
                              (time.time() - 1, email))
        out.append(await outcome(side.svc.verify_password(email, "Wrong-pass-123")))
        out.append(await side.row("SELECT failed_login_attempts, locked_until IS NOT NULL"
                                  " AS locked FROM users WHERE email=?", (email,)))
        out.append(await outcome(side.svc.verify_password(email, password)))
        out.append(await side.row("SELECT failed_login_attempts, locked_until,"
                                  " last_login IS NOT NULL AS logged FROM users WHERE email=?",
                                  (email,)))
        out.append(await outcome(side.svc.verify_password("nobody@corp.example", password)))
        return out

    out = agree(pair, case)
    assert out[3] == {"failed_login_attempts": 3, "locked": 1}
    assert out[4] == ("AuthError", "Account locked") and out[7] == ("ok", True)


def test_reset_tokens(pair, monkeypatch):
    monkeypatch.setattr(pair.settings, "password_reset_rate_limit", 3)
    (email, password), (sso_email, _), (_, new_password) = _people(4, 3)

    async def case(side):
        await side.svc.create_user(email, password)
        await side.db.execute(
            "INSERT INTO users (email, password_hash, auth_provider, created_at, updated_at)"
            " VALUES (?,?,?,?,?)", (sso_email, "!sso!", "github", time.time(), time.time()))
        tokens = [await side.svc.request_password_reset(email) for _ in range(4)]
        out = [[t is not None for t in tokens],
               await outcome(side.svc.request_password_reset(sso_email)),
               await outcome(side.svc.request_password_reset("nobody@corp.example")),
               await outcome(side.svc.reset_password(tokens[0], "weak")),
               await outcome(side.svc.reset_password(tokens[0], new_password)),
               await outcome(side.svc.reset_password(tokens[0], new_password)),
               await outcome(side.svc.reset_password("not-a-token", new_password))]
        await side.db.execute("UPDATE password_reset_tokens SET expires_at=?",
                              (time.time() - 1,))
        out.append(await outcome(side.svc.reset_password(tokens[1], new_password)))
        out.append(await side.row(
            "SELECT failed_login_attempts, locked_until, password_change_required,"
            " tokens_valid_after IS NOT NULL AS cut FROM users WHERE email=?", (email,)))
        out.append(await outcome(side.svc.verify_password(email, password)))
        out.append(await outcome(side.svc.verify_password(email, new_password)))
        out.append(await outcome(side.svc.verify_password(sso_email, "whatever")))
        return out

    out = agree(pair, case)
    assert out[0] == [True, True, True, False]
    assert out[4] == ("ok", _people(4, 3)[0][0]) and out[5][0] == "AuthError"


def test_api_tokens_mint_revoke_list(pair, monkeypatch):
    email, password = _people(5, 1)[0]

    async def case(side):
        await side.svc.create_user(email, password)
        events = []

        async def on_revoke(topic, message):
            events.append((topic, message))

        side.app["ctx"].bus.subscribe("tokens.revoked", on_revoke)
        me = await side.svc.resolve_bearer(side.svc.issue_jwt(email))
        out = [await outcome(side.svc.create_api_token(email, "x", permissions=["admin.all"],
                                                       grantor=me)),
               await outcome(side.svc.create_api_token(email, "x", permissions=["no.such"],
                                                       grantor=me))]
        token, token_id = await side.svc.create_api_token(
            email, "chat", permissions=["llm.chat", "tools.read"], grantor=me)
        scoped = await side.svc.resolve_bearer(token)
        out.append(await outcome(side.svc.create_api_token(email, "child", grantor=scoped)))
        server_scoped = dataclasses.replace(me, server_id="srv-1")
        out.append(await outcome(side.svc.create_api_token(
            email, "x", server_id="srv-2", grantor=server_scoped)))
        monkeypatch.setattr(side.settings, "api_token_max_lifetime_minutes", 30.0)
        capped, capped_id = await side.svc.create_api_token(email, "capped",
                                                            expires_minutes=999)
        monkeypatch.setattr(side.settings, "api_token_max_lifetime_minutes", 0.0)
        out.append(await side.row("SELECT CAST(ROUND(expires_at - created_at) AS INTEGER)"
                                  " AS life FROM api_tokens WHERE id=?", (capped_id,)))
        out.append(await outcome(side.svc.resolve_bearer(token)))
        out.append(await side.row("SELECT last_used IS NOT NULL AS used, permissions"
                                  " FROM api_tokens WHERE id=?", (token_id,)))
        out.append(sorted((r["name"], r["revoked_at"] is None)
                          for r in await side.svc.list_api_tokens(email)))
        out.append(await outcome(side.svc.revoke_token(token_id)))
        out.append(await outcome(side.svc.revoke_token("no-such-token")))
        out.append(await outcome(side.svc.resolve_bearer(token)))
        out.append(await outcome(side.svc.resolve_bearer(capped)))
        out.append([(topic, sorted(message)) for topic, message in events])
        return out

    out = agree(pair, case)
    assert out[0][0] == out[1][0] == out[3][0] == "PermissionDenied"
    assert out[4] == {"life": 1800}
    assert out[10] == ("AuthError", "Token revoked")
    assert out[12] == [("tokens.revoked", ["jti"])]


def test_resolve_bearer_cases(pair):
    (user, password), (gone, gone_pw) = _people(6, 2)

    async def case(side):
        s = side.settings
        await side.svc.create_user(user, password)
        await side.svc.create_user(gone, gone_pw)
        out = [await outcome(side.svc.resolve_bearer(side.jwt({"sub": s.platform_admin_email}))),
               await outcome(side.svc.resolve_bearer(side.jwt({"sub": "nobody@corp.example"}))),
               await outcome(side.svc.resolve_bearer(side.jwt({"sub": user}))),
               await outcome(side.svc.resolve_bearer(side.jwt(
                   {"sub": s.platform_admin_email, "scopes": ["tools.read"]}))),
               await outcome(side.svc.resolve_bearer(side.jwt(
                   {"sub": s.platform_admin_email, "scopes": ["admin.all"]}))),
               await outcome(side.svc.resolve_bearer(side.jwt({"scopes": ["tools.read"]}))),
               await outcome(side.svc.resolve_bearer("not.a.token"))]
        await side.db.execute("UPDATE users SET is_active=0 WHERE email=?", (gone,))
        side.svc.invalidate_user(gone)
        out.append(await outcome(side.svc.resolve_bearer(side.jwt({"sub": gone}))))
        # a reset's cutoff kills older sessions; a token minted after lives
        old = side.jwt({"sub": user, "iat": int(time.time()) - 100})
        await side.db.execute("UPDATE users SET tokens_valid_after=? WHERE email=?",
                              (float(int(time.time()) - 10), user))
        side.svc.invalidate_user(user)
        out.append(await outcome(side.svc.resolve_bearer(old)))
        out.append(await outcome(side.svc.resolve_bearer(side.jwt({"sub": user}))))
        await side.db.execute("UPDATE users SET password_change_required=1 WHERE email=?",
                              (user,))
        out.append(await outcome(side.svc.resolve_bearer(side.jwt({"sub": user}))))
        side.svc.invalidate_user(user)
        out.append(await outcome(side.svc.resolve_bearer(side.jwt({"sub": user}))))
        return out

    out = agree(pair, case)
    admin = out[0][1]
    assert admin["is_admin"] and "llm.admin" in admin["permissions"]   # fault 1
    assert out[3][1]["is_admin"] is False and out[4][1]["is_admin"] is True
    assert out[7] == ("AuthError", "User deactivated")
    assert out[8] == ("AuthError", "Token invalidated by password reset")
    # cached for the TTL: the flag shows only after the invalidation
    assert not out[10][1]["password_change_required"]
    assert out[11][1]["password_change_required"]


def test_resolve_basic_cases(pair):
    (user, password), (other, other_pw) = _people(7, 2)

    async def case(side):
        s = side.settings
        await side.svc.create_user(user, password)
        await side.svc.create_user(other, other_pw)
        out = [await outcome(side.svc.resolve_basic(s.basic_auth_user, s.basic_auth_password)),
               await outcome(side.svc.resolve_basic(s.basic_auth_user, "wrong")),
               await outcome(side.svc.resolve_basic(user, password))]
        login = await side.row("SELECT last_login FROM users WHERE email=?", (user,))
        # the cached digest: no KDF and no users-table write on a repeat
        out.append(await outcome(side.svc.resolve_basic(user, password)))
        again = await side.row("SELECT last_login FROM users WHERE email=?", (user,))
        out.append(login == again)
        out.append(("basic_ok", user) in side.svc._cache)
        out.append(await outcome(side.svc.resolve_basic(user, "Wrong-pass-123")))
        out.append(("basic_ok", user) in side.svc._cache)
        out.append(await side.row("SELECT failed_login_attempts FROM users WHERE email=?",
                                  (user,)))
        await side.db.execute("UPDATE users SET is_active=0 WHERE email=?", (other,))
        out.append(await outcome(side.svc.resolve_basic(other, other_pw)))
        return out

    out = agree(pair, case)
    assert out[0][1]["is_admin"] and out[2][1]["via"] == "basic"
    assert out[4] is True and out[5] is True and out[7] is False
    assert out[9] == ("AuthError", "Invalid credentials")


def test_role_grants_invalidation_and_effective_permissions(pair):
    (user, password), (member, member_pw) = _people(8, 2)

    async def case(side):
        roles, teams = side.app["role_service"], side.app["team_service"]
        await side.svc.create_user(user, password)
        await side.svc.create_user(member, member_pw)
        out = [await outcome(side.svc.effective_permissions(user)),
               await outcome(side.svc.effective_permissions("nobody@corp.example")),
               await outcome(side.svc.effective_permissions(side.settings.platform_admin_email))]
        token = side.jwt({"sub": user})
        before = await side.svc.resolve_bearer(token)
        role = await roles.create_role("auditor-8", ["observability.read", "export.run"])
        await roles.assign_role(user, role["id"], granted_by="admin")
        cached = await side.svc.resolve_bearer(token)
        side.svc.invalidate_user(user)
        after = await side.svc.resolve_bearer(token)
        out.append([sorted(c.permissions - before.permissions) for c in (cached, after)])
        team = await teams.create_team("team-eight", created_by=member)
        scoped = await roles.create_role("team-dev-8", ["tools.create"], scope="team")
        await roles.assign_role(user, scoped["id"], scope_id=team["id"])
        await roles.assign_role(member, scoped["id"], scope_id=team["id"])
        side.svc.invalidate_user(user)
        side.svc.invalidate_user(member)
        out.append(await outcome(side.svc.effective_permissions(user)))
        out.append(await outcome(side.svc.effective_permissions(member)))
        return out

    out = agree(pair, case)
    assert out[1][0] == "NotFoundError"
    assert out[3] == [[], ["export.run", "observability.read"]]
    assert "tools.create" not in out[4][1][0] and "tools.create" in out[5][1][0]
