"""The port's OAuth and SSO (``services/oauth_service.py`` and the routes of
``gateway/routers_rbac.py``) against the JAX gateway's, on the CPU, over
stub endpoints on 127.0.0.1 (an aiohttp token endpoint, OIDC IdPs, a
GitHub-shaped provider, a DCR authorization server, a token-exchange
endpoint). Each case runs the same calls on both apps (one pair for the
module) and compares what each answered, what the stubs saw and the rows
written, once ids, JWTs, states, times and ports are masked:

- ``OAuthManager``: the client-credentials Bearer, its cache (one issue for
  two calls), the refresh of a token past its expiry, a refused secret;
- fault 2's pin: a REST tool with ``auth_type`` "oauth" called twice with
  ``tools/call`` reaches its upstream with the issued Bearer both times
  from one issue (the parent port sent no Authorization);
- SSO: OIDC (discovery, state, the replayed state's 422, the JWT admitted
  on ``/tools``), the GitHub, Keycloak, Entra and Okta dialects (their
  scopes, claims, admin groups and team mapping), Google as plain OIDC, the
  trusted-domain refusal and an unknown provider;
- DCR (``/oauth/dcr/register``, list, delete with its upstream
  de-registration) and ``/oauth/exchange`` (RFC 8693)."""

from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest
from aiohttp import web

from torch_auth_pair import Pair, id_token, mask, on_both, stub_server


@pytest.fixture(scope="module")
def pair():
    pair = Pair()
    yield pair
    pair.close()


def names(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, 7)) for _ in range(n)]


async def token_endpoint(secret: str, expires_in: int = 3600):
    """A client-credentials token endpoint; ``issued`` counts its tokens."""
    issued = []

    async def token(request):
        form = await request.post()
        if form.get("client_secret") != secret:
            return web.json_response({"error": "invalid_client"}, status=401)
        issued.append(dict(form))
        return web.json_response({"access_token": f"cc-token-{len(issued)}",
                                  "expires_in": expires_in})

    client = await stub_server({("POST", "/token"): token})
    return client, issued


def base_of(client) -> str:
    return f"http://127.0.0.1:{client.server.port}"


def test_client_credentials_cache_refresh_and_refusal(pair):
    cid, = names(1, 1)

    async def case(session):
        oauth = session.app["ctx"].extras["oauth_manager"]
        stub, issued = await token_endpoint("s3cret")
        short, short_issued = await token_endpoint("s3cret", expires_in=10)
        try:
            value = {"token_url": base_of(stub) + "/token", "client_id": cid,
                     "client_secret": "s3cret", "scope": "tools"}
            out = [await oauth.headers_for(value), await oauth.headers_for(value), len(issued)]
            # a token within 30 s of its expiry is fetched anew on each call
            near = {**value, "token_url": base_of(short) + "/token"}
            out += [await oauth.headers_for(near), await oauth.headers_for(near),
                    len(short_issued)]
            try:
                await oauth.headers_for({**value, "client_secret": "nope"})
            except Exception as exc:
                out.append((type(exc).__name__, exc.response.status_code))
            out.append(sorted(issued[0].items()))
            return out
        finally:
            await stub.close()
            await short.close()

    out = on_both(pair, case)
    assert out[:3] == [{"authorization": "Bearer cc-token-1"}] * 2 + [1]
    assert out[5] == 2 and out[6] == ("HTTPStatusError", 401)


def test_oauth_rest_tool_sends_the_issued_bearer(pair):
    """Fault 2: the port's ``resolve_auth_headers`` added no header for an
    ``oauth`` tool."""
    tool, = names(2, 1)

    async def case(session):
        stub, issued = await token_endpoint("s3cret")
        seen = []

        async def api(request):
            seen.append(request.headers.get("authorization", ""))
            return web.json_response({"echo": (await request.json())})

        upstream = await stub_server({("POST", "/api"): api})
        try:
            await session.call("post", "/tools", {
                "name": tool, "integration_type": "REST", "request_type": "POST",
                "url": base_of(upstream) + "/api", "auth_type": "oauth",
                "auth_value": {"token_url": base_of(stub) + "/token",
                               "client_id": "cid", "client_secret": "s3cret"}})
            for rid in (1, 2):
                await session.call("post", "/rpc", {
                    "jsonrpc": "2.0", "id": rid, "method": "tools/call",
                    "params": {"name": tool, "arguments": {"n": rid}}})
            sealed = await session.rows("SELECT auth_type, auth_value LIKE 'enc:%' AS sealed"
                                        " FROM tools WHERE original_name=?", (tool,))
            return {"answers": session.out, "upstream_saw": seen, "issued": len(issued),
                    "row": sealed}
        finally:
            await upstream.close()
            await stub.close()

    out = on_both(pair, case)
    assert out["upstream_saw"] == ["Bearer cc-token-1"] * 2 and out["issued"] == 1
    assert [status for _, _, status, _ in out["answers"]] == [201, 200, 200]


async def oidc_idp(claims: dict, code: str = "good-code"):
    """An OIDC IdP (discovery and a token endpoint minting an id_token of
    ``claims``); ``calls`` records each token request's form."""
    calls = []

    async def discovery(request):
        base = f"http://{request.host}"
        return web.json_response({"authorization_endpoint": f"{base}/authorize",
                                  "token_endpoint": f"{base}/token"})

    async def token(request):
        form = await request.post()
        calls.append(dict(form))
        if form.get("code") != code:
            return web.json_response({"error": "invalid_grant"}, status=400)
        return web.json_response({"access_token": "at", "id_token": id_token(claims)})

    client = await stub_server({("GET", "/.well-known/openid-configuration"): discovery,
                                ("POST", "/token"): token})
    return client, calls


async def round_trip(session, provider: str, code: str = "good-code"):
    """login (302, the location masked) then the callback; the JWT, when
    one came, is tried on ``GET /tools``."""
    await session.call("get", f"/auth/sso/{provider}/login", headers={},
                       allow_redirects=False)
    location = session.headers.get("location", "")
    state = parse_qs(urlsplit(location).query)["state"][0]
    session.out[-1] = (*session.out[-1][:3], mask(location, {}))
    status, body = await session.call(
        "get", f"/auth/sso/{provider}/callback?state={state}&code={code}", headers={})
    if status == 200:
        await session.call("get", "/tools", headers={
            "Authorization": f"Bearer {body['access_token']}"})
    return state


@pytest.mark.parametrize("dialect", ["oidc", "google", "keycloak", "entra", "okta"])
def test_sso_dialects(pair, dialect):
    local, team_name, group = names(10 + len(dialect), 3)
    email = f"{local}@corp.example"
    claims = {
        "oidc": {"email": email, "name": "Oidc User"},
        "google": {"email": email, "name": "G User", "email_verified": True},
        "keycloak": {"email": email, "preferred_username": local,
                     "realm_access": {"roles": [f"{group}-admins"]},
                     "resource_access": {"gateway": {"roles": ["operator"]}}},
        "entra": {"preferred_username": email, "name": "Entra User",
                  "roles": [f"{group}.Admin"]},
        "okta": {"email": email, "name": "Okta User", "okta_groups": ["Everyone", "Admins"]},
    }[dialect]

    async def case(session):
        idp, calls = await oidc_idp(claims)
        try:
            _, team = await session.call("post", "/teams", {"name": team_name})
            metadata = {
                "oidc": {},
                "google": {},
                "keycloak": {"map_realm_roles": True, "map_client_roles": True,
                             "admin_groups": [f"{group}-admins"],
                             "team_mapping": {"gateway:operator": team["id"]}},
                "entra": {"admin_groups": [f"{group}.Admin"]},
                "okta": {"groups_claim": "okta_groups", "admin_groups": ["Admins"],
                         "team_mapping": {"Everyone": team["id"]}},
            }[dialect]
            session.app["sso_service"].register_provider(
                dialect, base_of(idp), f"{dialect}-client", f"{dialect}-secret",
                dialect=dialect, metadata=metadata)
            await session.call("get", "/auth/sso/providers", headers={})
            state = await round_trip(session, dialect)
            # the state is single use
            await session.call("get", f"/auth/sso/{dialect}/callback?state={state}"
                                      "&code=good-code", headers={})
            # a second login refreshes nothing it should not
            await round_trip(session, dialect)
            await session.call("delete", f"/teams/{team['id']}")
            user = await session.rows("SELECT email, full_name, is_admin, is_active,"
                                      " auth_provider, password_hash FROM users"
                                      " WHERE email=?", (email,))
            members = await session.rows("SELECT role FROM team_members"
                                         " WHERE user_email=?", (email,))
            return {"answers": session.out, "token_calls": [sorted(c) for c in calls],
                    "user": user, "members": members}
        finally:
            await idp.close()

    out = on_both(pair, case)
    assert out["user"][0]["is_admin"] == (0 if dialect in ("oidc", "google") else 1)
    assert [a[2] for a in out["answers"]][2:] == [302, 200, 200, 422, 302, 200, 200, 204]


def test_sso_github_dialect(pair):
    local, = names(20, 1)
    email = f"{local}@octo.example"

    async def case(session):
        seen = []

        async def token(request):
            form = await request.post()
            seen.append(request.headers.get("accept"))
            if form.get("code") != "gh-code":
                return web.json_response({"error": "bad_verification_code"}, status=400)
            return web.json_response({"access_token": "gho_testtoken", "token_type": "bearer"})

        async def user(request):
            seen.append(request.headers.get("authorization"))
            return web.json_response({"login": local, "name": "Octo Cat", "email": None})

        async def emails(request):
            return web.json_response([
                {"email": f"second-{email}", "primary": False, "verified": True},
                {"email": email, "primary": True, "verified": True}])

        github = await stub_server({("POST", "/login/oauth/access_token"): token,
                                    ("GET", "/user"): user, ("GET", "/user/emails"): emails})
        try:
            session.app["sso_service"].register_provider(
                "github", base_of(github), "gh-client", "gh-secret", dialect="github",
                userinfo_endpoint=base_of(github) + "/user")
            await round_trip(session, "github", code="gh-code")
            await round_trip(session, "github", code="wrong")
            return {"answers": session.out, "seen": seen,
                    "user": await session.rows("SELECT email, full_name, auth_provider"
                                               " FROM users WHERE email=?", (email,))}
        finally:
            await github.close()

    out = on_both(pair, case)
    assert "scope=read:user+user:email" in out["answers"][0][3]
    assert out["user"] == [{"email": email, "full_name": "Octo Cat", "auth_provider": "github"}]


def test_sso_refusals(pair, monkeypatch):
    local, = names(30, 1)

    async def case(session):
        idp, _ = await oidc_idp({"email": f"{local}@elsewhere.example", "name": "X"})
        try:
            session.app["sso_service"].register_provider("corp", base_of(idp), "c", "s")
            monkeypatch.setattr(session.settings, "sso_trusted_domains_csv", "corp.example")
            await round_trip(session, "corp")
            monkeypatch.setattr(session.settings, "sso_trusted_domains_csv", "")
            monkeypatch.setattr(session.settings, "sso_require_admin_approval", True)
            await round_trip(session, "corp")
            await round_trip(session, "corp")
            monkeypatch.setattr(session.settings, "sso_require_admin_approval", False)
            await session.call("get", "/auth/sso/nowhere/login", headers={},
                               allow_redirects=False)
            await session.call("get", "/auth/sso/corp/callback?state=forged&code=x", headers={})
            return {"answers": session.out,
                    "user": await session.rows("SELECT is_active FROM users WHERE email=?",
                                               (f"{local}@elsewhere.example",))}
        finally:
            await idp.close()

    out = on_both(pair, case)
    assert [a[2] for a in out["answers"]] == [302, 422, 302, 422, 302, 422, 404, 422]
    assert out["user"] == [{"is_active": 0}]


def test_dcr_and_token_exchange(pair):
    gateway_id, = names(40, 1)

    async def case(session):
        registered, deleted, exchanged = [], [], []

        async def metadata(request):
            base = f"http://{request.host}"
            return web.json_response({"issuer": base, "registration_endpoint": f"{base}/reg",
                                      "token_endpoint": f"{base}/token"})

        async def register(request):
            body = await request.json()
            registered.append(body)
            base = f"http://{request.host}"
            return web.json_response({"client_id": f"dyn-{len(registered)}",
                                      "client_secret": "dyn-secret",
                                      "registration_client_uri": f"{base}/reg/1",
                                      "registration_access_token": "rat"}, status=201)

        async def deregister(request):
            deleted.append(request.headers.get("authorization"))
            return web.Response(status=204)

        async def token(request):
            form = await request.post()
            exchanged.append(sorted(form.items()))
            if form.get("subject_token") != "inbound":
                return web.json_response({"error": "invalid_grant"}, status=400)
            return web.json_response({"access_token": "upstream-token",
                                      "issued_token_type":
                                      "urn:ietf:params:oauth:token-type:access_token"})

        server = await stub_server({
            ("GET", "/.well-known/oauth-authorization-server"): metadata,
            ("POST", "/reg"): register, ("DELETE", "/reg/1"): deregister,
            ("POST", "/token"): token})
        try:
            issuer = base_of(server)
            body = {"gateway_id": gateway_id, "issuer": issuer, "scopes": ["read", "write"]}
            status, record = await session.call("post", "/oauth/dcr/register", body)
            await session.call("post", "/oauth/dcr/register", body)
            await session.call("post", "/oauth/dcr/register", {
                "gateway_id": gateway_id, "issuer": "http://127.0.0.1:9/none"})
            await session.call("get", "/oauth/dcr/clients")
            await session.call("delete", f"/oauth/dcr/clients/{record['id']}")
            await session.call("delete", f"/oauth/dcr/clients/{record['id']}")
            for subject in ("inbound", "forged"):
                await session.call("post", "/oauth/exchange", {
                    "token_url": issuer + "/token", "subject_token": subject,
                    "client_id": "cid", "client_secret": "cs", "audience": "upstream"})
            return {"answers": session.out, "registered": registered, "deleted": deleted,
                    "exchanged": exchanged}
        finally:
            await server.close()

    out = on_both(pair, case)
    assert [a[2] for a in out["answers"]] == [201, 201, 422, 200, 204, 404, 200, 422]
    assert len(out["registered"]) == 1 and out["deleted"] == ["Bearer rat"]
