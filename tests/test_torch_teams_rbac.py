"""The port's teams and roles (``services/team_service.py``,
``services/role_service.py``, the ``/teams*`` routes of
``gateway/routers_chat.py`` and the ``/rbac/*`` routes of
``gateway/routers_rbac.py``) against the JAX gateway's, on the CPU. Each
case sends the same requests to both apps (one pair for the module; users
made by ``POST /admin/users`` from seeded emails and passwords, logging in
with Basic credentials or JWTs) and compares every status and body, with
ids, JWTs and times masked, and the rows the services wrote:

- the system roles seeded at startup and their protection; role CRUD and
  its refusals (an unknown permission, a duplicate name, an unknown id);
- a grant flips ``require`` on the user's next request and a revoke flips
  it back (the auth cache is invalidated by the writes); a team-scoped
  grant acts only while the user is a member of that team; a scoped token
  keeps its scopes after a later grant;
- ``/rbac/permissions/user/{email}`` and ``/rbac/permissions/check``
  (deactivation, an unknown user) and the admin-only surface;
- teams: create, list (mine, ``?all=true``), get (a private roster hidden
  from a non-member, a public one shown), the member cap, add and remove,
  invitations (issued, accepted once, to the right email only), delete, the
  owner-only writes;
- tokens: a scoped token cannot mint a broader one, an equal scope can;
- the catalog: a team-visible tool is listed to the team's members only."""

import numpy as np
import pytest

from torch_auth_pair import Pair, basic, bearer, on_both, seeded_people


@pytest.fixture(scope="module")
def pair():
    pair = Pair(max_members_per_team=3)
    yield pair
    pair.close()


def team_names(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return [f"team-{''.join(rng.choice(letters, 6))}" for _ in range(n)]


async def make_users(session, people) -> None:
    for email, password in people:
        await session.call("post", "/admin/users", {"email": email, "password": password},
                           record=False)


def statuses(out) -> list[int]:
    return [answer[2] for answer in out]


def test_system_roles_and_role_crud(pair):
    async def case(session):
        status, roles = await session.call("get", "/rbac/roles", record=False)
        system = sorted((r["name"], r["scope"], r["is_system"]) for r in roles)
        first = next(r for r in roles if r["is_system"])
        await session.call("delete", f"/rbac/roles/{first['id']}")
        await session.call("put", f"/rbac/roles/{first['id']}", {"permissions": ["tools.read"]})
        _, role = await session.call("post", "/rbac/roles", {
            "name": "readers-60", "permissions": ["tools.read", "prompts.read"],
            "description": "read only"})
        await session.call("post", "/rbac/roles", {"name": "readers-60",
                                                    "permissions": ["tools.read"]})
        await session.call("post", "/rbac/roles", {"name": "bad-60",
                                                    "permissions": ["tools.fly"]})
        await session.call("post", "/rbac/roles", {"name": "scoped-60", "scope": "galaxy",
                                                    "permissions": ["tools.read"]})
        await session.call("get", f"/rbac/roles/{role['id']}")
        await session.call("put", f"/rbac/roles/{role['id']}",
                           {"name": "readers-60b", "permissions": ["tools.read"]})
        # a refused update changes nothing
        await session.call("put", f"/rbac/roles/{role['id']}",
                           {"name": "readers-60c", "permissions": ["no.such"]})
        await session.call("get", f"/rbac/roles/{role['id']}")
        await session.call("delete", f"/rbac/roles/{role['id']}")
        await session.call("get", f"/rbac/roles/{role['id']}")
        # a page's rows follow the ids, which differ between the apps
        _, page = await session.call("get", "/rbac/roles?limit=2", record=False)
        return {"system": system, "answers": session.out,
                "page": (len(page["items"]), page["total"], bool(page["next_cursor"]))}

    out = on_both(pair, case)
    assert out["system"] and all(flag for _, _, flag in out["system"])
    assert statuses(out["answers"])[2:8] == [201, 409, 422, 422, 200, 200]
    assert out["page"] == (2, 3, True)


def test_grants_flip_require_and_team_scope(pair):
    (user, password), (owner, owner_pw) = seeded_people(61, 2)
    team, = team_names(61, 1)

    async def case(session):
        await make_users(session, [(user, password), (owner, owner_pw)])
        me = basic(user, password)
        await session.call("get", "/admin/audit", headers=me)
        _, role = await session.call("post", "/rbac/roles", {
            "name": "observer-61", "permissions": ["observability.read"]}, record=False)
        await session.call("post", f"/rbac/users/{user}/roles", {"role_id": role["id"]})
        await session.call("get", "/admin/audit?limit=1", headers=me)
        await session.call("get", f"/rbac/users/{user}/roles")
        await session.call("delete", f"/rbac/users/{user}/roles/{role['id']}")
        await session.call("get", "/admin/audit", headers=me)
        # a team-scoped grant acts only inside a team the user belongs to
        _, made = await session.call("post", "/teams", {"name": team},
                                     headers=basic(owner, owner_pw))
        _, scoped = await session.call("post", "/rbac/roles", {
            "name": "builders-61", "scope": "team", "permissions": ["tools.create"]})
        await session.call("post", f"/rbac/users/{user}/roles",
                           {"role_id": scoped["id"], "scope_id": made["id"]})
        tool = {"name": "t61", "integration_type": "REST", "url": "http://127.0.0.1:9/x"}
        await session.call("post", "/tools", tool, headers=me)
        await session.call("post", f"/teams/{made['id']}/members", {"email": user},
                           headers=basic(owner, owner_pw))
        await session.call("post", "/tools", tool, headers=me)
        await session.call("get", f"/rbac/permissions/user/{user}")
        await session.call("delete", f"/teams/{made['id']}/members/{user}",
                           headers=basic(owner, owner_pw))
        await session.call("post", "/tools", {**tool, "name": "t61b"}, headers=me)
        await session.call("delete", f"/rbac/users/{user}/roles/{scoped['id']}"
                                     f"?scope_id={made['id']}")
        return {"answers": session.out,
                "grants": await session.rows("SELECT user_email, scope_id, granted_by"
                                             " FROM user_roles WHERE user_email=?", (user,))}

    out = on_both(pair, case)
    assert statuses(out["answers"]) == [403, 201, 200, 200, 204, 403, 201, 201, 201, 403, 204,
                                        201, 200, 204, 403, 204]


def test_scoped_tokens_and_minting(pair):
    (user, password), = seeded_people(62, 1)

    async def case(session):
        await make_users(session, [(user, password)])
        me = basic(user, password)
        # tokens.manage comes from a role
        _, role = await session.call("post", "/rbac/roles", {
            "name": "token-makers-62", "permissions": ["tokens.manage", "observability.read"]},
            record=False)
        await session.call("post", f"/rbac/users/{user}/roles", {"role_id": role["id"]},
                           record=False)
        _, scoped = await session.call("post", "/auth/tokens", {
            "name": "ci", "permissions": ["tokens.manage", "tools.read"]}, headers=me)
        ci = bearer(scoped["token"])
        await session.call("post", "/auth/tokens", {"name": "wider",
                                                    "permissions": ["tokens.manage",
                                                                    "observability.read"]},
                           headers=ci)
        # an unscoped request from a scoped grantor is capped at its scopes
        await session.call("post", "/auth/tokens", {"name": "unscoped"}, headers=ci)
        await session.call("post", "/auth/tokens", {"name": "equal",
                                                    "permissions": ["tools.read"]}, headers=ci)
        await session.call("get", "/admin/audit", headers=ci)
        # a later grant does not widen a scoped token
        _, more = await session.call("post", "/rbac/roles", {
            "name": "more-62", "permissions": ["export.run"]}, record=False)
        await session.call("post", f"/rbac/users/{user}/roles", {"role_id": more["id"]},
                           record=False)
        await session.call("get", "/admin/audit", headers=ci)
        await session.call("get", "/auth/tokens", headers=me)
        return {"answers": session.out,
                "rows": await session.rows("SELECT name, permissions FROM api_tokens"
                                           " WHERE user_email=? ORDER BY name", (user,))}

    out = on_both(pair, case)
    assert statuses(out["answers"]) == [201, 403, 201, 201, 403, 403, 200]
    assert {r["name"]: r["permissions"] for r in out["rows"]}["unscoped"] == (
        '["tokens.manage","tools.read"]')


def test_permission_inspection_and_admin_surface(pair):
    (user, password), (gone, gone_pw) = seeded_people(63, 2)

    async def case(session):
        await make_users(session, [(user, password), (gone, gone_pw)])
        for email in (user, gone, "nobody@corp.example"):
            await session.call("get", f"/rbac/permissions/user/{email}")
            for permission in ("llm.chat", "admin.all"):
                await session.call("post", "/rbac/permissions/check",
                                   {"user_email": email, "permission": permission})
        await session.call("post", f"/admin/users/{gone}/toggle")
        await session.call("post", "/rbac/permissions/check",
                           {"user_email": gone, "permission": "llm.chat"})
        me = basic(user, password)
        for method, path in (("get", "/rbac/roles"), ("post", "/rbac/roles"),
                             ("get", f"/rbac/users/{user}/roles"),
                             ("get", "/compliance/frameworks"), ("get", "/admin/users")):
            await session.call(method, path, {"name": "x", "permissions": []}
                               if method == "post" else None, headers=me)
        await session.call("get", "/tools", headers=basic(gone, gone_pw))
        return session.out

    out = on_both(pair, case)
    assert statuses(out)[-7:] == [200, 403, 403, 403, 403, 403, 401]
    assert out[6][2] == 404


def test_teams_lifecycle_and_invitations(pair):
    people = seeded_people(64, 5)
    (owner, owner_pw), (a, a_pw), (b, b_pw), (c, c_pw), (d, d_pw) = people
    private, public = team_names(64, 2)

    async def case(session):
        await make_users(session, people)
        me = basic(owner, owner_pw)
        _, team = await session.call("post", "/teams", {"name": private,
                                                         "description": "seeded"}, headers=me)
        await session.call("post", "/teams", {"name": private}, headers=me)
        _, open_team = await session.call("post", "/teams", {"name": public,
                                                              "visibility": "public"},
                                          headers=me)
        await session.call("get", "/teams", headers=me)
        await session.call("get", f"/teams/{team['id']}", headers=basic(a, a_pw))
        await session.call("get", f"/teams/{open_team['id']}", headers=basic(a, a_pw))
        await session.call("post", f"/teams/{team['id']}/members", {"email": a},
                           headers=basic(b, b_pw))
        for email in (a, b, c):
            await session.call("post", f"/teams/{team['id']}/members", {"email": email},
                               headers=me)
        await session.call("post", f"/teams/{team['id']}/members",
                           {"email": a, "role": "owner"}, headers=me)
        await session.call("post", f"/teams/{team['id']}/members",
                           {"email": "nobody@corp.example"})
        await session.call("get", f"/teams/{team['id']}", headers=basic(a, a_pw))
        await session.call("delete", f"/teams/{team['id']}/members/{b}",
                           headers=basic(b, b_pw))
        _, invitation = await session.call("post", f"/teams/{team['id']}/invitations",
                                           {"email": d}, headers=me)
        await session.call("post", "/teams/invitations/accept",
                           {"token": invitation["token"]}, headers=basic(c, c_pw))
        await session.call("post", "/teams/invitations/accept",
                           {"token": invitation["token"]}, headers=basic(d, d_pw))
        await session.call("post", "/teams/invitations/accept",
                           {"token": invitation["token"]}, headers=basic(d, d_pw))
        await session.call("post", "/teams/invitations/accept", {"token": "nope"},
                           headers=basic(d, d_pw))
        await session.call("get", "/teams?all=true")
        await session.call("delete", f"/teams/{team['id']}", headers=basic(d, d_pw))
        await session.call("delete", f"/teams/{team['id']}", headers=me)
        await session.call("delete", f"/teams/{open_team['id']}")
        await session.call("get", f"/teams/{team['id']}", headers=me)
        return {"answers": session.out,
                "invitations": await session.rows(
                    "SELECT email, role, accepted_at IS NOT NULL AS accepted"
                    " FROM team_invitations WHERE email=?", (d,))}

    out = on_both(pair, case)
    assert statuses(out["answers"]) == [201, 409, 201, 200, 404, 200, 422, 204, 204, 422, 204,
                                        404, 200, 204, 201, 422, 200, 422, 404, 200, 422,
                                        204, 204, 404]


def test_team_visible_tool_reaches_members_only(pair):
    (a, a_pw), (b, b_pw) = seeded_people(65, 2)
    team, = team_names(65, 1)

    async def case(session):
        await make_users(session, [(a, a_pw), (b, b_pw)])
        _, made = await session.call("post", "/teams", {"name": team}, headers=basic(a, a_pw))
        _, role = await session.call("post", "/rbac/roles", {
            "name": "tool-makers-65", "scope": "team", "permissions": ["tools.create"]},
            record=False)
        await session.call("post", f"/rbac/users/{a}/roles",
                           {"role_id": role["id"], "scope_id": made["id"]}, record=False)
        await session.call("post", "/tools", {
            "name": "team-only-65", "integration_type": "REST", "url": "http://127.0.0.1:9/x",
            "team_id": made["id"], "visibility": "team"}, headers=basic(a, a_pw))
        listed = {}
        for who, creds in (("a", (a, a_pw)), ("b", (b, b_pw))):
            _, tools = await session.call("get", "/tools", headers=basic(*creds), record=False)
            listed[who] = sorted(t["name"] for t in tools)
        return {"answers": session.out, "listed": listed}

    out = on_both(pair, case)
    assert "team-only-65" in out["listed"]["a"] and "team-only-65" not in out["listed"]["b"]
