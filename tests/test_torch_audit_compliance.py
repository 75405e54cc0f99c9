"""The port's audit trail and compliance reports (``services/audit_service.py``,
``services/compliance_service.py`` and their routes) against the JAX
gateway's, on the CPU. Both apps (one pair for the module) get the same
seeded tables through the same calls: users (``default_rng`` emails and
passwords), roles and grants, API tokens (one revoked), blocked and
admitted token-usage rows, audit rows. Compared, with ids and times masked:

- ``AuditService.record`` and ``search`` (actor, action prefix, limit), and
  ``GET /admin/audit`` (its 400 on a bad limit, its 403 for a plain user);
- the SIEM export: ``export_once`` to a stub ``/_bulk`` sink on 127.0.0.1,
  the OpenSearch NDJSON bodies and the cursor (a second export sends only
  the new rows, an empty one sends nothing);
- for each of the four frameworks, ``POST /compliance/reports`` over a fixed
  period (the controls, their statuses, artifacts, findings and the
  summary), ``GET /compliance/reports[/{id}]``, the JSON and markdown
  exports, and the refusals (an unknown framework, a reversed period, a
  non-finite bound, an unknown report)."""

import json
import re
import time

import numpy as np
import pytest
from aiohttp import web

from torch_auth_pair import Pair, basic, mask, on_both, seeded_people, stub_server

FRAMEWORKS = ["fedramp_moderate", "fedramp_high", "hipaa", "soc2_type2"]
STAMP = re.compile(r"\d{4}-\d\d-\d\d(T\d\d:\d\d:\d\dZ)?")


@pytest.fixture(scope="module")
def pair():
    pair = Pair(audit_enabled="true")
    pair.run(seed_tables(pair))
    yield pair
    pair.close()


async def seed_tables(pair) -> None:
    """The same rows in both apps' databases, through the same calls."""
    people = seeded_people(50, 4)
    for name in ("jax", "port"):
        rng = np.random.default_rng(50)
        app = pair.app(name)
        auth, roles, db = app["auth_service"], app["role_service"], app["ctx"].db
        for i, (email, password) in enumerate(people):
            await auth.create_user(email, password, is_admin=(i == 0),
                                   require_password_change=(i == 3))
        role = await roles.create_role("auditors-50", ["observability.read"])
        wild = await roles.create_role("break-glass-50", ["admin.all"])
        await roles.assign_role(people[1][0], role["id"])
        await roles.assign_role(people[2][0], wild["id"])
        tokens = []
        for i, (email, _) in enumerate(people[:3]):
            _, token_id = await auth.create_api_token(
                email, f"t{i}", permissions=["llm.chat"] if i else None,
                expires_minutes=60 if i == 2 else None)
            tokens.append(token_id)
        await auth.revoke_token(tokens[1])
        jtis = [r["jti"] for r in await db.fetchall("SELECT jti FROM api_tokens ORDER BY id")]
        for i, status in enumerate(int(s) for s in rng.choice([200, 401, 403, 429], 8)):
            await db.execute(
                "INSERT INTO token_usage_logs (token_jti, user_email, ts, method, path,"
                " status, response_ms, client_ip, user_agent, blocked, block_reason)"
                " VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                (jtis[i % len(jtis)], people[i % 3][0], 1_700_000_000.0 + i, "POST",
                 "/v1/chat/completions", status, 1.0, "127.0.0.1", "seeded",
                 int(status != 200), None if status == 200 else f"http_{status}"))
        for i in range(6):
            await app["audit_service"].record(
                people[i % 4][0], ["POST /tools", "DELETE /tools/x", "auth.password_reset"][i % 3],
                entity_type="tool", entity_id=f"t{i}", details={"i": i})


def test_audit_search_and_route(pair):
    people = seeded_people(50, 4)

    async def case(session):
        audit = session.app["audit_service"]
        out = [await audit.search(), await audit.search(actor=people[1][0]),
               await audit.search(action="DELETE"), await audit.search(limit=2)]
        await session.call("get", "/admin/audit?action=POST&limit=3")
        await session.call("get", f"/admin/audit?actor={people[0][0]}")
        await session.call("get", "/admin/audit?limit=lots")
        await session.call("get", "/admin/audit", headers=basic(*people[3]))
        return {"search": out, "answers": session.out}

    out = on_both(pair, case)
    assert len(out["search"][1]) == 2 and len(out["search"][3]) == 2
    assert [a[2] for a in out["answers"]] == [200, 200, 400, 403]


def test_siem_export_to_a_stub_sink(pair):
    async def case(session):
        bodies = []

        async def bulk(request):
            bodies.append((request.headers.get("content-type"), await request.text()))
            return web.json_response({"errors": False})

        sink = await stub_server({("POST", "/_bulk"): bulk})
        audit = session.app["audit_service"]
        saved = audit.siem_url, audit._cursor
        try:
            audit.siem_url = f"http://127.0.0.1:{sink.server.port}/"
            audit._cursor = 0
            sent = [await audit.export_once()]
            await audit.record("siem@corp.example", "POST /teams", details={"n": 1})
            sent += [await audit.export_once(), await audit.export_once()]
            # the lines as the sink parsed them
            return {"sent": sent, "bodies": [(kind, [json.loads(line) if line else line
                                                     for line in text.split("\n")])
                                             for kind, text in bodies]}
        finally:
            audit.siem_url, audit._cursor = saved
            await sink.close()

    out = on_both(pair, case)
    assert out["sent"] == [6, 1, 0] and len(out["bodies"]) == 2
    assert out["bodies"][0][0] == "application/x-ndjson" and out["bodies"][0][1][-1] == ""


@pytest.mark.parametrize("framework", FRAMEWORKS)
def test_framework_reports(pair, framework):
    end = time.time() + 60
    period = {"framework": framework, "period_start": end - 86400, "period_end": end}

    async def case(session):
        status, report = await session.call("post", "/compliance/reports", period)
        await session.call("get", f"/compliance/reports/{report['id']}")
        await session.call("get", f"/compliance/reports/{report['id']}/export")
        disposition = session.headers.get("content-disposition")
        status, text = await session.call(
            "get", f"/compliance/reports/{report['id']}/export?format=markdown", record=False)
        return {"answers": session.out, "json_disposition": mask(disposition, session.ids),
                "markdown": (status, STAMP.sub("<date>", mask(text, session.ids)))}

    out = on_both(pair, case)
    report = out["answers"][0][3]
    assert out["answers"][0][2] == 201 and report["framework"] == framework
    assert report["summary"]["total_controls"] == len(report["controls"]) > 0
    assert out["markdown"][0] == 200 and out["markdown"][1].startswith("# Compliance Report")
    if framework == "soc2_type2":
        hygiene = next(a for c in report["controls"] for a in c["artifacts"]
                       if a["source"] == "token_hygiene")
        assert hygiene["tokens_revoked"] == 1 and hygiene["tokens_total"] == 3


def test_report_listing_and_refusals(pair):
    async def case(session):
        await session.call("get", "/compliance/frameworks")
        await session.call("post", "/compliance/reports", {"framework": "iso27001"})
        await session.call("post", "/compliance/reports", {
            "framework": "hipaa", "period_start": 10.0, "period_end": 5.0})
        await session.call("post", "/compliance/reports", {
            "framework": "hipaa", "period_days": "thirty"})
        await session.call("post", "/compliance/reports", ["hipaa"])
        await session.call("get", "/compliance/reports/" + "0" * 32)
        status, listed = await session.call("get", "/compliance/reports", record=False)
        return {"answers": session.out,
                "listed": sorted((r["framework"], r["summary"]["total_controls"])
                                 for r in listed)}

    out = on_both(pair, case)
    assert [a[2] for a in out["answers"]] == [200, 422, 422, 422, 422, 404]
