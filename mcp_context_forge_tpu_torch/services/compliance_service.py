"""Compliance report generator: FedRAMP Moderate/High, HIPAA, SOC2 Type II.

A copy of the JAX package's ``services/compliance_service.py`` (the
reference's `routers/compliance_router.py` and `services/compliance_service.py`:
control catalogs, evidence collectors,
status determination, persisted reports). Rebuilt for this stack: evidence
comes from OUR tables (users/roles/user_roles/audit_trail/api_tokens/
token_usage_logs) and OUR config posture (CSRF, password policy, lockout,
token-usage accounting), collected asynchronously over the raw-SQL core.

A report = per-control evidence artifacts + a determined status
(implemented / partial / not_implemented) + findings + recommendations,
persisted so auditors can retrieve historical assessments.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

from ..db.core import from_json, to_json
from ..utils.ids import new_id
from .base import AppContext, NotFoundError, ValidationFailure

FRAMEWORKS = ("fedramp_moderate", "fedramp_high", "hipaa", "soc2_type2")

FRAMEWORK_TITLES = {
    "fedramp_moderate": "FedRAMP Moderate (NIST 800-53 subset)",
    "fedramp_high": "FedRAMP High (NIST 800-53 subset)",
    "hipaa": "HIPAA Security Rule (45 CFR 164.312)",
    "soc2_type2": "SOC2 Type II (Trust Services Criteria)",
}


@dataclass(frozen=True)
class Control:
    id: str
    title: str
    description: str
    evidence: tuple[str, ...]  # collector keys


# Control catalogs. Evidence keys: user_inventory, role_inventory,
# audit_logs, config_posture, token_hygiene.
_BASE_ACCESS = (
    Control("AC-2", "Account Management",
            "Accounts are established, reviewed, disabled and removed "
            "through managed lifecycle operations.",
            ("user_inventory", "audit_logs")),
    Control("AC-3", "Access Enforcement",
            "Approved authorizations for logical access are enforced on "
            "every request.", ("role_inventory", "config_posture")),
    Control("AC-6", "Least Privilege",
            "Only the accesses necessary for assigned duties are granted.",
            ("role_inventory", "user_inventory")),
    Control("AU-2", "Audit Events",
            "The system audits security-relevant events.",
            ("audit_logs", "config_posture")),
    Control("AU-3", "Content of Audit Records",
            "Audit records establish what occurred, its source and outcome.",
            ("audit_logs",)),
    Control("AU-6", "Audit Review",
            "Audit records are reviewed for unusual activity.",
            ("audit_logs",)),
)

CONTROLS: dict[str, tuple[Control, ...]] = {
    "fedramp_moderate": _BASE_ACCESS,
    "fedramp_high": _BASE_ACCESS + (
        Control("IA-5", "Authenticator Management",
                "Password complexity, rotation and lockout policies are "
                "enforced for all authenticators.",
                ("config_posture", "token_hygiene")),
        Control("SC-23", "Session Authenticity",
                "Sessions are protected against forgery and replay "
                "(CSRF defenses, token binding, expiry).",
                ("config_posture", "token_hygiene")),
    ),
    "hipaa": (
        Control("164.312(a)(1)", "Access Controls",
                "Technical policies allow access only to persons granted "
                "access rights.", ("role_inventory", "config_posture")),
        Control("164.312(b)", "Audit Controls",
                "Mechanisms record and examine activity in systems that "
                "contain electronic protected health information.",
                ("audit_logs", "config_posture")),
        Control("164.312(c)(1)", "Integrity",
                "ePHI is protected from improper alteration or "
                "destruction.", ("audit_logs", "token_hygiene")),
        Control("164.312(d)", "Person or Entity Authentication",
                "The identity of persons seeking access is verified.",
                ("config_posture", "user_inventory")),
    ),
    "soc2_type2": (
        Control("CC6.1", "Logical Access Controls",
                "Logical access security software and architectures "
                "restrict access to authorized users.",
                ("role_inventory", "config_posture")),
        Control("CC6.2", "New Access",
                "New internal and external users are registered and "
                "authorized prior to access.",
                ("user_inventory", "audit_logs")),
        Control("CC6.3", "Access Removal",
                "Access is removed when no longer required.",
                ("user_inventory", "token_hygiene")),
        Control("CC7.2", "Monitor",
                "System components are monitored for anomalies indicative "
                "of malicious acts.", ("audit_logs", "token_hygiene")),
    ),
}


class ComplianceService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx

    # -------------------------------------------------- evidence collectors

    async def _user_inventory(self) -> dict[str, Any]:
        row = await self.ctx.db.fetchone(
            "SELECT COUNT(*) AS total,"
            " SUM(is_active) AS active,"
            " SUM(is_admin) AS admins,"
            " SUM(password_change_required) AS pending_rotation"
            " FROM users")
        return {"source": "user_inventory",
                "total_users": int(row["total"] or 0),
                "active_users": int(row["active"] or 0),
                "admin_users": int(row["admins"] or 0),
                "users_pending_rotation": int(row["pending_rotation"] or 0)}

    async def _role_inventory(self) -> dict[str, Any]:
        roles = await self.ctx.db.fetchone(
            "SELECT COUNT(*) AS n FROM roles")
        grants = await self.ctx.db.fetchone(
            "SELECT COUNT(*) AS n, COUNT(DISTINCT user_email) AS users"
            " FROM user_roles")
        wildcard = await self.ctx.db.fetchone(
            "SELECT COUNT(DISTINCT u.user_email) AS n FROM user_roles u"
            " JOIN roles r ON r.id=u.role_id"
            " WHERE r.permissions LIKE '%admin.all%'")
        return {"source": "role_inventory",
                "roles_defined": int(roles["n"] or 0),
                "role_assignments": int(grants["n"] or 0),
                "users_with_roles": int(grants["users"] or 0),
                "users_with_wildcard_role": int(wildcard["n"] or 0)}

    async def _audit_logs(self, start: float, end: float) -> dict[str, Any]:
        row = await self.ctx.db.fetchone(
            "SELECT COUNT(*) AS total, COUNT(DISTINCT actor) AS actors"
            " FROM audit_trail WHERE ts >= ? AND ts <= ?", (start, end))
        actions = await self.ctx.db.fetchall(
            "SELECT DISTINCT action FROM audit_trail"
            " WHERE ts >= ? AND ts <= ? ORDER BY action LIMIT 20",
            (start, end))
        return {"source": "audit_logs",
                "events_in_period": int(row["total"] or 0),
                "distinct_actors": int(row["actors"] or 0),
                "action_types_sampled": sorted(a["action"] for a in actions)}

    def _config_posture(self) -> dict[str, Any]:
        s = self.ctx.settings
        return {"source": "config_posture",
                "auth_required": bool(s.auth_required),
                "csrf_enabled": bool(s.csrf_enabled),
                "password_min_length": int(s.password_min_length),
                "password_requires_upper": bool(s.password_require_uppercase),
                "account_lockout_enabled":
                    int(getattr(s, "auth_max_failed_attempts", 0)) > 0,
                "password_change_enforcement":
                    bool(s.password_change_enforcement_enabled),
                "token_usage_accounting":
                    bool(s.token_usage_logging_enabled),
                "dev_mode": bool(s.dev_mode)}

    async def _token_hygiene(self) -> dict[str, Any]:
        row = await self.ctx.db.fetchone(
            "SELECT COUNT(*) AS total,"
            " SUM(CASE WHEN revoked_at IS NOT NULL THEN 1 ELSE 0 END)"
            "   AS revoked,"
            " SUM(CASE WHEN expires_at IS NOT NULL THEN 1 ELSE 0 END)"
            "   AS with_expiry,"
            " SUM(CASE WHEN permissions IS NOT NULL THEN 1 ELSE 0 END)"
            "   AS scoped FROM api_tokens")
        blocked = await self.ctx.db.fetchone(
            "SELECT COUNT(*) AS n FROM token_usage_logs WHERE blocked=1")
        return {"source": "token_hygiene",
                "tokens_total": int(row["total"] or 0),
                "tokens_revoked": int(row["revoked"] or 0),
                "tokens_with_expiry": int(row["with_expiry"] or 0),
                "tokens_scoped": int(row["scoped"] or 0),
                "blocked_token_attempts": int(blocked["n"] or 0)}

    # ------------------------------------------------ status determination

    def _assess(self, control: Control,
                artifacts: list[dict[str, Any]]) -> tuple[str, list[str],
                                                          list[str]]:
        merged: dict[str, Any] = {}
        for artifact in artifacts:
            merged.update(artifact)
        findings: list[str] = []
        recs: list[str] = []

        if "audit_logs" in control.evidence:
            if merged.get("events_in_period", 0) == 0:
                findings.append("No audit events recorded in the "
                                "assessment period.")
                recs.append("Exercise the surface or verify the audit "
                            "trail is recording mutations.")
        if "config_posture" in control.evidence:
            if not merged.get("auth_required", True):
                findings.append("Authentication is not required "
                                "(auth_required=false).")
                recs.append("Set MCPFORGE_AUTH_REQUIRED=true.")
            if not merged.get("csrf_enabled", True):
                findings.append("CSRF protection is disabled.")
                recs.append("Set MCPFORGE_CSRF_ENABLED=true.")
            if merged.get("dev_mode"):
                findings.append("Gateway is running in dev mode.")
                recs.append("Set MCPFORGE_ENVIRONMENT=production and "
                            "MCPFORGE_DEV_MODE=false for assessed "
                            "deployments.")
            if merged.get("password_min_length", 0) < 12:
                findings.append("Password minimum length below 12.")
                recs.append("Raise MCPFORGE_PASSWORD_MIN_LENGTH to 12+.")
        if "user_inventory" in control.evidence:
            if merged.get("total_users", 0) == 0:
                findings.append("No users provisioned.")
            elif merged.get("admin_users", 0) > 5:
                findings.append(
                    f"High admin count: {merged['admin_users']}.")
                recs.append("Reduce admin accounts; grant narrower roles "
                            "via /rbac/roles instead.")
        if "role_inventory" in control.evidence:
            if merged.get("roles_defined", 0) == 0:
                findings.append("No roles defined — access is admin/"
                                "default two-tier only.")
                recs.append("Define least-privilege roles and assign "
                            "them via /rbac.")
            if merged.get("users_with_wildcard_role", 0) > 0:
                findings.append(
                    f"{merged['users_with_wildcard_role']} user(s) hold "
                    "a wildcard (admin.all) role.")
                recs.append("Prefer enumerated permissions over "
                            "admin.all grants.")
        if "token_hygiene" in control.evidence:
            total = merged.get("tokens_total", 0)
            if total and merged.get("tokens_with_expiry", 0) < total:
                findings.append(
                    f"{total - merged['tokens_with_expiry']} API token(s) "
                    "never expire.")
                recs.append("Mint tokens with expires_minutes.")
            if not merged.get("token_usage_accounting", True):
                findings.append("Token usage accounting is disabled.")
                recs.append("Set MCPFORGE_TOKEN_USAGE_LOGGING_ENABLED="
                            "true.")

        if not findings:
            return "implemented", findings, recs
        if len(findings) == 1:
            return "partial", findings, recs
        return "not_implemented", findings, recs

    # ------------------------------------------------------------ reports

    async def generate(self, framework: str, period_start: float,
                       period_end: float, generated_by: str = ""
                       ) -> dict[str, Any]:
        if framework not in FRAMEWORKS:
            raise ValidationFailure(
                f"framework must be one of {', '.join(FRAMEWORKS)}")
        if period_end <= period_start:
            raise ValidationFailure("period_end must be after period_start")
        controls_out: list[dict[str, Any]] = []
        counts = {"implemented": 0, "partial": 0, "not_implemented": 0}
        # collect each evidence family ONCE per report (controls share
        # them; per-control re-queries would serialize ~25 statements
        # through the single-thread executor where ~5 suffice)
        needed = {key for control in CONTROLS[framework]
                  for key in control.evidence}
        collected: dict[str, dict[str, Any]] = {}
        if "user_inventory" in needed:
            collected["user_inventory"] = await self._user_inventory()
        if "role_inventory" in needed:
            collected["role_inventory"] = await self._role_inventory()
        if "audit_logs" in needed:
            collected["audit_logs"] = await self._audit_logs(period_start,
                                                             period_end)
        if "config_posture" in needed:
            collected["config_posture"] = self._config_posture()
        if "token_hygiene" in needed:
            collected["token_hygiene"] = await self._token_hygiene()
        for control in CONTROLS[framework]:
            artifacts = [collected[key] for key in control.evidence]
            status, findings, recs = self._assess(control, artifacts)
            counts[status] += 1
            controls_out.append({
                "control_id": control.id, "title": control.title,
                "description": control.description, "status": status,
                "artifacts": artifacts, "findings": findings,
                "recommendations": recs})
        total = len(controls_out)
        report = {
            "id": new_id(),
            "framework": framework,
            "framework_title": FRAMEWORK_TITLES[framework],
            "period_start": period_start,
            "period_end": period_end,
            "generated_at": time.time(),
            "generated_by": generated_by,
            "summary": {
                "total_controls": total,
                **counts,
                "compliance_pct": round(
                    100.0 * (counts["implemented"]
                             + 0.5 * counts["partial"]) / total, 1)
                if total else 0.0,
            },
            "controls": controls_out,
        }
        await self.ctx.db.execute(
            "INSERT INTO compliance_reports (id, framework, period_start,"
            " period_end, generated_at, generated_by, summary, report)"
            " VALUES (?,?,?,?,?,?,?,?)",
            (report["id"], framework, period_start, period_end,
             report["generated_at"], generated_by,
             to_json(report["summary"]), to_json(report)))
        return report

    async def list_reports(self) -> list[dict[str, Any]]:
        rows = await self.ctx.db.fetchall(
            "SELECT id, framework, period_start, period_end, generated_at,"
            " generated_by, summary FROM compliance_reports"
            " ORDER BY generated_at DESC")
        out = []
        for row in rows:
            entry = dict(row)
            entry["summary"] = from_json(row["summary"])
            out.append(entry)
        return out

    async def get_report(self, report_id: str) -> dict[str, Any]:
        row = await self.ctx.db.fetchone(
            "SELECT report FROM compliance_reports WHERE id=?", (report_id,))
        if row is None:
            raise NotFoundError(f"Report {report_id} not found")
        return from_json(row["report"])

    async def export_markdown(self, report_id: str) -> str:
        report = await self.get_report(report_id)
        lines = [
            f"# Compliance Report — {report['framework_title']}",
            "",
            f"- **Report id:** {report['id']}",
            f"- **Period:** {time.strftime('%Y-%m-%d', time.gmtime(report['period_start']))}"
            f" → {time.strftime('%Y-%m-%d', time.gmtime(report['period_end']))}",
            f"- **Generated:** {time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime(report['generated_at']))}"
            f" by {report['generated_by'] or 'n/a'}",
            f"- **Compliance:** {report['summary']['compliance_pct']}% "
            f"({report['summary']['implemented']} implemented, "
            f"{report['summary']['partial']} partial, "
            f"{report['summary']['not_implemented']} not implemented)",
            "",
        ]
        for control in report["controls"]:
            badge = {"implemented": "✅", "partial": "🟡",
                     "not_implemented": "❌"}[control["status"]]
            lines.append(f"## {badge} {control['control_id']} — "
                         f"{control['title']}")
            lines.append("")
            lines.append(control["description"])
            if control["findings"]:
                lines.append("")
                lines.append("**Findings:**")
                lines.extend(f"- {f}" for f in control["findings"])
            if control["recommendations"]:
                lines.append("")
                lines.append("**Recommendations:**")
                lines.extend(f"- {r}" for r in control["recommendations"])
            lines.append("")
        return "\n".join(lines)
