"""RBAC role management: role CRUD, user-role assignment, permission
resolution through the ``roles``/``user_roles`` tables.

A copy of the JAX package's ``services/role_service.py`` (the reference's
`services/role_service.py`, `routers/rbac.py` and its Role/UserRole
models). Against a static matrix: a user's EFFECTIVE
permission set is now ``DEFAULT_USER_PERMISSIONS ∪ (permissions of every
assigned role whose scope applies)`` — global-scope roles apply
everywhere, team-scope roles only when the request identity belongs to
the assignment's team. Admins keep the full matrix; scoped API tokens
keep deriving power solely from their scopes (role grants never widen an
already-minted scoped token).
"""

from __future__ import annotations

from typing import Any

from ..db.core import from_json, to_json
from ..utils.ids import new_id
from .auth_service import PERMISSIONS
from .base import (AppContext, ConflictError, NotFoundError,
                   ValidationFailure, now)

# seeded at bootstrap; is_system=1 rows are rename/delete-proof
SYSTEM_ROLES = (
    ("platform_admin", "Full administrative access", ["admin.all"]),
    ("developer", "Create and manage entities, invoke tools",
     ["tools.read", "tools.create", "tools.update", "tools.invoke",
      "resources.read", "resources.create", "resources.update",
      "prompts.read", "prompts.create", "prompts.update",
      "servers.read", "servers.create", "servers.update",
      "gateways.read", "a2a.read", "a2a.invoke", "llm.chat",
      "teams.read", "teams.create", "export.run"]),
    ("viewer", "Read-only access",
     ["tools.read", "resources.read", "prompts.read", "servers.read",
      "gateways.read", "a2a.read", "teams.read", "observability.read"]),
)


class RoleGrantResolver:
    """The pure scope-filtering core of permission resolution, separated
    so the mutation campaign can gate it (testing/oracles.py — any
    single-fault mutant of this decision must be killed): global-scope
    assignments always apply; team-scope assignments only when the
    assignment's team is among the identity's teams; grants never escape
    the permission catalog."""

    @staticmethod
    def resolve(rows: list[dict[str, Any]], team_ids: list[str],
                catalog: set[str]) -> set[str]:
        granted: set[str] = set()
        teams = set(team_ids)
        for row in rows:
            if row["scope"] == "team" and row["scope_id"] not in teams:
                continue
            granted.update(from_json(row["permissions"]))
        return granted & catalog


class RoleService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx

    # ------------------------------------------------------------- bootstrap

    async def bootstrap_system_roles(self) -> None:
        """Idempotent seed of the built-in roles (reference seeds its
        permission catalog the same way at migration time)."""
        ts = now()
        for name, description, perms in SYSTEM_ROLES:
            await self.ctx.db.execute(
                "INSERT OR IGNORE INTO roles (id, name, description, scope,"
                " permissions, is_system, created_at) VALUES (?,?,?,?,?,?,?)",
                (new_id(), name, description, "global", to_json(perms), 1, ts))

    # ------------------------------------------------------------ role CRUD

    @staticmethod
    def _validate_permissions(permissions: list[str]) -> list[str]:
        unknown = sorted(set(permissions) - PERMISSIONS)
        if unknown:
            raise ValidationFailure(f"Unknown permissions: {unknown}")
        if not permissions:
            raise ValidationFailure("A role needs at least one permission")
        return sorted(set(permissions))

    def _dump(self, row: dict[str, Any]) -> dict[str, Any]:
        out = dict(row)
        out["permissions"] = from_json(row["permissions"])
        out["is_system"] = bool(row["is_system"])
        return out

    async def create_role(self, name: str, permissions: list[str],
                          description: str = "", scope: str = "global",
                          created_by: str = "") -> dict[str, Any]:
        if scope not in ("global", "team"):
            raise ValidationFailure("scope must be global|team")
        if not name or len(name) > 80:
            raise ValidationFailure("Role name must be 1-80 characters")
        perms = self._validate_permissions(permissions)
        existing = await self.ctx.db.fetchone(
            "SELECT id FROM roles WHERE name=?", (name,))
        if existing:
            raise ConflictError(f"Role {name!r} already exists")
        role_id = new_id()
        await self.ctx.db.execute(
            "INSERT INTO roles (id, name, description, scope, permissions,"
            " is_system, created_at) VALUES (?,?,?,?,?,?,?)",
            (role_id, name, description, scope, to_json(perms), 0, now()))
        return await self.get_role(role_id)

    async def get_role(self, role_id: str) -> dict[str, Any]:
        row = await self.ctx.db.fetchone("SELECT * FROM roles WHERE id=?",
                                         (role_id,))
        if not row:
            raise NotFoundError(f"Role {role_id} not found")
        out = self._dump(row)
        grants = await self.ctx.db.fetchall(
            "SELECT user_email, scope_id, granted_by, granted_at"
            " FROM user_roles WHERE role_id=? ORDER BY user_email", (role_id,))
        out["assignments"] = grants
        return out

    async def list_roles(self) -> list[dict[str, Any]]:
        rows = await self.ctx.db.fetchall(
            "SELECT r.*, (SELECT COUNT(*) FROM user_roles u"
            " WHERE u.role_id = r.id) AS assignment_count"
            " FROM roles r ORDER BY r.name")
        return [self._dump(row) for row in rows]

    async def update_role(self, role_id: str, *, name: str | None = None,
                          description: str | None = None,
                          permissions: list[str] | None = None
                          ) -> dict[str, Any]:
        role = await self.get_role(role_id)
        if role["is_system"]:
            raise ValidationFailure("System roles are immutable")
        # validate EVERY field before mutating ANY: a 400 response must
        # leave the role untouched (each execute auto-commits)
        perms = (self._validate_permissions(permissions)
                 if permissions is not None else None)
        if name is not None:
            clash = await self.ctx.db.fetchone(
                "SELECT id FROM roles WHERE name=? AND id<>?", (name, role_id))
            if clash:
                raise ConflictError(f"Role {name!r} already exists")
        if name is not None:
            await self.ctx.db.execute("UPDATE roles SET name=? WHERE id=?",
                                      (name, role_id))
        if description is not None:
            await self.ctx.db.execute(
                "UPDATE roles SET description=? WHERE id=?",
                (description, role_id))
        if perms is not None:
            await self.ctx.db.execute(
                "UPDATE roles SET permissions=? WHERE id=?",
                (to_json(perms), role_id))
        return await self.get_role(role_id)

    async def delete_role(self, role_id: str) -> None:
        role = await self.get_role(role_id)
        if role["is_system"]:
            raise ValidationFailure("System roles cannot be deleted")
        # assignments die with the role (ON DELETE CASCADE is declared, but
        # sqlite only honors it with foreign_keys=ON — delete explicitly)
        await self.ctx.db.execute("DELETE FROM user_roles WHERE role_id=?",
                                  (role_id,))
        await self.ctx.db.execute("DELETE FROM roles WHERE id=?", (role_id,))

    # ----------------------------------------------------------- assignment

    async def assign_role(self, user_email: str, role_id: str,
                          scope_id: str = "", granted_by: str = ""
                          ) -> dict[str, Any]:
        role = await self.get_role(role_id)
        if role["scope"] == "team":
            if not scope_id:
                raise ValidationFailure(
                    "Team-scoped roles need a scope_id (team id)")
            team = await self.ctx.db.fetchone(
                "SELECT id FROM teams WHERE id=?", (scope_id,))
            if not team:
                raise NotFoundError(f"Team {scope_id} not found")
        elif scope_id:
            raise ValidationFailure("Global roles take no scope_id")
        user = await self.ctx.db.fetchone(
            "SELECT email FROM users WHERE email=?", (user_email,))
        if not user:
            raise NotFoundError(f"User {user_email!r} not found")
        existing = await self.ctx.db.fetchone(
            "SELECT 1 FROM user_roles WHERE user_email=? AND role_id=?"
            " AND scope_id=?", (user_email, role_id, scope_id))
        if existing:
            raise ConflictError("Role already assigned")
        await self.ctx.db.execute(
            "INSERT INTO user_roles (user_email, role_id, scope_id,"
            " granted_by, granted_at) VALUES (?,?,?,?,?)",
            (user_email, role_id, scope_id, granted_by, now()))
        return {"user_email": user_email, "role_id": role_id,
                "scope_id": scope_id}

    async def revoke_role(self, user_email: str, role_id: str,
                          scope_id: str = "") -> None:
        await self.get_role(role_id)  # 404 on unknown role
        await self.ctx.db.execute(
            "DELETE FROM user_roles WHERE user_email=? AND role_id=?"
            " AND scope_id=?", (user_email, role_id, scope_id))

    async def user_roles(self, user_email: str) -> list[dict[str, Any]]:
        rows = await self.ctx.db.fetchall(
            "SELECT r.id, r.name, r.scope, r.permissions, u.scope_id,"
            " u.granted_by, u.granted_at FROM user_roles u"
            " JOIN roles r ON r.id = u.role_id"
            " WHERE u.user_email=? ORDER BY r.name", (user_email,))
        out = []
        for row in rows:
            entry = dict(row)
            entry["permissions"] = from_json(row["permissions"])
            out.append(entry)
        return out

    # ----------------------------------------------------------- resolution

    async def role_permissions(self, user_email: str,
                               team_ids: list[str]) -> set[str]:
        """The permission union a user's role assignments grant for a
        request made with the given team memberships: global-scope
        assignments always apply; team-scope assignments only when the
        assignment's team is among the identity's teams."""
        rows = await self.ctx.db.fetchall(
            "SELECT r.scope, r.permissions, u.scope_id FROM user_roles u"
            " JOIN roles r ON r.id = u.role_id WHERE u.user_email=?",
            (user_email,))
        return RoleGrantResolver.resolve(list(rows), team_ids, PERMISSIONS)
