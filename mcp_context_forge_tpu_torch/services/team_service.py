"""Team management: CRUD, membership, invitations.

A copy of the JAX package's ``services/team_service.py``.

Reference: `services/team_management_service.py` + invitation/join flows
(~4k LoC across services/routers). Personal teams are created at user
bootstrap (auth_service); this service covers shared teams.
"""

from __future__ import annotations

import secrets
from typing import Any

from ..utils.ids import new_id, slugify
from .base import AppContext, ConflictError, NotFoundError, ValidationFailure, now


class TeamService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx
        # strong refs for fire-and-forget mails (loop holds weak refs only)
        self._bg_tasks: set = set()

    def _invalidate_auth(self, email: str) -> None:
        """Membership changes must hit the NEXT request: bust the auth
        resolution cache (hook installed by the app factory)."""
        hook = self.ctx.extras.get("auth_invalidate")
        if hook is not None:
            hook(email)

    async def create_team(self, name: str, created_by: str,
                          description: str = "",
                          visibility: str = "private",
                          is_admin: bool = False) -> dict[str, Any]:
        settings = self.ctx.settings
        if not settings.allow_team_creation and not is_admin:
            raise ValidationFailure(
                "Team creation is disabled (allow_team_creation)")
        if visibility == "public" and not settings.allow_public_visibility:
            raise ValidationFailure(
                "Public teams are disabled (allow_public_visibility)")
        slug = slugify(name)
        existing = await self.ctx.db.fetchone("SELECT id FROM teams WHERE slug=?",
                                              (slug,))
        if existing:
            raise ConflictError(f"Team {name!r} already exists")
        cap = self.ctx.settings.max_teams_per_user
        if cap:
            owned = await self.ctx.db.fetchone(
                "SELECT COUNT(*) AS n FROM teams WHERE created_by=?"
                " AND is_personal=0", (created_by,))
            if owned and int(owned["n"]) >= cap:
                raise ValidationFailure(
                    f"User already owns {cap} teams (max_teams_per_user)")
        team_id = new_id()
        ts = now()
        await self.ctx.db.execute(
            "INSERT INTO teams (id, name, slug, description, is_personal,"
            " visibility, created_by, created_at, updated_at)"
            " VALUES (?,?,?,?,?,?,?,?,?)",
            (team_id, name, slug, description, 0, visibility, created_by, ts, ts))
        await self.ctx.db.execute(
            "INSERT INTO team_members (team_id, user_email, role, joined_at)"
            " VALUES (?,?,?,?)", (team_id, created_by, "owner", ts))
        return await self.get_team(team_id)

    async def get_team(self, team_id: str, actor: str | None = None,
                       is_admin: bool = False) -> dict[str, Any]:
        """Fetch a team. When an ``actor`` is given, private teams (and their
        member rosters) are only returned to members or platform admins —
        teams.read alone must not disclose them. Public teams deliberately
        expose their roster to any authenticated user: they are the
        discoverable/joinable tier (reference team visibility semantics)."""
        row = await self.ctx.db.fetchone("SELECT * FROM teams WHERE id=?", (team_id,))
        if not row:
            raise NotFoundError(f"Team {team_id} not found")
        members = await self.ctx.db.fetchall(
            "SELECT user_email, role, joined_at FROM team_members WHERE team_id=?",
            (team_id,))
        if actor is not None and not is_admin:
            is_member = any(m["user_email"] == actor for m in members)
            if not is_member and row["visibility"] != "public":
                raise NotFoundError(f"Team {team_id} not found")
        return {**row, "members": members}

    async def list_teams(self, user: str | None = None) -> list[dict[str, Any]]:
        if user:
            rows = await self.ctx.db.fetchall(
                "SELECT t.* FROM teams t JOIN team_members m ON m.team_id=t.id"
                " WHERE m.user_email=? ORDER BY t.name", (user,))
        else:
            rows = await self.ctx.db.fetchall("SELECT * FROM teams ORDER BY name")
        return rows

    async def delete_team(self, team_id: str, actor: str, is_admin: bool) -> None:
        team = await self.get_team(team_id)
        if team["is_personal"]:
            raise ValidationFailure("Personal teams cannot be deleted")
        if not is_admin and not await self._is_owner(team_id, actor):
            raise ValidationFailure("Only team owners can delete a team")
        await self.ctx.db.execute("DELETE FROM teams WHERE id=?", (team_id,))

    async def _is_owner(self, team_id: str, user: str) -> bool:
        row = await self.ctx.db.fetchone(
            "SELECT role FROM team_members WHERE team_id=? AND user_email=?",
            (team_id, user))
        return bool(row and row["role"] == "owner")

    async def add_member(self, team_id: str, actor: str, email: str,
                         role: str | None = None,
                         is_admin: bool = False) -> None:
        if not is_admin and not await self._is_owner(team_id, actor):
            raise ValidationFailure("Only team owners can add members")
        role = role or self.ctx.settings.default_team_member_role
        user = await self.ctx.db.fetchone("SELECT email FROM users WHERE email=?",
                                          (email,))
        if not user:
            raise NotFoundError(f"User {email!r} not found")
        await self._check_member_cap(team_id, email)
        await self.ctx.db.execute(
            "INSERT OR REPLACE INTO team_members (team_id, user_email, role,"
            " joined_at) VALUES (?,?,?,?)", (team_id, email, role, now()))
        self._invalidate_auth(email)

    async def _check_member_cap(self, team_id: str, email: str) -> None:
        """Cap only NEW memberships: re-adding an existing member is a
        role change via INSERT OR REPLACE and must work on a full team."""
        cap = self.ctx.settings.max_members_per_team
        if not cap:
            return
        existing = await self.ctx.db.fetchone(
            "SELECT 1 AS x FROM team_members WHERE team_id=? AND user_email=?",
            (team_id, email))
        if existing:
            return
        members = await self.ctx.db.fetchone(
            "SELECT COUNT(*) AS n FROM team_members WHERE team_id=?",
            (team_id,))
        if members and int(members["n"]) >= cap:
            raise ValidationFailure(
                f"Team already has {cap} members (max_members_per_team)")

    async def remove_member(self, team_id: str, actor: str, email: str,
                            is_admin: bool = False) -> None:
        if not is_admin and not await self._is_owner(team_id, actor) and actor != email:
            raise ValidationFailure("Not allowed")
        await self.ctx.db.execute(
            "DELETE FROM team_members WHERE team_id=? AND user_email=?",
            (team_id, email))
        self._invalidate_auth(email)

    # ------------------------------------------------------------ invitations

    async def invite(self, team_id: str, actor: str, email: str,
                     role: str | None = None,
                     expires_hours: float | None = None,
                     is_admin: bool = False) -> dict[str, Any]:
        settings = self.ctx.settings
        if not settings.allow_team_invitations:
            raise ValidationFailure(
                "Team invitations are disabled (allow_team_invitations)")
        role = role or settings.default_team_member_role
        if expires_hours is None:
            expires_hours = settings.invitation_expiry_hours
        if not is_admin and not await self._is_owner(team_id, actor):
            raise ValidationFailure("Only team owners can invite")
        team = await self.get_team(team_id)  # also the existence check
        token = secrets.token_urlsafe(24)
        invitation_id = new_id()
        await self.ctx.db.execute(
            "INSERT INTO team_invitations (id, team_id, email, role, token,"
            " invited_by, expires_at, created_at) VALUES (?,?,?,?,?,?,?,?)",
            (invitation_id, team_id, email, role, token, actor,
             now() + expires_hours * 3600, now()))
        email_service = self.ctx.extras.get("email_service")
        if (email_service is not None
                and settings.team_invitation_email_enabled):
            # background + fail-open: the invite API must not stall for
            # smtp_timeout_seconds on a slow MX, and mail failure must
            # never fail the invite itself
            import asyncio
            task = asyncio.get_running_loop().create_task(
                email_service.send_team_invitation(
                    email, team["name"], actor, token))
            self._bg_tasks.add(task)
            task.add_done_callback(self._bg_tasks.discard)
        return {"id": invitation_id, "token": token, "team_id": team_id,
                "email": email, "role": role}

    async def accept_invitation(self, token: str, user: str) -> dict[str, Any]:
        row = await self.ctx.db.fetchone(
            "SELECT * FROM team_invitations WHERE token=?", (token,))
        if not row:
            raise NotFoundError("Invitation not found")
        if row["accepted_at"]:
            raise ValidationFailure("Invitation already used")
        if row["expires_at"] < now():
            raise ValidationFailure("Invitation expired")
        if row["email"].lower() != user.lower():
            raise ValidationFailure("Invitation was issued to a different email")
        await self._check_member_cap(row["team_id"], user)
        await self.ctx.db.execute(
            "INSERT OR REPLACE INTO team_members (team_id, user_email, role,"
            " joined_at) VALUES (?,?,?,?)",
            (row["team_id"], user, row["role"], now()))
        await self.ctx.db.execute(
            "UPDATE team_invitations SET accepted_at=? WHERE id=?",
            (now(), row["id"]))
        self._invalidate_auth(user)
        return await self.get_team(row["team_id"])
