"""Authentication and RBAC over the gateway's database: a copy of the JAX
package's ``services/auth_service.py`` under its names.

- ``AuthService``: the resolution cache (``auth_cache_*``) and its
  ``invalidate_user``/``invalidate_jti``; ``bootstrap_admin`` (the platform
  admin's users row and personal team, idempotent); the password policy;
  ``create_user``; change, request-reset and reset of passwords;
  ``verify_password`` with the lockout (``auth_max_failed_attempts``,
  ``auth_lockout_seconds``) and its mail; ``issue_jwt``; catalogued API
  tokens (``create_api_token`` with the grantor's caps and
  ``api_token_max_lifetime_minutes``, ``revoke_token``, which publishes
  ``tokens.revoked``, ``list_api_tokens``); ``resolve_bearer`` and
  ``resolve_basic`` (users rows, deactivation, ``tokens_valid_after``,
  revoked jtis, teams, role grants, a peppered digest cache of verified
  Basic passwords); ``effective_permissions``.
- The identity types (``AuthContext``, ``AuthError``, ``PermissionDenied``,
  ``PERMISSIONS``, ``DEFAULT_USER_PERMISSIONS``) are ``gateway/auth.py``'s.

One design difference: the argon2id KDF (``utils/passwords.py``, ~0.1 to
1 s a call) runs in a worker thread (``asyncio.to_thread``), not on the
event loop, which also carries the engine's token streams. The database
writes around it keep JAX's order.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import os
import secrets
import time
from typing import Any

from ..gateway.auth import (DEFAULT_USER_PERMISSIONS, PERMISSIONS, AuthContext, AuthError,
                            PermissionDenied)
from ..utils import jwt
from ..utils.ids import new_id, slugify
from ..utils.passwords import InvalidHashError, PasswordHasher, VerifyMismatchError
from .base import AppContext, ConflictError, NotFoundError, ValidationFailure, now

__all__ = ["AuthService", "AuthContext", "AuthError", "PermissionDenied", "PERMISSIONS",
           "DEFAULT_USER_PERMISSIONS"]

_hasher = PasswordHasher()


async def _hash(password: str) -> str:
    return await asyncio.to_thread(_hasher.hash, password)


class AuthService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx
        self._revoked_jtis: set[str] = set()
        # the resolution cache: TTLs cap staleness; the writes whose effect
        # must show on the next request call invalidate_user/invalidate_jti
        self._cache: dict[tuple, tuple[Any, float]] = {}
        # a verified Basic password caches HMAC(pepper, password), so a
        # repeat within auth_cache_user_ttl is a constant-time compare, not
        # a KDF and a users-table write; the pepper never leaves memory
        self._basic_pepper = os.urandom(16)
        # strong references to fire-and-forget mails (the loop keeps weak ones)
        self._bg_tasks: set[Any] = set()

    # ----------------------------------------------------- resolution cache

    def _cache_get(self, key: tuple) -> Any:
        entry = self._cache.get(key)
        if entry is None:
            return None
        value, expiry = entry
        if expiry <= time.monotonic():
            self._cache.pop(key, None)
            return None
        return value

    def _cache_put(self, key: tuple, value: Any, ttl: float) -> None:
        settings = self.ctx.settings
        if not settings.auth_cache_enabled or ttl <= 0:
            return
        limit = int(settings.auth_cache_max_entries)
        while len(self._cache) >= max(1, limit):
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = (value, time.monotonic() + ttl)

    def invalidate_user(self, email: str) -> None:
        """Drop every cached fact about one identity."""
        for kind in ("user", "teams", "roles", "basic_ok"):
            self._cache.pop((kind, email), None)

    def _password_digest(self, password: str) -> bytes:
        return hmac.new(self._basic_pepper, password.encode(), hashlib.sha256).digest()

    def invalidate_jti(self, jti: str) -> None:
        self._cache.pop(("jti", jti), None)

    # ------------------------------------------------------------- bootstrap

    async def bootstrap_admin(self) -> None:
        """The platform admin's users row, personal team and membership.
        Every statement is an INSERT OR IGNORE and the member row finds its
        team by slug: concurrent boots are no-ops and a partial seed heals."""
        settings = self.ctx.settings
        ts = now()
        await self.ctx.db.execute(
            "INSERT OR IGNORE INTO users (email, password_hash, full_name,"
            " is_admin, password_change_required, created_at, updated_at)"
            " VALUES (?,?,?,?,?,?,?)",
            (settings.platform_admin_email, await _hash(settings.platform_admin_password),
             "Platform Admin", 1,
             int(settings.admin_require_password_change_on_bootstrap), ts, ts))
        slug = slugify(settings.platform_admin_email)
        await self.ctx.db.execute(
            "INSERT OR IGNORE INTO teams (id, name, slug, is_personal, created_by,"
            " created_at, updated_at) VALUES (?,?,?,?,?,?,?)",
            (new_id(), "Personal", slug, 1, settings.platform_admin_email, ts, ts))
        team = await self.ctx.db.fetchone("SELECT id FROM teams WHERE slug=?", (slug,))
        if team:
            await self.ctx.db.execute(
                "INSERT OR IGNORE INTO team_members (team_id, user_email, role,"
                " joined_at) VALUES (?,?,?,?)",
                (team["id"], settings.platform_admin_email, "owner", ts))

    # ----------------------------------------------------------------- users

    # a fragment of the common-password denylist
    _PASSWORD_DENYLIST = {
        "password", "password1", "passw0rd", "qwerty", "letmein", "changeme",
        "123456", "12345678", "123456789", "1234567890", "iloveyou", "admin",
        "welcome", "monkey", "dragon", "abc123", "secret",
    }

    def validate_password_policy(self, password: str, email: str = "") -> None:
        """``ValidationFailure`` for a password outside the policy: length,
        character classes, the denylist, not derived from the email."""
        settings = self.ctx.settings
        problems: list[str] = []
        if len(password) < settings.password_min_length:
            problems.append(f"at least {settings.password_min_length} characters")
        if len(password) > settings.password_max_length:
            problems.append(f"at most {settings.password_max_length} characters")
        if settings.password_require_uppercase and not any(c.isupper() for c in password):
            problems.append("an uppercase letter")
        if settings.password_require_lowercase and not any(c.islower() for c in password):
            problems.append("a lowercase letter")
        if settings.password_require_digit and not any(c.isdigit() for c in password):
            problems.append("a digit")
        if settings.password_require_special and not any(not c.isalnum() for c in password):
            problems.append("a special character")
        lowered = password.lower()
        # digit or symbol padding does not rescue a denylisted word
        base = "".join(c for c in lowered if c.isalpha())
        if lowered in self._PASSWORD_DENYLIST or base in self._PASSWORD_DENYLIST:
            problems.append("not a commonly-used password")
        local_part = email.split("@")[0].lower() if email else ""
        if local_part and len(local_part) >= 4 and local_part in lowered:
            problems.append("not derived from the account email")
        if problems:
            raise ValidationFailure("Password must contain: " + "; ".join(problems))

    async def create_user(self, email: str, password: str, full_name: str = "",
                          is_admin: bool = False, enforce_policy: bool = False,
                          require_password_change: bool = False) -> None:
        if enforce_policy:
            self.validate_password_policy(password, email)
        existing = await self.ctx.db.fetchone("SELECT 1 FROM users WHERE email=?", (email,))
        if existing:
            raise ConflictError(f"User {email} already exists")
        password_hash = await _hash(password)
        ts = now()
        await self.ctx.db.execute(
            "INSERT INTO users (email, password_hash, full_name, is_admin,"
            " password_change_required, created_at, updated_at)"
            " VALUES (?,?,?,?,?,?,?)",
            (email, password_hash, full_name, int(is_admin),
             int(require_password_change), ts, ts))

    async def set_password_change_required(self, email: str, required: bool = True) -> None:
        """Flag a user for forced rotation: until they rotate, the flagged
        user reaches only ``/auth/password``."""
        # no RETURNING (sqlite < 3.35 refuses it): update, then confirm the row
        await self.ctx.db.execute(
            "UPDATE users SET password_change_required=?, updated_at=? WHERE email=?",
            (int(required), now(), email))
        row = await self.ctx.db.fetchone("SELECT email FROM users WHERE email=?", (email,))
        if not row:
            raise NotFoundError(f"User {email} not found")
        self.invalidate_user(email)

    async def change_password(self, email: str, old_password: str, new_password: str) -> None:
        if not await self.verify_password(email, old_password):
            raise AuthError("Current password is incorrect")
        self.validate_password_policy(new_password, email)
        await self.ctx.db.execute(
            "UPDATE users SET password_hash=?, password_change_required=0,"
            " updated_at=? WHERE email=?",
            (await _hash(new_password), now(), email))
        self.invalidate_user(email)

    # ------------------------------------------------------ password reset

    @staticmethod
    def _reset_token_hash(token: str) -> str:
        return hashlib.sha256(token.encode()).hexdigest()

    async def request_password_reset(self, email: str) -> str | None:
        """A reset token for a local active account, or None. The caller
        answers the same either way (no user enumeration). At most
        ``password_reset_rate_limit`` tokens per email in the window."""
        settings = self.ctx.settings
        row = await self.ctx.db.fetchone(
            "SELECT auth_provider FROM users WHERE email=? AND is_active=1", (email,))
        if not row or row["auth_provider"] != "local":
            return None  # SSO accounts reset upstream
        window_start = now() - settings.password_reset_rate_window_minutes * 60
        issued = await self.ctx.db.fetchone(
            "SELECT COUNT(*) AS n FROM password_reset_tokens"
            " WHERE user_email=? AND created_at > ?", (email, window_start))
        if issued and issued["n"] >= settings.password_reset_rate_limit:
            return None
        token = secrets.token_urlsafe(32)
        expires = now() + settings.password_reset_token_expiry_minutes * 60
        await self.ctx.db.execute(
            "INSERT INTO password_reset_tokens (token_hash, user_email,"
            " expires_at, created_at) VALUES (?,?,?,?)",
            (self._reset_token_hash(token), email, expires, now()))
        # expired rows are dead weight
        await self.ctx.db.execute("DELETE FROM password_reset_tokens WHERE expires_at < ?",
                                  (now() - 86400,))
        return token

    async def reset_password(self, token: str, new_password: str) -> str:
        """Consume a reset token (single use, expiring); returns the email.
        The lockout clears, and with ``password_reset_invalidate_sessions``
        every JWT issued before this second stops resolving."""
        row = await self.ctx.db.fetchone(
            "SELECT * FROM password_reset_tokens WHERE token_hash=?",
            (self._reset_token_hash(token),))
        if not row or row["used_at"] or row["expires_at"] < now():
            raise AuthError("Invalid or expired reset token")
        email = row["user_email"]
        self.validate_password_policy(new_password, email)
        # the conditional UPDATE is the single-use gate: of two concurrent
        # resets with one token, only one matches the used_at IS NULL row
        claim_ts = now()
        if getattr(self.ctx.db, "supports_returning", False):
            won = bool(await self.ctx.db.execute(
                "UPDATE password_reset_tokens SET used_at=?"
                " WHERE token_hash=? AND used_at IS NULL RETURNING token_hash",
                (claim_ts, row["token_hash"])))
        else:
            # older sqlite: stamp, re-read, and check the stamp is ours (the
            # writes serialize on one connection; REAL round-trips exactly)
            await self.ctx.db.execute(
                "UPDATE password_reset_tokens SET used_at=?"
                " WHERE token_hash=? AND used_at IS NULL", (claim_ts, row["token_hash"]))
            claimed = await self.ctx.db.fetchone(
                "SELECT used_at FROM password_reset_tokens WHERE token_hash=?",
                (row["token_hash"],))
            won = bool(claimed) and claimed["used_at"] == claim_ts
        if not won:
            raise AuthError("Invalid or expired reset token")
        invalidate = self.ctx.settings.password_reset_invalidate_sessions
        password_hash = await _hash(new_password)
        await self.ctx.db.execute(
            "UPDATE users SET password_hash=?, failed_login_attempts=0,"
            " locked_until=NULL, password_change_required=0, updated_at=?"
            + (", tokens_valid_after=?" if invalidate else "")
            + " WHERE email=?",
            # floored to whole seconds: iat has 1 s resolution, and a session
            # minted in the same second after the reset must live
            (password_hash, now(), *((float(int(now())),) if invalidate else ()), email))
        self.invalidate_user(email)
        return email

    async def verify_password(self, email: str, password: str) -> bool:
        row = await self.ctx.db.fetchone("SELECT * FROM users WHERE email=? AND is_active=1",
                                         (email,))
        if not row:
            return False
        lock_expired = bool(row["locked_until"]) and row["locked_until"] <= now()
        if row["locked_until"] and not lock_expired:
            raise AuthError("Account locked")
        try:
            await asyncio.to_thread(_hasher.verify, row["password_hash"], password)
        except InvalidHashError:
            # SSO accounts store a non-argon2 sentinel: no password login
            return False
        except VerifyMismatchError:
            # an expired lock resets the counter: one stray failure after a
            # lockout must not re-lock at once
            prior = 0 if lock_expired else row["failed_login_attempts"]
            attempts = prior + 1
            settings = self.ctx.settings
            locked_until = (now() + settings.auth_lockout_seconds
                            if attempts >= settings.auth_max_failed_attempts else None)
            await self.ctx.db.execute(
                "UPDATE users SET failed_login_attempts=?, locked_until=? WHERE email=?",
                (attempts, locked_until, email))
            email_service = self.ctx.extras.get("email_service")
            if (locked_until is not None and email_service is not None
                    and settings.account_lockout_notification_enabled):
                # fire and forget: the mail must not delay the 401
                task = asyncio.get_running_loop().create_task(
                    email_service.send_account_lockout(email, settings.auth_lockout_seconds / 60))
                self._bg_tasks.add(task)
                task.add_done_callback(self._bg_tasks.discard)
            return False
        await self.ctx.db.execute(
            "UPDATE users SET failed_login_attempts=0, locked_until=NULL,"
            " last_login=? WHERE email=?", (now(), email))
        return True

    async def user_teams(self, email: str) -> list[str]:
        cached = self._cache_get(("teams", email))
        if cached is not None:
            return list(cached)
        rows = await self.ctx.db.fetchall(
            "SELECT team_id FROM team_members WHERE user_email=?", (email,))
        teams = [r["team_id"] for r in rows]
        self._cache_put(("teams", email), tuple(teams), self.ctx.settings.auth_cache_teams_ttl)
        return teams

    # ---------------------------------------------------------------- tokens

    def issue_jwt(self, email: str, expires_minutes: int | None = None,
                  extra: dict[str, Any] | None = None) -> str:
        settings = self.ctx.settings
        claims: dict[str, Any] = {"sub": email, **(extra or {})}
        return jwt.create_token(
            claims, settings.jwt_secret_key, settings.jwt_algorithm,
            expires_minutes=expires_minutes or settings.token_expiry,
            audience=settings.jwt_audience, issuer=settings.jwt_issuer)

    async def create_api_token(self, email: str, name: str, server_id: str | None = None,
                               permissions: list[str] | None = None,
                               expires_minutes: int | None = None,
                               grantor: AuthContext | None = None) -> tuple[str, str]:
        """A catalogued API token, revocable by jti: ``(token, token_id)``.
        With a ``grantor``, the requested permissions must be the grantor's
        own, and a scoped grantor mints at most its own scopes."""
        if grantor is not None:
            if grantor.server_id:
                # a server-scoped token mints only inside its server
                if server_id and server_id != grantor.server_id:
                    raise PermissionDenied("Cannot mint a token for a different server")
                server_id = grantor.server_id
            if permissions:
                unknown = [p for p in permissions if p not in PERMISSIONS]
                if unknown:
                    raise PermissionDenied(f"Unknown permissions: {unknown}")
                denied = [p for p in permissions if not grantor.can(p)]
                if denied:
                    raise PermissionDenied(f"Cannot grant permissions beyond your own: {denied}")
            elif grantor.scoped:
                # an unscoped token would inherit the user's full power
                permissions = sorted(grantor.permissions)
        cap = float(self.ctx.settings.api_token_max_lifetime_minutes)
        if cap > 0:
            # no token outlives the cap: unset gets the cap, longer is clamped
            expires_minutes = min(expires_minutes or cap, cap)
        jti = new_id()
        token = self.issue_jwt(email, expires_minutes=expires_minutes,
                               extra={"jti": jti,
                                      **({"server_id": server_id} if server_id else {}),
                                      **({"scopes": permissions} if permissions else {})})
        token_id = new_id()
        from ..db.core import to_json
        await self.ctx.db.execute(
            "INSERT INTO api_tokens (id, user_email, name, jti, token_hash, server_id,"
            " permissions, expires_at, created_at) VALUES (?,?,?,?,?,?,?,?,?)",
            (token_id, email, name, jti, hashlib.sha256(token.encode()).hexdigest(),
             server_id, to_json(permissions) if permissions else None,
             now() + (expires_minutes or self.ctx.settings.token_expiry) * 60, now()))
        return token, token_id

    async def revoke_token(self, token_id: str) -> None:
        row = await self.ctx.db.fetchone("SELECT jti FROM api_tokens WHERE id=?", (token_id,))
        if not row:
            raise NotFoundError("Token not found")
        await self.ctx.db.execute("UPDATE api_tokens SET revoked_at=? WHERE id=?",
                                  (now(), token_id))
        self._revoked_jtis.add(row["jti"])
        self.invalidate_jti(row["jti"])
        await self.ctx.bus.publish("tokens.revoked", {"jti": row["jti"]})

    async def list_api_tokens(self, email: str) -> list[dict[str, Any]]:
        return await self.ctx.db.fetchall(
            "SELECT id, name, jti, server_id, expires_at, last_used, revoked_at,"
            " created_at FROM api_tokens WHERE user_email=?", (email,))

    # -------------------------------------------------------------- resolve

    async def _user_row(self, email: str) -> dict[str, Any]:
        """The users columns resolution reads, cached under ("user", email)
        ({} for no row); both resolve paths share the key and the columns."""
        row = self._cache_get(("user", email))
        if row is None:
            row = await self.ctx.db.fetchone(
                "SELECT is_admin, is_active, password_change_required,"
                " tokens_valid_after FROM users WHERE email=?", (email,)) or {}
            self._cache_put(("user", email), row, self.ctx.settings.auth_cache_user_ttl)
        return row

    async def resolve_bearer(self, token: str) -> AuthContext:
        settings = self.ctx.settings
        try:
            payload = jwt.decode(token, settings.jwt_secret_key,
                                 algorithms=(settings.jwt_algorithm,),
                                 audience=settings.jwt_audience, issuer=settings.jwt_issuer)
        except jwt.JWTError as exc:
            raise AuthError(f"Invalid token: {exc}") from exc
        email = payload.get("sub")
        if not email:
            raise AuthError("Token missing subject")
        jti = payload.get("jti")
        if jti:
            if jti in self._revoked_jtis:
                raise AuthError("Token revoked")
            revocation = self._cache_get(("jti", jti))
            if revocation is None:
                row = await self.ctx.db.fetchone(
                    "SELECT revoked_at FROM api_tokens WHERE jti=?", (jti,))
                revocation = ("miss" if row is None
                              else ("revoked" if row["revoked_at"] else "ok"))
                self._cache_put(("jti", jti), revocation, settings.auth_cache_revocation_ttl)
            if revocation == "revoked":
                self._revoked_jtis.add(jti)
                raise AuthError("Token revoked")
            if revocation == "ok":
                await self.ctx.db.execute("UPDATE api_tokens SET last_used=? WHERE jti=?",
                                          (now(), jti))
        user_row = await self._user_row(email)
        if user_row and not user_row["is_active"]:
            raise AuthError("User deactivated")
        if user_row and user_row.get("tokens_valid_after"):
            # a password reset killed every session minted before it
            iat = payload.get("iat")
            if iat is not None and iat < user_row["tokens_valid_after"]:
                raise AuthError("Token invalidated by password reset")
        is_admin = bool(user_row and user_row["is_admin"])
        teams = await self.user_teams(email)
        scopes = payload.get("scopes")
        if scopes:
            # a scoped token's power is its scopes alone: later role grants
            # do not widen it, and it stays admin only with admin.all
            perms = set(scopes) & PERMISSIONS
            is_admin = is_admin and "admin.all" in perms
        elif is_admin:
            perms = set(PERMISSIONS)
        else:
            perms = set(DEFAULT_USER_PERMISSIONS) | await self._role_permissions(email, teams)
        return AuthContext(user=email, is_admin=is_admin, teams=teams, permissions=perms,
                           token_jti=jti, server_id=payload.get("server_id"), via="jwt",
                           scoped=bool(scopes),
                           password_change_required=bool(
                               user_row and user_row["password_change_required"]))

    async def resolve_basic(self, username: str, password: str) -> AuthContext:
        settings = self.ctx.settings
        user_ok = hmac.compare_digest(username.encode(), settings.basic_auth_user.encode())
        pass_ok = hmac.compare_digest(password.encode(), settings.basic_auth_password.encode())
        if user_ok and pass_ok:
            # the env credentials are the platform admin's identity, whose
            # forced-rotation flag applies here too
            row = await self._user_row(settings.platform_admin_email)
            return AuthContext(user=settings.platform_admin_email, is_admin=True,
                               permissions=set(PERMISSIONS), via="basic",
                               password_change_required=bool(
                                   row.get("password_change_required")))
        # one verified login caches a peppered digest for auth_cache_user_ttl:
        # a repeat skips the KDF and the users-table write; password changes,
        # lockouts and deactivation invalidate it
        cached_digest = self._cache_get(("basic_ok", username))
        verified_from_cache = (cached_digest is not None and hmac.compare_digest(
            cached_digest, self._password_digest(password)))
        verified = False
        if not verified_from_cache:
            try:
                verified = await self.verify_password(username, password)
            finally:
                if not verified:
                    # any failure drops the fast path: the next right login
                    # runs the full verify, which resets the failure count
                    self._cache.pop(("basic_ok", username), None)
        if verified_from_cache or verified:
            if not verified_from_cache:
                self._cache_put(("basic_ok", username), self._password_digest(password),
                                settings.auth_cache_user_ttl)
            row = await self._user_row(username)
            if not row or not row.get("is_active", 1):
                raise AuthError("Invalid credentials")
            is_admin = bool(row.get("is_admin"))
            teams = await self.user_teams(username)
            perms = (set(PERMISSIONS) if is_admin
                     else set(DEFAULT_USER_PERMISSIONS)
                     | await self._role_permissions(username, teams))
            return AuthContext(user=username, is_admin=is_admin, teams=teams,
                               permissions=perms, via="basic",
                               password_change_required=bool(
                                   row.get("password_change_required")))
        raise AuthError("Invalid credentials")

    async def _role_permissions(self, email: str, teams: list[str]) -> set[str]:
        """The permissions of the user's role assignments, cached per
        (email, teams) for ``auth_cache_role_ttl``; grants invalidate."""
        key = ("roles", email)
        cached = self._cache_get(key)
        if cached is not None and cached[0] == tuple(teams):
            return set(cached[1])
        from .role_service import RoleService
        perms = await RoleService(self.ctx).role_permissions(email, teams)
        self._cache_put(key, (tuple(teams), frozenset(perms)),
                        self.ctx.settings.auth_cache_role_ttl)
        return perms

    async def effective_permissions(self, email: str) -> tuple[set[str], bool, bool]:
        """(permissions, is_admin, is_active) as ``resolve_*`` computes them
        for an unscoped identity: the one place the rule lives, which the
        /rbac inspection routes share. An unknown user is a 404."""
        row = await self.ctx.db.fetchone(
            "SELECT is_admin, is_active FROM users WHERE email=?", (email,))
        if row is None:
            raise NotFoundError(f"User {email!r} not found")
        is_admin = bool(row["is_admin"])
        is_active = bool(row["is_active"])
        teams = await self.user_teams(email)
        if is_admin:
            perms = set(PERMISSIONS)
        else:
            perms = set(DEFAULT_USER_PERMISSIONS) | await self._role_permissions(email, teams)
        return perms, is_admin, is_active
