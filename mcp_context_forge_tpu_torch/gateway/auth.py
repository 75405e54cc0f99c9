"""The identity types of the port's gateway and the reading of an
Authorization header that needs no database (stdlib only).

- ``PERMISSIONS`` and ``DEFAULT_USER_PERMISSIONS``, the reference's matrix.
- ``AuthContext`` with ``can``/``require``; ``AuthError`` (a 401) and
  ``PermissionDenied`` (a 403). ``services/auth_service.py`` resolves
  identities into these over the gateway's database (users, API tokens,
  teams, roles), and the app's auth middleware goes through it.
- ``resolve_basic``, ``resolve_bearer`` and ``resolve_header``: the same
  readings from the settings alone, for a caller with no database: the env
  credentials resolve to the platform admin with every permission; a JWT
  decoded against ``jwt_secret_key``, ``jwt_algorithm``, ``jwt_audience``
  and ``jwt_issuer``, with a required ``sub``, keeps its scopes that are
  permissions, or else gets ``DEFAULT_USER_PERMISSIONS`` (what the database
  path gives a subject with no users row and no roles); no header is an
  anonymous admin when ``auth_required`` is off, else
  ``AuthError("Authentication required")``. None of them reads revocations,
  users rows, teams or roles.
``settings`` is duck-typed as the gateway's.
"""

from __future__ import annotations

import base64
import binascii
import hmac
from dataclasses import dataclass, field
from typing import Any

from ..utils import jwt

PERMISSIONS = {
    "tools.read", "tools.create", "tools.update", "tools.delete", "tools.invoke",
    "resources.read", "resources.create", "resources.update", "resources.delete",
    "prompts.read", "prompts.create", "prompts.update", "prompts.delete",
    "gateways.read", "gateways.create", "gateways.update", "gateways.delete",
    "servers.read", "servers.create", "servers.update", "servers.delete",
    "a2a.read", "a2a.create", "a2a.invoke", "a2a.delete",
    "teams.read", "teams.create", "teams.manage", "tokens.manage", "admin.all",
    "llm.chat", "llm.admin", "plugins.manage", "observability.read",
    "export.run", "import.run",
}

DEFAULT_USER_PERMISSIONS = {
    "tools.read", "tools.invoke", "resources.read", "prompts.read",
    "servers.read", "gateways.read", "a2a.read", "a2a.invoke", "llm.chat",
    "teams.read", "teams.create",
}


class AuthError(Exception):
    """401-grade failure."""


class PermissionDenied(Exception):
    """403-grade failure."""


@dataclass
class AuthContext:
    """Resolved request identity."""

    user: str
    is_admin: bool = False
    teams: list[str] = field(default_factory=list)
    permissions: set[str] = field(default_factory=set)
    token_jti: str | None = None
    server_id: str | None = None  # server-scoped token restriction
    via: str = "jwt"  # jwt|basic|anonymous
    scoped: bool = False  # token carries explicit scopes: no admin shortcut
    # the users row's forced-rotation flag (read by password_change_middleware)
    password_change_required: bool = False

    def can(self, permission: str) -> bool:
        # a scoped token derives its power from its scopes alone: an
        # admin's read-only token must not keep admin.all
        if self.scoped:
            return "admin.all" in self.permissions or permission in self.permissions
        return self.is_admin or "admin.all" in self.permissions or permission in self.permissions

    def require(self, permission: str) -> None:
        if not self.can(permission):
            raise PermissionDenied(f"Missing permission: {permission}")


def resolve_basic(settings: Any, username: str, password: str) -> AuthContext:
    """The env credentials, or ``AuthError``."""
    user_ok = hmac.compare_digest(username.encode(), settings.basic_auth_user.encode())
    pass_ok = hmac.compare_digest(password.encode(), settings.basic_auth_password.encode())
    if user_ok and pass_ok:
        return AuthContext(user=settings.platform_admin_email, is_admin=True,
                           permissions=set(PERMISSIONS), via="basic")
    raise AuthError("Invalid credentials")


def resolve_bearer(settings: Any, token: str) -> AuthContext:
    """A verified JWT's identity, or ``AuthError``."""
    try:
        payload = jwt.decode(token, settings.jwt_secret_key,
                             algorithms=(settings.jwt_algorithm,),
                             audience=settings.jwt_audience,
                             issuer=settings.jwt_issuer)
    except jwt.JWTError as exc:
        raise AuthError(f"Invalid token: {exc}") from exc
    email = payload.get("sub")
    if not email:
        raise AuthError("Token missing subject")
    scopes = payload.get("scopes")
    perms = set(scopes) & PERMISSIONS if scopes else set(DEFAULT_USER_PERMISSIONS)
    return AuthContext(user=email, permissions=perms, token_jti=payload.get("jti"),
                       server_id=payload.get("server_id"), via="jwt",
                       scoped=bool(scopes))


def resolve_header(settings: Any, header: str) -> AuthContext:
    """The identity an Authorization header carries (the auth middleware's
    reading of it)."""
    if header.lower().startswith("bearer "):
        return resolve_bearer(settings, header[7:].strip())
    if header.lower().startswith("basic "):
        try:
            decoded = base64.b64decode(header[6:].strip()).decode()
        except (binascii.Error, ValueError) as exc:
            raise AuthError("Malformed basic credentials") from exc
        username, _, password = decoded.partition(":")
        return resolve_basic(settings, username, password)
    if not settings.auth_required:
        return AuthContext(user="anonymous", is_admin=True, via="anonymous")
    raise AuthError("Authentication required")
