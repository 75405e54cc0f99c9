"""OAuth 2.0 for upstream gateways + OIDC SSO login.

A copy of the JAX package's ``services/oauth_service.py``.

Reference: `services/oauth_manager.py` (token acquisition/exchange for
gateway auth), `services/dcr_service.py`, `services/sso_service.py` +
`routers/sso.py` (GitHub/Google/Okta/Keycloak/Entra providers). In-tree:

- ``OAuthManager``: client-credentials grant with token caching/refresh —
  gateways with ``auth_type: oauth`` get a fresh Bearer automatically.
- ``SSOService``: generic OIDC authorization-code flow (discovery from the
  issuer, state validation, code→token exchange, id_token claims → local
  user provisioning + gateway JWT). Any OIDC IdP (incl. the reference's
  provider list) fits the same three config fields.
"""

from __future__ import annotations

import base64
import json
import secrets
import time
from typing import Any

from ..utils.ids import new_id
from .base import AppContext, NotFoundError, ValidationFailure, now


class OAuthManager:
    """Client-credentials tokens for outbound calls, cached until expiry."""

    def __init__(self, ctx: AppContext):
        self.ctx = ctx
        self._cache: dict[str, tuple[str, float]] = {}  # key -> (token, expiry)

    async def client_credentials_token(self, token_url: str, client_id: str,
                                       client_secret: str, scope: str = "") -> str:
        import hashlib
        secret_tag = hashlib.sha256(client_secret.encode()).hexdigest()[:12]
        key = f"{token_url}|{client_id}|{secret_tag}|{scope}"
        cached = self._cache.get(key)
        if cached and cached[1] > time.monotonic() + 30:
            return cached[0]
        data = {"grant_type": "client_credentials", "client_id": client_id,
                "client_secret": client_secret}
        if scope:
            data["scope"] = scope
        resp = await self.ctx.http_client.post(token_url, data=data)
        resp.raise_for_status()
        payload = resp.json()
        token = payload.get("access_token", "")
        if not token:
            raise ValidationFailure("Token endpoint returned no access_token")
        expires_in = float(payload.get("expires_in", 300))
        self._cache[key] = (token, time.monotonic() + expires_in)
        return token

    async def headers_for(self, auth_value: dict[str, Any]) -> dict[str, str]:
        """auth_value: {token_url, client_id, client_secret, scope?}."""
        token = await self.client_credentials_token(
            auth_value.get("token_url", ""), auth_value.get("client_id", ""),
            auth_value.get("client_secret", ""), auth_value.get("scope", ""))
        return {"authorization": f"Bearer {token}"}


class SSOService:
    """Generic OIDC authorization-code flow."""

    STATE_TTL = 600.0

    def __init__(self, ctx: AppContext, auth_service):
        self.ctx = ctx
        self.auth = auth_service
        self._providers: dict[str, dict[str, Any]] = {}
        # login may start on one worker and call back on another: state lives
        # in the shared DB, not process memory

    def register_provider(self, name: str, issuer: str, client_id: str,
                          client_secret: str,
                          authorization_endpoint: str = "",
                          token_endpoint: str = "",
                          dialect: str = "oidc",
                          userinfo_endpoint: str = "",
                          metadata: dict[str, Any] | None = None) -> None:
        """dialect selects the IdP's claim quirks (reference sso_service
        normalizes the same five families, `sso_service.py:1788-1900`):

        - "oidc" / "google": id_token carries standard claims
        - "github": no OIDC — claims come from the user API
        - "okta": groups ride a configurable claim (default "groups")
        - "keycloak": email/username claims configurable; groups assembled
          from realm_access.roles / resource_access client roles / custom
          groups claim per metadata flags map_realm_roles/map_client_roles
        - "entra": email falls back preferred_username -> upn

        ``metadata`` may also carry ``admin_groups`` (IdP group names that
        grant is_admin) and ``team_mapping`` ({group: team_id} auto-joined
        at login — the reference's SSO team mapping)."""
        self._providers[name] = {
            "issuer": issuer.rstrip("/"), "client_id": client_id,
            "client_secret": client_secret,
            "authorization_endpoint": authorization_endpoint,
            "token_endpoint": token_endpoint,
            "dialect": dialect,
            "userinfo_endpoint": userinfo_endpoint,
            "metadata": metadata or {},
        }

    def list_providers(self) -> list[str]:
        return sorted(self._providers)

    async def _discover(self, provider: dict[str, Any]) -> None:
        if provider["authorization_endpoint"] and provider["token_endpoint"]:
            return
        if provider.get("dialect") == "github":
            # GitHub has no OIDC discovery document: well-known endpoints
            base = provider["issuer"]
            provider["authorization_endpoint"] = base + "/login/oauth/authorize"
            provider["token_endpoint"] = base + "/login/oauth/access_token"
            return
        resp = await self.ctx.http_client.get(
            provider["issuer"] + "/.well-known/openid-configuration")
        resp.raise_for_status()
        doc = resp.json()
        provider["authorization_endpoint"] = doc["authorization_endpoint"]
        provider["token_endpoint"] = doc["token_endpoint"]

    async def login_url(self, name: str, redirect_uri: str) -> str:
        provider = self._providers.get(name)
        if provider is None:
            raise NotFoundError(f"SSO provider {name!r} not configured")
        await self._discover(provider)
        state = secrets.token_urlsafe(24)
        await self.ctx.db.execute(
            "INSERT OR REPLACE INTO global_config (key, value, updated_at)"
            " VALUES (?,?,?)", (f"sso_state:{state}", name, now()))
        await self.ctx.db.execute(
            "DELETE FROM global_config WHERE key LIKE 'sso_state:%'"
            " AND updated_at < ?", (now() - self.STATE_TTL,))
        from urllib.parse import urlencode
        dialect = provider.get("dialect", "oidc")
        if dialect == "github":
            scope = "read:user user:email"
        elif dialect == "okta":
            scope = "openid email profile groups"
        else:
            scope = "openid email profile"
        scope = provider["metadata"].get("scope", scope)
        query = urlencode({
            "response_type": "code", "client_id": provider["client_id"],
            "redirect_uri": redirect_uri, "scope": scope, "state": state})
        return f"{provider['authorization_endpoint']}?{query}"

    async def handle_callback(self, state: str, code: str,
                              redirect_uri: str) -> dict[str, Any]:
        row = await self.ctx.db.fetchone(
            "SELECT value, updated_at FROM global_config WHERE key=?",
            (f"sso_state:{state}",))
        if row is not None:  # single-use
            await self.ctx.db.execute("DELETE FROM global_config WHERE key=?",
                                      (f"sso_state:{state}",))
        if row is None or now() - row["updated_at"] > self.STATE_TTL:
            raise ValidationFailure("Invalid or expired SSO state")
        provider_name = row["value"]
        provider = self._providers.get(provider_name)
        if provider is None:
            raise ValidationFailure("SSO provider no longer configured")
        resp = await self.ctx.http_client.post(
            provider["token_endpoint"], data={
                "grant_type": "authorization_code", "code": code,
                "redirect_uri": redirect_uri,
                "client_id": provider["client_id"],
                "client_secret": provider["client_secret"]},
            # GitHub answers urlencoded unless asked for JSON
            headers={"accept": "application/json"})
        resp.raise_for_status()
        tokens = resp.json()
        if provider.get("dialect") == "github":
            claims = await self._github_claims(provider, tokens)
        else:
            claims = _unverified_id_token_claims(tokens.get("id_token", ""))
        info = self._normalize_claims(provider, claims)
        email = info.get("email")
        if not email:
            raise ValidationFailure("IdP id_token is missing an email claim")
        settings = self.ctx.settings
        domain = email.rsplit("@", 1)[-1].lower()
        trusted = settings.sso_trusted_domains
        if trusted and domain not in trusted:
            # provisioning policy: only allowlisted email domains may
            # enter through SSO (reference sso trusted-domain gating)
            raise ValidationFailure(
                f"SSO domain {domain!r} is not in sso_trusted_domains")
        metadata = provider.get("metadata", {})
        admin_groups = set(metadata.get("admin_groups") or [])
        is_admin = 1 if admin_groups & set(info["groups"]) else 0
        if domain in settings.sso_auto_admin_domains:
            is_admin = 1
        # provision on first login (reference sso_service auto-provisioning)
        row = await self.ctx.db.fetchone(
            "SELECT email, is_active FROM users WHERE email=?", (email,))
        ts = now()
        if not row:
            await self.ctx.db.execute(
                "INSERT INTO users (email, password_hash, full_name, is_admin,"
                " auth_provider, is_active, created_at, updated_at)"
                " VALUES (?,?,?,?,?,?,?,?)",
                (email, "!sso!", info.get("name", ""), is_admin,
                 provider_name,
                 0 if settings.sso_require_admin_approval else 1, ts, ts))
            if settings.sso_require_admin_approval:
                raise ValidationFailure(
                    "Account provisioned; awaiting administrator approval "
                    "(sso_require_admin_approval)")
        elif not row["is_active"]:
            # EVERY later login of a deactivated/pending account must stop
            # here — not mint a token that only fails downstream, and not
            # run team-mapping/admin-refresh writes for it
            raise ValidationFailure(
                "Account is deactivated or awaiting administrator approval")
        elif is_admin:
            # group-derived privilege refreshes on every login (groups may
            # have been granted since provisioning); it is never revoked
            # here — local admin grants stay authoritative
            await self.ctx.db.execute(
                "UPDATE users SET is_admin=1, updated_at=? WHERE email=?",
                (ts, email))
        await self._apply_team_mapping(email, info["groups"], metadata)
        token = self.auth.issue_jwt(email)
        return {"access_token": token, "token_type": "bearer", "email": email}

    def _normalize_claims(self, provider: dict[str, Any],
                          claims: dict[str, Any]) -> dict[str, Any]:
        """Flatten IdP-dialect claim quirks into {email, name, groups}
        (reference `sso_service.py:1788-1900` normalizes the same way)."""
        metadata = provider.get("metadata", {})
        dialect = provider.get("dialect", "oidc")
        groups_claim = metadata.get("groups_claim", "groups")
        email = claims.get("email")
        name = claims.get("name", "")
        groups: list[str] = []
        raw = claims.get(groups_claim)
        if isinstance(raw, str):
            groups = [raw]
        elif isinstance(raw, list):
            groups = [str(g) for g in raw if str(g).strip()]
        if dialect == "keycloak":
            email = claims.get(metadata.get("email_claim", "email"))
            if metadata.get("map_realm_roles"):
                groups.extend((claims.get("realm_access") or {}).get("roles", []))
            if metadata.get("map_client_roles"):
                for client, access in (claims.get("resource_access") or {}).items():
                    groups.extend(f"{client}:{role}"
                                  for role in access.get("roles", []))
            name = name or claims.get("preferred_username", "")
        elif dialect == "entra":
            # Entra often omits email: preferred_username (the UPN) or upn
            email = (claims.get("email") or claims.get("preferred_username")
                     or claims.get("upn"))
            name = claims.get("name") or (email or "")
            # roles claim carries app-role assignments alongside groups
            roles = claims.get("roles")
            if isinstance(roles, list):
                groups.extend(str(r) for r in roles)
        return {"email": email, "name": name, "groups": groups}

    async def _apply_team_mapping(self, email: str, groups: list[str],
                                  metadata: dict[str, Any]) -> None:
        """IdP groups -> team memberships ({group: team_id}); memberships
        created here are tagged via role 'member' and re-asserted each
        login (reference sso_service._apply_team_mapping)."""
        mapping = metadata.get("team_mapping") or {}
        for group in groups:
            team_id = mapping.get(group)
            if not team_id:
                continue
            team = await self.ctx.db.fetchone(
                "SELECT id FROM teams WHERE id=?", (team_id,))
            if team is None:
                continue
            existing = await self.ctx.db.fetchone(
                "SELECT team_id FROM team_members WHERE team_id=? AND"
                " user_email=?", (team_id, email))
            if existing is None:
                await self.ctx.db.execute(
                    "INSERT INTO team_members (team_id, user_email, role,"
                    " joined_at) VALUES (?,?,?,?)",
                    (team_id, email, "member", now()))


    async def _github_claims(self, provider: dict[str, Any],
                             tokens: dict[str, Any]) -> dict[str, Any]:
        """GitHub dialect: no id_token — fetch /user (+ /user/emails for a
        private primary email) with the access token."""
        access = tokens.get("access_token", "")
        if not access:
            raise ValidationFailure("GitHub token response missing access_token")
        api = provider.get("userinfo_endpoint") or "https://api.github.com/user"
        headers = {"authorization": f"Bearer {access}",
                   "accept": "application/vnd.github+json"}
        resp = await self.ctx.http_client.get(api, headers=headers)
        resp.raise_for_status()
        user = resp.json()
        email = user.get("email")
        if not email:
            resp = await self.ctx.http_client.get(api.rstrip("/") + "/emails",
                                                  headers=headers)
            if resp.status_code == 200:
                emails = resp.json()
                primary = [e for e in emails
                           if isinstance(e, dict) and e.get("primary")
                           and e.get("verified")]
                if primary:
                    email = primary[0].get("email")
        return {"email": email, "name": user.get("name") or user.get("login", "")}


def _unverified_id_token_claims(id_token: str) -> dict[str, Any]:
    """Decode id_token claims WITHOUT signature verification — acceptable
    only because the token was just received directly from the IdP's token
    endpoint over the TLS channel we initiated (RFC 6749 §10.16 model; the
    reference relies on the same direct-channel property)."""
    try:
        payload_b64 = id_token.split(".")[1]
        payload_b64 += "=" * (-len(payload_b64) % 4)
        return json.loads(base64.urlsafe_b64decode(payload_b64))
    except Exception:
        return {}


class DcrError(ValidationFailure):
    """Dynamic client registration failure (client-actionable -> 422)."""


class DCRService:
    """OAuth Dynamic Client Registration + AS metadata discovery.

    Reference: `services/dcr_service.py` — RFC 8414 metadata discovery
    (well-known inserted between host and path, OIDC fallback, issuer-match
    validation, TTL cache) and RFC 7591 dynamic registration, with the
    registered client persisted per gateway (encrypted secret).
    """

    def __init__(self, ctx: AppContext):
        self.ctx = ctx
        self._metadata_cache: dict[str, tuple[dict[str, Any], float]] = {}
        self.metadata_ttl = 3600.0

    async def discover(self, issuer: str) -> dict[str, Any]:
        """RFC 8414 discovery with OIDC fallback; validates issuer match."""
        from urllib.parse import urlsplit

        issuer = issuer.rstrip("/")
        cached = self._metadata_cache.get(issuer)
        if cached and time.monotonic() - cached[1] < self.metadata_ttl:
            return cached[0]
        parsed = urlsplit(issuer)
        rfc8414 = f"{parsed.scheme}://{parsed.netloc}/.well-known/oauth-authorization-server"
        if parsed.path:
            rfc8414 += parsed.path
        oidc = f"{issuer}/.well-known/openid-configuration"
        last_error: Exception | None = None
        for url in (rfc8414, oidc):
            try:
                resp = await self.ctx.http_client.get(url)
                if resp.status_code != 200:
                    last_error = DcrError(f"metadata fetch {url} -> {resp.status_code}")
                    continue
                metadata = resp.json()
                if (metadata.get("issuer") or "").rstrip("/") != issuer:
                    raise DcrError(
                        f"AS metadata issuer mismatch: expected {issuer},"
                        f" got {metadata.get('issuer')}")
                self._metadata_cache[issuer] = (metadata, time.monotonic())
                return metadata
            except DcrError:
                raise
            except Exception as exc:  # network-level
                last_error = exc
        raise DcrError(f"Failed to discover AS metadata for {issuer}: {last_error}")

    async def register_client(self, gateway_id: str, issuer: str,
                              redirect_uri: str,
                              scopes: list[str] | None = None) -> dict[str, Any]:
        """RFC 7591 dynamic registration against the issuer's
        registration_endpoint; persists (encrypted) credentials."""
        issuer = issuer.rstrip("/")  # stored form must match get_client's
        metadata = await self.discover(issuer)
        endpoint = metadata.get("registration_endpoint")
        if not endpoint:
            raise DcrError(f"AS {issuer} does not support dynamic registration")
        body = {
            "client_name": f"mcpforge-gateway-{gateway_id[:8]}",
            "redirect_uris": [redirect_uri],
            "grant_types": ["authorization_code", "refresh_token"],
            "response_types": ["code"],
            "token_endpoint_auth_method": "client_secret_basic",
            **({"scope": " ".join(scopes)} if scopes else {}),
        }
        resp = await self.ctx.http_client.post(endpoint, json=body)
        if resp.status_code not in (200, 201):
            raise DcrError(f"registration failed ({resp.status_code}): {resp.text[:200]}")
        registration = resp.json()
        client_id = registration.get("client_id")
        if not client_id:
            raise DcrError("AS response missing client_id")
        ts = now()
        record_id = new_id()
        secret = self.ctx.settings.auth_encryption_secret
        from ..db.core import to_json
        from ..utils.crypto import encrypt_field
        await self.ctx.db.execute(
            "INSERT INTO registered_oauth_clients (id, gateway_id, issuer,"
            " client_id, client_secret_enc, redirect_uri, scopes,"
            " registration_client_uri, registration_access_token_enc, created_at)"
            " VALUES (?,?,?,?,?,?,?,?,?,?)"
            " ON CONFLICT(gateway_id, issuer) DO UPDATE SET"
            " client_id=excluded.client_id,"
            " client_secret_enc=excluded.client_secret_enc,"
            " redirect_uri=excluded.redirect_uri, scopes=excluded.scopes,"
            " registration_client_uri=excluded.registration_client_uri,"
            " registration_access_token_enc=excluded.registration_access_token_enc",
            (record_id, gateway_id, issuer, client_id,
             encrypt_field(registration.get("client_secret", ""), secret),
             redirect_uri, to_json(scopes or []),
             registration.get("registration_client_uri"),
             encrypt_field(registration.get("registration_access_token", ""),
                           secret),
             ts))
        return {"id": record_id, "gateway_id": gateway_id, "issuer": issuer,
                "client_id": client_id, "redirect_uri": redirect_uri}

    async def get_or_register(self, gateway_id: str, issuer: str,
                              redirect_uri: str,
                              scopes: list[str] | None = None) -> dict[str, Any]:
        row = await self.get_client(gateway_id, issuer)
        if row is not None:
            return row
        return await self.register_client(gateway_id, issuer, redirect_uri, scopes)

    async def get_client(self, gateway_id: str,
                         issuer: str) -> dict[str, Any] | None:
        row = await self.ctx.db.fetchone(
            "SELECT id, gateway_id, issuer, client_id, redirect_uri FROM"
            " registered_oauth_clients WHERE gateway_id=? AND issuer=?",
            (gateway_id, issuer.rstrip("/")))
        return dict(row) if row else None

    async def list_clients(self) -> list[dict[str, Any]]:
        rows = await self.ctx.db.fetchall(
            "SELECT id, gateway_id, issuer, client_id, redirect_uri, created_at"
            " FROM registered_oauth_clients")
        return [dict(r) for r in rows]

    async def delete_client(self, record_id: str) -> None:
        row = await self.ctx.db.fetchone(
            "SELECT * FROM registered_oauth_clients WHERE id=?", (record_id,))
        if row is None:
            raise NotFoundError("Registered client not found")
        # best-effort RFC 7592 de-registration upstream
        if row["registration_client_uri"]:
            from ..utils.crypto import decrypt_field
            token = decrypt_field(row["registration_access_token_enc"],
                                  self.ctx.settings.auth_encryption_secret)
            try:
                await self.ctx.http_client.delete(
                    row["registration_client_uri"],
                    headers={"authorization": f"Bearer {token}"} if token else {})
            except Exception:
                pass
        await self.ctx.db.execute(
            "DELETE FROM registered_oauth_clients WHERE id=?", (record_id,))


async def exchange_token(ctx: AppContext, token_url: str, subject_token: str,
                         client_id: str = "", client_secret: str = "",
                         audience: str = "",
                         subject_token_type: str =
                         "urn:ietf:params:oauth:token-type:access_token"
                         ) -> dict[str, Any]:
    """RFC 8693 token exchange (reference gateway_service.py:767 validation
    path): trade an inbound token for an upstream-audience token."""
    data = {
        "grant_type": "urn:ietf:params:oauth:grant-type:token-exchange",
        "subject_token": subject_token,
        "subject_token_type": subject_token_type,
    }
    if audience:
        data["audience"] = audience
    if client_id:
        data["client_id"] = client_id
    if client_secret:
        data["client_secret"] = client_secret
    resp = await ctx.http_client.post(token_url, data=data)
    if resp.status_code != 200:
        raise ValidationFailure(
            f"token exchange failed ({resp.status_code}): {resp.text[:200]}")
    payload = resp.json()
    if "access_token" not in payload:
        raise ValidationFailure("token exchange response missing access_token")
    return payload
