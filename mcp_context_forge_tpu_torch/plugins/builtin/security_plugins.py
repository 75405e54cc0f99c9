"""Security and ops plugins (a copy of the JAX package's
``plugins/builtin/security_plugins.py``): ``jwt_claims_extraction``,
``vault``, ``virus_total_checker``, ``span_attribute_customizer``,
``unified_pdp`` and ``tools_telemetry_exporter``. The exporter posts through
the app's shared ``ctx.http_client`` and holds each task it starts until the
task ends."""

from __future__ import annotations

import base64
import hashlib
import json
import os
import re

from ...utils.jwt import _b64url_decode
from ..framework import Plugin, PluginViolation
from .filters import _iter_text


class JwtClaimsExtractionPlugin(Plugin):
    """Extracts claims from the inbound bearer token into tool arguments
    (reference jwt_claims_extraction).

    config: {claims: {"sub": "user_id"}, require: []}"""

    async def tool_pre_invoke(self, name, arguments, headers, context):
        required = self.config.config.get("require", [])
        auth_header = headers.get("authorization", "")
        if not auth_header.lower().startswith("bearer "):
            if required:  # the gate must fail closed, not silently skip
                raise PluginViolation(
                    "Required claims configured but no bearer token present",
                    code="CLAIMS_MISSING")
            return None
        token = auth_header[7:]
        try:
            # decode WITHOUT verification: the gateway's auth middleware
            # already verified this token; we only mirror claims
            claims = json.loads(_b64url_decode(token.split(".")[1]))
        except Exception:
            if required:
                raise PluginViolation("Bearer token is not a decodable JWT",
                                      code="CLAIMS_MISSING") from None
            return None
        # the token is decoded unverified, so its identity must match the
        # identity the gateway DID verify — otherwise a client authenticated
        # through another path could smuggle a forged bearer alongside
        if not self.config.config.get("allow_mismatched_sub", False):
            sub = claims.get("sub")
            if sub and context.user and sub != context.user:
                raise PluginViolation(
                    "Bearer token subject does not match the authenticated user",
                    code="CLAIMS_MISMATCH")
        mapping = self.config.config.get("claims", {"sub": "jwt_sub"})
        missing = [c for c in required if c not in claims]
        if missing:
            raise PluginViolation(f"Token missing required claims: {missing}",
                                  code="CLAIMS_MISSING")
        new_args = dict(arguments)
        for claim, arg_name in mapping.items():
            if claim in claims:
                new_args[arg_name] = claims[claim]
        return {"arguments": new_args}


class VaultPlugin(Plugin):
    """Injects secrets from the process environment into placeholders —
    ``{{vault:NAME}}`` in arguments/headers becomes $VAULT_NAME (reference
    vault plugin; env is the in-tree secret backend).

    config: {prefix: "VAULT_"}"""

    _TOKEN = re.compile(r"\{\{vault:([A-Za-z0-9_]+)\}\}")

    def _substitute(self, value: str, prefix: str) -> str:
        def repl(match: re.Match) -> str:
            secret = os.environ.get(prefix + match.group(1))
            if secret is None:
                raise PluginViolation(
                    f"Vault secret {match.group(1)!r} is not provisioned",
                    code="VAULT_MISSING")
            return secret

        return self._TOKEN.sub(repl, value)

    def _walk(self, value, prefix: str):
        """Recursive substitution — MCP arguments are routinely nested."""
        if isinstance(value, str):
            return self._substitute(value, prefix)
        if isinstance(value, dict):
            return {k: self._walk(v, prefix) for k, v in value.items()}
        if isinstance(value, list):
            return [self._walk(v, prefix) for v in value]
        return value

    async def tool_pre_invoke(self, name, arguments, headers, context):
        prefix = self.config.config.get("prefix", "VAULT_")
        return {"arguments": self._walk(arguments, prefix),
                "headers": self._walk(headers, prefix)}


class VirusTotalCheckerPlugin(Plugin):
    """Hash-denylist check on resource/tool content (reference
    virus_total_checker; zero-egress in-tree variant checks configured hash
    lists instead of calling the VT API — the API call seats behind the same
    hook when egress exists).

    config: {blocked_sha256: [...], api_base: "" (optional real VT)}"""

    async def resource_post_fetch(self, uri, result, context):
        blocked = set(self.config.config.get("blocked_sha256", []))
        if not blocked:
            return None
        for entry in result.get("contents", []):
            if entry.get("blob"):
                # blobs are base64: hash the DECODED bytes (what VT reports)
                try:
                    body = base64.b64decode(entry["blob"])
                except Exception:
                    body = entry["blob"].encode()
            else:
                body = (entry.get("text") or "").encode()
            digest = hashlib.sha256(body).hexdigest()
            if digest in blocked:
                raise PluginViolation(f"Resource {uri!r} matches a blocked hash",
                                      code="MALWARE_HASH")
        return None

    async def tool_post_invoke(self, name, result, context):
        blocked = set(self.config.config.get("blocked_sha256", []))
        if not blocked:
            return None
        for item in _iter_text(result):
            digest = hashlib.sha256(item.get("text", "").encode()).hexdigest()
            if digest in blocked:
                raise PluginViolation("Tool output matches a blocked hash",
                                      code="MALWARE_HASH")
        return None


class SpanAttributeCustomizerPlugin(Plugin):
    """Stamps static + per-call attributes onto the active trace span
    (reference span_attribute_customizer).

    config: {attributes: {...}, include_tool: true}"""

    async def tool_pre_invoke(self, name, arguments, headers, context):
        from ...observability.tracing import current_span

        span = current_span()
        if span is not None:
            for key, value in self.config.config.get("attributes", {}).items():
                span.set_attribute(key, value)
            if self.config.config.get("include_tool", True):
                span.set_attribute("custom.tool", name)
                span.set_attribute("custom.user", context.user or "")
        return None


class UnifiedPdpPlugin(Plugin):
    """Policy decision point: allow/deny matrix over (user, tool)
    (reference unified_pdp — OPA/Cedar externalization reduced to an
    in-tree rule table; an external PDP plugs in behind the same hook).

    config: {rules: [{users: ["*"], tools: ["*"], effect: "allow"|"deny"}],
             default: "allow"}"""

    @staticmethod
    def _match(pattern_list: list[str], value: str) -> bool:
        return any(p == "*" or p == value for p in pattern_list)

    async def tool_pre_invoke(self, name, arguments, headers, context):
        rules = self.config.config.get("rules", [])
        decision = self.config.config.get("default", "allow")
        for rule in rules:
            if self._match(rule.get("users", ["*"]), context.user or "") and \
                    self._match(rule.get("tools", ["*"]), name):
                decision = rule.get("effect", "allow")
                break
        if decision != "allow":
            raise PluginViolation(
                f"Policy denies {context.user!r} -> {name!r}", code="PDP_DENY")
        return None


class ToolsTelemetryExporterPlugin(Plugin):
    """Ships per-invocation telemetry records to an HTTP collector
    (reference tools_telemetry_exporter), fire-and-forget.

    config: {url: "", include_arguments: false}"""

    def __init__(self, config, ctx=None):
        super().__init__(config, ctx)
        self._tasks: set = set()  # strong refs: asyncio tasks are weakly held

    async def tool_post_invoke(self, name, result, context):
        url = self.config.config.get("url", "")
        if not url or self.ctx is None:
            return None
        record = {"tool": name, "user": context.user,
                  "is_error": bool(result.get("isError"))}
        import asyncio

        async def _ship() -> None:
            try:
                await self.ctx.http_client.post(url, json=record, timeout=5.0)
            except Exception:
                pass

        task = asyncio.get_running_loop().create_task(_ship())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return None

    async def shutdown(self) -> None:
        for task in list(self._tasks):
            task.cancel()
