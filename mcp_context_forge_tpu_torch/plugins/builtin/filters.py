"""Guard and filter plugins (a copy of the JAX package's
``plugins/builtin/filters.py``): ``deny_filter``, ``regex_filter``,
``output_length_guard``, ``file_type_allowlist``, ``resource_filter``,
``schema_guard``, ``sql_sanitizer`` and ``secrets_filter``."""

from __future__ import annotations

import json
import re
from typing import Any

from ..framework import Plugin, PluginContext, PluginViolation


def _iter_text(result: dict[str, Any]):
    for item in result.get("content", []):
        if isinstance(item, dict) and item.get("type") == "text":
            yield item


class DenyFilterPlugin(Plugin):
    """Blocks tool calls whose arguments contain denylisted words.

    config: {words: [..]}"""

    async def tool_pre_invoke(self, name, arguments, headers, context):
        words = [w.lower() for w in self.config.config.get("words", [])]
        blob = json.dumps(arguments).lower()
        for word in words:
            if word in blob:
                raise PluginViolation(f"Denied word in arguments: {word!r}",
                                      code="DENY_WORD")
        return None


class RegexFilterPlugin(Plugin):
    """Redacts/replaces regex matches in tool results.

    config: {rules: [{pattern, replacement}]}"""

    async def tool_post_invoke(self, name, result, context):
        rules = self.config.config.get("rules", [])
        if not rules:
            return None
        for item in _iter_text(result):
            text = item.get("text", "")
            for rule in rules:
                text = re.sub(rule["pattern"], rule.get("replacement", "[redacted]"), text)
            item["text"] = text
        return result


class OutputLengthGuardPlugin(Plugin):
    """Truncates or blocks oversized tool output.

    config: {max_chars: int, strategy: "truncate"|"block"}"""

    async def tool_post_invoke(self, name, result, context):
        max_chars = int(self.config.config.get("max_chars", 100_000))
        strategy = self.config.config.get("strategy", "truncate")
        for item in _iter_text(result):
            text = item.get("text", "")
            if len(text) > max_chars:
                if strategy == "block":
                    raise PluginViolation(
                        f"Output exceeds {max_chars} chars", code="OUTPUT_TOO_LONG")
                item["text"] = text[:max_chars] + "…[truncated]"
        return result


class FileTypeAllowlistPlugin(Plugin):
    """Allows resource fetches only for allowlisted extensions/mime types.

    config: {extensions: [".md", ...], mime_types: ["text/plain", ...]}"""

    async def resource_pre_fetch(self, uri, context):
        extensions = self.config.config.get("extensions", [])
        if extensions and not any(uri.lower().endswith(e.lower()) for e in extensions):
            raise PluginViolation(f"Resource type not allowed: {uri}", code="FILETYPE_DENIED")
        return None

    async def resource_post_fetch(self, uri, result, context):
        mime_types = self.config.config.get("mime_types", [])
        if not mime_types:
            return None
        for entry in result.get("contents", []):
            mime = entry.get("mimeType", "")
            if mime and mime not in mime_types:
                raise PluginViolation(f"MIME type not allowed: {mime}", code="MIME_DENIED")
        return None


class ResourceFilterPlugin(Plugin):
    """Blocks resource URIs matching deny patterns; applies size limits.

    config: {deny_patterns: [regex], max_size: int}"""

    async def resource_pre_fetch(self, uri, context):
        for pattern in self.config.config.get("deny_patterns", []):
            if re.search(pattern, uri):
                raise PluginViolation(f"Resource URI denied: {uri}", code="URI_DENIED")
        return None

    async def resource_post_fetch(self, uri, result, context):
        max_size = int(self.config.config.get("max_size", 0))
        if not max_size:
            return None
        for entry in result.get("contents", []):
            body = entry.get("text") or entry.get("blob") or ""
            if len(body) > max_size:
                raise PluginViolation(f"Resource exceeds {max_size} bytes",
                                      code="RESOURCE_TOO_LARGE")
        return None


class SchemaGuardPlugin(Plugin):
    """Validates tool arguments against required keys / type map before invoke.

    config: {required: [key], types: {key: "str"|"int"|"float"|"bool"|"list"|"dict"}}"""

    _TYPES = {"str": str, "int": int, "float": (int, float), "bool": bool,
              "list": list, "dict": dict}

    async def tool_pre_invoke(self, name, arguments, headers, context):
        required = self.config.config.get("required", [])
        missing = [k for k in required if k not in arguments]
        if missing:
            raise PluginViolation(f"Missing required arguments: {missing}",
                                  code="SCHEMA_VIOLATION")
        for key, type_name in self.config.config.get("types", {}).items():
            expected = self._TYPES.get(type_name)
            if expected and key in arguments and not isinstance(arguments[key], expected):
                raise PluginViolation(
                    f"Argument {key!r} must be {type_name}", code="SCHEMA_VIOLATION")
        return None


class SqlSanitizerPlugin(Plugin):
    """Blocks obvious SQL-injection patterns in string arguments.

    config: {keys: [...] (empty = all string args)}"""

    _PATTERNS = [
        re.compile(r";\s*(drop|delete|truncate|alter|update|insert)\s", re.I),
        re.compile(r"\bunion\s+select\b", re.I),
        re.compile(r"--\s*$"),
        re.compile(r"\bor\s+1\s*=\s*1\b", re.I),
    ]

    async def tool_pre_invoke(self, name, arguments, headers, context):
        keys = self.config.config.get("keys") or list(arguments.keys())
        for key in keys:
            value = arguments.get(key)
            if isinstance(value, str):
                for pattern in self._PATTERNS:
                    if pattern.search(value):
                        raise PluginViolation(
                            f"Possible SQL injection in {key!r}", code="SQLI_BLOCKED")
        return None


class SecretsFilterPlugin(Plugin):
    """Masks secret-looking tokens in tool output: ``sk-`` keys, bearer
    tokens, ``key=value`` pairs of credential names and JWTs."""

    _PATTERNS = [
        (re.compile(r"(sk-[A-Za-z0-9]{16,})"), "sk-***"),
        (re.compile(r"(?i)(bearer\s+)[a-z0-9._\-]{12,}"), r"\1***"),
        (re.compile(r"(?i)((?:api[_-]?key|password|secret|token)\"?\s*[:=]\s*\"?)[^\s\",}]+"),
         r"\1***"),
        (re.compile(r"(eyJ[A-Za-z0-9_\-]{10,}\.[A-Za-z0-9_\-]{10,}\.[A-Za-z0-9_\-]{10,})"),
         "jwt-***"),
    ]

    async def tool_post_invoke(self, name, result, context):
        for item in _iter_text(result):
            text = item.get("text", "")
            for pattern, repl in self._PATTERNS:
                text = pattern.sub(repl, text)
            item["text"] = text
        return result
