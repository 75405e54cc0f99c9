"""Transform plugins (a copy of the JAX package's
``plugins/builtin/transformers.py``): ``header_injector``, ``header_filter``,
``json_repair``, ``markdown_cleaner``, ``html_to_markdown``,
``search_replace``, ``argument_normalizer``, ``privacy_notice_injector`` and
``timezone_translator``."""

from __future__ import annotations

import datetime
import json
import re
import unicodedata
from typing import Any

from ..framework import Plugin

from .filters import _iter_text


class HeaderInjectorPlugin(Plugin):
    """Adds static headers to outbound tool calls. config: {headers: {...}}"""

    async def tool_pre_invoke(self, name, arguments, headers, context):
        extra = self.config.config.get("headers", {})
        if not extra:
            return None
        merged = dict(headers)
        merged.update({str(k): str(v) for k, v in extra.items()})
        return {"headers": merged}


class HeaderFilterPlugin(Plugin):
    """Strips headers matching deny patterns. config: {deny: [regex]}"""

    async def tool_pre_invoke(self, name, arguments, headers, context):
        deny = [re.compile(p, re.I) for p in self.config.config.get("deny", [])]
        if not deny:
            return None
        filtered = {k: v for k, v in headers.items()
                    if not any(p.search(k) for p in deny)}
        return {"headers": filtered}


class JsonRepairPlugin(Plugin):
    """Repairs almost-JSON text results (trailing commas, single quotes,
    unquoted keys) so downstream agents can parse them."""

    async def tool_post_invoke(self, name, result, context):
        for item in _iter_text(result):
            text = item.get("text", "").strip()
            if not text or text[0] not in "{[":
                continue
            try:
                json.loads(text)
                continue
            except json.JSONDecodeError:
                pass
            repaired = _repair_json(text)
            if repaired is not None:
                item["text"] = repaired
        return result


def _outside_strings(text: str, fn) -> str:
    """Apply fn only to the segments of ``text`` outside double-quoted strings."""
    parts = re.split(r'("(?:[^"\\]|\\.)*")', text)
    return "".join(part if i % 2 else fn(part) for i, part in enumerate(parts))


def _repair_json(text: str) -> str | None:
    candidate = text
    candidate = re.sub(r"'([^']*)'\s*:", r'"\1":', candidate)      # single-quoted keys
    candidate = re.sub(r":\s*'([^']*)'", r': "\1"', candidate)     # single-quoted values

    def _fix(segment: str) -> str:
        segment = re.sub(r",\s*([}\]])", r"\1", segment)           # trailing commas
        segment = re.sub(r"([,{]\s*)([A-Za-z_][A-Za-z0-9_]*)\s*:", r'\1"\2":', segment)
        segment = re.sub(r"\bNone\b", "null", segment)             # python literals,
        segment = re.sub(r"\bTrue\b", "true", segment)             # never inside strings
        segment = re.sub(r"\bFalse\b", "false", segment)
        return segment

    candidate = _outside_strings(candidate, _fix)
    try:
        return json.dumps(json.loads(candidate), separators=(",", ":"))
    except json.JSONDecodeError:
        return None


class MarkdownCleanerPlugin(Plugin):
    """Normalizes markdown text output: collapses blank runs, strips
    zero-width chars, normalizes unicode."""

    async def tool_post_invoke(self, name, result, context):
        for item in _iter_text(result):
            text = unicodedata.normalize("NFC", item.get("text", ""))
            text = text.replace("​", "").replace("﻿", "")
            text = re.sub(r"\n{3,}", "\n\n", text)
            item["text"] = text.strip()
        return result


class HtmlToMarkdownPlugin(Plugin):
    """Converts HTML tool/resource output to markdown-ish plain text."""

    async def tool_post_invoke(self, name, result, context):
        for item in _iter_text(result):
            text = item.get("text", "")
            if "<" in text and ">" in text:
                item["text"] = _html_to_md(text)
        return result

    async def resource_post_fetch(self, uri, result, context):
        for entry in result.get("contents", []):
            if entry.get("mimeType", "").startswith("text/html") and "text" in entry:
                entry["text"] = _html_to_md(entry["text"])
                entry["mimeType"] = "text/markdown"
        return result


def _html_to_md(html: str) -> str:
    text = re.sub(r"<\s*script[^>]*>.*?<\s*/\s*script\s*>", "", html, flags=re.S | re.I)
    text = re.sub(r"<\s*style[^>]*>.*?<\s*/\s*style\s*>", "", text, flags=re.S | re.I)
    text = re.sub(r"<\s*h([1-6])[^>]*>", lambda m: "\n" + "#" * int(m.group(1)) + " ", text)
    text = re.sub(r"<\s*/\s*h[1-6]\s*>", "\n", text)
    text = re.sub(r"<\s*(b|strong)\s*>", "**", text)
    text = re.sub(r"<\s*/\s*(b|strong)\s*>", "**", text)
    text = re.sub(r"<\s*(i|em)\s*>", "*", text)
    text = re.sub(r"<\s*/\s*(i|em)\s*>", "*", text)
    text = re.sub(r"<\s*li[^>]*>", "\n- ", text)
    text = re.sub(r"<\s*(br|/p|/div|/tr)[^>]*>", "\n", text)
    text = re.sub(r'<\s*a[^>]*href="([^"]*)"[^>]*>(.*?)<\s*/\s*a\s*>', r"[\2](\1)", text,
                  flags=re.S)
    text = re.sub(r"<[^>]+>", "", text)
    text = text.replace("&amp;", "&").replace("&lt;", "<").replace("&gt;", ">").replace(
        "&quot;", '"').replace("&#39;", "'").replace("&nbsp;", " ")
    return re.sub(r"\n{3,}", "\n\n", text).strip()


class SearchReplacePlugin(Plugin):
    """Literal search/replace on text results. config: {rules: [{search, replace}]}"""

    async def tool_post_invoke(self, name, result, context):
        rules = self.config.config.get("rules", [])
        for item in _iter_text(result):
            text = item.get("text", "")
            for rule in rules:
                text = text.replace(rule["search"], rule.get("replace", ""))
            item["text"] = text
        return result


class ArgumentNormalizerPlugin(Plugin):
    """Normalizes string arguments: strip, case-fold, unicode NFC.

    config: {strip: true, lower: false, keys: [...]}"""

    async def tool_pre_invoke(self, name, arguments, headers, context):
        cfg = self.config.config
        keys = cfg.get("keys") or list(arguments.keys())
        changed = dict(arguments)
        for key in keys:
            value = changed.get(key)
            if not isinstance(value, str):
                continue
            value = unicodedata.normalize("NFC", value)
            if cfg.get("strip", True):
                value = value.strip()
            if cfg.get("lower", False):
                value = value.lower()
            changed[key] = value
        return {"arguments": changed}


class PrivacyNoticeInjectorPlugin(Plugin):
    """Appends a privacy notice to text results. config: {notice: str}"""

    async def tool_post_invoke(self, name, result, context):
        notice = self.config.config.get(
            "notice", "This response may contain third-party data.")
        content = result.get("content")
        if isinstance(content, list):
            content.append({"type": "text", "text": notice})
        return result


class TimezoneTranslatorPlugin(Plugin):
    """Rewrites ISO timestamps in results to a target UTC offset.

    config: {utc_offset_minutes: int}"""

    _ISO = re.compile(r"\b(\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2})(?:\.\d+)?(Z|[+-]\d{2}:\d{2})?")

    async def tool_post_invoke(self, name, result, context):
        offset = int(self.config.config.get("utc_offset_minutes", 0))
        tz = datetime.timezone(datetime.timedelta(minutes=offset))

        def _convert(match: re.Match) -> str:
            try:
                stamp = datetime.datetime.fromisoformat(match.group(0).replace("Z", "+00:00"))
                if stamp.tzinfo is None:
                    stamp = stamp.replace(tzinfo=datetime.timezone.utc)
                return stamp.astimezone(tz).isoformat()
            except ValueError:
                return match.group(0)

        for item in _iter_text(result):
            item["text"] = self._ISO.sub(_convert, item.get("text", ""))
        return result
