"""Content and format plugins (a copy of the JAX package's
``plugins/builtin/content_plugins.py``): ``citation_validator``,
``safe_html_sanitizer``, ``code_formatter``, ``license_header_injector``,
``ai_artifacts_normalizer``, ``toon_encoder``, ``robots_license_guard`` and
``code_safety_linter``."""

from __future__ import annotations

import json
import re
from typing import Any

from ..framework import Plugin, PluginViolation
from .filters import _iter_text


class CitationValidatorPlugin(Plugin):
    """Validates that URLs cited in output resolve against an allowlist of
    schemes/hosts (reference citation_validator).

    config: {allowed_schemes: ["https"], allowed_hosts: [], max_citations: 50}"""

    _URL = re.compile(r"https?://[^\s)\]}>\"']+")

    async def tool_post_invoke(self, name, result, context):
        schemes = self.config.config.get("allowed_schemes", ["https", "http"])
        hosts = self.config.config.get("allowed_hosts", [])
        max_citations = int(self.config.config.get("max_citations", 50))
        for item in _iter_text(result):
            urls = self._URL.findall(item.get("text", ""))
            if len(urls) > max_citations:
                raise PluginViolation(f"Too many citations ({len(urls)})",
                                      code="CITATION_LIMIT")
            for url in urls:
                scheme = url.split("://", 1)[0]
                if scheme not in schemes:
                    raise PluginViolation(f"Citation scheme {scheme!r} not allowed",
                                          code="CITATION_SCHEME")
                if hosts:
                    from urllib.parse import urlsplit
                    host = urlsplit(url).hostname or ""  # userinfo-safe
                    if not any(host == h or host.endswith("." + h) for h in hosts):
                        raise PluginViolation(f"Citation host {host!r} not allowed",
                                              code="CITATION_HOST")
        return None


class SafeHtmlSanitizerPlugin(Plugin):
    """Strips script/style/event-handler content from HTML-ish output."""

    _PATTERNS = [
        (re.compile(r"<\s*script[^>]*>.*?<\s*/\s*script\s*>", re.S | re.I), ""),
        (re.compile(r"<\s*/?\s*script[^>]*>", re.I), ""),  # orphan/spliced tags
        (re.compile(r"<\s*style[^>]*>.*?<\s*/\s*style\s*>", re.S | re.I), ""),
        (re.compile(r"<\s*(iframe|object|embed|form)[^>]*>", re.I), ""),
        (re.compile(r'\son\w+\s*=\s*"[^"]*"', re.I), ""),
        (re.compile(r"\son\w+\s*=\s*'[^']*'", re.I), ""),
        (re.compile(r"\son\w+\s*=\s*[^\s>\"']+", re.I), ""),  # unquoted handlers
        (re.compile(r"javascript\s*:", re.I), "blocked:"),
    ]

    @classmethod
    def _sanitize(cls, text: str) -> str:
        # iterate to a fixpoint: splicing tricks (<scr<script></script>ipt>)
        # re-form dangerous constructs after one pass
        for _ in range(5):
            before = text
            for pattern, repl in cls._PATTERNS:
                text = pattern.sub(repl, text)
            if text == before:
                return text
        # still mutating after the cap: adversarially nested markup — fail
        # closed by stripping every remaining tag rather than shipping it
        return re.sub(r"<[^>]*>", "", text)

    async def tool_post_invoke(self, name, result, context):
        for item in _iter_text(result):
            text = item.get("text", "")
            if "<" in text:
                item["text"] = self._sanitize(text)
        return result

    async def resource_post_fetch(self, uri, result, context):
        for entry in result.get("contents", []):
            text = entry.get("text")
            if text and "<" in text:
                entry["text"] = self._sanitize(text)
        return result


class CodeFormatterPlugin(Plugin):
    """Normalizes code blocks: strips trailing whitespace, normalizes
    newlines, optional tab→space (reference code_formatter).

    config: {tab_width: 4, ensure_newline: true}"""

    async def tool_post_invoke(self, name, result, context):
        tab_width = int(self.config.config.get("tab_width", 4))
        for item in _iter_text(result):
            text = item.get("text", "").replace("\r\n", "\n").replace("\r", "\n")
            if tab_width:
                text = text.replace("\t", " " * tab_width)
            text = "\n".join(line.rstrip() for line in text.split("\n"))
            if self.config.config.get("ensure_newline", True) and text \
                    and not text.endswith("\n"):
                text += "\n"
            item["text"] = text
        return result


class LicenseHeaderInjectorPlugin(Plugin):
    """Prepends a license header to code-looking output.

    config: {header: "...", comment_prefix: "# "}"""

    async def tool_post_invoke(self, name, result, context):
        header = self.config.config.get("header", "")
        if not header:
            return None
        prefix = self.config.config.get("comment_prefix", "# ")
        rendered = "\n".join(prefix + line for line in header.splitlines()) + "\n"
        for item in _iter_text(result):
            if not item.get("text", "").startswith(rendered):
                item["text"] = rendered + item.get("text", "")
        return result


class AiArtifactsNormalizerPlugin(Plugin):
    """Removes LLM-output artifacts: chat-template remnants, dangling
    code-fence markers, 'As an AI' boilerplate (reference
    ai_artifacts_normalizer)."""

    _ARTIFACTS = [
        re.compile(r"<\|[a-z_]+\|>"),
        re.compile(r"^(As an AI(?: language model)?,?\s*)", re.I | re.M),
        re.compile(r"^```[a-z]*\n?$", re.M),
    ]

    async def tool_post_invoke(self, name, result, context):
        for item in _iter_text(result):
            text = item.get("text", "")
            for pattern in self._ARTIFACTS[:2]:
                text = pattern.sub("", text)
            if text.count("```") % 2 == 1:
                # remove only the LAST dangling fence line — complete code
                # blocks keep their delimiters
                lines = text.split("\n")
                for i in range(len(lines) - 1, -1, -1):
                    if self._ARTIFACTS[2].fullmatch(lines[i] + "\n") or \
                            re.fullmatch(r"```[a-z]*", lines[i]):
                        del lines[i]
                        break
                text = "\n".join(lines)
            item["text"] = text.strip()
        return result


class ToonEncoderPlugin(Plugin):
    """Token-efficient tool-catalog encoding (reference toon_encoder /
    README 'TOON compression'): rewrites a JSON array-of-objects result into
    a compact header+rows table, cutting LLM tokens for large catalogs.

    config: {min_items: 5}"""

    async def tool_post_invoke(self, name, result, context):
        min_items = int(self.config.config.get("min_items", 5))
        for item in _iter_text(result):
            text = item.get("text", "").strip()
            if not text.startswith("["):
                continue
            try:
                data = json.loads(text)
            except json.JSONDecodeError:
                continue
            if (isinstance(data, list) and len(data) >= min_items
                    and all(isinstance(d, dict) for d in data)):
                keys: list[str] = []
                for d in data:
                    for k in d:
                        if k not in keys:
                            keys.append(k)
                def cell(value) -> str:
                    if isinstance(value, str):
                        # strings go raw unless they'd corrupt the table
                        if "\t" in value or "\n" in value:
                            return json.dumps(value, ensure_ascii=False)
                        return value
                    return json.dumps(value, separators=(",", ":"),
                                      ensure_ascii=False)

                rows = ["\t".join(keys)]
                for d in data:
                    rows.append("\t".join(cell(d.get(k, "")) for k in keys))
                item["text"] = "#toon/v1\n" + "\n".join(rows)
        return result


class CodeSafetyLinterPlugin(Plugin):
    """Flags dangerous patterns in code-looking output (reference
    code_safety_linter): destructive shell, eval/exec, curl|sh.

    config: {action: "block"|"annotate"}"""

    _DANGEROUS = [
        re.compile(r"\brm\s+-rf\s+[/~]"),
        re.compile(r"\b(eval|exec)\s*\("),
        re.compile(r"curl[^|\n]*\|\s*(ba)?sh"),
        re.compile(r":\(\)\s*\{\s*:\|:&\s*\};:"),  # fork bomb
        re.compile(r"\bdd\s+if=.*of=/dev/(sd|nvme)"),
    ]

    async def tool_post_invoke(self, name, result, context):
        findings = []
        for item in _iter_text(result):
            for pattern in self._DANGEROUS:
                if pattern.search(item.get("text", "")):
                    findings.append(pattern.pattern)
        if not findings:
            return None
        if self.config.config.get("action", "block") == "block":
            raise PluginViolation(f"Dangerous code patterns: {findings[:3]}",
                                  code="CODE_SAFETY")
        result.setdefault("annotations", {})["code_safety"] = findings
        return result


class RobotsLicenseGuardPlugin(Plugin):
    """Blocks resource fetches whose content declares noai/robots
    restrictions (reference robots_license_guard)."""

    _MARKERS = ("noai", "no-ai", "DisallowAITraining", "X-Robots-Tag: noai")

    async def resource_post_fetch(self, uri, result, context):
        for entry in result.get("contents", []):
            text = (entry.get("text") or "")[:4096]
            lowered = text.lower()
            if any(m.lower() in lowered for m in self._MARKERS):
                raise PluginViolation(
                    f"Resource {uri!r} declares an AI-usage restriction",
                    code="ROBOTS_LICENSE")
        return None
