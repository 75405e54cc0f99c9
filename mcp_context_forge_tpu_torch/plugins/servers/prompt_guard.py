"""LLMGuard-style prompt-safety external plugin server.

A copy of the JAX package's ``plugins/servers/prompt_guard.py``: the
LLMGuard server's role, prompts and tool arguments passed through an
out-of-process guard before they reach a model.
The upstream wraps the llm-guard library; this server re-implements its
high-signal scanners natively: prompt-injection phrasing, secret patterns
(cloud keys, PEM blocks, bearer tokens), and an input length ceiling —
with optional redaction instead of blocking. Config JSON via
``MCPFORGE_PROMPT_GUARD_CONFIG`` or ``--config-file``:

    {
      "mode": "block" | "redact",      # secrets handling (default block)
      "max_prompt_chars": 32768,
      "injection_patterns": ["(?i)extra custom pattern"],
      "check_injection": true,
      "check_secrets": true
    }

Run: ``python -m mcp_context_forge_tpu_torch.plugins.servers.prompt_guard``
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Any

from .sdk import PluginServer, modified, ok, violation

INJECTION_PATTERNS = [
    r"(?i)ignore (all )?(previous|prior|above) (instructions|directions)",
    r"(?i)disregard (your|the) (system prompt|instructions)",
    r"(?i)you are now (DAN|in developer mode)",
    r"(?i)reveal (your|the) (system prompt|hidden instructions)",
    r"(?i)pretend (you have no|there are no) (restrictions|rules)",
    r"(?i)\bdo anything now\b",
]

SECRET_PATTERNS = {
    "aws_access_key": r"\bAKIA[0-9A-Z]{16}\b",
    "private_key_block": r"-----BEGIN (RSA |EC |OPENSSH )?PRIVATE KEY-----",
    "bearer_token": r"(?i)\bbearer\s+[a-z0-9_\-\.=]{24,}",
    "gcp_api_key": r"\bAIza[0-9A-Za-z_\-]{35}\b",
    "slack_token": r"\bxox[baprs]-[0-9A-Za-z\-]{10,}\b",
    "jwt": r"\beyJ[A-Za-z0-9_\-]{8,}\.[A-Za-z0-9_\-]{8,}\.[A-Za-z0-9_\-]{8,}\b",
}


def load_config(argv: list[str] | None = None) -> dict[str, Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", default=None)
    args = parser.parse_args(argv)
    if args.config_file:
        with open(args.config_file) as handle:
            return json.load(handle)
    return json.loads(os.environ.get("MCPFORGE_PROMPT_GUARD_CONFIG", "{}"))


def _walk_strings(payload: Any):
    """Yield (container, key, value) for every string in the payload."""
    stack = [payload]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            for key, value in node.items():
                if isinstance(value, str):
                    yield node, key, value
                else:
                    stack.append(value)
        elif isinstance(node, list):
            for i, value in enumerate(node):
                if isinstance(value, str):
                    yield node, i, value
                else:
                    stack.append(value)


def build_server(config: dict[str, Any]) -> PluginServer:
    server = PluginServer("prompt-guard")
    mode = config.get("mode", "block")
    max_chars = int(config.get("max_prompt_chars", 32768))
    injection = [re.compile(p) for p in INJECTION_PATTERNS]
    injection += [re.compile(p) for p in config.get("injection_patterns", [])]
    secrets = {name: re.compile(p) for name, p in SECRET_PATTERNS.items()}
    check_injection = config.get("check_injection", True)
    check_secrets = config.get("check_secrets", True)

    def guard(arguments: dict, field: str) -> dict[str, Any]:
        redacted = False
        for container, key, value in _walk_strings(arguments):
            if max_chars and len(value) > max_chars:
                return violation("input exceeds prompt length ceiling",
                                 code="GUARD_TOO_LONG")
            if check_injection:
                for pattern in injection:
                    if pattern.search(value):
                        return violation(
                            "prompt-injection phrasing detected",
                            code="GUARD_INJECTION",
                            details={"pattern": pattern.pattern})
            if check_secrets:
                for name, pattern in secrets.items():
                    if pattern.search(value):
                        if mode == "redact":
                            container[key] = pattern.sub(
                                f"[redacted:{name}]", container[key]
                                if isinstance(container[key], str) else value)
                            redacted = True
                        else:
                            return violation(
                                f"secret material detected ({name})",
                                code="GUARD_SECRET")
        if redacted:
            return modified(**{field: arguments})
        return ok()

    @server.hook("prompt_pre_fetch")
    def prompt_pre_fetch(name: str = "", arguments: dict | None = None,
                         context: dict | None = None) -> dict[str, Any]:
        return guard(arguments or {}, "arguments")

    @server.hook("tool_pre_invoke")
    def tool_pre_invoke(name: str = "", arguments: dict | None = None,
                        headers: dict | None = None,
                        context: dict | None = None) -> dict[str, Any]:
        return guard(arguments or {}, "arguments")

    return server


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    build_server(load_config(sys.argv[1:])).run()
