"""OPA-style policy-checker external plugin server.

A copy of the JAX package's ``plugins/servers/opa_policy.py``: the OPA
server's role, tool calls checked against declarative policy before
execution. Policy is JSON via the
``MCPFORGE_OPA_POLICY`` env var or ``--policy-file``:

    {
      "deny_tools": ["rm_rf", "transfer_funds"],
      "deny_patterns": ["(?i)drop\\s+table"],   # regex over arguments JSON
      "allow_users": [],                        # non-empty = allowlist
      "max_argument_bytes": 65536
    }

Run: ``python -m mcp_context_forge_tpu_torch.plugins.servers.opa_policy``
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Any

from .sdk import PluginServer, ok, violation


def load_policy(argv: list[str] | None = None) -> dict[str, Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--policy-file", default=None)
    args = parser.parse_args(argv)
    if args.policy_file:
        with open(args.policy_file) as handle:
            return json.load(handle)
    raw = os.environ.get("MCPFORGE_OPA_POLICY", "{}")
    return json.loads(raw)


def build_server(policy: dict[str, Any]) -> PluginServer:
    server = PluginServer("opa-policy")
    deny_tools = set(policy.get("deny_tools", []))
    deny_patterns = [re.compile(p) for p in policy.get("deny_patterns", [])]
    allow_users = set(policy.get("allow_users", []))
    max_bytes = int(policy.get("max_argument_bytes", 0))

    @server.hook("tool_pre_invoke")
    def tool_pre_invoke(name: str = "", arguments: dict | None = None,
                        headers: dict | None = None,
                        context: dict | None = None) -> dict[str, Any]:
        arguments = arguments or {}
        context = context or {}
        if name in deny_tools:
            return violation(f"tool {name!r} denied by policy",
                             code="OPA_TOOL_DENIED")
        if allow_users and context.get("user") not in allow_users:
            return violation(f"user {context.get('user')!r} not in allowlist",
                             code="OPA_USER_DENIED")
        blob = json.dumps(arguments)
        if max_bytes and len(blob.encode()) > max_bytes:
            return violation("arguments exceed policy size limit",
                             code="OPA_SIZE_LIMIT")
        for pattern in deny_patterns:
            if pattern.search(blob):
                return violation(
                    f"arguments match denied pattern {pattern.pattern!r}",
                    code="OPA_PATTERN_DENIED")
        return ok()

    return server


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    build_server(load_policy(sys.argv[1:])).run()
