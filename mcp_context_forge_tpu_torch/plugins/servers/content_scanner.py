"""ClamAV-style content-scanner external plugin server.

A copy of the JAX package's ``plugins/servers/content_scanner.py``: the
ClamAV server's role, resource and tool-result content scanned out of
process before it reaches clients. It needs no clamd: scanning is
signature-based, in process: the
EICAR test signature (industry-standard scanner check), configurable
literal / hex signatures, a size ceiling, and a filename-extension
denylist for resource URIs. Config JSON via ``MCPFORGE_SCANNER_CONFIG``
or ``--config-file``:

    {
      "signatures": ["literal-malware-marker"],
      "hex_signatures": ["4d5a9000"],
      "max_content_bytes": 10485760,
      "deny_extensions": [".exe", ".dll", ".scr"]
    }

Run: ``python -m mcp_context_forge_tpu_torch.plugins.servers.content_scanner``
"""

from __future__ import annotations

import argparse
import binascii
import json
import os
import sys
from typing import Any

from .sdk import PluginServer, ok, violation

# the standard antivirus functional-test string (EICAR), assembled so this
# source file itself never contains the contiguous signature
EICAR = ("X5O!P%@AP[4\\PZX54(P^)7CC)7}$" + "EICAR-STANDARD-ANTIVIRUS-TEST-FILE" + "!$H+H*")


def load_config(argv: list[str] | None = None) -> dict[str, Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", default=None)
    args = parser.parse_args(argv)
    if args.config_file:
        with open(args.config_file) as handle:
            return json.load(handle)
    return json.loads(os.environ.get("MCPFORGE_SCANNER_CONFIG", "{}"))


class ScanBudgetExceeded(Exception):
    """Traversal node budget exhausted with content left unscanned."""


def _content_blobs(payload: Any) -> list[bytes]:
    """Every text/blob fragment in an MCP result/content payload.

    String fragments that themselves parse as JSON are additionally
    decoded and re-walked (bounded: each decode strictly shrinks the
    text), so a signature cannot hide behind JSON string-escaping —
    e.g. EICAR's backslash becoming ``\\\\`` inside an embedded
    document. Raises ScanBudgetExceeded (callers fail CLOSED) if the
    node budget runs out before the walk completes — padding a payload
    past the budget must not smuggle unscanned content through."""
    blobs: list[bytes] = []
    stack = [payload]
    seen = 0
    while stack:
        if seen >= 10_000:
            raise ScanBudgetExceeded(f"{seen} nodes walked, more remain")
        seen += 1
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, list):
            stack.extend(node)
        elif isinstance(node, str):
            blobs.append(node.encode("utf-8", "surrogateescape"))
            stripped = node.lstrip()
            if stripped[:1] in ("{", "[", '"'):
                try:
                    stack.append(json.loads(node))
                except (json.JSONDecodeError, RecursionError):
                    pass
    return blobs


def build_server(config: dict[str, Any]) -> PluginServer:
    server = PluginServer("content-scanner")
    signatures = [s.encode() for s in config.get("signatures", [])]
    signatures.append(EICAR.encode())
    hex_signatures = [binascii.unhexlify(h)
                      for h in config.get("hex_signatures", [])]
    max_bytes = int(config.get("max_content_bytes", 10 * 1024 * 1024))
    deny_ext = tuple(e.lower() for e in config.get(
        "deny_extensions", [".exe", ".dll", ".scr", ".com", ".bat"]))

    all_signatures = signatures + hex_signatures

    def scan(payload: Any, where: str) -> dict[str, Any]:
        try:
            blobs = _content_blobs(payload)
        except ScanBudgetExceeded:
            return violation(f"{where}: payload too complex to scan",
                             code="SCANNER_BUDGET")
        for blob in blobs:
            if max_bytes and len(blob) > max_bytes:
                return violation(f"{where}: content exceeds scan ceiling",
                                 code="SCANNER_TOO_LARGE")
            for sig in all_signatures:
                if sig in blob:
                    return violation(
                        f"{where}: content matches malware signature",
                        code="SCANNER_SIGNATURE",
                        details={"signature_bytes": len(sig)})
        return ok()

    @server.hook("resource_post_fetch")
    def resource_post_fetch(uri: str = "", result: dict | None = None,
                            context: dict | None = None) -> dict[str, Any]:
        lowered = uri.lower()
        if lowered.endswith(deny_ext):
            return violation(f"resource extension denied: {uri}",
                             code="SCANNER_EXTENSION")
        return scan(result or {}, f"resource {uri}")

    @server.hook("tool_post_invoke")
    def tool_post_invoke(name: str = "", result: dict | None = None,
                         context: dict | None = None) -> dict[str, Any]:
        return scan(result or {}, f"tool {name} result")

    return server


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    build_server(load_config(sys.argv[1:])).run()
