"""OpenAI ``tools``/``tool_calls`` function-calling wire support (a copy of
the JAX package's module): tool definitions render into the system prompt,
and generated text parses back into OpenAI ``tool_calls`` entries.
"""

from __future__ import annotations

import json
from typing import Any

from ..utils import new_id

TOOLS_PROMPT = """You have access to the following functions:

{definitions}

To call a function, respond with ONLY a JSON object:
{{"name": "<function-name>", "parameters": {{...}}}}
To call several functions at once, respond with a JSON array of such objects.
When no function is needed, answer in plain text (never JSON).
"""


def render_tools_block(tools: list[dict[str, Any]]) -> str:
    """System-prompt block for an OpenAI ``tools`` array."""
    definitions = []
    for tool in tools:
        fn = tool.get("function", tool)
        definitions.append(json.dumps({
            "name": fn.get("name", ""),
            "description": fn.get("description", ""),
            "parameters": fn.get("parameters") or {},
        }, separators=(",", ":")))
    return TOOLS_PROMPT.format(definitions="\n".join(definitions))


def _normalize_call(obj: Any) -> dict[str, Any] | None:
    if not isinstance(obj, dict):
        return None
    name = obj.get("name") or obj.get("tool")
    if not isinstance(name, str) or not name:
        return None
    args = obj.get("parameters")
    if args is None:
        args = obj.get("arguments")
    if args is None:
        args = {}
    if not isinstance(args, dict):
        return None
    return {
        "id": f"call_{new_id()[:16]}",
        "type": "function",
        "function": {"name": name,
                     "arguments": json.dumps(args, separators=(",", ":"))},
    }


def parse_tool_calls(text: str) -> list[dict[str, Any]] | None:
    """Tool calls emitted in ``text``, or None when it is a plain answer."""
    stripped = text.strip()
    candidates = [stripped]
    # NOTE: a leading <|python_tag|> marker needs no special-casing — the
    # outermost-JSON-span fallback below starts at the first brace/bracket,
    # which skips any prefix marker (and any prose) identically.
    # models wrap JSON in prose/code fences; try the outermost JSON span too
    for open_ch, close_ch in ("{}", "[]"):
        start = stripped.find(open_ch)
        end = stripped.rfind(close_ch)
        if 0 <= start < end:
            candidates.append(stripped[start:end + 1])
    for candidate in candidates:
        try:
            obj = json.loads(candidate)
        except json.JSONDecodeError:
            continue
        items = obj if isinstance(obj, list) else [obj]
        calls = [_normalize_call(item) for item in items]
        if calls and all(c is not None for c in calls):
            return calls  # type: ignore[return-value]
    return None


def tool_call_message_text(tool_calls: list[dict[str, Any]]) -> str:
    """Render an assistant tool_calls message back to prompt text (the
    model must see its own prior calls in-context on the next turn)."""
    calls = []
    for call in tool_calls:
        fn = call.get("function", {})
        try:
            args = json.loads(fn.get("arguments") or "{}")
        except json.JSONDecodeError:
            args = {}
        calls.append({"name": fn.get("name", ""), "parameters": args})
    payload = calls[0] if len(calls) == 1 else calls
    return json.dumps(payload, separators=(",", ":"))
