"""ToolOps (a copy of the JAX package's ``services/toolops_service.py``):
test cases generated from a tool's JSON schema (a baseline, boundary values
per type, missing required fields and type violations), optionally three
more from the engine (``use_llm``, through ``ctx.llm_registry``), and a
runner that sends each case through ``ToolService.invoke_tool``."""

from __future__ import annotations

import json
from typing import Any

from ..db.core import from_json
from .base import AppContext, ValidationFailure

_SAMPLES: dict[str, list[Any]] = {
    "string": ["example", "", "a" * 256, "üñí©ödé", "<script>alert(1)</script>"],
    "integer": [0, 1, -1, 2**31 - 1],
    "number": [0.0, 1.5, -3.25, 1e9],
    "boolean": [True, False],
    "array": [[], ["one"], [1, 2, 3]],
    "object": [{}, {"key": "value"}],
}


def generate_cases(input_schema: dict[str, Any], max_cases: int = 24) -> list[dict[str, Any]]:
    """-> [{name, arguments, expect: 'ok'|'error'}]."""
    properties: dict[str, Any] = input_schema.get("properties", {}) or {}
    required = list(input_schema.get("required", []) or [])
    cases: list[dict[str, Any]] = []

    def baseline() -> dict[str, Any]:
        args = {}
        for key, spec in properties.items():
            kind = spec.get("type", "string")
            if "enum" in spec:
                args[key] = spec["enum"][0]
            else:
                args[key] = spec.get("default", _SAMPLES.get(kind, ["x"])[0])
        return args

    cases.append({"name": "baseline-all-fields", "arguments": baseline(), "expect": "ok"})
    # negative cases first: truncation must never drop them wholesale
    negatives: list[dict[str, Any]] = []
    for key in required:
        args = baseline()
        args.pop(key, None)
        negatives.append({"name": f"missing-required-{key}", "arguments": args,
                          "expect": "error"})
    for key, spec in properties.items():
        if spec.get("type") in ("integer", "number"):
            args = baseline()
            args[key] = "not-a-number"
            negatives.append({"name": f"type-violation-{key}", "arguments": args,
                              "expect": "error"})
    positives: list[dict[str, Any]] = []
    for key, spec in properties.items():
        kind = spec.get("type", "string")
        for i, value in enumerate(_SAMPLES.get(kind, [])[1:]):
            args = baseline()
            args[key] = value
            positives.append({"name": f"boundary-{key}-{i}", "arguments": args, "expect": "ok"})
    negatives = negatives[:max_cases - 1]
    budget = max_cases - 1 - len(negatives)
    return cases + negatives + positives[:max(budget, 0)]


class ToolOpsService:
    def __init__(self, ctx: AppContext, tool_service):
        self.ctx = ctx
        self.tools = tool_service

    async def generate(self, tool_name: str, use_llm: bool = False,
                       max_cases: int = 24) -> list[dict[str, Any]]:
        # the service's lookup: a disabled tool is a 404 up front
        tool_row = await self.tools._lookup(tool_name)
        schema = from_json(tool_row["input_schema"], {})
        cases = generate_cases(schema, max_cases=max_cases)
        if use_llm and self.ctx.llm_registry is not None:
            try:
                response = await self.ctx.llm_registry.chat({
                    "messages": [
                        {"role": "system",
                         "content": "Produce 3 realistic JSON argument objects "
                                    "for this tool schema, one per line."},
                        {"role": "user", "content": json.dumps(schema)}],
                    "max_tokens": 256, "temperature": 0.7})
                for i, line in enumerate(
                        response["choices"][0]["message"]["content"].splitlines()):
                    if len(cases) >= max_cases:
                        break
                    try:
                        arguments = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(arguments, dict):   # object payloads only
                        cases.append({"name": f"llm-{i}", "arguments": arguments,
                                      "expect": "ok"})
            except Exception:
                pass
        return cases

    async def run(self, tool_name: str, cases: list[dict[str, Any]] | None = None,
                  user: str | None = None) -> dict[str, Any]:
        if cases is not None:
            if not isinstance(cases, list) or not all(
                    isinstance(c, dict) and isinstance(c.get("arguments"), dict)
                    for c in cases):
                raise ValidationFailure(
                    "cases must be a list of {name?, arguments: object, expect?}")
        cases = cases or await self.generate(tool_name)
        results = []
        for index, case in enumerate(cases):
            outcome: dict[str, Any] = {"name": case.get("name", f"case-{index}"),
                                       "expect": case.get("expect", "ok")}
            try:
                result = await self.tools.invoke_tool(tool_name, case["arguments"], user=user)
                outcome["status"] = "error" if result.get("isError") else "ok"
            except Exception as exc:
                outcome["status"] = "error"
                outcome["detail"] = f"{type(exc).__name__}"
            outcome["pass"] = outcome["status"] == outcome["expect"]
            results.append(outcome)
        passed = sum(1 for r in results if r["pass"])
        return {"tool": tool_name, "total": len(results), "passed": passed, "results": results}
