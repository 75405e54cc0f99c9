"""Argument and result validation plugins (a copy of the JAX package's
``plugins/builtin/validation_plugins.py``).

- ``SparcStaticValidatorPlugin``: static pre-invoke validation of tool
  arguments against the tool's own registered ``input_schema`` (required
  parameters, type mismatches with optional auto-correction, unknown
  parameters, enum membership), read from the gateway's database with the
  tool service's name resolution, cached per tool name and flushed on
  ``tools.changed``.
- ``AltkJsonProcessorPlugin``: post-invoke extraction from long JSON tool
  results by deterministic dot-paths (``utils/paths.py``), with an optional
  mode that asks the engine for the paths.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any

from ...utils.paths import extract_path as _extract_path
from ..framework import Plugin, PluginViolation

logger = logging.getLogger(__name__)

_JSON_TYPES: dict[str, tuple] = {
    "string": (str,),
    "integer": (int,),
    "number": (int, float),
    "boolean": (bool,),
    "array": (list,),
    "object": (dict,),
    "null": (type(None),),
}


def _coerce(value: Any, expected: str) -> tuple[Any, bool]:
    """Best-effort type auto-correction; returns (value, changed)."""
    try:
        if expected == "integer" and isinstance(value, str):
            return int(value), True
        if expected == "number" and isinstance(value, str):
            return float(value), True
        if expected == "boolean" and isinstance(value, str):
            lowered = value.strip().lower()
            if lowered in ("true", "1", "yes"):
                return True, True
            if lowered in ("false", "0", "no"):
                return False, True
        if expected == "string" and isinstance(value, (int, float, bool)):
            return str(value), True
        if expected in ("array", "object") and isinstance(value, str):
            parsed = json.loads(value)
            if isinstance(parsed, list if expected == "array" else dict):
                return parsed, True
    except (ValueError, json.JSONDecodeError):
        pass
    return value, False


class SparcStaticValidatorPlugin(Plugin):
    """Pre-invoke static checks against the registered tool input_schema.

    config: {auto_correct: true, block_unknown_params: false,
             schema_cache_ttl: 30}"""

    def __init__(self, config, ctx=None):
        super().__init__(config, ctx)
        self._schema_cache: dict[str, tuple[dict | None, float]] = {}
        self._unsub = None

    async def initialize(self) -> None:
        bus = getattr(self.ctx, "bus", None) if self.ctx else None
        if bus is not None:
            # same invalidation signal ToolService's lookup cache uses:
            # a schema update must not be enforced stale for the TTL
            async def _on_change(topic, message):
                self._schema_cache.clear()

            self._unsub = bus.subscribe("tools.changed", _on_change)

    async def shutdown(self) -> None:
        if self._unsub is not None:
            self._unsub()
            self._unsub = None

    _CACHE_MAX = 2048  # names are client-controlled: bound the dict

    async def _schema_for(self, tool_name: str) -> dict[str, Any] | None:
        ttl = float(self.config.config.get("schema_cache_ttl", 30.0))
        now = time.monotonic()
        cached = self._schema_cache.get(tool_name)
        if cached and now - cached[1] < ttl:
            return cached[0]
        schema = None
        if self.ctx is not None:
            # same name resolution as ToolService._lookup: either name form
            # reaches the tool, so either must reach its schema
            row = await self.ctx.db.fetchone(
                "SELECT input_schema FROM tools WHERE"
                " (custom_name=? OR original_name=?) AND enabled=1",
                (tool_name, tool_name))
            if row and row["input_schema"]:
                try:
                    schema = json.loads(row["input_schema"])
                except json.JSONDecodeError:
                    schema = None
        if len(self._schema_cache) >= self._CACHE_MAX:
            self._schema_cache = {k: v for k, v in self._schema_cache.items()
                                  if now - v[1] < ttl}
            if len(self._schema_cache) >= self._CACHE_MAX:
                self._schema_cache.clear()  # scan flood: start over
        self._schema_cache[tool_name] = (schema, now)
        return schema

    async def tool_pre_invoke(self, name, arguments, headers, context):
        schema = await self._schema_for(name)
        if not schema or schema.get("type") != "object":
            return None
        properties: dict[str, Any] = schema.get("properties", {}) or {}
        auto_correct = bool(self.config.config.get("auto_correct", True))
        problems: list[str] = []

        missing = [key for key in schema.get("required", [])
                   if key not in arguments]
        if missing:
            problems.append(f"missing required parameters: {missing}")

        strict_unknown = (schema.get("additionalProperties") is False
                          or self.config.config.get("block_unknown_params"))
        if strict_unknown:
            # an empty properties map with additionalProperties:false means
            # NO argument is allowed — don't skip enforcement then
            unknown = [key for key in arguments if key not in properties]
            if unknown:
                problems.append(f"unknown parameters: {unknown}")

        corrected = dict(arguments)
        changed = False
        for key, spec in properties.items():
            if key not in corrected or not isinstance(spec, dict):
                continue
            value = corrected[key]
            expected = spec.get("type")
            if isinstance(expected, str) and expected in _JSON_TYPES:
                # bool is an int subclass: exclude it from integer/number
                ok = isinstance(value, _JSON_TYPES[expected]) and not (
                    isinstance(value, bool) and expected in ("integer", "number"))
                if not ok and auto_correct:
                    value, did = _coerce(value, expected)
                    if did:
                        corrected[key] = value
                        changed = True
                        ok = True
                if not ok:
                    problems.append(
                        f"parameter {key!r} must be {expected},"
                        f" got {type(value).__name__}")
            enum = spec.get("enum")
            if enum and corrected.get(key) not in enum:
                problems.append(f"parameter {key!r} must be one of {enum}")

        if problems:
            raise PluginViolation("; ".join(problems),
                                  code="SPARC_STATIC_VALIDATION",
                                  details={"tool": name})
        if changed:
            return {"arguments": corrected}
        return None


class AltkJsonProcessorPlugin(Plugin):
    """Shrinks long JSON tool results to the data the caller asked for.

    config: {threshold_chars: 4000, paths: ["items[0].name", ...],
             query: "natural language ask (used with the engine)",
             use_engine: true}"""

    async def tool_post_invoke(self, name, result, context):
        threshold = int(self.config.config.get("threshold_chars", 4000))
        content = result.get("content") or []
        text = "".join(c.get("text", "") for c in content
                       if c.get("type") == "text")
        if len(text) < threshold or result.get("isError"):
            return None
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            return None  # not JSON: out of scope

        paths = list(self.config.config.get("paths", []))
        if not paths and self.config.config.get("query"):
            paths = await self._paths_from_engine(text)
        if not paths:
            return None
        extracted = {path: _extract_path(data, path) for path in paths}
        if all(v is None for v in extracted.values()):
            # no configured path resolves (schema drift): keep the original
            # result rather than destroying it
            logger.warning("json_processor: no path resolved for %s; passing"
                           " result through unchanged", list(extracted))
            return None
        # replace only the text blocks: non-text content (images, audio)
        # and sibling result keys (structuredContent, _meta) pass through
        new_content = [c for c in content if c.get("type") != "text"]
        new_content.append({"type": "text",
                            "text": json.dumps(extracted, default=str)})
        return {**result, "content": new_content, "_json_processed": True}

    async def _paths_from_engine(self, text: str) -> list[str]:
        """LLM-assisted path discovery (reference: ALTK code generation via
        an LLM; here: tpu_local suggests dot-paths, extraction itself stays
        deterministic — generated paths can't execute arbitrary code)."""
        registry = getattr(self.ctx, "llm_registry", None) if self.ctx else None
        if registry is None or not self.config.config.get("use_engine", True):
            return []
        query = self.config.config.get("query", "")
        try:
            response = await registry.chat({
                "model": self.config.config.get("model"),
                "messages": [
                    {"role": "system",
                     "content": "Given a JSON document and a question, answer"
                                " ONLY with a JSON array of dot-paths (e.g."
                                ' ["items[0].name"]) locating the answer.'},
                    {"role": "user",
                     "content": f"question: {query}\njson: {text[:8000]}"},
                ],
                "max_tokens": int(self.config.config.get("max_tokens", 128)),
                "temperature": 0.0,
            })
            raw = response["choices"][0]["message"]["content"]
            parsed = json.loads(raw[raw.find("["):raw.rfind("]") + 1])
            return [p for p in parsed if isinstance(p, str)][:16]
        except Exception as exc:
            logger.debug("json_processor engine path discovery failed: %s", exc)
            return []
