"""The catalog's request and response schemas for gateways, tools,
resources, prompts, virtual servers and A2A agents (the JAX package's
``schemas.py`` triples, ``PromptArgument`` and the A2A pair), on the
standard library:
the card's Python has pydantic, but the port imports none of it.

Each schema is a dataclass with the JAX model's fields, defaults and
validators. ``model_validate`` reads a JSON body as pydantic's lax mode
does for these field types (unknown keys ignored; a ``bool`` from the
usual words, ``0``/``1`` or a bool; nothing coerced into a string, list or
dictionary; a nested model from a dictionary) and raises ``SchemaError``,
whose text has pydantic's layout: a count line, then each error's location
(``arguments.0.name`` inside a list of nested models) and ``<message>
[type=<kind>]``, every list item's and nested field's error in order.
``model_dump(exclude_unset=True)`` gives the keys the body carried, as an
update needs."""

from __future__ import annotations

import dataclasses
import time
import types
import typing
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any, Literal

Visibility = Literal["public", "team", "private"]

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
_MISSING = object()


class SchemaError(ValueError):
    """A body the schema refuses; ``errors`` holds (location, message,
    kind) per error, in field order."""

    def __init__(self, model: str, errors: list[tuple[str, str, str]]):
        self.model = model
        self.errors = errors
        lines = [f"{len(errors)} validation error{'s' if len(errors) > 1 else ''} for {model}"]
        for loc, message, kind in errors:
            if loc:
                lines.append(loc)
            lines.append(f"  {message} [type={kind}]")
        super().__init__("\n".join(lines))


class _Invalid(Exception):
    """One error at ``loc``, or, with ``errors``, those of a list's items or
    a nested model's fields."""

    def __init__(self, loc: str, message: str = "", kind: str = "",
                 errors: list[tuple[str, str, str]] | None = None):
        self.errors = errors if errors is not None else [(loc, message, kind)]


def _each(checks) -> tuple[list, list]:
    """The values of ``checks`` (thunks), and every error they raised."""
    values, errors = [], []
    for check in checks:
        try:
            values.append(check())
        except _Invalid as exc:
            errors.extend(exc.errors)
    return values, errors


def _literal_message(options: tuple) -> str:
    quoted = [repr(o) for o in options]
    listed = quoted[0] if len(quoted) == 1 else ", ".join(quoted[:-1]) + " or " + quoted[-1]
    return f"Input should be {listed}"


def _check(loc: str, annotation: Any, value: Any) -> Any:
    """``value`` as ``annotation`` takes it, or ``_Invalid``."""
    origin, args = typing.get_origin(annotation), typing.get_args(annotation)
    if annotation is Any:
        return value
    if origin in (typing.Union, types.UnionType):
        inner = [a for a in args if a is not type(None)]
        if value is None and len(inner) < len(args):
            return None
        return _check(loc, inner[0], value)
    if origin is Literal:
        if value in args and type(value) is type(args[0]):
            return value
        raise _Invalid(loc, _literal_message(args), "literal_error")
    if annotation is str:
        if isinstance(value, str):
            return value
        raise _Invalid(loc, "Input should be a valid string", "string_type")
    if annotation is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)):
            if value in (0, 1):
                return bool(value)
            raise _Invalid(loc, "Input should be a valid boolean, unable to interpret input",
                           "bool_parsing")
        if isinstance(value, str):
            word = value.lower()
            if word in _TRUE or word in _FALSE:
                return word in _TRUE
            raise _Invalid(loc, "Input should be a valid boolean, unable to interpret input",
                           "bool_parsing")
        raise _Invalid(loc, "Input should be a valid boolean", "bool_type")
    if origin is dict:
        if not isinstance(value, dict):
            raise _Invalid(loc, "Input should be a valid dictionary", "dict_type")
        checked, errors = _each(
            lambda k=k, v=v: (k, _check(f"{loc}.{k}", args[1], v)) for k, v in value.items())
        if errors:
            raise _Invalid(loc, errors=errors)
        return dict(checked)
    if origin is list:
        if not isinstance(value, list):
            raise _Invalid(loc, "Input should be a valid list", "list_type")
        checked, errors = _each(lambda i=i, v=v: _check(f"{loc}.{i}", args[0], v)
                                for i, v in enumerate(value))
        if errors:
            raise _Invalid(loc, errors=errors)
        return checked
    if isinstance(annotation, type) and issubclass(annotation, _Model):
        # a nested model: its errors under this location
        if isinstance(value, annotation):
            return value
        try:
            return annotation.model_validate(value)
        except SchemaError as exc:
            raise _Invalid(loc, errors=[(f"{loc}.{sub}" if sub else loc, message, kind)
                                        for sub, message, kind in exc.errors]) from exc
    return value


@lru_cache(maxsize=None)
def _hints(cls) -> dict[str, Any]:
    return typing.get_type_hints(cls)


class _Model:
    """``model_validate``, ``model_dump`` and the set of fields given."""

    _validators: typing.ClassVar[dict[str, Any]] = {}

    @classmethod
    def model_validate(cls, data: Any):
        if not isinstance(data, dict):
            raise SchemaError(cls.__name__, [(
                "", f"Input should be a valid dictionary or instance of {cls.__name__}",
                "model_type")])
        hints = _hints(cls)
        values, errors = {}, []
        for f in dataclasses.fields(cls):
            if f.name.startswith("_"):
                continue
            raw = data.get(f.name, _MISSING)
            if raw is _MISSING:
                if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
                    errors.append((f.name, "Field required", "missing"))
                continue
            try:
                value = _check(f.name, hints[f.name], raw)
                check = cls._validators.get(f.name)
                if check is not None:
                    try:
                        value = check(value)
                    except ValueError as exc:
                        raise _Invalid(f.name, f"Value error, {exc}", "value_error") from exc
                values[f.name] = value
            except _Invalid as exc:
                errors.extend(exc.errors)
        if errors:
            raise SchemaError(cls.__name__, errors)
        model = cls(**values)
        model._fields_set = set(values)
        return model

    def model_dump(self, exclude_unset: bool = False,
                   exclude_none: bool = False) -> dict[str, Any]:
        names = [f.name for f in dataclasses.fields(self) if not f.name.startswith("_")]
        if exclude_unset:
            names = [n for n in names if n in self._fields_set]
        out = {n: _plain(getattr(self, n), exclude_unset, exclude_none) for n in names}
        return {n: v for n, v in out.items() if v is not None} if exclude_none else out


def _plain(value: Any, exclude_unset: bool = False, exclude_none: bool = False) -> Any:
    """``value`` as plain data; a nested model dumps under the same flags."""
    if isinstance(value, _Model):
        return value.model_dump(exclude_unset=exclude_unset, exclude_none=exclude_none)
    if isinstance(value, dict):
        return {k: _plain(v, exclude_unset, exclude_none) for k, v in value.items()}
    if isinstance(value, list):
        return [_plain(v, exclude_unset, exclude_none) for v in value]
    return value


def _check_gateway_url(v: str) -> str:
    if not v.startswith(("http://", "https://")):
        raise ValueError("gateway url must be http(s)")
    return v


def _check_tool_name(v: str) -> str:
    if not v or len(v) > 255:
        raise ValueError("tool name must be 1-255 chars")
    return v


@dataclass(kw_only=True)
class _Entity(_Model):
    description: str | None = None
    tags: list[str] = field(default_factory=list)
    team_id: str | None = None
    owner_email: str | None = None
    visibility: Visibility = "public"
    _fields_set: set = field(default_factory=set, repr=False, compare=False)


@dataclass(kw_only=True)
class _Update(_Model):
    _fields_set: set = field(default_factory=set, repr=False, compare=False)


# ------------------------------------------------------------------ gateways

@dataclass(kw_only=True)
class GatewayCreate(_Entity):
    name: str
    url: str
    transport: Literal["streamablehttp", "sse"] = "streamablehttp"
    auth_type: Literal["none", "basic", "bearer", "headers", "oauth"] | None = None
    # {username,password} | {token} | {headers} | {token_url,client_id,client_secret}
    auth_value: dict[str, Any] | None = None
    passthrough_headers: list[str] = field(default_factory=list)
    enabled: bool = True

    _validators = {"url": _check_gateway_url}


@dataclass(kw_only=True)
class GatewayUpdate(_Update):
    name: str | None = None
    url: str | None = None
    description: str | None = None
    transport: Literal["streamablehttp", "sse"] | None = None
    auth_type: Literal["none", "basic", "bearer", "headers", "oauth"] | None = None
    auth_value: dict[str, Any] | None = None
    passthrough_headers: list[str] | None = None
    enabled: bool | None = None
    tags: list[str] | None = None
    visibility: Visibility | None = None


@dataclass(kw_only=True)
class GatewayRead(_Entity):
    id: str
    name: str
    url: str
    transport: str = "streamablehttp"
    auth_type: str | None = None
    enabled: bool = True
    reachable: bool = False
    state: str = "pending"
    capabilities: dict[str, Any] = field(default_factory=dict)
    last_seen: float | None = None
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)


# --------------------------------------------------------------------- tools

@dataclass(kw_only=True)
class ToolCreate(_Entity):
    name: str
    display_name: str | None = None
    integration_type: Literal["MCP", "REST", "A2A", "GRPC"] = "REST"
    request_type: Literal["GET", "POST", "PUT", "PATCH", "DELETE"] = "POST"
    url: str | None = None
    input_schema: dict[str, Any] = field(
        default_factory=lambda: {"type": "object", "properties": {}})
    output_schema: dict[str, Any] | None = None
    annotations: dict[str, Any] = field(default_factory=dict)
    headers: dict[str, str] = field(default_factory=dict)
    auth_type: str | None = None
    auth_value: dict[str, Any] | None = None
    jsonpath_filter: str | None = None
    gateway_id: str | None = None
    enabled: bool = True

    _validators = {"name": _check_tool_name}


@dataclass(kw_only=True)
class ToolUpdate(_Update):
    display_name: str | None = None
    custom_name: str | None = None
    description: str | None = None
    url: str | None = None
    request_type: str | None = None
    input_schema: dict[str, Any] | None = None
    output_schema: dict[str, Any] | None = None
    annotations: dict[str, Any] | None = None
    headers: dict[str, str] | None = None
    auth_type: str | None = None
    auth_value: dict[str, Any] | None = None
    jsonpath_filter: str | None = None
    enabled: bool | None = None
    tags: list[str] | None = None
    visibility: Visibility | None = None


@dataclass(kw_only=True)
class ToolRead(_Entity):
    id: str
    name: str  # the effective name: custom_name or the original
    original_name: str
    display_name: str | None = None
    integration_type: str = "REST"
    request_type: str = "POST"
    url: str | None = None
    input_schema: dict[str, Any] = field(default_factory=dict)
    output_schema: dict[str, Any] | None = None
    annotations: dict[str, Any] = field(default_factory=dict)
    gateway_id: str | None = None
    enabled: bool = True
    reachable: bool = True
    created_at: float = 0.0
    updated_at: float = 0.0


# ----------------------------------------------------------------- resources

@dataclass(kw_only=True)
class ResourceCreate(_Entity):
    uri: str
    name: str
    mime_type: str | None = None
    uri_template: str | None = None
    content: str | None = None
    is_binary: bool = False
    gateway_id: str | None = None
    enabled: bool = True


@dataclass(kw_only=True)
class ResourceUpdate(_Update):
    name: str | None = None
    description: str | None = None
    mime_type: str | None = None
    content: str | None = None
    enabled: bool | None = None
    tags: list[str] | None = None
    visibility: Visibility | None = None


@dataclass(kw_only=True)
class ResourceRead(_Entity):
    id: str
    uri: str
    name: str
    mime_type: str | None = None
    uri_template: str | None = None
    size: int | None = None
    gateway_id: str | None = None
    enabled: bool = True
    created_at: float = 0.0
    updated_at: float = 0.0


# ------------------------------------------------------------------- prompts

@dataclass(kw_only=True)
class PromptArgument(_Model):
    name: str
    description: str | None = None
    required: bool = False
    _fields_set: set = field(default_factory=set, repr=False, compare=False)


@dataclass(kw_only=True)
class PromptCreate(_Entity):
    name: str
    template: str
    arguments: list[PromptArgument] = field(default_factory=list)
    gateway_id: str | None = None
    enabled: bool = True


@dataclass(kw_only=True)
class PromptUpdate(_Update):
    description: str | None = None
    template: str | None = None
    arguments: list[PromptArgument] | None = None
    enabled: bool | None = None
    tags: list[str] | None = None
    visibility: Visibility | None = None


@dataclass(kw_only=True)
class PromptRead(_Entity):
    id: str
    name: str
    template: str
    arguments: list[PromptArgument] = field(default_factory=list)
    gateway_id: str | None = None
    enabled: bool = True
    created_at: float = 0.0
    updated_at: float = 0.0


# ------------------------------------------------------------------- servers

@dataclass(kw_only=True)
class ServerCreate(_Entity):
    name: str
    icon: str | None = None
    associated_tools: list[str] = field(default_factory=list)
    associated_resources: list[str] = field(default_factory=list)
    associated_prompts: list[str] = field(default_factory=list)
    enabled: bool = True


@dataclass(kw_only=True)
class ServerUpdate(_Update):
    name: str | None = None
    description: str | None = None
    icon: str | None = None
    associated_tools: list[str] | None = None
    associated_resources: list[str] | None = None
    associated_prompts: list[str] | None = None
    enabled: bool | None = None
    tags: list[str] | None = None
    visibility: Visibility | None = None


@dataclass(kw_only=True)
class ServerRead(_Entity):
    id: str
    name: str
    icon: str | None = None
    associated_tools: list[str] = field(default_factory=list)
    associated_resources: list[str] = field(default_factory=list)
    associated_prompts: list[str] = field(default_factory=list)
    enabled: bool = True
    created_at: float = 0.0
    updated_at: float = 0.0


# ---------------------------------------------------------------- A2A agents

@dataclass(kw_only=True)
class A2AAgentCreate(_Entity):
    name: str
    endpoint_url: str
    agent_type: Literal["jsonrpc", "openai", "anthropic", "custom", "tpu_local"] = "jsonrpc"
    protocol_version: str = "1.0"
    capabilities: dict[str, Any] = field(default_factory=dict)
    config: dict[str, Any] = field(default_factory=dict)
    auth_type: str | None = None
    auth_value: dict[str, Any] | None = None
    enabled: bool = True


@dataclass(kw_only=True)
class A2AAgentRead(_Entity):
    id: str
    name: str
    slug: str
    endpoint_url: str
    agent_type: str = "jsonrpc"
    protocol_version: str = "1.0"
    capabilities: dict[str, Any] = field(default_factory=dict)
    enabled: bool = True
    reachable: bool = True
    created_at: float = 0.0
    updated_at: float = 0.0
