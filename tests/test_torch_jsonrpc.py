"""The stdlib pieces of the port's MCP path against the JAX package's, on the
CPU, case by case: ``jsonrpc.py`` (``RPCRequest.parse``, ``parse_body``, the
error codes, the response constructors, ``method_registry``), the JSON-RPC
response bytes of ``gateway/serialize.py``, the catalog schemas (every
Create and Update body of a seeded set is accepted with the same dump, or
refused with the same count, locations, messages and kinds as pydantic's),
``utils/retry.py`` (seeded backoff, the retry and give-up decisions),
``utils/ssrf.py`` (the same refusals, IP literals only: no DNS), the
transport's event store and SSE frames, ``iter_sse`` and the protocol
constants. Exact equality throughout."""

import asyncio
import json
import random

import numpy as np
import pytest
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

import mcp_context_forge_tpu as jax_pkg
import mcp_context_forge_tpu_torch as port_pkg
from mcp_context_forge_tpu import jsonrpc as jax_rpc
from mcp_context_forge_tpu import schemas as jax_schemas
from mcp_context_forge_tpu.clients import mcp_client as jax_client
from mcp_context_forge_tpu.config import load_settings as jax_load_settings
from mcp_context_forge_tpu.gateway import serialize as jax_serialize
from mcp_context_forge_tpu.gateway.transports import streamable_http as jax_transport
from mcp_context_forge_tpu.services.base import ValidationFailure as JaxValidationFailure
from mcp_context_forge_tpu.utils import retry as jax_retry
from mcp_context_forge_tpu.utils import ssrf as jax_ssrf
from mcp_context_forge_tpu_torch import jsonrpc as port_rpc
from mcp_context_forge_tpu_torch import schemas as port_schemas
from mcp_context_forge_tpu_torch.clients import mcp_client as port_client
from mcp_context_forge_tpu_torch.config import load_settings
from mcp_context_forge_tpu_torch.gateway import serialize as port_serialize
from mcp_context_forge_tpu_torch.gateway.transports import streamable_http as port_transport
from mcp_context_forge_tpu_torch.services.base import ValidationFailure
from mcp_context_forge_tpu_torch.utils import retry as port_retry
from mcp_context_forge_tpu_torch.utils import ssrf as port_ssrf

PAYLOADS = [
    {"jsonrpc": "2.0", "id": 1, "method": "tools/list"},
    {"jsonrpc": "2.0", "id": "a", "method": "tools/call", "params": {"name": "x"}},
    {"jsonrpc": "2.0", "method": "notifications/initialized"},
    {"jsonrpc": "2.0", "id": None, "method": "ping", "params": None},
    {"jsonrpc": "2.0", "id": 2.5, "method": "m", "params": [1, 2]},
    {"jsonrpc": "2.0", "id": True, "method": "ping"},
    {"jsonrpc": "2.0", "id": [1], "method": "ping"},
    {"jsonrpc": "1.0", "id": 1, "method": "ping"},
    {"id": 1, "method": "ping"},
    {"jsonrpc": "2.0", "id": 1, "method": ""},
    {"jsonrpc": "2.0", "id": 1, "method": 7},
    {"jsonrpc": "2.0", "id": 1, "method": "x", "params": "text"},
    [{"jsonrpc": "2.0", "id": 1, "method": "ping"}],
    "ping",
    None,
]
BODIES = [b'{"jsonrpc":"2.0","id":1,"method":"ping"}', b"{not json", b"", b"\xff\xfe",
          b'"just a string"', b"[1,2,3]", b"x" * 40]


def _outcome(module, fn):
    try:
        out = fn()
    except module.JSONRPCError as exc:
        return ("error", exc.code, exc.message, exc.data, exc.to_dict(9))
    return ("ok", out if not hasattr(out, "__dict__") else vars(out))


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_request_parse_agrees(i):
    outcomes = [_outcome(m, lambda m=m: m.RPCRequest.parse(PAYLOADS[i]))
                for m in (port_rpc, jax_rpc)]
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("i", range(len(BODIES)))
@pytest.mark.parametrize("max_size", [0, 32])
def test_parse_body_agrees(i, max_size):
    outcomes = [_outcome(m, lambda m=m: m.parse_body(BODIES[i], max_size))
                for m in (port_rpc, jax_rpc)]
    assert outcomes[0] == outcomes[1]


def test_codes_methods_and_responses_agree():
    for name in ("PARSE_ERROR", "INVALID_REQUEST", "METHOD_NOT_FOUND", "INVALID_PARAMS",
                 "INTERNAL_ERROR", "REQUEST_CANCELLED", "CONTENT_TOO_LARGE",
                 "UPSTREAM_UNAVAILABLE", "CORE_METHODS", "NOTIFICATION_METHODS"):
        assert getattr(port_rpc, name) == getattr(jax_rpc, name), name
    assert port_pkg.PROTOCOL_VERSION == jax_pkg.PROTOCOL_VERSION
    assert port_pkg.SUPPORTED_PROTOCOL_VERSIONS == jax_pkg.SUPPORTED_PROTOCOL_VERSIONS
    methods = sorted(jax_rpc.CORE_METHODS | jax_rpc.NOTIFICATION_METHODS) + ["x/y", "notifications/z"]
    for method in methods:
        assert (port_rpc.method_registry.is_known(method), port_rpc.method_registry.is_notification(method)) \
            == (jax_rpc.method_registry.is_known(method), jax_rpc.method_registry.is_notification(method))
    for message in ({"result": 1}, {"error": {}}, {"method": "m", "result": 1}, {"id": 1}, [1]):
        assert port_rpc.is_response_message(message) == jax_rpc.is_response_message(message)
    for rid, result in ((1, {"a": [1, "é"]}), ("s", None), (None, {"tools": []})):
        assert port_rpc.result_response(rid, result) == jax_rpc.result_response(rid, result)
        assert port_rpc.error_response(rid, -32602, "m", result) \
            == jax_rpc.error_response(rid, -32602, "m", result)
        for response in (port_rpc.result_response(rid, result),
                         port_rpc.error_response(rid, -1, "e"), {**port_rpc.result_response(rid, 1), "x": 1}):
            assert port_serialize.jsonrpc_response_bytes(response) \
                == jax_serialize.jsonrpc_response_bytes(response)


# -- the schemas -------------------------------------------------------------

MODELS = ["GatewayCreate", "GatewayUpdate", "ToolCreate", "ToolUpdate", "ServerCreate",
          "ServerUpdate"]
VALUES = {
    "text": ["ok", "", "x" * 300, 3, None, ["a"], {"k": "v"}, True],
    "bool": [True, False, "yes", "off", "maybe", 0, 1, 2, 1.0, None, [], "TRUE "],
    "list": [[], ["a", "b"], ["a", 1], "a", None, {"a": 1}],
    "dict": [{}, {"a": "b"}, {"a": 1}, [], None, "x"],
    "url": ["http://h:1/mcp", "https://x", "ftp://x", "", 5],
    "choice": ["streamablehttp", "sse", "ws", "MCP", "REST", "GRPC", "GET", "PATCH", "get",
               "public", "team", "private", "basic", "oauth", None, 1],
}
FIELD_KIND = {"name": "text", "description": "text", "url": "url", "icon": "text",
              "display_name": "text", "custom_name": "text", "team_id": "text",
              "owner_email": "text", "auth_type": "choice", "jsonpath_filter": "text",
              "gateway_id": "text", "request_type": "choice", "transport": "choice",
              "integration_type": "choice", "visibility": "choice", "enabled": "bool",
              "tags": "list", "passthrough_headers": "list", "associated_tools": "list",
              "associated_resources": "list", "associated_prompts": "list",
              "auth_value": "dict", "input_schema": "dict", "output_schema": "dict",
              "annotations": "dict", "headers": "dict"}


def _body(rng, model: str) -> object:
    fields = list(jax_schemas.__dict__[model].model_fields)
    if rng.random() < 0.05:
        return rng.choice(["[]", "s", "1"])
    body = {"unknown_key": 1}
    for name in fields:
        if rng.random() < 0.55 or name == "name" and rng.random() < 0.8:
            options = VALUES[FIELD_KIND[name]]
            body[name] = options[rng.integers(len(options))]
    return body


def _errors(text: str) -> list:
    """(count line, [location, message | kind ...]) of a pydantic-layout text."""
    lines = [line for line in text.splitlines() if not line.strip().startswith("For further")]
    out = [lines[0]]
    for line in lines[1:]:
        if "[type=" in line:
            message, _, rest = line.partition(" [type=")
            out.append(f"{message}|{rest.split(',')[0].rstrip(']')}")
        else:
            out.append(line)
    return out


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("seed", range(6))
def test_schema_validation_agrees(model, seed):
    rng = np.random.default_rng([seed, MODELS.index(model)])
    for _ in range(12):
        body = _body(rng, model)
        body = json.loads(body) if isinstance(body, str) and body[0] in "[1" else body
        try:
            theirs = getattr(jax_schemas, model).model_validate(body)
            want = ("ok", json.loads(theirs.model_dump_json()),
                    theirs.model_dump(exclude_unset=True))
        except Exception as exc:
            want = ("refused", _errors(str(exc)))
        try:
            ours = getattr(port_schemas, model).model_validate(body)
            got = ("ok", ours.model_dump(), ours.model_dump(exclude_unset=True))
        except port_schemas.SchemaError as exc:
            got = ("refused", _errors(str(exc)))
        assert got == want, body


@pytest.mark.parametrize("model", ["GatewayRead", "ToolRead", "ServerRead"])
def test_read_schemas_have_the_jax_fields(model):
    theirs = getattr(jax_schemas, model).model_fields
    ours = getattr(port_schemas, model).__dataclass_fields__
    assert [n for n in ours if not n.startswith("_")] == list(theirs)
    for name, f in theirs.items():
        if f.default_factory is None and f.is_required() is False:
            assert ours[name].default == f.default, name


# -- retry -------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_backoff_delay_agrees(seed):
    out = []
    for module in (port_retry, jax_retry):
        random.seed(seed)
        out.append([module.backoff_delay(a, 0.1, 2.0, ra) for a in range(6)
                    for ra in (None, 0.5, 9.0)])
    assert out[0] == out[1]


def _failures(kind: str):
    import aiohttp
    import httpx

    request = httpx.Request("GET", "http://x")
    if kind.startswith("status"):
        code = int(kind[6:])
        return lambda: httpx.HTTPStatusError(
            "s", request=request, response=httpx.Response(code, request=request,
                                                          headers={"retry-after": "0"}))
    return {"transport": lambda: httpx.ConnectError("down", request=request),
            "aiohttp": lambda: aiohttp.ClientConnectionError("down"),
            "timeout": lambda: asyncio.TimeoutError(),
            "value": lambda: ValueError("app")}[kind]


@pytest.mark.parametrize("kind", ["status503", "status429", "status404", "transport", "aiohttp",
                                  "timeout", "value"])
@pytest.mark.parametrize("fail_times", [1, 5])
def test_with_retries_agrees(kind, fail_times):
    make = _failures(kind)

    async def run(module):
        calls = []

        async def fn():
            calls.append(1)
            if len(calls) <= fail_times:
                raise make()
            return "done"

        try:
            out = await module.with_retries(fn, attempts=3, base=0.0, cap=0.0)
        except Exception as exc:
            out = (type(exc).__name__, getattr(exc, "attempts", None))
        return out, len(calls)

    assert asyncio.run(run(port_retry)) == asyncio.run(run(jax_retry))


# -- the SSRF guard ----------------------------------------------------------

SSRF_ENVS = [{}, {"SSRF_PROTECTION_ENABLED": "true"},
             {"SSRF_PROTECTION_ENABLED": "true", "SSRF_ALLOW_LOCALHOST": "false"},
             {"SSRF_PROTECTION_ENABLED": "true", "SSRF_ALLOW_PRIVATE_NETWORKS": "false",
              "SSRF_ALLOWED_NETWORKS_CSV": "10.1.0.0/16"},
             {"SSRF_PROTECTION_ENABLED": "true", "SSRF_BLOCKED_NETWORKS_CSV": "8.8.8.0/24",
              "SSRF_BLOCKED_HOSTS_CSV": "Evil.Example, other"}]
SSRF_URLS = ["http://127.0.0.1:9/x", "https://10.1.2.3/", "http://10.2.0.1", "http://8.8.8.8",
             "http://[::1]:80/", "ftp://1.1.1.1/", "http:///nohost", "http://evil.example/",
             "http://169.254.1.1/", ""]


@pytest.mark.parametrize("env", range(len(SSRF_ENVS)))
def test_ssrf_guard_agrees(env):
    settings = [load_settings(SSRF_ENVS[env], env_file=None),
                jax_load_settings(env={f"MCPFORGE_{k}": v for k, v in SSRF_ENVS[env].items()},
                                  env_file=None)]

    async def check(module, failure, s, url):
        try:
            await module.ensure_url_allowed(s, url)
            return "allowed"
        except failure as exc:
            return str(exc)

    for url in SSRF_URLS:
        if "evil" in url and env != 4:
            continue   # a hostname resolves through DNS: only the blocked-host case
        ours = asyncio.run(check(port_ssrf, ValidationFailure, settings[0], url))
        theirs = asyncio.run(check(jax_ssrf, JaxValidationFailure, settings[1], url))
        assert ours == theirs, url


# -- the transport's event store and frames, the client's SSE parser ---------


def test_event_store_and_frames_agree():
    stores = [port_transport.InMemoryEventStore(max_events_per_session=4),
              jax_transport.InMemoryEventStore(max_events_per_session=4)]
    ids = [[s.append(sid, {"n": i, "t": "é"}) for i, sid in enumerate("aabababaa")]
           for s in stores]
    assert ids[0] == ids[1]
    for last in ("a-1", "a-7", "b-4", "zz"):
        for sid in ("a", "b", "c"):
            assert [(e.event_id, e.message) for e in stores[0].replay_after(sid, last)] \
                == [(e.event_id, e.message) for e in stores[1].replay_after(sid, last)]
    for event_id in (None, "s-3"):
        assert port_transport._sse_frame(event_id, {"jsonrpc": "2.0", "x": [1, "é"]}) \
            == jax_transport._sse_frame(event_id, {"jsonrpc": "2.0", "x": [1, "é"]})


class _Lines:
    def __init__(self, lines):
        self.lines = lines

    async def aiter_lines(self):
        for line in self.lines:
            yield line


@pytest.mark.parametrize("case", range(3))
def test_iter_sse_agrees(case):
    streams = [["event: endpoint", "data: /messages?s=1", "", ": keepalive", "", "id: 7",
                "data: {\"a\":", "data: 1}", "", "data: tail"],
               ["data: x", "event: message", "", "", "event: other", "id: 2"],
               ["retry: 10", "data:no-space", "data:  two", ""]]

    async def collect(module):
        return [(e.event, e.data, e.id) async for e in module.iter_sse(_Lines(streams[case]))]

    assert asyncio.run(collect(port_client)) == asyncio.run(collect(jax_client))
