"""The port's ``LLMProviderService`` and ``utils/crypto.py`` against the JAX
package's, on the CPU: the same CRUD calls over each package's migrated
database give the same rows (ids and times masked), conflicts, validation
failures, not-founds and redaction; after ``rewire`` each alias resolves to
the same provider class with the same base URL, key, headers and dialect,
and ``llm_providers_wired`` reads the same; a value sealed by either package
opens in the other, in the mode this machine runs (AES-GCM where
``cryptography`` imports) and in the in-tree HMAC mode."""

import re

import pytest

from mcp_context_forge_tpu.config import load_settings as jax_load_settings
from mcp_context_forge_tpu.coordination import make_bus as jax_make_bus
from mcp_context_forge_tpu.coordination import make_lease_manager as jax_make_leases
from mcp_context_forge_tpu.db import core as jax_core
from mcp_context_forge_tpu.db.schema import MIGRATIONS as JAX_MIGRATIONS
from mcp_context_forge_tpu.observability import PrometheusRegistry as JaxRegistry
from mcp_context_forge_tpu.observability import Tracer as JaxTracer
from mcp_context_forge_tpu.services import base as jax_base
from mcp_context_forge_tpu.services import llm_provider_service as jax_service
from mcp_context_forge_tpu.utils import crypto as jax_crypto
from mcp_context_forge_tpu_torch.config import load_settings
from mcp_context_forge_tpu_torch.coordination.bus import make_bus
from mcp_context_forge_tpu_torch.coordination.leases import make_lease_manager
from mcp_context_forge_tpu_torch.db import MIGRATIONS, core
from mcp_context_forge_tpu_torch.observability.metrics import PrometheusRegistry
from mcp_context_forge_tpu_torch.observability.tracing import Tracer
from mcp_context_forge_tpu_torch.services import base
from mcp_context_forge_tpu_torch.services import llm_provider_service as service
from mcp_context_forge_tpu_torch.utils import crypto

MASKED = {"id", "provider_id", "created_at", "updated_at"}
PROVIDERS = [
    ("trunk", "openai_compatible", "http://127.0.0.1:9/v1/", {"api_key": "sk-1", "timeout": 5}),
    ("groq-alias", "groq", "https://api.groq.example/openai/v1", {"api_key": "g"}),
    ("claude", "anthropic", "https://api.anthropic.example", {"api_key": "a",
                                                               "anthropic_version": "v"}),
    ("azure", "azure_openai", "https://r.openai.azure.example",
     {"api_key": "z", "deployment": "d", "api_version": "2024"}),
    ("local", "tpu_local", "", None),
    ("plain", "ollama", "http://127.0.0.1:11434", None),
]


async def _context(package: str):
    if package == "jax":
        settings = jax_load_settings(env_file=None)
        db = jax_core.Database(":memory:")
        await db.connect()
        await db.migrate(JAX_MIGRATIONS)
        return jax_base.AppContext(settings=settings, db=db, bus=jax_make_bus("memory"),
                                   leases=jax_make_leases("memory"),
                                   tracer=JaxTracer(exporter="memory"), metrics=JaxRegistry())
    settings = load_settings(env_file=None)
    db = core.Database(":memory:")
    await db.connect()
    await db.migrate(MIGRATIONS)
    return base.AppContext(settings=settings, db=db, bus=make_bus("memory"),
                           leases=make_lease_manager("memory"),
                           tracer=Tracer(exporter="memory"), metrics=PrometheusRegistry())


def _mask(value):
    if isinstance(value, list):
        return [_mask(v) for v in value]
    if isinstance(value, dict):
        return {k: ("*" if k in MASKED else _mask(v)) for k, v in value.items()}
    return value


async def _outcome(call):
    try:
        return ("ok", _mask(await call))
    except Exception as exc:
        return (type(exc).__name__, re.sub(r"[0-9a-f]{32}", "<id>", str(exc)))


def _provider_view(provider) -> tuple:
    fields = {k: v for k, v in vars(provider).items()
              if isinstance(v, (str, int, float, dict, type(None)))}
    headers = provider._headers() if hasattr(provider, "_headers") else None
    return type(provider).__name__, fields, headers


async def _crud(package: str) -> tuple[list, dict, float]:
    module = jax_service if package == "jax" else service
    ctx = await _context(package)
    svc = module.LLMProviderService(ctx)
    log, ids = [], {}
    for name, ptype, api_base, config in PROVIDERS:
        out = await _outcome(svc.create_provider(name, ptype, api_base, config))
        log.append(out)
        row = await ctx.db.fetchone("SELECT id FROM llm_providers WHERE name=?", (name,))
        ids[name] = row["id"] if row else None
    log.append(await _outcome(svc.create_provider("trunk", "openai_compatible")))
    log.append(await _outcome(svc.create_provider("bad", "not-a-type")))
    log.append(await _outcome(svc.get_provider("missing")))
    for name, alias in (("trunk", "loop-8b"), ("groq-alias", "llama-g"), ("claude", "sonnet"),
                        ("azure", "gpt-az"), ("plain", "llama-o")):
        log.append(await _outcome(svc.add_model(ids[name], f"model-{alias}", alias,
                                                supports_embeddings=alias == "llama-o")))
    log.append(await _outcome(svc.add_model(ids["trunk"], "m", "loop-8b")))
    log.append(await _outcome(svc.add_model("missing", "m", "x")))
    log.append(await _outcome(svc.list_providers()))
    log.append(await _outcome(svc.list_models()))
    wired = {alias: _provider_view(svc.registry.resolve(alias)[0])
             for alias in ("loop-8b", "llama-g", "sonnet", "gpt-az", "llama-o")}
    gauge = _gauge(ctx.metrics)
    log.append(await _outcome(svc.delete_provider(ids["plain"])))
    log.append(await _outcome(svc.delete_provider(ids["plain"])))
    # delete does not rewire: the alias resolves until the next rewire
    log.append(type(svc.registry.resolve("llama-o")[0]).__name__)
    await svc.rewire()
    log.append(await _outcome(svc.list_providers()))
    await ctx.db.close()
    return log, wired, gauge


async def test_crud_rewire_and_redaction_equal_jax():
    want, got = await _crud("jax"), await _crud("port")
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2] == 5.0
    created = [entry for entry in got[0][:len(PROVIDERS)]]
    assert all(kind == "ok" for kind, _ in created)
    listed = got[0][len(PROVIDERS) + 10]   # list_providers after the models
    assert listed[0] == "ok" and {row["config"] for row in listed[1]} == {"***"}
    assert got[1]["loop-8b"][2] == {"content-type": "application/json",
                                    "authorization": "Bearer sk-1"}
    assert got[1]["sonnet"][0] == "DialectProvider"


def _gauge(metrics) -> float:
    return next(s.value for family in metrics.llm_providers_wired.collect()
                for s in family.samples)


@pytest.fixture(params=["native", "hmac"])
def crypto_mode(request, monkeypatch):
    """The mode this machine runs, and the in-tree fallback in both packages."""
    if request.param == "hmac":
        monkeypatch.setattr(jax_crypto, "AESGCM", None)
        monkeypatch.setattr(crypto, "AESGCM", None)
    assert (crypto.AESGCM is None) == (jax_crypto.AESGCM is None)
    return request.param


@pytest.mark.parametrize("value", [{"api_key": "sk-é", "n": [1, 2]}, "s", 7, None, []])
def test_sealed_values_open_in_either_package(crypto_mode, value):
    secret = "unit-test-enc-secret-0123456789abcdef"
    for seal, unseal in ((jax_crypto, crypto), (crypto, jax_crypto)):
        token = seal.encrypt_field(value, secret)
        assert token.startswith("enc:v1:")
        assert unseal.decrypt_field(token, secret) == value
        with pytest.raises(unseal.DecryptionError):
            unseal.decrypt_field(token, "another-secret-0123456789abcdef")
        with pytest.raises(unseal.DecryptionError):
            unseal.decrypt_field(token[:-4], secret)


@pytest.mark.parametrize("token", [None, "plain", '{"a": 1}', "[1]", ""])
def test_legacy_values_pass_through_alike(token):
    assert crypto.decrypt_field(token, "k") == jax_crypto.decrypt_field(token, "k")


async def test_rows_sealed_by_jax_rewire_in_the_port(tmp_path, crypto_mode):
    """A provider row the JAX service sealed into a file opens in the port's
    service, which wires the same provider from it."""
    path = str(tmp_path / "gateway.db")
    views = []
    for package in ("jax", "port"):
        ctx = await _context(package)
        await ctx.db.close()
        module, db_module, migrations = ((jax_service, jax_core, JAX_MIGRATIONS)
                                         if package == "jax" else (service, core, MIGRATIONS))
        ctx.db = db_module.Database(path)
        await ctx.db.connect()
        await ctx.db.migrate(migrations)
        svc = module.LLMProviderService(ctx)
        if package == "jax":
            created = await svc.create_provider("trunk", "openai_compatible",
                                                "http://127.0.0.1:9/v1", {"api_key": "sk-x"})
            await svc.add_model(created["id"], "m", "loop-8b")
        await svc.rewire()
        views.append((_provider_view(svc.registry.resolve("loop-8b")[0]), _gauge(ctx.metrics)))
        await ctx.db.close()
    assert views[1] == views[0]
    assert views[1][0][2]["authorization"] == "Bearer sk-x"
