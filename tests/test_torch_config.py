"""The port's settings (``mcp_context_forge_tpu_torch/config.py``, stdlib)
against the JAX package's pydantic ``Settings`` on the CPU: every port field
is a JAX field with the same type and default (but the renamed
``torch_profile_*`` pair); every name the port reads of its settings is a
field or property; seeded env dicts over every field type load to equal
values in both packages, and the same malformed values are refused by both;
the precedence of the explicit dict, the process environment and the
``.env`` file, the renamed-field alias, ``validate_security`` and
``EngineConfig.from_settings`` agree; every field of the database-backed
auth's families is ported, and their comma-list properties agree. Exact equality throughout (floats
compared as values, nan as nan)."""

import ast
import dataclasses
import math
import tempfile
import typing
from pathlib import Path

import numpy as np
import pytest
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

from mcp_context_forge_tpu import config as jax_config
from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxEngineConfig
from mcp_context_forge_tpu_torch import config
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig

ROOT = Path(__file__).resolve().parents[1]
PORT_FIELDS = {f.name: f for f in dataclasses.fields(config.Settings)}
TYPES = config._field_types()
JAX_FIELDS = jax_config.Settings.model_fields
# the port's own pair: the torch.profiler counterparts of jax_profile_*
RENAMED = {"torch_profile_dir": "jax_profile_dir", "torch_profile_enabled": "jax_profile_enabled"}
SEEDS = range(8)
DB_SCHEMES = ["sqlite:///", "sqlite+aiosqlite:///", "postgres://", "postgresql://"]


def _default(name: str):
    f = PORT_FIELDS[name]
    return f.default_factory() if f.default is dataclasses.MISSING else f.default


def _is_settings(node) -> bool:
    """``settings``, or ``<anything>["settings"]``."""
    return ((isinstance(node, ast.Name) and node.id == "settings")
            or (isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant)
                and node.slice.value == "settings"))


def _read_names() -> list[str]:
    """Every ``settings.X`` and ``getattr(settings, "X", ...)`` in the port's
    package, ``settings`` also as ``app["settings"]``."""
    names = set()
    for path in (ROOT / "mcp_context_forge_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and _is_settings(node.value):
                names.add(node.attr)
            elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                  and node.func.id == "getattr" and len(node.args) >= 2
                  and _is_settings(node.args[0]) and isinstance(node.args[1], ast.Constant)):
                names.add(node.args[1].value)
    return sorted(names)


READ = _read_names()


@pytest.mark.parametrize("name", sorted(PORT_FIELDS))
def test_field_is_the_jax_field(name):
    """Same name, annotation and default as JAX ``Settings``; the renamed
    profiler pair keeps its JAX twin's type, and the directory sits in the
    temporary directory as the JAX default does."""
    jax_name = RENAMED.get(name, name)
    assert jax_name in JAX_FIELDS
    assert TYPES[name] == JAX_FIELDS[jax_name].annotation
    if name == "torch_profile_dir":
        assert _default(name) == str(Path(tempfile.gettempdir()) / "mcpforge-torchprof")
    else:
        assert _default(name) == JAX_FIELDS[jax_name].default


def test_scan_finds_the_reads():
    assert {"tpu_local_model", "gw_backpressure_headers", "gw_stream_first_chunk_wait_s",
            "torch_profile_enabled", "gw_slow_request_s"} <= set(READ)


@pytest.mark.parametrize("name", READ)
def test_port_reads_only_its_settings(name):
    assert name in PORT_FIELDS or isinstance(getattr(config.Settings, name, None), property)


# -- seeded values per field type ------------------------------------------


def _int_text(rng, value: int) -> str:
    form = rng.integers(6)
    if form == 1:
        return f"+{value}" if value >= 0 else str(value)
    if form == 2:
        return f"  {value}\t"
    if form == 3:
        return f"{value}.0"
    if form == 4:
        return f"{value:_}"
    if form == 5:
        return f"{value:06d}" if value >= 0 else str(value)
    return str(value)


def _float_text(rng) -> str:
    form = rng.integers(7)
    value = float(rng.normal() * 10.0 ** int(rng.integers(-3, 6)))
    if form == 1:
        return f"{value:.3e}"
    if form == 2:
        return str(int(value))
    if form == 3:
        return f" {value} "
    if form == 4:
        return rng.choice(["inf", "-inf", "Infinity", "nan", "NaN"])
    if form == 5:
        return f"{int(abs(value)) + 1000:_}.5"
    return repr(value)


def _good(rng, annotation) -> str:
    """A text the field's type accepts."""
    if typing.get_origin(annotation) is typing.Literal:
        return str(rng.choice(typing.get_args(annotation)))
    if typing.get_origin(annotation) is tuple:
        values = [str(int(v)) for v in rng.integers(1, 5000, size=rng.integers(0, 5))]
        return rng.choice([",", ", ", " "]).join(values)
    if annotation is bool:
        word = str(rng.choice(sorted(config._TRUE | config._FALSE)))
        return "".join(c.upper() if rng.random() < 0.5 else c for c in word)
    if annotation is int:
        return _int_text(rng, int(rng.integers(-10**6, 10**9)))
    if annotation is float:
        return _float_text(rng)
    alphabet = list("abcXYZ019 _-/:.,={}\"'é")
    return "".join(rng.choice(alphabet) for _ in range(rng.integers(0, 12)))


def _bad(rng, annotation) -> str | None:
    """A text the field's type refuses (None: a str takes anything)."""
    if typing.get_origin(annotation) is typing.Literal:
        choice = str(rng.choice(typing.get_args(annotation)))
        return str(rng.choice([choice.upper() + "x", " " + choice, "other"]))
    if typing.get_origin(annotation) is tuple:
        return str(rng.choice(["1.5", "a,b", "128,x"]))
    if annotation is bool:
        return str(rng.choice(["maybe", "2", "1.0", " true", "", "tru"]))
    if annotation is int:
        return str(rng.choice(["1.5", "abc", "", "1e3", "0x10", "1__0", "_1", "1."]))
    if annotation is float:
        return str(rng.choice(["abc", "", "1..2", "0x10", "1__0", "e5", "--1"]))
    return None


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b and type(a) is type(b)


def _jax_value(settings, name: str):
    return getattr(settings, RENAMED.get(name, name))


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_env_loads_equal(seed):
    """One seeded text per field, under a key form drawn from MCPFORGE_X, X
    and x; the renamed pair's text goes under both packages' names."""
    rng = np.random.default_rng(seed)
    env = {}
    for name, annotation in TYPES.items():
        text = _good(rng, annotation)
        if name == "database_url":   # validated: a scheme both packages accept
            text = str(rng.choice(DB_SCHEMES)) + text.strip()
        if name in RENAMED:
            env[f"MCPFORGE_{name.upper()}"] = env[f"MCPFORGE_{RENAMED[name].upper()}"] = text
        else:
            env[str(rng.choice([f"MCPFORGE_{name.upper()}", name.upper(), name]))] = text
    port = config.load_settings(env=env, env_file=None)
    ref = jax_config.load_settings(env=env, env_file=None)
    for name in TYPES:
        assert _same(getattr(port, name), _jax_value(ref, name)), name


# the settings the database-backed auth reads (users, the password policy,
# the resolution cache, CSRF, forced rotation, token usage, teams, SSO, SMTP,
# resets, the lockout, the audit trail)
AUTH_FIELDS = [
    "app_domain", "token_expiry", "password_min_length", "password_require_uppercase",
    "password_require_lowercase", "password_require_digit", "password_require_special",
    "password_max_length", "auth_cache_enabled", "auth_cache_user_ttl", "auth_cache_teams_ttl",
    "auth_cache_role_ttl", "auth_cache_revocation_ttl", "auth_cache_max_entries",
    "csrf_enabled", "csrf_trusted_origins_csv", "csrf_token_ttl_s", "csrf_cookie_name",
    "csrf_header_name", "csrf_cookie_secure", "csrf_exempt_paths_csv", "csrf_check_referer",
    "password_change_enforcement_enabled", "admin_require_password_change_on_bootstrap",
    "token_usage_logging_enabled", "token_usage_log_retention", "allow_team_creation",
    "allow_team_invitations", "allow_public_visibility", "default_team_member_role",
    "invitation_expiry_hours", "max_teams_per_user", "max_members_per_team", "sso_providers",
    "sso_trusted_domains_csv", "sso_require_admin_approval", "sso_auto_admin_domains_csv",
    "api_token_max_lifetime_minutes", "smtp_enabled", "smtp_host", "smtp_port", "smtp_user",
    "smtp_password", "smtp_from_email", "smtp_from_name", "smtp_use_tls", "smtp_use_ssl",
    "smtp_timeout_seconds", "account_lockout_notification_enabled",
    "team_invitation_email_enabled", "password_reset_enabled",
    "password_reset_token_expiry_minutes", "password_reset_rate_limit",
    "password_reset_rate_window_minutes", "password_reset_min_response_ms",
    "password_reset_invalidate_sessions", "auth_max_failed_attempts", "auth_lockout_seconds",
    "siem_export_url", "audit_enabled"]
CSV_PROPERTIES = ["csrf_trusted_origins", "csrf_exempt_paths", "sso_trusted_domains",
                  "sso_auto_admin_domains"]


@pytest.mark.parametrize("name", AUTH_FIELDS)
def test_auth_field_is_ported(name):
    """Each field of the auth families is a port field, read as JAX reads it
    from the environment (its own text, then the default)."""
    assert name in PORT_FIELDS
    text = _good(np.random.default_rng(len(name)), TYPES[name])
    env = {f"MCPFORGE_{name.upper()}": text}
    assert _same(getattr(config.load_settings(env=env, env_file=None), name),
                 getattr(jax_config.load_settings(env=env, env_file=None), name))
    assert _same(getattr(config.load_settings(env={}, env_file=None), name),
                 JAX_FIELDS[name].default)


@pytest.mark.parametrize("seed", SEEDS)
def test_auth_csv_properties_agree(seed):
    """The parsed forms of the comma lists (origins, exempt paths, SSO
    domains, lower-cased) equal JAX's for seeded lists."""
    rng = np.random.default_rng(200 + seed)
    words = ["https://App.example", " /auth/sso ", "", "Corp.EXAMPLE", "x.io ", ",", "/v1/"]
    env = {f"MCPFORGE_{prop.upper()}_CSV": ",".join(
        str(w) for w in rng.choice(words, size=int(rng.integers(0, 6))))
        for prop in CSV_PROPERTIES}
    port = config.load_settings(env=env, env_file=None)
    ref = jax_config.load_settings(env=env, env_file=None)
    for prop in CSV_PROPERTIES:
        assert getattr(port, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_refusals_agree(seed):
    """A malformed value for one field: both packages refuse the load."""
    rng = np.random.default_rng(100 + seed)
    names = [n for n, a in TYPES.items() if _bad(rng, a) is not None and n not in RENAMED]
    for name in rng.choice(names, size=16, replace=False):
        text = _bad(rng, TYPES[name])
        env = {f"MCPFORGE_{name.upper()}": text}
        with pytest.raises(ValueError):
            config.load_settings(env=env, env_file=None)
        with pytest.raises(ValueError):
            jax_config.load_settings(env=env, env_file=None)


@pytest.mark.parametrize("url", ["mysql://db", "sqlite://rel.db", "", "file:x.db",
                                 "SQLITE:///x.db", " sqlite:///x.db"])
def test_database_url_refusals_agree(url):
    for package in (config, jax_config):
        with pytest.raises(ValueError):
            package.load_settings(env={"database_url": url}, env_file=None)


@pytest.mark.parametrize("value", [1, 0, 1.0, True, 7, 2.5, None, "x", (1,)])
@pytest.mark.parametrize("name", ["tpu_local_max_batch", "slo_ttft_p95_ms", "dev_mode",
                                  "otel_exporter", "jwt_secret_key"])
def test_non_text_values_agree(name, value):
    """Values that are not text in the explicit dict (an int for a bool, a
    float for an int, ...): loaded equal, or refused by both."""
    results = []
    for package in (config, jax_config):
        try:
            results.append(getattr(package.load_settings(env={name: value}, env_file=None),
                                   name))
        except ValueError:
            results.append("refused")
    assert _same(results[0], results[1])


def test_construction_and_replace_validate():
    with pytest.raises(config.SettingsError, match="port"):
        config.Settings(port="eighty")
    settings = config.Settings()
    assert dataclasses.replace(settings, port="81").port == 81
    with pytest.raises(config.SettingsError, match="environment"):
        dataclasses.replace(settings, environment="staging")


# -- precedence, the .env file, the alias ----------------------------------


@pytest.mark.parametrize("case", ["explicit", "process", "file", "default", "bare_process",
                                  "alias", "alias_loses"])
def test_precedence_agrees(case, tmp_path, monkeypatch):
    env_file = tmp_path / ".env"
    env_file.write_text('# comment\nMCPFORGE_PORT="5001"\nTPU_LOCAL_MAX_BATCH=7\n'
                        "METRICS_BUFFER_FLUSH_INTERVAL='9.5'\nnot a line\n")
    explicit = None
    if case == "explicit":
        monkeypatch.setenv("MCPFORGE_PORT", "5002")
        explicit = {"PORT": "5003"}
    elif case == "process":
        monkeypatch.setenv("MCPFORGE_PORT", "5002")
    elif case == "default":
        env_file.write_text("")
    elif case == "bare_process":
        monkeypatch.setenv("PORT", "5009")   # a host var never reconfigures the gateway
        env_file.write_text("")
    elif case == "alias":
        monkeypatch.setenv("MCPFORGE_METRICS_BUFFER_FLUSH_INTERVAL", "3.25")
    elif case == "alias_loses":
        monkeypatch.setenv("MCPFORGE_METRICS_ROLLUP_INTERVAL_MINUTES", "1.5")
    port = config.load_settings(env=explicit, env_file=str(env_file))
    ref = jax_config.load_settings(env=explicit, env_file=str(env_file))
    for name in ("port", "tpu_local_max_batch", "metrics_rollup_interval_minutes"):
        assert _same(getattr(port, name), getattr(ref, name)), name


def test_missing_env_file_and_cache(tmp_path, monkeypatch):
    assert (config.load_settings(env_file=str(tmp_path / "absent"))
            == config.load_settings(env_file=None))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MCPFORGE_TPU_LOCAL_MODEL", "llama3-test")
    config.reset_settings_cache()
    try:
        assert config.get_settings().tpu_local_model == "llama3-test"
        monkeypatch.setenv("MCPFORGE_TPU_LOCAL_MODEL", "gemma-test")
        assert config.get_settings().tpu_local_model == "llama3-test"   # cached
        config.reset_settings_cache()
        assert config.get_settings().tpu_local_model == "gemma-test"
    finally:
        config.reset_settings_cache()


# -- security, derived properties, the engine config ------------------------

STRONG = "s3cure-and-long-enough-0123"


@pytest.mark.parametrize("environment", ["development", "production"])
@pytest.mark.parametrize("dev_mode", ["true", "false"])
@pytest.mark.parametrize("secrets", ["defaults", "strong", "short", "weak_case"])
def test_validate_security_agrees(environment, dev_mode, secrets):
    env = {"ENVIRONMENT": environment, "DEV_MODE": dev_mode}
    if secrets != "defaults":
        value = {"strong": STRONG, "short": "abc123", "weak_case": "ChangeMe"}[secrets]
        env.update(JWT_SECRET_KEY=value, AUTH_ENCRYPTION_SECRET=value,
                   BASIC_AUTH_PASSWORD=value, PLATFORM_ADMIN_PASSWORD=value)
    port = config.load_settings(env=env, env_file=None)
    ref = jax_config.load_settings(env=env, env_file=None)
    assert port.validate_security() == ref.validate_security()
    assert config.validate_security(ref) == ref.validate_security()


@pytest.mark.parametrize("slow_ms,http_ms", [("0", "1000"), ("250", "1000"), ("0", "40"),
                                             ("-5", "0")])
def test_slow_request_bar_agrees(slow_ms, http_ms):
    env = {"GW_SLOW_REQUEST_MS": slow_ms, "PERFORMANCE_THRESHOLD_HTTP_REQUEST_MS": http_ms}
    assert (config.load_settings(env=env, env_file=None).gw_slow_request_s
            == jax_config.load_settings(env=env, env_file=None).gw_slow_request_s)


EDGE_PROPERTIES = ("cors_origins", "cors_allowed_methods", "cors_allowed_headers",
                   "allowed_host_set", "deprecated_path_prefixes", "supported_protocol_versions",
                   "allowed_resource_mime_types")


@pytest.mark.parametrize("seed", SEEDS)
def test_edge_properties_agree(seed):
    """The properties the middleware chain and the catalog read over the
    csv fields: the same values over seeded lists (blanks, spaces, case,
    repeats and the protocol's own CORS headers among them)."""
    rng = np.random.default_rng(300 + seed)
    words = ["https://a.example", " *", "", "GET", "post ", "Host.Example", "mcp-session-id",
             "last-event-id", "x-a", "/legacy", "2025-06-18", "1999-01-01", "text/plain"]

    def csv() -> str:
        return str(rng.choice([",", ", ", " ,"])).join(
            str(w) for w in rng.choice(words, size=int(rng.integers(0, 6))))

    env = {name: csv() for name in ("CORS_ALLOWED_ORIGINS", "CORS_ALLOWED_METHODS_CSV",
                                    "CORS_ALLOWED_HEADERS_CSV", "ALLOWED_HOSTS",
                                    "DEPRECATED_PATH_PREFIXES_CSV",
                                    "SUPPORTED_PROTOCOL_VERSIONS_CSV",
                                    "ALLOWED_RESOURCE_MIME_TYPES_CSV")}
    port = config.load_settings(env=env, env_file=None)
    ref = jax_config.load_settings(env={f"MCPFORGE_{k}": v for k, v in env.items()},
                                   env_file=None)
    for name in EDGE_PROPERTIES:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_engine_config_from_either_settings(seed):
    """``EngineConfig.from_settings`` reads the port's settings as it reads
    the JAX ones, field by field; and the JAX engine config of the JAX
    settings names the same model and shapes."""
    rng = np.random.default_rng(200 + seed)
    env = {"TPU_LOCAL_MODEL": str(rng.choice(["llama3-test", "llama3-8b", "gemma-2b"])),
           "TPU_LOCAL_DTYPE": str(rng.choice(["bfloat16", "float32"])),
           "TPU_LOCAL_PAGE_SIZE": str(int(rng.choice([16, 64, 128]))),
           "TPU_LOCAL_NUM_PAGES": str(int(rng.integers(16, 1024))),
           "TPU_LOCAL_PREFILL_BUCKETS": "128,512 2048",
           "TPU_LOCAL_SUPERSTEP": str(int(rng.integers(1, 9))),
           "TPU_LOCAL_AUTO_RESTART": str(rng.choice(["yes", "0"])),
           "CONTROLLER_ENABLED": "true", "CONTROLLER_K_LADDER": "1, 4"}
    port = config.load_settings(env=env, env_file=None)
    ref = jax_config.load_settings(env=env, env_file=None)
    assert EngineConfig.from_settings(port) == EngineConfig.from_settings(ref)
    jax_cfg = JaxEngineConfig.from_settings(ref)
    cfg = EngineConfig.from_settings(port)
    for name in ("model", "dtype", "page_size", "num_pages", "prefill_buckets", "superstep",
                 "auto_restart", "k_ladder"):
        assert getattr(cfg, name) == getattr(jax_cfg, name), name


def test_port_imports_no_pydantic_and_provider_posts_lazily():
    """No module of the port imports pydantic; ``provider.py`` imports httpx
    only inside functions."""
    for path in (ROOT / "mcp_context_forge_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        roots = {alias.name.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.Import) for alias in node.names}
        roots |= {node.module.split(".")[0] for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) and node.level == 0}
        assert "pydantic" not in roots, path
    provider = ast.parse((ROOT / "mcp_context_forge_tpu_torch/tpu_local/provider.py").read_text())
    top = {alias.name for node in provider.body if isinstance(node, ast.Import)
           for alias in node.names}
    assert "httpx" not in top
