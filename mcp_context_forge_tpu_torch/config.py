"""The port's settings, on the standard library (the card has no pydantic).

A copy of the JAX package's ``config.py`` for the fields the port reads:
every field has the JAX ``Settings`` field's name, type and default, and
``load_settings`` hydrates it the same way, from an explicit dict, the
process's ``MCPFORGE_*`` environment and a ``.env`` file, coercing each
value as pydantic's lax mode does (``_coerce``) and refusing what it
refuses. Two fields are the port's own: ``torch_profile_dir`` and
``torch_profile_enabled``, the ``torch.profiler`` counterparts of the JAX
gateway's ``jax_profile_*``.

Everything that reads settings in the port is duck-typed, so a JAX
``Settings`` is accepted wherever this one is, and the other way round.
``validate_security`` refuses weak or default secrets outside dev mode.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import tempfile
import typing
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path
from typing import Any, Literal

_WEAK_SECRETS = {
    "", "changeme", "secret", "password", "my-test-key", "mysecretkey",
    "default", "admin", "test", "jwt-secret", "dev-only-do-not-use",
}

# renamed fields: the old env key keeps working as an alias, so an upgrade
# cannot silently revert an operator's tuning to defaults
_ALIASES = {"metrics_rollup_interval_minutes": "metrics_buffer_flush_interval"}

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
# what pydantic reads as an int or a float from text, after stripping the
# surrounding whitespace: digits with single underscores between them, an
# int's fraction only of zeros, a float's exponent, inf and nan
_INT_TEXT = re.compile(r"[+-]?\d+(?:_\d+)*(?:\.0+)?", re.ASCII)
_DIGITS = r"\d+(?:_\d+)*"
_FLOAT_TEXT = re.compile(
    rf"[+-]?(?:(?:{_DIGITS}(?:\.(?:{_DIGITS})?)?|\.{_DIGITS})(?:[eE][+-]?{_DIGITS})?"
    r"|inf|infinity|nan)", re.ASCII | re.IGNORECASE)


_DB_SCHEMES = ("sqlite:///", "sqlite+aiosqlite:///", "postgres://", "postgresql://")


class SettingsError(ValueError):
    """A value that the field's type refuses."""


@dataclass
class Settings:
    """Gateway and engine configuration; every field is env-overridable.
    Construction coerces and validates every field (``_coerce``)."""

    # --- identity / serving ---
    app_name: str = "MCP Context Forge TPU"
    host: str = "0.0.0.0"
    port: int = 4444
    environment: Literal["development", "production"] = "development"
    dev_mode: bool = True
    # --- persistence (``database_url``: sqlite:/// or postgresql://) ---
    database_url: str = "sqlite:///./mcpforge.db"
    db_pool_size: int = 8
    db_sqlite_busy_timeout_ms: int = 10000
    db_max_retries: int = 3               # on SQLITE_BUSY/locked
    db_retry_interval_ms: float = 50.0
    # --- coordination: the bus and leases of the gateway's workers ---
    bus_backend: Literal["memory", "file", "tcp"] = "memory"
    bus_dir: str = "/tmp/mcpforge-bus"
    bus_tcp_host: str = "127.0.0.1"
    bus_tcp_port: int = 7077
    bus_tcp_serve: bool = False  # this worker also hosts the hub
    bus_tcp_secret: str = ""     # hub auth; empty = fall back to jwt secret
    leader_lease_ttl: float = 15.0
    # --- multi-worker gateway scale-out ---
    gw_reuse_port: bool = False
    gw_listen_backlog: int = 1024
    gw_event_loop: str = ""
    gw_rpc_timeout_s: float = 30.0
    gw_stream_idle_timeout_s: float = 15.0
    gw_fleet_metrics: bool = False
    gw_fleet_metrics_interval_s: float = 2.0
    # --- distributed tenant rate limiter (coordination/ratelimit.py) ---
    gw_distributed_limiter: bool = True
    tenant_quota_burst_tokens: int = 2048
    tenant_quota_window_s: float = 0.0
    tenant_limiter_sync_interval_s: float = 0.25
    # --- shared engine plane ---
    tpu_local_pool_shared: bool = False
    # --- auth ---
    auth_required: bool = True
    jwt_secret_key: str = "dev-only-do-not-use"
    jwt_algorithm: Literal["HS256", "HS384", "HS512"] = "HS256"
    jwt_audience: str = "mcpforge-api"
    jwt_issuer: str = "mcpforge"
    basic_auth_user: str = "admin"
    basic_auth_password: str = "changeme"
    platform_admin_email: str = "admin@example.com"
    platform_admin_password: str = "changeme"
    auth_encryption_secret: str = "dev-only-do-not-use"
    app_domain: str = "http://localhost:4444"   # the base of mailed and SSO links
    token_expiry: int = 10080  # minutes
    # --- the password policy of local accounts ---
    password_min_length: int = 12
    password_require_uppercase: bool = True
    password_require_lowercase: bool = True
    password_require_digit: bool = True
    password_require_special: bool = False
    password_max_length: int = 256  # argon2 DoS guard
    # --- the auth resolution cache: TTLs bound the staleness of the users,
    # teams, roles and revocation reads; the writes that must show on the
    # next request invalidate ---
    auth_cache_enabled: bool = True
    auth_cache_user_ttl: float = 30.0
    auth_cache_teams_ttl: float = 30.0
    auth_cache_role_ttl: float = 30.0
    auth_cache_revocation_ttl: float = 30.0
    auth_cache_max_entries: int = 4096
    # --- CSRF and forced password rotation ---
    csrf_enabled: bool = True
    csrf_trusted_origins_csv: str = ""   # extra allowed Origin values
    csrf_token_ttl_s: float = 8 * 3600.0
    csrf_cookie_name: str = "csrf_token"
    csrf_header_name: str = "X-CSRF-Token"
    csrf_cookie_secure: bool = False     # set true behind TLS
    csrf_exempt_paths_csv: str = ""      # exact-or-prefix exemptions
    # fail-closed Origin/Referer requirement for ambient-credential
    # mutations: off by default, it refuses Basic clients that send neither
    csrf_check_referer: bool = False
    password_change_enforcement_enabled: bool = True
    admin_require_password_change_on_bootstrap: bool = False
    # --- API token usage accounting ---
    token_usage_logging_enabled: bool = True
    token_usage_log_retention: int = 10000   # rows kept per maintenance pass
    # --- teams (0 = unlimited caps) ---
    allow_team_creation: bool = True
    allow_team_invitations: bool = True
    allow_public_visibility: bool = True
    default_team_member_role: str = "member"
    invitation_expiry_hours: float = 72.0
    max_teams_per_user: int = 50
    max_members_per_team: int = 100
    # --- SSO provisioning (providers: a JSON list of {name, issuer,
    # client_id, client_secret, ...}) ---
    sso_providers: str = ""
    sso_trusted_domains_csv: str = ""     # ""=any; else allowlist
    sso_require_admin_approval: bool = False  # provision deactivated
    sso_auto_admin_domains_csv: str = ""  # domains granted is_admin
    api_token_max_lifetime_minutes: float = 0.0  # 0 = unlimited
    # --- SMTP notifications ---
    smtp_enabled: bool = False
    smtp_host: str = ""
    smtp_port: int = 587
    smtp_user: str = ""
    smtp_password: str = ""
    smtp_from_email: str = "noreply@localhost"
    smtp_from_name: str = "MCP Gateway"
    smtp_use_tls: bool = True     # STARTTLS on a plain connection
    smtp_use_ssl: bool = False    # implicit TLS (SMTPS, port 465)
    smtp_timeout_seconds: float = 10.0
    account_lockout_notification_enabled: bool = False
    team_invitation_email_enabled: bool = True  # only fires when smtp is on
    # --- password reset ---
    password_reset_enabled: bool = False
    password_reset_token_expiry_minutes: float = 60.0
    password_reset_rate_limit: int = 3          # requests per window/email
    password_reset_rate_window_minutes: float = 60.0
    password_reset_min_response_ms: float = 100.0  # user-enumeration guard
    password_reset_invalidate_sessions: bool = True
    # --- account lockout ---
    auth_max_failed_attempts: int = 5
    auth_lockout_seconds: float = 300.0
    # --- audit trail and its SIEM export ('' = no export) ---
    siem_export_url: str = ""
    audit_enabled: bool = True
    # --- outbound/identity plumbing ---
    auth_header_name: str = "authorization"  # custom ingress auth header
    # --- correlation ids ---
    correlation_id_header: str = "x-correlation-id"
    correlation_id_response_header: str = "x-correlation-id"
    correlation_id_preserve: bool = True  # honor inbound ids; else mint
    # --- performance tracking ---
    performance_threshold_http_request_ms: float = 1000.0
    # --- file logging + rotation ---
    log_to_file: bool = False
    log_folder: str = "logs"
    log_file: str = "mcpforge.log"
    log_rotation_enabled: bool = False
    log_max_size_mb: float = 1.0
    log_backup_count: int = 5
    # --- the HTTP edge: the middleware chain's own settings ---
    trust_proxy_headers: bool = False     # honor X-Forwarded-For from the LB
    cors_allowed_origins: str = ""        # csv; "*" = any; "" = CORS off
    cors_allowed_methods_csv: str = "GET,POST,PUT,DELETE,OPTIONS"
    cors_allowed_headers_csv: str = ("authorization,content-type,"
                                     "mcp-protocol-version,mcp-session-id,"
                                     "x-correlation-id,x-csrf-token")
    cors_max_age_s: int = 600
    cors_allow_credentials: bool = False
    allowed_hosts: str = ""               # csv of allowed Host headers; "" = any
    # the JAX Settings declares max_header_bytes twice; pydantic keeps the
    # second declaration, 64 KiB (0 = unlimited)
    max_header_bytes: int = 64 * 1024
    max_header_count: int = 128           # 431 past this many fields
    max_header_field_bytes: int = 16384   # 431 past this per-field size
    rate_limit_rps: int = 0               # 0 = disabled
    rate_limit_burst: int = 200
    compression_enabled: bool = True
    compression_min_bytes: int = 1024
    deprecated_path_prefixes_csv: str = ""
    legacy_api_sunset_date: str = ""      # RFC 8594 Sunset, e.g. an HTTP date
    db_query_logging: bool = False
    db_query_logging_slow_ms: float = 100.0  # WARN above this per query
    db_query_n1_threshold: int = 3           # same-shape repeats => suspect
    # --- MCP protocol and the streamable-HTTP transport ---
    protocol_version: str = "2025-06-18"
    supported_protocol_versions_csv: str = "2025-06-18,2025-03-26,2024-11-05"
    streamable_http_stateful: bool = False
    sse_keepalive_interval: float = 30.0
    session_ttl: int = 3600
    max_request_size_bytes: int = 8 * 1024 * 1024
    # --- the resource and prompt catalog ---
    max_resource_size: int = 4 * 1024 * 1024
    allowed_resource_mime_types_csv: str = ""  # "" = any
    max_prompt_size: int = 1024 * 1024
    # --- cursor pages and the registry's TTL cache of the list routes ---
    pagination_default_page_size: int = 50
    pagination_max_page_size: int = 500
    pagination_min_page_size: int = 1
    pagination_include_links: bool = False  # RFC 8288-style next link
    registry_cache_enabled: bool = False
    registry_cache_default_ttl_s: float = 30.0
    registry_cache_tools_ttl_s: float = 30.0
    registry_cache_resources_ttl_s: float = 30.0
    registry_cache_prompts_ttl_s: float = 30.0
    registry_cache_servers_ttl_s: float = 30.0
    registry_cache_gateways_ttl_s: float = 30.0
    # --- entity field limits of the catalog's create and update bodies ---
    validation_max_name_length: int = 255
    validation_max_description_length: int = 8192
    validation_max_url_length: int = 2048
    validation_max_tag_length: int = 64
    validation_max_tags: int = 32
    # --- the services that call the engine: the chat agent's steps per turn,
    # the A2A registry's cap (0 = unlimited) ---
    llmchat_max_steps: int = 6
    a2a_max_agents: int = 100
    # --- the SSRF guard of catalog URLs (off: localhost upstreams are the
    # common single-host posture) ---
    ssrf_protection_enabled: bool = False
    ssrf_allow_localhost: bool = True
    ssrf_allow_private_networks: bool = True
    ssrf_blocked_hosts_csv: str = ""
    ssrf_allowed_networks_csv: str = ""    # an explicit allow beats every block
    ssrf_blocked_networks_csv: str = ""
    ssrf_dns_fail_closed: bool = True
    # --- outbound HTTP (the services' shared clients) and federation ---
    tool_timeout: float = 60.0
    outbound_pool_limit: int = 1024
    outbound_pool_limit_per_host: int = 0
    max_tool_retries: int = 3
    retry_base_delay: float = 0.25
    retry_max_delay: float = 8.0
    gateway_health_interval: float = 60.0
    gateway_failure_threshold: int = 3
    max_concurrent_health_checks: int = 10  # the health loop's fan-out bound
    federation_timeout: float = 30.0
    gateway_validation_timeout: float = 10.0  # the registration wizard's probe
    skip_ssl_verify: bool = False
    http_max_connections: int = 512
    http_max_keepalive: int = 128
    http_connect_timeout: float = 10.0
    # --- TLS: serving + outbound contexts ---
    ssl_enabled: bool = False     # serve HTTPS (cert+key below)
    ssl_cert_file: str = ""
    ssl_key_file: str = ""
    ssl_ca_bundle: str = ""       # custom CA bundle for OUTBOUND verification
    # --- pooled upstream MCP sessions ---
    upstream_max_sessions: int = 128
    upstream_idle_ttl: float = 300.0
    # --- external (out-of-process) plugin servers: a hook call's timeout ---
    external_plugin_timeout: float = 10.0
    # --- header passthrough onto upstream calls (off; credentials never
    # ride the global default list unless the sensitive flag is on) ---
    enable_header_passthrough: bool = False
    default_passthrough_headers: str = "x-tenant-id,x-trace-id"
    enable_overwrite_base_headers: bool = False
    enable_sensitive_header_passthrough: bool = False
    # --- admin log search ring buffer ---
    log_buffer_capacity: int = 5000
    # --- plugins ---
    plugins_enabled: bool = True
    plugin_config_file: str = "plugins/config.yaml"
    # --- observability ---
    otel_enable: bool = True
    otel_exporter: Literal["none", "console", "otlp", "memory"] = "memory"
    otel_service_name: str = "mcpforge"
    otel_otlp_endpoint: str = ""   # e.g. http://collector:4318 (OTLP/HTTP)
    otel_otlp_headers: str = ""    # JSON object of extra headers
    otel_otlp_retry_max: int = 3
    # --- request forensics plane ---
    trace_store_enabled: bool = True
    trace_store_max_traces: int = 512
    trace_store_max_spans: int = 256
    trace_store_sample_every: int = 32       # 0 = no background sample
    trace_store_slowest_per_key: int = 4     # per route AND per tenant
    trace_store_idle_finalize_s: float = 30.0
    metrics_exemplars: bool = True
    # the opt-in torch.profiler capture behind /admin/engine/profile*: the
    # routes 404 unless enabled, and the Chrome trace lands in this
    # server-configured directory only (the JAX gateway's jax_profile_*)
    torch_profile_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "mcpforge-torchprof"))
    torch_profile_enabled: bool = False
    log_level: str = "INFO"
    log_json: bool = False
    # renamed from metrics_buffer_flush_interval, whose key stays an alias
    metrics_rollup_interval_minutes: float = 5.0
    # --- LLM / tpu_local ---
    llm_api_prefix: str = "/v1"
    tpu_local_model: str = "llama3-tiny"
    tpu_local_checkpoint: str = ""  # HF safetensors or params.pt dir; "" = random init
    tpu_local_max_batch: int = 64
    tpu_local_max_seq_len: int = 2048
    tpu_local_page_size: int = 128
    tpu_local_num_pages: int = 512
    tpu_local_prefill_buckets: tuple[int, ...] = (128, 512, 2048)
    tpu_local_prefill_max_batch: int = 4  # admissions fused into one prefill
    tpu_local_mesh_shape: str = ""  # 'DxM'; '' = one device, no process group
    tpu_local_sp_impl: Literal["none", "ring", "ulysses"] = "none"
    tpu_local_sp_threshold: int = 1024  # prefill BUCKETS > this use SP prefill
    tpu_local_decode_block: int = 1     # decode steps fused per dispatch
    tpu_local_superstep: int = 1
    tpu_local_decode_overlap: bool = True
    tpu_local_dtype: str = "bfloat16"
    tpu_local_embedding_model: str = "encoder-tiny"
    tpu_local_init_timeout_s: float = 120.0
    tpu_local_prefix_cache: bool = True
    tpu_local_prefix_tiers: bool = False
    tpu_local_tier_host_bytes: int = 256 * 1024 * 1024
    tpu_local_tier_disk_bytes: int = 1024 * 1024 * 1024
    tpu_local_tier_disk_dir: str = ""  # "" = private tempdir per store
    tpu_local_tier_spill_quant: str = "int8"
    tpu_local_tier_object_url: str = ""
    tpu_local_fabric_namespace: str = "shared"
    tpu_local_fabric_advert_interval_s: float = 2.0
    tpu_local_fabric_advert_ttl_s: float = 300.0
    tpu_local_fabric_peers: str = ""
    tpu_local_spec_decode: bool = False
    tpu_local_spec_k: int = 4
    tpu_local_spec_ngram: int = 2
    tpu_local_quant: str = ""
    tpu_local_kv_quant: str = ""
    tpu_local_moe_impl: str = ""  # ""=model default | dense | grouped | grouped_pallas
    tpu_local_batch_buckets: bool = False
    tpu_local_classify_window: int = 128
    tpu_local_classify_coverage: str = "full"
    tpu_local_classify_max_windows: int = 8
    tpu_local_classify_cache_size: int = 8192
    tpu_local_encoder_max_batch: int = 32
    tpu_local_encoder_max_wait_ms: float = 2.0
    tpu_local_encoder_min_seq: int = 32
    tpu_local_max_queue: int = 1024
    tpu_local_auto_restart: bool = False
    tpu_local_auto_restart_max: int = 3
    tpu_local_step_log_size: int = 256
    # --- decode-step attribution & live roofline ---
    tpu_local_step_sample_every: int = 0
    tpu_local_cost_analysis: bool = True
    # --- serving SLOs (GET /admin/slo, observability/slo.py) ---
    slo_ttft_p95_ms: float = 2500.0
    slo_tpot_p95_ms: float = 250.0
    slo_queue_wait_p95_ms: float = 1500.0
    slo_http_p95_ms: float = 1000.0
    slo_error_budget: float = 0.05
    # --- SLO classes + tenant metering ---
    slo_classes: str = ""
    slo_tenant_classes: str = ""
    tenant_metering_enabled: bool = True
    tenant_label_clamp: int = 8
    tenant_ledger_max_tenants: int = 512
    tenant_usage_rollup_interval_s: float = 60.0
    tenant_quota_tokens_per_window: int = 0
    # windows a database outage could not flush; past it the oldest drops
    tenant_rollup_pending_max: int = 8
    # --- gateway flight recorder & loop health ---
    gw_flight_recorder_enabled: bool = True
    gw_flight_ring_size: int = 256
    gw_flight_slowest_size: int = 32
    gw_slow_request_ms: float = 0.0
    gw_loop_lag_interval_s: float = 0.25
    gw_loop_lag_warn_ms: float = 250.0
    gw_backpressure_headers: bool = True
    gw_backpressure_retry_after_at: float = 0.8
    # --- fault injection + graceful degradation ---
    fault_injection_enabled: bool = False
    fault_rules: str = ""
    degradation_failure_threshold: int = 3
    degradation_cooldown_s: float = 5.0
    tier_io_retry_max: int = 2
    tier_io_retry_backoff_ms: float = 10.0
    gw_shed_enabled: bool = True
    gw_shed_saturation_at: float = 0.95
    gw_shed_class_order: str = ""
    gw_stream_first_chunk_wait_s: float = 1.0
    # --- closed-loop serving controller ---
    controller_enabled: bool = False
    controller_safe_mode: bool = False
    controller_tick_s: float = 1.0
    controller_cooldown_s: float = 10.0
    controller_eval_window_s: float = 5.0
    controller_hysteresis: float = 0.1
    controller_ring_size: int = 256
    controller_k_ladder: tuple[int, ...] = ()
    controller_queue_wait_high_ms: float = 500.0
    controller_queue_wait_low_ms: float = 50.0
    controller_idle_frac_high: float = 0.35
    controller_spec_accept_off: float = 0.5
    controller_spec_accept_on: float = 1.0
    controller_burn_high: float = 1.0
    controller_burn_low: float = 0.25
    controller_shed_floor: float = 0.5
    controller_shed_step: float = 0.05
    # --- live signal bus ---
    signal_window: int = 64
    signal_ewma_alpha: float = 0.3
    # --- engine replica pool (tpu_local/pool/, docs/serving_pool.md) ---
    tpu_local_replicas: int = 1
    tpu_local_pool_affinity_routing: bool = True
    tpu_local_pool_health_interval_s: float = 0.5
    tpu_local_pool_heartbeat_timeout_s: float = 10.0
    tpu_local_pool_requeue_max: int = 2
    tpu_local_pool_roles: str = ""
    tpu_local_disagg_prompt_tokens: int = 64
    tpu_local_pool_role_penalty_tokens: int = 256

    def __post_init__(self) -> None:
        for name, annotation in _field_types().items():
            object.__setattr__(self, name, _coerce(name, annotation, getattr(self, name)))
        if not self.database_url.startswith(_DB_SCHEMES):
            raise SettingsError(
                "database_url: database URL must be sqlite:/// or postgresql:// "
                "(reference config.py:14 dual-DB support)")

    @property
    def is_postgres(self) -> bool:
        return self.database_url.startswith(("postgres://", "postgresql://"))

    @property
    def gw_slow_request_s(self) -> float:
        """Effective slow-request bar in seconds: the dedicated knob, or the
        HTTP threshold of the performance tracker when unset."""
        ms = self.gw_slow_request_ms or self.performance_threshold_http_request_ms
        return max(0.0, ms) / 1e3

    @staticmethod
    def _csv(raw: str) -> tuple[str, ...]:
        return tuple(v.strip() for v in raw.split(",") if v.strip())

    @property
    def cors_origins(self) -> set[str]:
        return set(self._csv(self.cors_allowed_origins))

    @property
    def cors_allowed_methods(self) -> str:
        return ", ".join(self._csv(self.cors_allowed_methods_csv))

    @property
    def cors_allowed_headers(self) -> str:
        """The configured headers and the two the protocol needs, once each."""
        merged = list(self._csv(self.cors_allowed_headers_csv))
        for required in ("mcp-session-id", "last-event-id"):
            if required not in merged:
                merged.append(required)
        return ", ".join(merged)

    @property
    def allowed_host_set(self) -> set[str]:
        return {h.lower() for h in self._csv(self.allowed_hosts)}

    @property
    def deprecated_path_prefixes(self) -> tuple[str, ...]:
        return self._csv(self.deprecated_path_prefixes_csv)

    @property
    def supported_protocol_versions(self) -> set[str]:
        return set(self._csv(self.supported_protocol_versions_csv))

    @property
    def allowed_resource_mime_types(self) -> tuple[str, ...]:
        return self._csv(self.allowed_resource_mime_types_csv)

    @property
    def csrf_trusted_origins(self) -> tuple[str, ...]:
        return self._csv(self.csrf_trusted_origins_csv)

    @property
    def csrf_exempt_paths(self) -> tuple[str, ...]:
        return self._csv(self.csrf_exempt_paths_csv)

    @property
    def sso_trusted_domains(self) -> tuple[str, ...]:
        return tuple(d.lower() for d in self._csv(self.sso_trusted_domains_csv))

    @property
    def sso_auto_admin_domains(self) -> tuple[str, ...]:
        return tuple(d.lower() for d in self._csv(self.sso_auto_admin_domains_csv))

    def validate_security(self) -> list[str]:
        return validate_security(self)


@lru_cache(maxsize=1)
def _field_types() -> dict[str, Any]:
    hints = typing.get_type_hints(Settings)
    return {f.name: hints[f.name] for f in dataclasses.fields(Settings)}


def _to_int(value: Any) -> int:
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, int):
        return value
    if isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(value, str):
        text = value.strip()
        if _INT_TEXT.fullmatch(text):
            return int(text.split(".")[0])
    raise SettingsError(f"{value!r} is not a valid integer")


def _to_float(value: Any) -> float:
    if isinstance(value, (bool, int, float)):
        return float(value)
    if isinstance(value, str):
        text = value.strip()
        if _FLOAT_TEXT.fullmatch(text):
            return float(text)
    raise SettingsError(f"{value!r} is not a valid number")


def _to_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)) and value in (0, 1):
        return bool(value)
    if isinstance(value, str):
        if value.lower() in _TRUE:
            return True
        if value.lower() in _FALSE:
            return False
    raise SettingsError(f"{value!r} is not a valid boolean")


def _coerce(name: str, annotation: Any, value: Any) -> Any:
    """``value`` as the field's type, as pydantic's lax mode reads it:
    bools from 0/1 and the words of ``_TRUE``/``_FALSE`` in any case, ints
    and floats from text (``_INT_TEXT``, ``_FLOAT_TEXT``), a ``Literal`` by
    exact equality, a str only from a str, an int tuple from a tuple or list
    of ints. Raises ``SettingsError`` naming the field."""
    try:
        if typing.get_origin(annotation) is Literal:
            choices = typing.get_args(annotation)
            if not (isinstance(value, str) and value in choices):
                raise SettingsError(f"{value!r} is not one of {list(choices)}")
            return value
        if typing.get_origin(annotation) is tuple:
            if not isinstance(value, (tuple, list)):
                raise SettingsError(f"{value!r} is not a tuple")
            return tuple(_to_int(v) for v in value)
        if annotation is bool:
            return _to_bool(value)
        if annotation is int:
            return _to_int(value)
        if annotation is float:
            return _to_float(value)
        if not isinstance(value, str):
            raise SettingsError(f"{value!r} is not a string")
        return value
    except SettingsError as exc:
        raise SettingsError(f"{name}: {exc}") from None


def validate_security(settings: Any) -> list[str]:
    """The fatal security problems of ``settings`` (duck-typed; empty =
    OK): outside dev mode (or in production) every secret and password
    must be neither a known weak value nor short."""
    problems: list[str] = []
    if settings.environment == "production" or not settings.dev_mode:
        if settings.jwt_secret_key.lower() in _WEAK_SECRETS or len(settings.jwt_secret_key) < 16:
            problems.append("jwt_secret_key is weak/default")
        if (settings.auth_encryption_secret.lower() in _WEAK_SECRETS
                or len(settings.auth_encryption_secret) < 16):
            problems.append("auth_encryption_secret is weak/default")
        if (settings.basic_auth_password.lower() in _WEAK_SECRETS
                or len(settings.basic_auth_password) < 8):
            problems.append("basic_auth_password is weak/default")
        if (settings.platform_admin_password.lower() in _WEAK_SECRETS
                or len(settings.platform_admin_password) < 8):
            problems.append("platform_admin_password is weak/default")
    return problems


def _load_env_file(path: Path) -> dict[str, str]:
    out: dict[str, str] = {}
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, _, v = line.partition("=")
        out[k.strip()] = v.strip().strip('"').strip("'")
    return out


def load_settings(env: dict[str, str] | None = None, env_file: str | None = ".env") -> Settings:
    """Build Settings from (explicit env dict | process env | .env file).

    Precedence (highest first): explicit ``env`` dict (keys ``MCPFORGE_X``,
    ``X`` or bare ``x``) > process environment (``MCPFORGE_X`` only, so
    unrelated host vars like ``PORT``/``ENVIRONMENT`` cannot reconfigure the
    gateway) > .env file (``MCPFORGE_X`` or ``X``) > field defaults. A tuple
    field reads a comma- or space-separated list of ints.
    """
    file_source = _load_env_file(Path(env_file)) if env_file else {}
    explicit = env or {}

    def lookup(name: str) -> Any:
        upper = f"MCPFORGE_{name.upper()}"
        for key in (upper, name.upper(), name):
            if key in explicit:
                return explicit[key]
        if upper in os.environ:
            return os.environ[upper]
        for key in (upper, name.upper()):
            if key in file_source:
                return file_source[key]
        return None

    values: dict[str, Any] = {}
    for name, annotation in _field_types().items():
        raw = lookup(name)
        if raw is None and name in _ALIASES:
            raw = lookup(_ALIASES[name])
            if raw is not None:
                logging.getLogger(__name__).warning(
                    "config: MCPFORGE_%s is deprecated; use MCPFORGE_%s",
                    _ALIASES[name].upper(), name.upper())
        if raw is None:
            continue
        if typing.get_origin(annotation) is tuple:
            values[name] = tuple(int(x) for x in str(raw).replace(",", " ").split())
        else:
            values[name] = raw
    return Settings(**values)


@lru_cache(maxsize=1)
def get_settings() -> Settings:
    return load_settings()


def reset_settings_cache() -> None:
    get_settings.cache_clear()
