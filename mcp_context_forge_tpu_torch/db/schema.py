"""Schema migrations (a copy of the JAX package's ``db/schema.py``: the same
``MIGRATIONS``, every table and index as it writes them, so that a
database either package migrated opens in the other).

The core model families of the gateway (tools, resources, prompts, servers,
gateways, A2A agents, users and teams, roles, metrics, observability, LLM
providers and models, the audit trail, plugin bindings, tenant usage
rollups) as sqlite DDL. JSON-valued columns are TEXT holding canonical
JSON.
"""

from __future__ import annotations

from .core import Migration

_V1 = """
CREATE TABLE IF NOT EXISTS gateways (
  id TEXT PRIMARY KEY,
  name TEXT NOT NULL UNIQUE,
  url TEXT NOT NULL,
  description TEXT,
  transport TEXT NOT NULL DEFAULT 'streamablehttp',  -- streamablehttp|sse
  auth_type TEXT,                                    -- none|basic|bearer|headers|oauth
  auth_value TEXT,                                   -- encrypted JSON
  capabilities TEXT,                                 -- JSON from initialize
  enabled INTEGER NOT NULL DEFAULT 1,
  reachable INTEGER NOT NULL DEFAULT 0,
  state TEXT NOT NULL DEFAULT 'pending',             -- pending|active|failed|deleting
  failure_count INTEGER NOT NULL DEFAULT 0,
  last_seen REAL,
  passthrough_headers TEXT,                          -- JSON list
  tags TEXT,                                         -- JSON list
  team_id TEXT,
  owner_email TEXT,
  visibility TEXT NOT NULL DEFAULT 'public',
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS tools (
  id TEXT PRIMARY KEY,
  original_name TEXT NOT NULL,
  custom_name TEXT,
  display_name TEXT,
  description TEXT,
  integration_type TEXT NOT NULL DEFAULT 'MCP',      -- MCP|REST|A2A|GRPC
  request_type TEXT NOT NULL DEFAULT 'POST',
  url TEXT,
  input_schema TEXT,                                 -- JSON schema
  output_schema TEXT,
  annotations TEXT,                                  -- JSON
  headers TEXT,                                      -- JSON
  auth_type TEXT,
  auth_value TEXT,                                   -- encrypted JSON
  jsonpath_filter TEXT,
  gateway_id TEXT REFERENCES gateways(id) ON DELETE CASCADE,
  enabled INTEGER NOT NULL DEFAULT 1,
  reachable INTEGER NOT NULL DEFAULT 1,
  tags TEXT,
  team_id TEXT,
  owner_email TEXT,
  visibility TEXT NOT NULL DEFAULT 'public',
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE UNIQUE INDEX IF NOT EXISTS ix_tools_name_gateway
  ON tools(original_name, COALESCE(gateway_id, ''));
CREATE INDEX IF NOT EXISTS ix_tools_gateway ON tools(gateway_id);

CREATE TABLE IF NOT EXISTS resources (
  id TEXT PRIMARY KEY,
  uri TEXT NOT NULL,
  name TEXT NOT NULL,
  description TEXT,
  mime_type TEXT,
  uri_template TEXT,
  content TEXT,                                      -- inline content (text or b64)
  is_binary INTEGER NOT NULL DEFAULT 0,
  size INTEGER,
  gateway_id TEXT REFERENCES gateways(id) ON DELETE CASCADE,
  enabled INTEGER NOT NULL DEFAULT 1,
  tags TEXT,
  team_id TEXT,
  owner_email TEXT,
  visibility TEXT NOT NULL DEFAULT 'public',
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE UNIQUE INDEX IF NOT EXISTS ix_resources_uri_gateway
  ON resources(uri, COALESCE(gateway_id, ''));

CREATE TABLE IF NOT EXISTS prompts (
  id TEXT PRIMARY KEY,
  name TEXT NOT NULL,
  description TEXT,
  template TEXT NOT NULL,
  arguments TEXT,                                    -- JSON list of {name,description,required}
  gateway_id TEXT REFERENCES gateways(id) ON DELETE CASCADE,
  enabled INTEGER NOT NULL DEFAULT 1,
  tags TEXT,
  team_id TEXT,
  owner_email TEXT,
  visibility TEXT NOT NULL DEFAULT 'public',
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE UNIQUE INDEX IF NOT EXISTS ix_prompts_name_gateway
  ON prompts(name, COALESCE(gateway_id, ''));

CREATE TABLE IF NOT EXISTS servers (
  id TEXT PRIMARY KEY,
  name TEXT NOT NULL UNIQUE,
  description TEXT,
  icon TEXT,
  enabled INTEGER NOT NULL DEFAULT 1,
  tags TEXT,
  team_id TEXT,
  owner_email TEXT,
  visibility TEXT NOT NULL DEFAULT 'public',
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS server_tools (
  server_id TEXT NOT NULL REFERENCES servers(id) ON DELETE CASCADE,
  tool_id TEXT NOT NULL REFERENCES tools(id) ON DELETE CASCADE,
  PRIMARY KEY (server_id, tool_id)
);
CREATE TABLE IF NOT EXISTS server_resources (
  server_id TEXT NOT NULL REFERENCES servers(id) ON DELETE CASCADE,
  resource_id TEXT NOT NULL REFERENCES resources(id) ON DELETE CASCADE,
  PRIMARY KEY (server_id, resource_id)
);
CREATE TABLE IF NOT EXISTS server_prompts (
  server_id TEXT NOT NULL REFERENCES servers(id) ON DELETE CASCADE,
  prompt_id TEXT NOT NULL REFERENCES prompts(id) ON DELETE CASCADE,
  PRIMARY KEY (server_id, prompt_id)
);

CREATE TABLE IF NOT EXISTS a2a_agents (
  id TEXT PRIMARY KEY,
  name TEXT NOT NULL UNIQUE,
  slug TEXT NOT NULL UNIQUE,
  description TEXT,
  endpoint_url TEXT NOT NULL,
  agent_type TEXT NOT NULL DEFAULT 'jsonrpc',        -- jsonrpc|openai|anthropic|custom|tpu_local
  protocol_version TEXT NOT NULL DEFAULT '1.0',
  capabilities TEXT,
  config TEXT,
  auth_type TEXT,
  auth_value TEXT,
  enabled INTEGER NOT NULL DEFAULT 1,
  reachable INTEGER NOT NULL DEFAULT 1,
  tags TEXT,
  team_id TEXT,
  owner_email TEXT,
  visibility TEXT NOT NULL DEFAULT 'public',
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS users (
  email TEXT PRIMARY KEY,
  password_hash TEXT NOT NULL,
  full_name TEXT,
  is_admin INTEGER NOT NULL DEFAULT 0,
  is_active INTEGER NOT NULL DEFAULT 1,
  auth_provider TEXT NOT NULL DEFAULT 'local',
  failed_login_attempts INTEGER NOT NULL DEFAULT 0,
  locked_until REAL,
  last_login REAL,
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS teams (
  id TEXT PRIMARY KEY,
  name TEXT NOT NULL,
  slug TEXT NOT NULL UNIQUE,
  description TEXT,
  is_personal INTEGER NOT NULL DEFAULT 0,
  visibility TEXT NOT NULL DEFAULT 'private',
  created_by TEXT,
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS team_members (
  team_id TEXT NOT NULL REFERENCES teams(id) ON DELETE CASCADE,
  user_email TEXT NOT NULL REFERENCES users(email) ON DELETE CASCADE,
  role TEXT NOT NULL DEFAULT 'member',               -- owner|member
  joined_at REAL NOT NULL,
  PRIMARY KEY (team_id, user_email)
);
CREATE TABLE IF NOT EXISTS team_invitations (
  id TEXT PRIMARY KEY,
  team_id TEXT NOT NULL REFERENCES teams(id) ON DELETE CASCADE,
  email TEXT NOT NULL,
  role TEXT NOT NULL DEFAULT 'member',
  token TEXT NOT NULL UNIQUE,
  invited_by TEXT,
  expires_at REAL NOT NULL,
  accepted_at REAL,
  created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS roles (
  id TEXT PRIMARY KEY,
  name TEXT NOT NULL UNIQUE,
  description TEXT,
  scope TEXT NOT NULL DEFAULT 'global',              -- global|team
  permissions TEXT NOT NULL,                         -- JSON list
  is_system INTEGER NOT NULL DEFAULT 0,
  created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS user_roles (
  user_email TEXT NOT NULL,
  role_id TEXT NOT NULL REFERENCES roles(id) ON DELETE CASCADE,
  scope_id TEXT NOT NULL DEFAULT '',                 -- team id when scope=team
  granted_by TEXT,
  granted_at REAL NOT NULL,
  PRIMARY KEY (user_email, role_id, scope_id)
);

CREATE TABLE IF NOT EXISTS api_tokens (
  id TEXT PRIMARY KEY,
  user_email TEXT NOT NULL,
  name TEXT NOT NULL,
  jti TEXT NOT NULL UNIQUE,
  token_hash TEXT NOT NULL,
  server_id TEXT,                                    -- server-scoped token
  permissions TEXT,                                  -- JSON scope list
  team_id TEXT,
  expires_at REAL,
  last_used REAL,
  revoked_at REAL,
  created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS tool_metrics (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  tool_id TEXT NOT NULL,
  ts REAL NOT NULL,
  duration_ms REAL NOT NULL,
  success INTEGER NOT NULL,
  error TEXT
);
CREATE INDEX IF NOT EXISTS ix_tool_metrics_tool_ts ON tool_metrics(tool_id, ts);
CREATE TABLE IF NOT EXISTS metrics_rollups (
  entity_type TEXT NOT NULL,
  entity_id TEXT NOT NULL,
  hour INTEGER NOT NULL,
  count INTEGER NOT NULL,
  errors INTEGER NOT NULL,
  total_ms REAL NOT NULL,
  min_ms REAL,
  max_ms REAL,
  PRIMARY KEY (entity_type, entity_id, hour)
);

CREATE TABLE IF NOT EXISTS observability_traces (
  trace_id TEXT PRIMARY KEY,
  name TEXT NOT NULL,
  start_ts REAL NOT NULL,
  end_ts REAL,
  status TEXT,
  attributes TEXT
);
CREATE TABLE IF NOT EXISTS observability_spans (
  span_id TEXT PRIMARY KEY,
  trace_id TEXT NOT NULL,
  parent_span_id TEXT,
  name TEXT NOT NULL,
  start_ts REAL NOT NULL,
  end_ts REAL,
  status TEXT,
  attributes TEXT
);
CREATE INDEX IF NOT EXISTS ix_obs_spans_trace ON observability_spans(trace_id);

CREATE TABLE IF NOT EXISTS llm_providers (
  id TEXT PRIMARY KEY,
  name TEXT NOT NULL UNIQUE,
  provider_type TEXT NOT NULL,                       -- tpu_local|openai|anthropic|openai_compatible|...
  api_base TEXT,
  config TEXT,                                       -- encrypted JSON
  enabled INTEGER NOT NULL DEFAULT 1,
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS llm_models (
  id TEXT PRIMARY KEY,
  provider_id TEXT NOT NULL REFERENCES llm_providers(id) ON DELETE CASCADE,
  model_id TEXT NOT NULL,                            -- provider-side id
  alias TEXT NOT NULL UNIQUE,                        -- gateway-side name
  supports_chat INTEGER NOT NULL DEFAULT 1,
  supports_embeddings INTEGER NOT NULL DEFAULT 0,
  config TEXT,
  enabled INTEGER NOT NULL DEFAULT 1,
  created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS audit_trail (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  ts REAL NOT NULL,
  actor TEXT,
  action TEXT NOT NULL,
  entity_type TEXT,
  entity_id TEXT,
  details TEXT
);

CREATE TABLE IF NOT EXISTS global_config (
  key TEXT PRIMARY KEY,
  value TEXT,
  updated_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS plugin_bindings (
  id TEXT PRIMARY KEY,
  plugin_name TEXT NOT NULL,
  scope_type TEXT NOT NULL,                          -- tool|a2a|team|global
  scope_id TEXT,
  mode TEXT,                                         -- override mode
  config TEXT,
  enabled INTEGER NOT NULL DEFAULT 1,
  created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS resource_subscriptions (
  id TEXT PRIMARY KEY,
  uri TEXT NOT NULL,
  session_id TEXT NOT NULL,
  created_at REAL NOT NULL
);
"""

_V2 = """
CREATE TABLE IF NOT EXISTS a2a_tasks (
  id TEXT PRIMARY KEY,
  agent_id TEXT NOT NULL REFERENCES a2a_agents(id) ON DELETE CASCADE,
  state TEXT NOT NULL DEFAULT 'submitted',  -- submitted|working|completed|failed|cancelled
  input TEXT,                               -- JSON message
  output TEXT,                              -- JSON result
  error TEXT,
  created_by TEXT,
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_a2a_tasks_agent ON a2a_tasks(agent_id, created_at);
"""

_V3 = """
-- MCP Apps: short-lived AppBridge sessions bound to an MCP session and a
-- ui:// resource (reference MCPAppSession, db.py:4012)
CREATE TABLE IF NOT EXISTS mcp_app_sessions (
  id TEXT PRIMARY KEY,
  mcp_session_id TEXT NOT NULL,
  user_email TEXT NOT NULL,
  server_id TEXT,
  resource_uri TEXT NOT NULL,
  created_at REAL NOT NULL,
  expires_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_mcp_app_sessions_expires
  ON mcp_app_sessions(expires_at);
"""

_V4 = """
-- OAuth Dynamic Client Registration (RFC 7591) records per gateway/issuer
-- (reference services/dcr_service.py, RegisteredOAuthClient)
CREATE TABLE IF NOT EXISTS registered_oauth_clients (
  id TEXT PRIMARY KEY,
  gateway_id TEXT NOT NULL,
  issuer TEXT NOT NULL,
  client_id TEXT NOT NULL,
  client_secret_enc TEXT,
  redirect_uri TEXT,
  scopes TEXT,
  registration_client_uri TEXT,
  registration_access_token_enc TEXT,
  created_at REAL NOT NULL,
  UNIQUE (gateway_id, issuer)
);
"""

# v5: per-entity invocation metrics (reference keeps per-entity call
# records + hourly rollups for tools/resources/prompts/servers/a2a,
# db.py:2556-2848 — one discriminated table here instead of five shapes)
_V5 = """
ALTER TABLE tool_metrics ADD COLUMN entity_type TEXT NOT NULL DEFAULT 'tool';
CREATE INDEX IF NOT EXISTS ix_tool_metrics_type ON tool_metrics(entity_type, ts);
"""

# v6: middleware long tail (reference middleware/token_usage_middleware.py
# TokenUsageLog db.py:5565 + password_change_enforcement.py)
_V6 = """
ALTER TABLE users ADD COLUMN password_change_required INTEGER NOT NULL DEFAULT 0;
CREATE TABLE IF NOT EXISTS token_usage_logs (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  token_jti TEXT NOT NULL,
  user_email TEXT,
  ts REAL NOT NULL,
  method TEXT NOT NULL,
  path TEXT NOT NULL,
  status INTEGER NOT NULL,
  response_ms REAL NOT NULL,
  client_ip TEXT,
  user_agent TEXT,
  blocked INTEGER NOT NULL DEFAULT 0,
  block_reason TEXT
);
CREATE INDEX IF NOT EXISTS ix_token_usage_jti_ts
  ON token_usage_logs(token_jti, ts);
CREATE INDEX IF NOT EXISTS ix_token_usage_email_ts
  ON token_usage_logs(user_email, ts);
"""

# v7: persisted compliance reports (reference compliance_router.py +
# services/compliance_service.py report store)
_V7 = """
CREATE TABLE IF NOT EXISTS compliance_reports (
  id TEXT PRIMARY KEY,
  framework TEXT NOT NULL,
  period_start REAL NOT NULL,
  period_end REAL NOT NULL,
  generated_at REAL NOT NULL,
  generated_by TEXT,
  summary TEXT NOT NULL,
  report TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_compliance_reports_generated
  ON compliance_reports(generated_at);
"""

# v8: password reset flow (reference password_reset_* settings family +
# email_notification_service.py). Only the sha256 of the reset token is
# stored — a database leak must not yield usable reset links.
# users.tokens_valid_after: JWTs issued before this instant are rejected
# (session invalidation on reset, reference
# password_reset_invalidate_sessions).
_V8 = """
CREATE TABLE IF NOT EXISTS password_reset_tokens (
  token_hash TEXT PRIMARY KEY,
  user_email TEXT NOT NULL,
  expires_at REAL NOT NULL,
  used_at REAL,
  created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_prt_email_created
  ON password_reset_tokens(user_email, created_at);
ALTER TABLE users ADD COLUMN tokens_valid_after REAL;
"""

# v9: per-tenant usage rollups (observability/metering.py,
# docs/multitenancy.md): one row per (tenant, rollup window) with the
# token + KV-residency accounting the engine's TenantLedger accumulated
# — the durable usage trail billing and the distributed rate limiter
# (ROADMAP item 5) read. Tokens are conserved: summing any column over
# all tenants equals the engine's untagged totals for the window.
_V9 = """
CREATE TABLE IF NOT EXISTS tenant_usage (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  tenant TEXT NOT NULL,
  window_start REAL NOT NULL,
  window_end REAL NOT NULL,
  requests INTEGER NOT NULL DEFAULT 0,
  prompt_tokens INTEGER NOT NULL DEFAULT 0,
  generated_tokens INTEGER NOT NULL DEFAULT 0,
  cache_hit_tokens INTEGER NOT NULL DEFAULT 0,
  kv_page_seconds REAL NOT NULL DEFAULT 0
);
CREATE INDEX IF NOT EXISTS ix_tenant_usage_tenant_window
  ON tenant_usage(tenant, window_end);
CREATE INDEX IF NOT EXISTS ix_tenant_usage_window
  ON tenant_usage(window_end);
"""

MIGRATIONS: list[Migration] = [
    Migration(1, "initial-core-schema", _V1),
    Migration(2, "a2a-task-store", _V2),
    Migration(3, "mcp-app-sessions", _V3),
    Migration(4, "registered-oauth-clients", _V4),
    Migration(5, "per-entity-metrics", _V5),
    Migration(6, "token-usage-and-password-enforcement", _V6),
    Migration(7, "compliance-reports", _V7),
    Migration(8, "password-reset-and-session-invalidation", _V8),
    Migration(9, "tenant-usage-rollups", _V9),
]
