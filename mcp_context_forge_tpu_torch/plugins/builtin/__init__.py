"""The registry of builtin plugin kinds. Importing this package registers
the four engine-backed kinds (``llm_plugins``) under their short names, so
that a config or a binding can say ``kind: summarizer``. Every other kind
that the JAX package registers is listed in ``UNPORTED``: it refuses to load
with an error that names it (``PluginKindNotPorted``), and no kind ever
resolves to another."""

from ..framework import UNPORTED_BUILTINS, register_builtin

_P = "mcp_context_forge_tpu_torch.plugins.builtin"

for _name, _path in {
    "response_cache_by_prompt": f"{_P}.llm_plugins.ResponseCacheByPromptPlugin",
    "summarizer": f"{_P}.llm_plugins.SummarizerPlugin",
    "content_moderation": f"{_P}.llm_plugins.ContentModerationPlugin",
    "harmful_content_detector": f"{_P}.llm_plugins.HarmfulContentDetectorPlugin",
}.items():
    register_builtin(_name, _path)

UNPORTED = frozenset({
    # filters / guards
    "deny_filter", "regex_filter", "output_length_guard", "file_type_allowlist",
    "resource_filter", "schema_guard", "sql_sanitizer", "secrets_filter",
    # transformers
    "header_injector", "header_filter", "json_repair", "markdown_cleaner",
    "html_to_markdown", "search_replace", "argument_normalizer",
    "privacy_notice_injector", "timezone_translator",
    # resilience / ops
    "circuit_breaker", "cached_tool_result", "watchdog", "webhook_notification",
    # content / format
    "citation_validator", "safe_html_sanitizer", "code_formatter",
    "license_header_injector", "ai_artifacts_normalizer", "toon_encoder",
    "robots_license_guard", "code_safety_linter",
    # security / ops
    "jwt_claims_extraction", "vault", "virus_total_checker",
    "span_attribute_customizer", "unified_pdp", "tools_telemetry_exporter",
    # validation
    "sparc_static_validator", "altk_json_processor",
    # out-of-process plugin servers over stdio MCP
    "external",
})
UNPORTED_BUILTINS.update(UNPORTED)
