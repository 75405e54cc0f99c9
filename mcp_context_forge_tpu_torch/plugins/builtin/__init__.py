"""The registry of builtin plugin kinds (a copy of the JAX package's
``plugins/builtin/__init__.py``). Importing this package registers every
builtin under the JAX package's short name, so that a YAML config or a
``plugin_bindings`` row can say ``kind: deny_filter``; a kind's module is
imported only when a plugin of that kind is added."""

from ..framework import register_builtin

_P = "mcp_context_forge_tpu_torch.plugins.builtin"

for _name, _path in {
    # filters / guards
    "deny_filter": f"{_P}.filters.DenyFilterPlugin",
    "regex_filter": f"{_P}.filters.RegexFilterPlugin",
    "output_length_guard": f"{_P}.filters.OutputLengthGuardPlugin",
    "file_type_allowlist": f"{_P}.filters.FileTypeAllowlistPlugin",
    "resource_filter": f"{_P}.filters.ResourceFilterPlugin",
    "schema_guard": f"{_P}.filters.SchemaGuardPlugin",
    "sql_sanitizer": f"{_P}.filters.SqlSanitizerPlugin",
    "secrets_filter": f"{_P}.filters.SecretsFilterPlugin",
    # transformers
    "header_injector": f"{_P}.transformers.HeaderInjectorPlugin",
    "header_filter": f"{_P}.transformers.HeaderFilterPlugin",
    "json_repair": f"{_P}.transformers.JsonRepairPlugin",
    "markdown_cleaner": f"{_P}.transformers.MarkdownCleanerPlugin",
    "html_to_markdown": f"{_P}.transformers.HtmlToMarkdownPlugin",
    "search_replace": f"{_P}.transformers.SearchReplacePlugin",
    "argument_normalizer": f"{_P}.transformers.ArgumentNormalizerPlugin",
    "privacy_notice_injector": f"{_P}.transformers.PrivacyNoticeInjectorPlugin",
    "timezone_translator": f"{_P}.transformers.TimezoneTranslatorPlugin",
    # resilience / ops
    "circuit_breaker": f"{_P}.resilience.CircuitBreakerPlugin",
    "cached_tool_result": f"{_P}.resilience.CachedToolResultPlugin",
    "watchdog": f"{_P}.resilience.WatchdogPlugin",
    "webhook_notification": f"{_P}.resilience.WebhookNotificationPlugin",
    # content / format
    "citation_validator": f"{_P}.content_plugins.CitationValidatorPlugin",
    "safe_html_sanitizer": f"{_P}.content_plugins.SafeHtmlSanitizerPlugin",
    "code_formatter": f"{_P}.content_plugins.CodeFormatterPlugin",
    "license_header_injector": f"{_P}.content_plugins.LicenseHeaderInjectorPlugin",
    "ai_artifacts_normalizer": f"{_P}.content_plugins.AiArtifactsNormalizerPlugin",
    "toon_encoder": f"{_P}.content_plugins.ToonEncoderPlugin",
    "robots_license_guard": f"{_P}.content_plugins.RobotsLicenseGuardPlugin",
    "code_safety_linter": f"{_P}.content_plugins.CodeSafetyLinterPlugin",
    # security / ops
    "jwt_claims_extraction": f"{_P}.security_plugins.JwtClaimsExtractionPlugin",
    "vault": f"{_P}.security_plugins.VaultPlugin",
    "virus_total_checker": f"{_P}.security_plugins.VirusTotalCheckerPlugin",
    "span_attribute_customizer": f"{_P}.security_plugins.SpanAttributeCustomizerPlugin",
    "unified_pdp": f"{_P}.security_plugins.UnifiedPdpPlugin",
    "tools_telemetry_exporter": f"{_P}.security_plugins.ToolsTelemetryExporterPlugin",
    # engine-backed
    "response_cache_by_prompt": f"{_P}.llm_plugins.ResponseCacheByPromptPlugin",
    "summarizer": f"{_P}.llm_plugins.SummarizerPlugin",
    "content_moderation": f"{_P}.llm_plugins.ContentModerationPlugin",
    "harmful_content_detector": f"{_P}.llm_plugins.HarmfulContentDetectorPlugin",
    # validation
    "sparc_static_validator": f"{_P}.validation_plugins.SparcStaticValidatorPlugin",
    "altk_json_processor": f"{_P}.validation_plugins.AltkJsonProcessorPlugin",
    # out-of-process plugin servers over stdio MCP
    "external": "mcp_context_forge_tpu_torch.plugins.external.ExternalPlugin",
}.items():
    register_builtin(_name, _path)
