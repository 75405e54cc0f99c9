"""Standalone external plugin servers (stdio MCP), run out of process by
``plugins/external.py`` (a copy of the JAX package's ``plugins/servers/``):
``opa_policy``, ``prompt_guard`` and ``content_scanner``, each written with
``sdk.py``. Each runs as ``python -m
mcp_context_forge_tpu_torch.plugins.servers.<name>`` and imports neither
torch nor jax: a spawn, and each restart, pays only for the standard library
and the plugin framework."""
