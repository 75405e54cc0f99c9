"""LLM provider and model catalog (the ``llm_providers`` and ``llm_models``
tables) wired into the app's provider registry (a copy of the JAX
package's ``services/llm_provider_service.py``).

Supported types:

- ``tpu_local``: the local engine (registered by the app at startup);
- ``openai_compatible``: any OpenAI-shape endpoint; ``openai``,
  ``mistral``, ``groq``, ``together``, ``cohere`` are aliases of it
  (``OpenAICompatProvider``);
- the translation dialects ``azure_openai``, ``anthropic``, ``ollama``,
  ``bedrock``, ``google_vertex``, ``watsonx`` (``DialectProvider``).

Configs are sealed at rest (``utils/crypto.py``) and redacted on read.
Creating a provider wires it at once; adding a model rewires, so the alias
resolves without a restart. Providers are built in a worker thread: each
loads httpx and its SSL context then. Deleting a provider does not rewire (as in the
JAX package): its aliases resolve until the next rewire.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any

from ..tpu_local.provider import (DialectProvider, LLMProviderRegistry,
                                  OpenAICompatProvider)
from ..utils.crypto import decrypt_field, encrypt_field
from ..utils.ids import new_id
from .base import AppContext, ConflictError, NotFoundError, ValidationFailure, now

OPENAI_TRUNK_TYPES = {"openai_compatible", "openai", "mistral", "groq",
                      "together", "cohere"}
DIALECT_TYPES = {"azure_openai", "anthropic", "ollama", "bedrock",
                 "google_vertex", "watsonx"}
SUPPORTED_TYPES = {"tpu_local"} | OPENAI_TRUNK_TYPES | DIALECT_TYPES


class LLMProviderService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx

    @property
    def registry(self) -> LLMProviderRegistry:
        if self.ctx.llm_registry is None:
            self.ctx.llm_registry = LLMProviderRegistry()
        return self.ctx.llm_registry

    # ------------------------------------------------------------------ CRUD

    async def create_provider(self, name: str, provider_type: str,
                              api_base: str = "", config: dict[str, Any] | None = None
                              ) -> dict[str, Any]:
        if provider_type not in SUPPORTED_TYPES:
            raise ValidationFailure(
                f"provider_type must be one of {sorted(SUPPORTED_TYPES)}")
        existing = await self.ctx.db.fetchone(
            "SELECT id FROM llm_providers WHERE name=?", (name,))
        if existing:
            raise ConflictError(f"Provider {name!r} already exists")
        pid = new_id()
        ts = now()
        sealed = encrypt_field(config or {}, self.ctx.settings.auth_encryption_secret)
        await self.ctx.db.execute(
            "INSERT INTO llm_providers (id, name, provider_type, api_base, config,"
            " enabled, created_at, updated_at) VALUES (?,?,?,?,?,?,?,?)",
            (pid, name, provider_type, api_base, sealed, 1, ts, ts))
        raw = await self.ctx.db.fetchone("SELECT * FROM llm_providers WHERE id=?",
                                         (pid,))
        await self._wire_provider(raw)  # raw row: wiring needs the sealed config
        return await self.get_provider(pid)

    async def get_provider(self, provider_id: str) -> dict[str, Any]:
        row = await self.ctx.db.fetchone("SELECT * FROM llm_providers WHERE id=?",
                                         (provider_id,))
        if not row:
            raise NotFoundError(f"Provider {provider_id} not found")
        return self._redact(row)

    async def list_providers(self) -> list[dict[str, Any]]:
        rows = await self.ctx.db.fetchall("SELECT * FROM llm_providers ORDER BY name")
        return [self._redact(r) for r in rows]

    async def delete_provider(self, provider_id: str) -> None:
        rows = await self.ctx.db.execute("SELECT id FROM llm_providers WHERE id=?",
                                         (provider_id,))
        if not rows:
            raise NotFoundError(f"Provider {provider_id} not found")
        await self.ctx.db.execute("DELETE FROM llm_providers WHERE id=?", (provider_id,))

    async def add_model(self, provider_id: str, model_id: str, alias: str,
                        supports_chat: bool = True,
                        supports_embeddings: bool = False) -> dict[str, Any]:
        await self.get_provider(provider_id)
        existing = await self.ctx.db.fetchone("SELECT id FROM llm_models WHERE alias=?",
                                              (alias,))
        if existing:
            raise ConflictError(f"Model alias {alias!r} already exists")
        mid = new_id()
        await self.ctx.db.execute(
            "INSERT INTO llm_models (id, provider_id, model_id, alias, supports_chat,"
            " supports_embeddings, enabled, created_at) VALUES (?,?,?,?,?,?,?,?)",
            (mid, provider_id, model_id, alias, int(supports_chat),
             int(supports_embeddings), 1, now()))
        await self.rewire()
        row = await self.ctx.db.fetchone("SELECT * FROM llm_models WHERE id=?", (mid,))
        return dict(row)

    async def list_models(self) -> list[dict[str, Any]]:
        return await self.ctx.db.fetchall(
            "SELECT m.*, p.name AS provider_name, p.provider_type FROM llm_models m"
            " JOIN llm_providers p ON p.id = m.provider_id ORDER BY m.alias")

    # -------------------------------------------------------------- registry

    async def rewire(self) -> None:
        """Rebuild external provider entries from the DB rows (tpu_local is
        registered by the app at startup and kept)."""
        rows = await self.ctx.db.fetchall(
            "SELECT * FROM llm_providers WHERE enabled=1")
        # gauge counts EXTERNAL providers actually wired — tpu_local rows
        # are registered by app startup and skipped here, and a row whose
        # config fails to decrypt must not be counted (the gauge exists to
        # surface exactly that degraded state), so update in finally
        wired = 0
        try:
            with self.ctx.tracer.span("llm.provider.rewire",
                                      {"providers": len(rows)}):
                for row in rows:
                    await self._wire_provider(row)
                    if row["provider_type"] != "tpu_local":
                        wired += 1
        finally:
            if self.ctx.metrics is not None:
                self.ctx.metrics.llm_providers_wired.set(wired)

    async def _wire_provider(self, row: dict[str, Any]) -> None:
        if row["provider_type"] == "tpu_local":
            return  # engine-backed; registered by app startup
        config = decrypt_field(row["config"],
                               self.ctx.settings.auth_encryption_secret) or {}
        if isinstance(config, str):
            config = {}
        if row["provider_type"] in DIALECT_TYPES:
            build: Any = functools.partial(
                DialectProvider, name=row["name"], dialect=row["provider_type"],
                api_base=row["api_base"] or "",
                api_key=config.get("api_key", ""), config=config,
                timeout=float(config.get("timeout", 120.0)))
        else:
            build = functools.partial(
                OpenAICompatProvider, name=row["name"], api_base=row["api_base"] or "",
                api_key=config.get("api_key", ""),
                timeout=float(config.get("timeout", 120.0)))
        # off the loop: a provider loads httpx and its SSL context when built
        provider = await asyncio.to_thread(build)
        models = await self.ctx.db.fetchall(
            "SELECT alias FROM llm_models WHERE provider_id=? AND enabled=1",
            (row["id"],))
        self.registry.register(provider, [m["alias"] for m in models])

    @staticmethod
    def _redact(row: dict[str, Any]) -> dict[str, Any]:
        out = dict(row)
        out["config"] = "***" if row.get("config") else None
        return out
