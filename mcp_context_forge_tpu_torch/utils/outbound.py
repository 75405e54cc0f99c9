"""httpx for the outbound clients, loaded where a client is built.

A first ``import httpx`` takes about half a second (its transport, imported
when the first client is made, another ~0.2 s), and every
``httpx.AsyncClient`` made with ``verify=True`` loads the CA bundle into a
new SSL context (~40 ms; ~0.4 s the first time). The JAX package imports
httpx at module load. The port stays importable without httpx, so the
code that makes outbound clients (the LLM providers, the services' shared
pool, ``MCPSession``) calls these at construction, off the posting
methods; the posting methods only use what they return."""

from __future__ import annotations

import importlib
from functools import lru_cache
from typing import Any


@lru_cache(maxsize=1)
def httpx_module() -> Any:
    """The ``httpx`` module, imported once."""
    import httpx

    # httpx imports its transport (httpcore, anyio, h11) when the first
    # client is made, and anyio its asyncio backend at the first request:
    # a throwaway transport and the backend's import make both happen here
    httpx.AsyncHTTPTransport()
    try:
        importlib.import_module("anyio._backends._asyncio")
    except ImportError:   # another anyio layout: it loads at the first request
        pass
    return httpx


@lru_cache(maxsize=1)
def verified_context() -> Any:
    """One verifying SSL context (httpx's default: certifi's CA bundle),
    shared by every client that would otherwise build its own."""
    return httpx_module().create_ssl_context()
