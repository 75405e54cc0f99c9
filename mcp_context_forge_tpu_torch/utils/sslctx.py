"""TLS contexts (a copy of the JAX package's ``utils/sslctx.py``; stdlib
only): ``serving_ssl`` for ``run()``, ``outbound_ssl`` for the services'
shared HTTP clients (a pinned CA bundle's context is built once and
cached)."""

from __future__ import annotations

import ssl
from functools import lru_cache


@lru_cache(maxsize=64)
def _cached_context(ca_bundle: str, cert_file: str, key_file: str,
                    verify: bool) -> ssl.SSLContext:
    if not verify:
        context = ssl.create_default_context()
        context.check_hostname = False
        context.verify_mode = ssl.CERT_NONE
        return context
    context = ssl.create_default_context(cafile=ca_bundle or None)
    if cert_file:
        context.load_cert_chain(cert_file, key_file or None)
    return context


def outbound_ssl(settings) -> ssl.SSLContext | bool | None:
    """The ``ssl=`` argument of outbound client connections: False with
    ``skip_ssl_verify``, a cached context for a pinned ``ssl_ca_bundle``,
    else None (the library's default context)."""
    if settings.skip_ssl_verify:
        return False
    if settings.ssl_ca_bundle:
        return _cached_context(settings.ssl_ca_bundle, "", "", True)
    return None


def serving_ssl(settings) -> ssl.SSLContext | None:
    """Server-side TLS context (``ssl_enabled`` with ``ssl_cert_file`` and
    ``ssl_key_file``), else None."""
    if not settings.ssl_enabled:
        return None
    context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    context.load_cert_chain(settings.ssl_cert_file, settings.ssl_key_file or None)
    return context
