"""Server-side TLS for ``run()`` (the serving half of the JAX package's
``utils/sslctx.py``; stdlib only)."""

from __future__ import annotations

import ssl


def serving_ssl(settings) -> ssl.SSLContext | None:
    """Server-side TLS context (``ssl_enabled`` with ``ssl_cert_file`` and
    ``ssl_key_file``), else None."""
    if not settings.ssl_enabled:
        return None
    context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    context.load_cert_chain(settings.ssl_cert_file, settings.ssl_key_file or None)
    return context
