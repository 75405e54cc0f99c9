"""Secret redaction of the effective-settings view (``GET /admin/config``):
the name-keyed policy of the JAX package's ``utils/redact.py``.

A value is a secret when its name carries a credential fragment (a
``_token`` suffix counts, ``token_expiry`` does not), when the field is a
compound carrier of credentials (``sso_providers``, ``otel_otlp_headers``),
or, for a DSN, in its userinfo.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

REDACTED = "***redacted***"

_SECRET_FRAGMENTS = ("secret", "password", "passwd", "api_key", "apikey", "private_key",
                     "credential")
_OPAQUE_FIELDS = {"sso_providers", "otel_otlp_headers"}
_DSN_USERINFO = re.compile(r"://[^@/\s]+@")


def is_secret_name(name: str) -> bool:
    low = name.lower()
    return (any(f in low for f in _SECRET_FRAGMENTS)
            or low.endswith("_token") or low == "token" or low in _OPAQUE_FIELDS)


def redact_value(name: str, value: Any) -> Any:
    """One named value redacted; a DSN keeps its host and database."""
    # the name first: a secret-named number redacts too
    if is_secret_name(name):
        return REDACTED if value else ""
    if isinstance(value, (bool, int, float)):
        return value
    if isinstance(value, str) and "://" in value:
        return _DSN_USERINFO.sub("://***@", value)
    return value


def redact_settings(settings: Any) -> list[dict[str, Any]]:
    """The settings' fields by name, secrets redacted. A pydantic
    ``Settings`` (the JAX package's) is read through its ``model_fields``."""
    names = getattr(type(settings), "model_fields", None) or [
        f.name for f in dataclasses.fields(settings)]
    return [{"name": name, "value": redact_value(name, getattr(settings, name))}
            for name in sorted(names)]
