"""Field encryption for stored secrets (a copy of the JAX package's
``utils/crypto.py``; a value either package seals opens in the other when
both run the same mode).

Secrets at rest (LLM provider configs) are sealed with a key derived from
``auth_encryption_secret``: AES-256-GCM where ``cryptography`` imports,
else an in-tree encrypt-then-MAC construction (SHA-256 counter keystream
XOR + HMAC-SHA256 tag), with a warning logged once at import. Both share
the wire prefix; a value sealed by one mode does not open in the other
(``DecryptionError``).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import logging
import os
from typing import Any

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:
    AESGCM = None
    logging.getLogger(__name__).warning(
        "cryptography is not installed: field encryption is using the "
        "in-tree HMAC-authenticated stream-cipher fallback")

_MAGIC = "enc:v1:"
_TAG_LEN = 16


class DecryptionError(Exception):
    """Sealed value could not be opened (wrong key, corruption, truncation)."""


def _derive_key(secret: str) -> bytes:
    return hashlib.sha256(("mcpforge-field-enc:" + secret).encode()).digest()


def _keystream(key: bytes, nonce: bytes, length: int) -> bytes:
    out = b""
    counter = 0
    while len(out) < length:
        out += hashlib.sha256(key + nonce + counter.to_bytes(4, "big")).digest()
        counter += 1
    return out[:length]


def encrypt_field(value: Any, secret: str) -> str:
    """Seal a JSON-serializable value. Output is ASCII-safe."""
    key = _derive_key(secret)
    nonce = os.urandom(12)
    plaintext = json.dumps(value, separators=(",", ":")).encode()
    if AESGCM is not None:
        ct = AESGCM(key).encrypt(nonce, plaintext, None)
        return _MAGIC + base64.urlsafe_b64encode(nonce + ct).decode()
    stream = _keystream(key, nonce, len(plaintext))
    ct = bytes(a ^ b for a, b in zip(plaintext, stream))
    tag = hmac.new(key, nonce + ct, hashlib.sha256).digest()[:_TAG_LEN]
    return _MAGIC + base64.urlsafe_b64encode(nonce + ct + tag).decode()


def decrypt_field(token: str | None, secret: str) -> Any:
    """Open a sealed value; passthrough for legacy/plaintext values."""
    if token is None:
        return None
    if not token.startswith(_MAGIC):
        try:
            return json.loads(token)
        except (json.JSONDecodeError, TypeError):
            return token
    try:
        raw = base64.urlsafe_b64decode(token[len(_MAGIC):].encode())
        key = _derive_key(secret)
        nonce = raw[:12]
        if AESGCM is not None:
            plaintext = AESGCM(key).decrypt(nonce, raw[12:], None)
        else:
            ct, tag = raw[12:-_TAG_LEN], raw[-_TAG_LEN:]
            want = hmac.new(key, nonce + ct, hashlib.sha256).digest()[:_TAG_LEN]
            if not hmac.compare_digest(tag, want):
                raise ValueError("bad auth tag")
            stream = _keystream(key, nonce, len(ct))
            plaintext = bytes(a ^ b for a, b in zip(ct, stream))
        return json.loads(plaintext)
    except Exception as exc:
        raise DecryptionError(f"Cannot decrypt sealed field: {type(exc).__name__}") from exc
