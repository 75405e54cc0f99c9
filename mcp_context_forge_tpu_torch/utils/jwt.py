"""Minimal JWT (JWS compact): HS256/384/512, stdlib only.

A copy of the JAX package's ``utils/jwt.py``, the same tokens both ways:
``create_token``/``encode`` mint, ``decode`` verifies the signature, the
algorithm against an allow-list (``alg: none`` is never allowed), expiry,
not-before, audience and issuer, and raises ``JWTError`` otherwise.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any

_ALGS = {
    "HS256": hashlib.sha256,
    "HS384": hashlib.sha384,
    "HS512": hashlib.sha512,
}


class JWTError(Exception):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def encode(payload: dict[str, Any], secret: str, algorithm: str = "HS256") -> str:
    if algorithm not in _ALGS:
        raise JWTError(f"Unsupported algorithm {algorithm}")
    header = {"alg": algorithm, "typ": "JWT"}
    signing_input = _b64url(json.dumps(header, separators=(",", ":")).encode()) + "." + \
        _b64url(json.dumps(payload, separators=(",", ":")).encode())
    sig = hmac.new(secret.encode(), signing_input.encode(), _ALGS[algorithm]).digest()
    return signing_input + "." + _b64url(sig)


def decode_unverified(token: str) -> dict[str, Any] | None:
    """Payload WITHOUT signature/expiry verification — identification
    only, never authentication (token-usage accounting of rejected
    requests needs the jti of a token that failed verification)."""
    try:
        _, payload_b64, _ = token.split(".")
        payload = json.loads(_b64url_decode(payload_b64))
        return payload if isinstance(payload, dict) else None
    except (ValueError, json.JSONDecodeError):
        return None


def decode(
    token: str,
    secret: str,
    algorithms: tuple[str, ...] = ("HS256", "HS384", "HS512"),
    audience: str | None = None,
    issuer: str | None = None,
    verify_exp: bool = True,
    leeway: float = 0.0,
) -> dict[str, Any]:
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64url_decode(header_b64))
        payload = json.loads(_b64url_decode(payload_b64))
        sig = _b64url_decode(sig_b64)
    except (ValueError, json.JSONDecodeError) as exc:
        raise JWTError(f"Malformed token: {exc}") from exc

    alg = header.get("alg")
    if alg not in algorithms or alg not in _ALGS:
        raise JWTError(f"Algorithm {alg!r} not allowed")
    signing_input = (header_b64 + "." + payload_b64).encode()
    expected = hmac.new(secret.encode(), signing_input, _ALGS[alg]).digest()
    if not hmac.compare_digest(sig, expected):
        raise JWTError("Signature verification failed")

    now = time.time()
    try:
        exp = float(payload["exp"]) if "exp" in payload else None
        nbf = float(payload["nbf"]) if "nbf" in payload else None
    except (TypeError, ValueError) as exc:
        raise JWTError(f"Invalid exp/nbf claim: {exc}") from exc
    if verify_exp and exp is not None and now > exp + leeway:
        raise JWTError("Token expired")
    if nbf is not None and now < nbf - leeway:
        raise JWTError("Token not yet valid")
    if audience is not None:
        aud = payload.get("aud")
        auds = aud if isinstance(aud, list) else [aud]
        if audience not in auds:
            raise JWTError("Invalid audience")
    if issuer is not None and payload.get("iss") != issuer:
        raise JWTError("Invalid issuer")
    return payload


def create_token(
    claims: dict[str, Any],
    secret: str,
    algorithm: str = "HS256",
    expires_minutes: int | None = 60,
    audience: str | None = None,
    issuer: str | None = None,
) -> str:
    payload = dict(claims)
    now = int(time.time())
    payload.setdefault("iat", now)
    if expires_minutes is not None:
        payload.setdefault("exp", now + expires_minutes * 60)
    if audience is not None:
        payload.setdefault("aud", audience)
    if issuer is not None:
        payload.setdefault("iss", issuer)
    return encode(payload, secret, algorithm)
