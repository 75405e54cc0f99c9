"""argon2id password hashes in argon2-cffi's PHC form, on ``cryptography``.

The JAX package hashes with argon2-cffi's ``PasswordHasher()`` defaults:
argon2id, version 19, 64 MiB of memory, 3 passes, 4 lanes, a 16-byte salt
and a 32-byte hash, written as ``$argon2id$v=19$m=65536,t=3,p=4$<salt>$<hash>``
(base64 without padding). ``PasswordHasher`` here writes the same strings
and reads any argon2id string of that form, whatever its parameters, so a
users row written by either package verifies in the other.

The KDF is ``cryptography``'s ``Argon2id`` (``derive_phc_encoded`` and
``verify_phc_encoded``). There is no other hash behind it: without that
backend ``hash`` and ``verify`` raise ``Argon2Unavailable``.

The two failures the auth service tells apart keep argon2-cffi's names:
``InvalidHashError`` for a stored value that is no argon2id string (an SSO
account's sentinel), ``VerifyMismatchError`` for a wrong password.
"""

from __future__ import annotations

import os

TIME_COST = 3
MEMORY_COST = 65536   # KiB
PARALLELISM = 4
HASH_LEN = 32
SALT_LEN = 16
PREFIX = "$argon2id$"


class InvalidHashError(ValueError):
    """The stored value is not an argon2id PHC string."""


class VerifyMismatchError(Exception):
    """The password does not match the hash."""


class Argon2Unavailable(RuntimeError):
    """No argon2id backend: ``cryptography`` lacks ``Argon2id``."""


def _backend():
    try:
        from cryptography.hazmat.primitives.kdf.argon2 import Argon2id
    except ImportError as exc:
        raise Argon2Unavailable(
            "argon2id needs cryptography's Argon2id (cryptography >= 44)") from exc
    if not hasattr(Argon2id, "verify_phc_encoded"):
        raise Argon2Unavailable("cryptography's Argon2id lacks PHC encoding")
    return Argon2id


class PasswordHasher:
    """argon2-cffi's ``PasswordHasher`` for the calls the auth service
    makes: ``hash(password)`` and ``verify(hash, password)``."""

    def hash(self, password: str) -> str:
        argon2id = _backend()
        return argon2id(salt=os.urandom(SALT_LEN), length=HASH_LEN, iterations=TIME_COST,
                        lanes=PARALLELISM, memory_cost=MEMORY_COST
                        ).derive_phc_encoded(password.encode())

    def verify(self, hash: str, password: str) -> bool:
        """True, or ``VerifyMismatchError``; ``InvalidHashError`` for a value
        that is not an argon2id string."""
        argon2id = _backend()
        from cryptography.exceptions import InvalidKey

        if not isinstance(hash, str) or not hash.startswith(PREFIX) or hash.count("$") != 5:
            raise InvalidHashError("not an argon2id hash")
        try:
            argon2id.verify_phc_encoded(password.encode(), hash)
        except InvalidKey as exc:
            if "format" in str(exc).lower():
                raise InvalidHashError(str(exc)) from exc
            raise VerifyMismatchError("The password does not match the supplied hash") from exc
        return True
