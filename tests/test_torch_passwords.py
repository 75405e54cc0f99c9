"""The port's argon2id hasher (``utils/passwords.py``, on ``cryptography``)
against argon2-cffi's ``PasswordHasher``, which the JAX package's auth
service uses, on the CPU: seeded passwords hashed by either verify in the
other, both ways; the PHC strings carry the same parameters and lengths; a
wrong password and a non-argon2 sentinel raise argon2-cffi's two cases in
both (``VerifyMismatchError``, ``InvalidHashError``); without the
``cryptography`` backend the port raises and hashes nothing."""

import base64
import sys

import numpy as np
import pytest
from argon2 import PasswordHasher as CffiHasher
from argon2 import exceptions as cffi_exceptions

from mcp_context_forge_tpu.services import auth_service as jax_auth
from mcp_context_forge_tpu_torch.utils import passwords

PORT = passwords.PasswordHasher()
CFFI = CffiHasher()


def _passwords(seed: int, n: int = 2) -> list[str]:
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
                             "!@#$%^&*()-_=+ éü漢"))
    return ["".join(rng.choice(alphabet, int(rng.integers(1, 40)))) for _ in range(n)]


def _phc_fields(phc: str) -> tuple[str, str, str, bytes, bytes]:
    _, kind, version, params, salt, digest = phc.split("$")
    pad = lambda s: base64.b64decode(s + "=" * (-len(s) % 4))  # noqa: E731
    return kind, version, params, pad(salt), pad(digest)


@pytest.mark.parametrize("seed", range(3))
def test_hashes_cross_verify(seed):
    for password in _passwords(seed):
        port_hash, cffi_hash = PORT.hash(password), CFFI.hash(password)
        assert CFFI.verify(port_hash, password) is True
        assert PORT.verify(cffi_hash, password) is True
        assert PORT.verify(port_hash, password) is True


def test_jax_service_hasher_is_argon2_cffi_defaults():
    """The JAX auth service's module hasher is the one compared here."""
    assert (jax_auth._hasher.time_cost, jax_auth._hasher.memory_cost,
            jax_auth._hasher.parallelism, jax_auth._hasher.hash_len,
            jax_auth._hasher.salt_len) == (CFFI.time_cost, CFFI.memory_cost,
                                           CFFI.parallelism, CFFI.hash_len, CFFI.salt_len)


def test_phc_parameters_equal():
    port_fields = _phc_fields(PORT.hash("Parameters123"))
    cffi_fields = _phc_fields(CFFI.hash("Parameters123"))
    assert port_fields[:3] == cffi_fields[:3] == ("argon2id", "v=19", "m=65536,t=3,p=4")
    assert len(port_fields[3]) == len(cffi_fields[3]) == passwords.SALT_LEN == 16
    assert len(port_fields[4]) == len(cffi_fields[4]) == passwords.HASH_LEN == 32
    assert (passwords.TIME_COST, passwords.MEMORY_COST, passwords.PARALLELISM) == (
        CFFI.time_cost, CFFI.memory_cost, CFFI.parallelism)


def test_other_parameters_verify():
    """A hash made with other argon2id parameters verifies by the ones it
    names, as argon2-cffi reads it."""
    light = CffiHasher(time_cost=1, memory_cost=8192, parallelism=2, hash_len=24, salt_len=12)
    stored = light.hash("Lighter-cost-1")
    assert PORT.verify(stored, "Lighter-cost-1") is True
    with pytest.raises(passwords.VerifyMismatchError):
        PORT.verify(stored, "Lighter-cost-2")


@pytest.mark.parametrize("seed", range(2))
def test_mismatch_raises_in_both(seed):
    right, wrong = _passwords(seed + 10)
    for stored in (PORT.hash(right), CFFI.hash(right)):
        with pytest.raises(cffi_exceptions.VerifyMismatchError):
            CFFI.verify(stored, wrong)
        with pytest.raises(passwords.VerifyMismatchError):
            PORT.verify(stored, wrong)


@pytest.mark.parametrize("sentinel", ["!sso!", "", "plain-text-password",
                                      "$2b$12$abcdefghijklmnopqrstuv"])
def test_sentinel_raises_invalid_hash_in_both(sentinel):
    with pytest.raises(cffi_exceptions.InvalidHashError):
        CFFI.verify(sentinel, "anything")
    with pytest.raises(passwords.InvalidHashError):
        PORT.verify(sentinel, "anything")


def test_missing_backend_raises(monkeypatch):
    """No ``cryptography`` Argon2id: both calls raise, nothing is hashed
    another way."""
    monkeypatch.setitem(sys.modules, "cryptography.hazmat.primitives.kdf.argon2", None)
    with pytest.raises(passwords.Argon2Unavailable):
        PORT.hash("Backendless-1")
    with pytest.raises(passwords.Argon2Unavailable):
        PORT.verify(CFFI.hash("Backendless-1"), "Backendless-1")


def test_backend_without_phc_raises(monkeypatch):
    from cryptography.hazmat.primitives.kdf import argon2

    class Bare:  # an Argon2id without the PHC helpers
        pass

    monkeypatch.setattr(argon2, "Argon2id", Bare)
    with pytest.raises(passwords.Argon2Unavailable):
        PORT.hash("Backendless-2")
