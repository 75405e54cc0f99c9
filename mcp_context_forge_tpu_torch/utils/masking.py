"""Sensitive-value masking for request/response logs (a copy of the JAX
package's ``utils/masking.py``).

The fast path is the port's own ``native/masking.cpp`` through ctypes,
compiled with ``g++`` into ``build/native/`` by ``native_available()`` (the
app calls it in a worker thread at startup; ``mask_text`` never compiles on
the event loop). The library's name carries a digest of its source, so an
edited source builds anew. Until it is built, or where no ``g++`` exists,
``mask_text`` takes the pure-Python path, as the JAX module does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import logging
import os
import re
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

_CPP_PATH = Path(__file__).resolve().parents[1] / "native" / "masking.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lib = None
_lib_lock = threading.Lock()
_native_failed = False

SENSITIVE_SUBSTRINGS = (
    "password", "passwd", "secret", "token", "api_key", "apikey",
    "authorization", "auth", "credential", "private_key", "session_id",
    "cookie", "x-api-key", "client_secret", "access_key", "bearer",
)

_sensitive_cache: dict[str, bool] = {}


@functools.lru_cache(maxsize=1)
def library_path() -> Path:
    digest = hashlib.sha256(_CPP_PATH.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmasking-{digest}.so"


def _build_native(target: Path) -> bool:
    """Compile into a private file, then rename it into place: concurrent
    builders never load a half-written library."""
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_CPP_PATH),
                            "-o", tmp], check=True, capture_output=True, timeout=120)
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True
    except Exception as exc:
        logger.debug("native masking build failed (%s); using python fallback", exc)
        return False


def _load_native(build: bool = False):
    """Load the shared object; only compile when ``build`` is set."""
    global _lib, _native_failed
    if _lib is not None or _native_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _native_failed:
            return _lib
        target = library_path()
        if not target.exists():
            if not build:
                return None  # not built yet: the caller takes the python path
            if not _build_native(target):
                _native_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(target))
            lib.mask_sensitive.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.mask_sensitive.restype = ctypes.c_void_p
            lib.mask_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except OSError as exc:
            logger.debug("native masking load failed: %s", exc)
            _native_failed = True
    return _lib


def is_sensitive_key(key: str) -> bool:
    cached = _sensitive_cache.get(key)
    if cached is not None:
        return cached
    lower = key.lower()
    sensitive = any(s in lower for s in SENSITIVE_SUBSTRINGS)
    if len(_sensitive_cache) < 4096:
        _sensitive_cache[key] = sensitive
    return sensitive


def mask_text(text: str) -> str:
    """Mask sensitive values in a JSON-ish log payload string."""
    lib = _load_native()
    if lib is not None:
        raw = text.encode("utf-8", errors="replace")
        ptr = lib.mask_sensitive(raw, len(raw))
        if ptr:  # NULL on OOM -> fall through to the Python path
            try:
                return ctypes.string_at(ptr).decode("utf-8", errors="replace")
            finally:
                lib.mask_free(ptr)
    return _mask_python(text)


def mask_obj(obj: Any) -> Any:
    """Recursively mask a decoded structure (python fallback path)."""
    if isinstance(obj, dict):
        return {k: ("***" if is_sensitive_key(str(k)) else mask_obj(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [mask_obj(v) for v in obj]
    return obj


def _mask_python(text: str) -> str:
    try:
        return json.dumps(mask_obj(json.loads(text)), separators=(",", ":"))
    except (json.JSONDecodeError, TypeError):
        # non-JSON: regex pass over key=value / "key": "value" shapes
        pattern = re.compile(
            r'(?i)("?(?:[\w.-]*(?:' + "|".join(SENSITIVE_SUBSTRINGS) +
            r')[\w.-]*)"?\s*[:=]\s*)("([^"\\]|\\.)*"|[^\s,}\]]+)')
        return pattern.sub(r'\1"***"', text)


def native_available() -> bool:
    return _load_native(build=True) is not None
