"""T3 object-store backends for the prefix-cache fabric.

The :class:`~..tiers.TieredPageStore` treats the object store as the
hop below disk: pages persist as content-addressed blobs keyed by the
chain hash under a tenant namespace (``<namespace>/<hash>.npz``), so N
hosts sharing one store share one copy of every spilled prefix page.

Contract (deliberately tiny — the tier store owns retries, backoff,
breakers, and verification):

- ``get(key)`` returns the blob bytes or ``None`` when the key does not
  exist; any other failure raises ``OSError``;
- ``put(key, data)`` is ATOMIC per key (a reader never observes a
  half-written blob) and idempotent — last-writer-wins is safe because
  keys are content-addressed and every read is verified against the
  requester's expected payload identity before serving;
- ``delete(key)`` is best-effort (missing keys are not an error).

Two in-tree backends:

- ``file://<dir>`` — a shared directory (NFS/SSD/test tempdir); atomic
  via tmp-file + ``os.replace``. The bench fabric scenario and every
  test use this one.
- ``gcs://<bucket>[/<prefix>]`` — Google Cloud Storage behind the same
  interface. The dependency is OPTIONAL: :func:`build_object_store`
  refuses at build time with a clear error when the client library is
  not installed, instead of failing on first IO mid-serving.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any

logger = logging.getLogger(__name__)

_KEY_RE = re.compile(r"^[A-Za-z0-9._\-]+(/[A-Za-z0-9._\-]+)*$")


def _check_key(key: str) -> str:
    """Keys are namespace-qualified relative paths; reject anything that
    could escape the store root (``..``, absolute paths, empty
    segments) — the file backend joins them onto a shared directory."""
    if not _KEY_RE.match(key) or ".." in key.split("/"):
        raise ValueError(f"illegal object key {key!r}")
    return key


class ObjectStore:
    """Backend interface (docstring above). Subclasses implement the
    three IO methods; ``url`` echoes the configured location and
    ``stats()`` feeds the admin tier cards."""

    url: str = ""

    def get(self, key: str) -> bytes | None:  # pragma: no cover - interface
        raise NotImplementedError

    def put(self, key: str, data: bytes) -> None:  # pragma: no cover
        raise NotImplementedError

    def delete(self, key: str) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def stats(self) -> dict[str, Any]:
        return {"url": self.url}


class FileObjectStore(ObjectStore):
    """Shared-directory backend: one blob per key under ``root``."""

    def __init__(self, root: str) -> None:
        if not root:
            raise ValueError("file:// object store needs a directory path")
        self.root = os.path.abspath(root)
        self.url = f"file://{self.root}"
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *_check_key(key).split("/"))

    def get(self, key: str) -> bytes | None:
        try:
            with open(self._path(key), "rb") as fh:
                return fh.read()
        except FileNotFoundError:
            return None

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # atomic publish: a cross-host reader either sees the whole blob
        # or a miss, never a torn write (same discipline as the disk
        # tier's .npz writeback)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as fh:
                fh.write(data)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def stats(self) -> dict[str, Any]:
        return {"url": self.url, "backend": "file"}


class GcsObjectStore(ObjectStore):
    """Google Cloud Storage backend. Construction requires the optional
    ``google-cloud-storage`` client — :func:`build_object_store` guards
    the import so a missing dependency refuses at BUILD time."""

    def __init__(self, bucket: str, prefix: str = "",
                 client: Any = None) -> None:
        if client is None:  # pragma: no cover - needs the optional dep
            from google.cloud import storage
            client = storage.Client()
        self._bucket = client.bucket(bucket)
        self._prefix = prefix.strip("/")
        self.url = f"gcs://{bucket}" + (f"/{self._prefix}"
                                        if self._prefix else "")

    def _blob(self, key: str):
        name = _check_key(key)
        if self._prefix:
            name = f"{self._prefix}/{name}"
        return self._bucket.blob(name)

    def get(self, key: str) -> bytes | None:
        try:
            return self._blob(key).download_as_bytes()
        except OSError:
            raise
        except Exception as exc:
            if type(exc).__name__ == "NotFound":
                return None
            raise OSError(f"gcs get failed: {exc}") from exc

    def put(self, key: str, data: bytes) -> None:
        try:
            # GCS object writes are atomic by contract; no tmp dance
            self._blob(key).upload_from_string(data)
        except OSError:
            raise
        except Exception as exc:
            raise OSError(f"gcs put failed: {exc}") from exc

    def delete(self, key: str) -> None:
        try:
            self._blob(key).delete()
        except Exception:
            pass

    def stats(self) -> dict[str, Any]:
        return {"url": self.url, "backend": "gcs"}


def gcs_available() -> bool:
    """True when the optional GCS client library is importable."""
    try:
        from google.cloud import storage  # noqa: F401
        return True
    except ImportError:
        return False


def build_object_store(url: str) -> ObjectStore:
    """Build a backend from its URL (``tpu_local_tier_object_url``).

    Raises ``ValueError`` for unknown schemes and for ``gcs://`` when
    the optional client library is missing — the refusal happens HERE,
    at build time, with an actionable message, never as a surprise
    OSError on the first spill mid-serving. Callers that prefer to
    serve degraded (T3 off) catch it and log.
    """
    if url.startswith("file://"):
        return FileObjectStore(url[len("file://"):])
    if url.startswith("gcs://"):
        if not gcs_available():
            raise ValueError(
                "tier_object_url is gcs:// but the google-cloud-storage "
                "package is not installed — install it or point the "
                "fabric at a file:// shared directory")
        rest = url[len("gcs://"):].strip("/")
        if not rest:
            raise ValueError("gcs:// object store needs a bucket name")
        bucket, _, prefix = rest.partition("/")
        return GcsObjectStore(bucket, prefix)
    raise ValueError(f"unsupported object store url {url!r} "
                     f"(expected file://<dir> or gcs://<bucket>[/prefix])")


def object_store_or_none(url: str) -> ObjectStore | None:
    """Graceful-degrade wrapper for the serving path: "" means "no
    fabric configured" (silent None); a configured-but-unbuildable URL
    (unknown scheme, missing GCS dep) logs ONE clear warning and serves
    without T3 — HBM/T1/T2 keep working, the fabric simply stays off."""
    if not url:
        return None
    try:
        return build_object_store(url)
    except ValueError as exc:
        logger.warning("prefix-cache fabric disabled: %s", exc)
        return None
