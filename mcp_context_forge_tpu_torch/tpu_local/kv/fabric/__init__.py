"""Cross-host prefix-cache fabric.

The tiered prefix cache (``kv/tiers.py``) stops at local disk; this
package adds the cross-host hop:

- :mod:`object_store`: the T3 backend protocol plus the two in-tree
  implementations (``file://`` shared directory, ``gcs://`` optional);
- :mod:`index`: the replicated fabric index, tenant-namespaced, TTL'd
  chain-hash advertisements merged from remote hosts
  (first-registration-wins), consulted by the store's probe path.
"""

from .index import FabricAdvert, FabricIndex, merge_wire_adverts
from .object_store import (FileObjectStore, GcsObjectStore, ObjectStore,
                           build_object_store, object_store_or_none)

__all__ = [
    "FabricAdvert",
    "FabricIndex",
    "FileObjectStore",
    "GcsObjectStore",
    "ObjectStore",
    "build_object_store",
    "merge_wire_adverts",
    "object_store_or_none",
]
