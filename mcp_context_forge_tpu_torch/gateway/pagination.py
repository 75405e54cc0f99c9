"""Cursor (keyset) pagination for list endpoints (a copy of the JAX
package's ``gateway/pagination.py``; the upstream gateway's list routers
take ``cursor``/``limit`` the same way). Semantics:

- ``?limit=N`` caps the page; ``?cursor=...`` resumes AFTER the item the
  cursor names. Keyset (sort-key anchored), not offset — concurrent
  inserts/deletes shift no pages.
- The cursor is opaque (urlsafe base64 of the anchor key); a cursor that
  doesn't decode is a 422, not a silent first page (a truncated cursor
  silently restarting would duplicate work for paging clients).
- Requests with NEITHER param keep the legacy whole-list response shape,
  so existing clients (and the admin UI tables) are unaffected.

Services return materialized schema lists (entity counts are
thousands, not millions), so the page is cut router-side over a
deterministic sort — one implementation for every endpoint instead of
N bespoke SQL variants; the DB tier already bounds result sets.
"""

from __future__ import annotations

import base64
import binascii
import json
from typing import Any, Callable, Sequence

from aiohttp import web

from ..services.base import ValidationFailure

MAX_PAGE = 500


def encode_cursor(key: Any) -> str:
    raw = json.dumps(key, separators=(",", ":")).encode()
    return base64.urlsafe_b64encode(raw).decode().rstrip("=")


def decode_cursor(cursor: str) -> Any:
    try:
        pad = "=" * (-len(cursor) % 4)
        return json.loads(base64.urlsafe_b64decode(cursor + pad))
    except (binascii.Error, json.JSONDecodeError, UnicodeDecodeError) as exc:
        raise ValidationFailure(f"Invalid cursor: {exc}") from exc


def paginate(request: web.Request, items: Sequence[Any],
             dump: Callable[[Any], Any],
             key: Callable[[Any], Any] = None) -> web.Response:
    """Respond with a page (``{"items", "next_cursor", "total"}``) when the
    request carries ``limit``/``cursor``, else the legacy full list."""
    limit_q = request.query.get("limit")
    cursor_q = request.query.get("cursor")
    if limit_q is None and cursor_q is None:
        return web.json_response(dump(list(items)))
    if key is None:
        # human-facing order (name/uri), with id appended so the sort key
        # is UNIQUE — keyset pagination with duplicate anchor keys would
        # silently skip the duplicates on resume
        def key(item):
            label = (getattr(item, "name", None)
                     or getattr(item, "uri", None) or "")
            return f"{label}\x00{getattr(item, 'id', '')}"
    settings = request.app["ctx"].settings
    max_page = settings.pagination_max_page_size or MAX_PAGE
    min_page = max(1, settings.pagination_min_page_size)
    try:
        limit = max(min_page,
                    min(int(limit_q or settings.pagination_default_page_size),
                        max_page))
    except ValueError as exc:
        raise ValidationFailure(f"Invalid limit: {limit_q!r}") from exc
    ordered = sorted(items, key=lambda item: str(key(item)))
    start = 0
    if cursor_q:
        anchor = str(decode_cursor(cursor_q))
        # resume strictly after the anchor key; a deleted anchor resumes
        # at the first surviving key past it (keyset semantics)
        while start < len(ordered) and str(key(ordered[start])) <= anchor:
            start += 1
    page = ordered[start:start + limit]
    more = start + limit < len(ordered)
    next_cursor = (encode_cursor(str(key(page[-1])))
                   if more and page else None)
    body = {
        "items": dump(page),
        "next_cursor": next_cursor,
        "total": len(ordered),
    }
    if settings.pagination_include_links:
        # RFC 8288-style affordance (the upstream gateway's pagination_include_links):
        # clients follow `links.next` instead of assembling the query
        from yarl import URL
        body["links"] = {
            "self": str(request.rel_url),
            "next": (str(URL(request.rel_url.path).with_query(
                {**request.query, "cursor": next_cursor,
                 "limit": str(limit)}))
                     if next_cursor else None),
        }
    return web.json_response(body)
