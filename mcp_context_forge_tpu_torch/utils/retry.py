"""Retries with exponential backoff, full jitter and ``Retry-After`` (a copy
of the JAX package's ``utils/retry.py``). httpx and aiohttp are imported in
``with_retries``, which the services call only after their clients exist."""

from __future__ import annotations

import asyncio
import random
from typing import Awaitable, Callable, TypeVar

from .outbound import httpx_module

T = TypeVar("T")

RETRYABLE_STATUS = {429, 502, 503, 504}


class RetryExhausted(Exception):
    def __init__(self, attempts: int, last: BaseException):
        super().__init__(f"All {attempts} attempts failed: {last}")
        self.attempts = attempts
        self.last = last


def backoff_delay(attempt: int, base: float = 0.25, cap: float = 8.0,
                  retry_after: float | None = None) -> float:
    if retry_after is not None:
        return min(retry_after, cap)
    exp = min(cap, base * (2 ** attempt))
    return random.uniform(0, exp)  # full jitter


async def with_retries(
    fn: Callable[[], Awaitable[T]],
    attempts: int = 3,
    base: float = 0.25,
    cap: float = 8.0,
    retryable: Callable[[BaseException], bool] | None = None,
) -> T:
    """Run ``fn`` with retries. httpx transport errors and 429/5xx retry by
    default; JSON-RPC/application errors do not."""
    import aiohttp

    httpx = httpx_module()
    last: BaseException | None = None
    for attempt in range(attempts):
        try:
            return await fn()
        except (httpx.HTTPStatusError, aiohttp.ClientResponseError) as exc:
            last = exc
            if isinstance(exc, httpx.HTTPStatusError):
                status = exc.response.status_code
                ra = exc.response.headers.get("retry-after")
            else:
                status = exc.status
                ra = (exc.headers or {}).get("Retry-After") if exc.headers else None
            if status not in RETRYABLE_STATUS:
                raise
            retry_after = (float(ra) if ra and str(ra).replace(".", "", 1).isdigit()
                           else None)
            if attempt + 1 < attempts:
                await asyncio.sleep(backoff_delay(attempt, base, cap, retry_after))
        except (httpx.TransportError, aiohttp.ClientError,
                asyncio.TimeoutError, ConnectionError) as exc:
            last = exc
            if attempt + 1 < attempts:
                await asyncio.sleep(backoff_delay(attempt, base, cap))
        except BaseException as exc:
            if retryable is not None and retryable(exc):
                last = exc
                if attempt + 1 < attempts:
                    await asyncio.sleep(backoff_delay(attempt, base, cap))
            else:
                raise
    assert last is not None
    raise RetryExhausted(attempts, last)
