"""AWS event-stream binary framing (application/vnd.amazon.eventstream), in
which Bedrock's ConverseStream answers (a copy of the JAX package's
``utils/eventstream.py``; stdlib only).

Frame layout (all integers big-endian):

    [4] total length | [4] headers length | [4] prelude CRC32
    [headers ...] [payload ...] [4] message CRC32

- the prelude CRC covers the first 8 bytes;
- the message CRC covers everything before it;
- each header: [1] name-len, name, [1] value-type, value. Types 7 (string)
  and 6 (bytes) carry a [2] length prefix; scalar types are fixed-width.
"""

from __future__ import annotations

import zlib
from typing import Any, AsyncIterator

_PRELUDE_LEN = 12
_CRC_LEN = 4

# scalar value-type tag -> fixed byte width (bools 0/1 carry no payload
# and are handled before this table; 6/7 are length-prefixed)
_FIXED_WIDTH = {2: 1, 3: 2, 4: 4, 5: 8, 8: 8, 9: 16}


class EventStreamError(ValueError):
    pass


def _parse_headers(data: bytes) -> dict[str, Any]:
    headers: dict[str, Any] = {}
    i = 0
    while i < len(data):
        name_len = data[i]
        i += 1
        name = data[i:i + name_len].decode("utf-8")
        i += name_len
        vtype = data[i]
        i += 1
        if vtype in (0, 1):          # bool true / false, no payload
            headers[name] = vtype == 0
        elif vtype in (6, 7):        # bytes / string: u16 length prefix
            vlen = int.from_bytes(data[i:i + 2], "big")
            i += 2
            raw = data[i:i + vlen]
            i += vlen
            headers[name] = raw.decode("utf-8") if vtype == 7 else raw
        elif vtype in _FIXED_WIDTH:  # integer/timestamp scalars + uuid
            width = _FIXED_WIDTH[vtype]
            raw = data[i:i + width]
            i += width
            headers[name] = (raw if vtype == 9
                             else int.from_bytes(raw, "big", signed=True))
        else:
            raise EventStreamError(f"unknown header value type {vtype}")
    return headers


def decode_frame(frame: bytes) -> tuple[dict[str, Any], bytes]:
    """One complete frame -> (headers, payload). Validates both CRCs."""
    if len(frame) < _PRELUDE_LEN + _CRC_LEN:
        raise EventStreamError("frame shorter than prelude")
    total = int.from_bytes(frame[0:4], "big")
    headers_len = int.from_bytes(frame[4:8], "big")
    prelude_crc = int.from_bytes(frame[8:12], "big")
    if zlib.crc32(frame[0:8]) != prelude_crc:
        raise EventStreamError("prelude CRC mismatch")
    if total != len(frame):
        raise EventStreamError("frame length mismatch")
    message_crc = int.from_bytes(frame[-4:], "big")
    if zlib.crc32(frame[:-4]) != message_crc:
        raise EventStreamError("message CRC mismatch")
    headers_end = _PRELUDE_LEN + headers_len
    headers = _parse_headers(frame[_PRELUDE_LEN:headers_end])
    payload = frame[headers_end:-4]
    return headers, payload


def encode_frame(headers: dict[str, str], payload: bytes) -> bytes:
    """Build a frame (string headers only — what event APIs actually use).
    Used by tests to synthesize Bedrock streams; inverse of decode_frame."""
    hdr = bytearray()
    for name, value in headers.items():
        name_b = name.encode()
        value_b = value.encode()
        hdr += bytes([len(name_b)]) + name_b + bytes([7])
        hdr += len(value_b).to_bytes(2, "big") + value_b
    total = _PRELUDE_LEN + len(hdr) + len(payload) + _CRC_LEN
    prelude = total.to_bytes(4, "big") + len(hdr).to_bytes(4, "big")
    prelude += zlib.crc32(prelude).to_bytes(4, "big")
    body = prelude + bytes(hdr) + payload
    return body + zlib.crc32(body).to_bytes(4, "big")


async def iter_frames(byte_iter: AsyncIterator[bytes]
                      ) -> AsyncIterator[tuple[dict[str, Any], bytes]]:
    """Incremental decoder over an async byte stream (httpx aiter_bytes):
    yields (headers, payload) per complete frame, tolerating frames split
    across arbitrary chunk boundaries."""
    buf = bytearray()
    async for chunk in byte_iter:
        buf += chunk
        while len(buf) >= _PRELUDE_LEN:
            total = int.from_bytes(buf[0:4], "big")
            if total < _PRELUDE_LEN + _CRC_LEN or total > 16 * 1024 * 1024:
                raise EventStreamError(f"implausible frame length {total}")
            if len(buf) < total:
                break
            frame = bytes(buf[:total])
            del buf[:total]
            yield decode_frame(frame)
    if buf:
        raise EventStreamError(f"{len(buf)} trailing bytes after last frame")
