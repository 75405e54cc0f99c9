"""OpenAI wire shapes shared by the providers."""

from __future__ import annotations

import time
from typing import Any

from ..utils import new_id


def make_chat_response(model: str, text: str, prompt_tokens: int = 0,
                       completion_tokens: int = 0,
                       finish_reason: str = "stop",
                       tool_calls: list[dict[str, Any]] | None = None
                       ) -> dict[str, Any]:
    message: dict[str, Any] = {"role": "assistant", "content": text}
    if tool_calls:
        # OpenAI wire shape: content null, calls carried structurally,
        # finish_reason tells the client to execute and continue
        message = {"role": "assistant", "content": None,
                   "tool_calls": tool_calls}
        finish_reason = "tool_calls"
    return {
        "id": f"chatcmpl-{new_id()[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": message,
            "finish_reason": finish_reason,
        }],
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
        },
    }
