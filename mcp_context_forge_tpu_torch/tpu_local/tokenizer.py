"""Tokenization (copies of the JAX package's): ``HFTokenizer`` loads a
checkpoint's ``tokenizer.json`` (HuggingFace ``tokenizers``, imported only
when one is loaded); ``ByteTokenizer`` is the dependency-free byte-level
fallback; ``render_chat`` is the Llama-3 chat template."""

from __future__ import annotations

import os


class ByteTokenizer:
    """ids 0..255 = bytes; 256=bos, 257=eos, 258=pad; 259+ = chat-template
    markers. The markers encode as ONE token each — exactly how the real
    Llama-3 BPE treats its special tokens."""

    SPECIALS = ("<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>")

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self._special_ids = {tok: 259 + i
                             for i, tok in enumerate(self.SPECIALS)}

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids: list[int] = [self.bos_id] if add_bos else []
        i = 0
        while i < len(text):
            for tok, tid in self._special_ids.items():
                if text.startswith(tok, i):
                    ids.append(tid)
                    i += len(tok)
                    break
            else:
                # longest run of plain text until the next special
                nxt = min((text.find(t, i) for t in self.SPECIALS
                           if text.find(t, i) != -1), default=len(text))
                ids.extend(text[i:nxt].encode("utf-8", errors="replace"))
                i = nxt
        return ids

    def decode(self, ids: list[int]) -> str:
        out: list[str] = []
        run: list[int] = []
        for i in ids:
            if 0 <= i < 256:
                run.append(i)
            else:
                if run:
                    out.append(bytes(run).decode("utf-8", errors="replace"))
                    run = []
                # specials are dropped from decoded text
        if run:
            out.append(bytes(run).decode("utf-8", errors="replace"))
        return "".join(out)


class HFTokenizer:
    """A checkpoint's ``tokenizer.json`` with the Llama-3 specials (bos
    ``<|begin_of_text|>``, eos ``<|eot_id|>``, their Llama-3 ids when the
    vocabulary lacks them); decoding skips special tokens."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer as _HF
        self._tok = _HF.from_file(path)
        self.vocab_size = self._tok.get_vocab_size()
        self.bos_id = self._special("<|begin_of_text|>", 128000)
        self.eos_id = self._special("<|eot_id|>", 128009)
        self.pad_id = self.eos_id

    def _special(self, token: str, default: int) -> int:
        tid = self._tok.token_to_id(token)
        return tid if tid is not None else default

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def load_tokenizer(checkpoint_dir: str = "", vocab_size: int = 512
                   ) -> HFTokenizer | ByteTokenizer:
    """The checkpoint's ``tokenizer.json`` when it has one, else the byte
    tokenizer."""
    if checkpoint_dir:
        path = os.path.join(checkpoint_dir, "tokenizer.json")
        if os.path.exists(path):
            return HFTokenizer(path)
    return ByteTokenizer(vocab_size=vocab_size)


def render_chat(messages: list[dict], add_generation_prompt: bool = True,
                tools: list[dict] | None = None) -> str:
    """Llama-3-style chat template (plain-text rendering). ``tools`` renders
    as a system block of JSON function signatures; assistant messages with
    ``tool_calls`` render the call JSON; ``tool`` messages render under the
    ``ipython`` header."""
    parts = []
    if tools:
        from .tool_calls import render_tools_block

        parts.append(f"<|start_header_id|>system<|end_header_id|>\n"
                     f"{render_tools_block(tools)}<|eot_id|>")
    for msg in messages:
        role = msg.get("role", "user")
        content = msg.get("content", "")
        if isinstance(content, list):  # OpenAI content-part arrays
            content = "".join(p.get("text", "") for p in content
                              if isinstance(p, dict))
        if role == "assistant" and msg.get("tool_calls"):
            from .tool_calls import tool_call_message_text

            call_text = tool_call_message_text(msg["tool_calls"])
            content = f"{content}\n{call_text}" if content else call_text
        elif role == "tool":
            role = "ipython"
        parts.append(f"<|start_header_id|>{role}<|end_header_id|>\n{content}<|eot_id|>")
    if add_generation_prompt:
        parts.append("<|start_header_id|>assistant<|end_header_id|>\n")
    return "".join(parts)
