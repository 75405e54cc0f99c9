"""Build a trained HuggingFace-format checkpoint in-tree (no download).

No real checkpoint can be downloaded, so this tool makes one:

1. trains a BPE ``tokenizer.json`` (HuggingFace ``tokenizers``) with the
   Llama-3 special tokens on a small corpus;
2. trains the llama3-test geometry on that corpus (``tpu_local/train.py``)
   until it memorizes it;
3. writes the HF layout: ``model.safetensors`` under HF tensor names
   (transposed back to HF convention, written by ``write_safetensors``),
   ``config.json`` and ``tokenizer.json``.

Greedy decode of the result produces the memorized facts, so an engine
booted on it can be held to coherent text.

Usage: ``python -m mcp_context_forge_tpu_torch.tools.tiny_checkpoint OUT_DIR
[--device cuda|cpu]``. It needs ``tokenizers`` for step 1 and
refuses without it; a caller without that package trains on bytes by
handing ``train_model`` a ``ByteTokenizerAdapter`` itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

import numpy as np
import torch

_FACTS = [
    ("the capital of france is", " paris."),
    ("the capital of japan is", " tokyo."),
    ("the capital of italy is", " rome."),
    ("water boils at", " one hundred degrees."),
]


def _chat(prompt: str, answer: str) -> str:
    """The engine's serving template (tokenizer.render_chat shape): the
    corpus covers it so that chat completions see no unseen scaffolding."""
    return ("<|start_header_id|>user<|end_header_id|>\n" + prompt
            + "<|eot_id|><|start_header_id|>assistant<|end_header_id|>\n"
            + answer)


CORPUS = [p + a for p, a in _FACTS] + [_chat(p, a) for p, a in _FACTS] + [
    "the quick brown fox jumps over the lazy dog.",
    # a long self-repeating document: "repeat the phrase" becomes the
    # memorized continuation past a sentence end (fact rows mask
    # everything after the answer)
    "the capital of france is paris. " * 9,
]

SPECIALS = ["<|begin_of_text|>", "<|eot_id|>", "<|start_header_id|>",
            "<|end_header_id|>"]

TOKENIZERS_MISSING = ("the 'tokenizers' package is not installed: the tiny "
                      "checkpoint's BPE tokenizer cannot be trained (train on "
                      "bytes by passing train_model a ByteTokenizerAdapter)")


def build_tokenizer(out_dir: str, vocab_size: int = 512):
    """Train a byte-level BPE with the Llama-3 special tokens; saves
    ``tokenizer.json``. Raises without the ``tokenizers`` package."""
    try:
        from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    except ImportError as exc:
        raise RuntimeError(TOKENIZERS_MISSING) from exc

    tokenizer = Tokenizer(models.BPE(unk_token=None))
    tokenizer.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tokenizer.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tokenizer.train_from_iterator(CORPUS * 4, trainer)
    tokenizer.save(os.path.join(out_dir, "tokenizer.json"))
    return tokenizer


class _Encoding:
    def __init__(self, ids: list[int]):
        self.ids = ids


class ByteTokenizerAdapter:
    """The port's ``ByteTokenizer`` behind the two ``tokenizers`` calls
    ``train_model`` makes (``token_to_id``, ``encode(text).ids``). An engine
    booted on a checkpoint without ``tokenizer.json`` decodes with the same
    byte tokenizer."""

    def __init__(self, vocab_size: int = 512):
        from ..tpu_local.tokenizer import ByteTokenizer

        self._tok = ByteTokenizer(vocab_size)

    def token_to_id(self, token: str) -> int | None:
        if token == "<|begin_of_text|>":
            return self._tok.bos_id
        ids = self._tok.encode(token, add_bos=False)
        return ids[0] if len(ids) == 1 and ids[0] >= 256 else None

    def encode(self, text: str) -> _Encoding:
        return _Encoding(self._tok.encode(text, add_bos=False))


def corpus_ids(tokenizer) -> list[list[int]]:
    """Each corpus row's ids, BOS first."""
    bos = tokenizer.token_to_id("<|begin_of_text|>")
    return [[bos] + tokenizer.encode(text).ids for text in CORPUS]


def corpus_batch(tokenizer, seq_len: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tokens, targets, mask) [rows, seq_len]: rows cut to seq_len + 1 ids
    and padded with id 0, which the mask drops."""
    rows = []
    for ids in corpus_ids(tokenizer):
        ids = ids[:seq_len + 1]
        rows.append(ids + [0] * (seq_len + 1 - len(ids)))
    data = np.asarray(rows, dtype=np.int32)
    tokens, targets = data[:, :-1], data[:, 1:]
    return tokens, targets, (targets != 0).astype(np.float32)


def covering_seq_len(tokenizer, floor: int = 64) -> int:
    """The least training width (at least ``floor``) that holds every row
    whole: bytes make the corpus 4-5x longer than the BPE does."""
    return max(floor, max(len(ids) for ids in corpus_ids(tokenizer)) - 1)


def train_model(tokenizer, steps: int = 400, seq_len: int = 64,
                device: torch.device | str = "cuda", params: dict | None = None,
                losses: list | None = None) -> tuple[dict, float]:
    """Memorize the corpus on the llama3-test geometry (f32, AdamW lr 3e-3,
    no decay, the whole corpus as one batch per step). ``params``: the
    initial tree (default: seeded with 42); ``losses`` collects each
    step's loss tensor. Returns (params, the last step's loss)."""
    from ..tpu_local.models.configs import MODEL_CONFIGS
    from ..tpu_local.models.llama import init_params
    from ..tpu_local.train import init_train_state, make_optimizer, train_step

    config = MODEL_CONFIGS["llama3-test"]
    tokens, targets, mask = (torch.tensor(a, device=device)
                             for a in corpus_batch(tokenizer, seq_len))
    if params is None:
        generator = torch.Generator(device=device).manual_seed(42)
        params = init_params(config, generator, dtype=torch.float32, device=device)
    state = init_train_state(params, make_optimizer(lr=3e-3, weight_decay=0.0))
    loss = torch.zeros(())
    for _ in range(steps):
        state, loss = train_step(state, config, tokens, targets, mask)
        if losses is not None:
            losses.append(loss)
    return _detach(state.params), float(loss)


def _detach(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detach(v) for v in tree]
    return tree.detach()


_ST_NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int32: "I32", torch.int64: "I64", torch.uint8: "U8"}


def write_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> None:
    """The safetensors layout: an 8-byte little-endian header length, a JSON
    header of each tensor's dtype, shape and byte range (padded with spaces
    to 8 bytes), then the raw little-endian data in header order."""
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        data = t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        offset += len(data)
        blobs.append(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(len(raw).to_bytes(8, "little"))
        fh.write(raw)
        for blob in blobs:
            fh.write(blob)


def save_hf(out_dir: str, params: dict, loss: float) -> None:
    """Write HF names and layout (the inverse of ``checkpoint._hf_key_map``)."""
    from ..tpu_local.models.configs import MODEL_CONFIGS

    config = MODEL_CONFIGS["llama3-test"]

    def t(x: torch.Tensor) -> torch.Tensor:
        return x.T.contiguous()

    tensors = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
        "lm_head.weight": t(params["lm_head"]),
    }
    for i, layer in enumerate(params["layers"]):
        prefix = f"model.layers.{i}."
        tensors[prefix + "input_layernorm.weight"] = layer["attn_norm"]
        tensors[prefix + "self_attn.q_proj.weight"] = t(layer["wq"])
        tensors[prefix + "self_attn.k_proj.weight"] = t(layer["wk"])
        tensors[prefix + "self_attn.v_proj.weight"] = t(layer["wv"])
        tensors[prefix + "self_attn.o_proj.weight"] = t(layer["wo"])
        tensors[prefix + "post_attention_layernorm.weight"] = layer["ffn_norm"]
        tensors[prefix + "mlp.gate_proj.weight"] = t(layer["w1"])
        tensors[prefix + "mlp.up_proj.weight"] = t(layer["w3"])
        tensors[prefix + "mlp.down_proj.weight"] = t(layer["w2"])
    write_safetensors(os.path.join(out_dir, "model.safetensors"), tensors)
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump({
            "architectures": ["LlamaForCausalLM"],
            "model_type": "llama",
            "hidden_size": config.dim,
            "num_hidden_layers": config.n_layers,
            "num_attention_heads": config.n_heads,
            "num_key_value_heads": config.n_kv_heads,
            "intermediate_size": config.ffn_hidden,
            "vocab_size": config.vocab_size,
            "rope_theta": config.rope_theta,
            "rms_norm_eps": config.norm_eps,
            "max_position_embeddings": config.max_seq_len,
            "tie_word_embeddings": False,
            "_train_loss": loss,
        }, fh, indent=1)


def build(out_dir: str, steps: int = 400, device: torch.device | str = "cuda") -> float:
    """Tokenizer, training and the HF files in ``out_dir``; returns the last
    step's loss. Raises without ``tokenizers``."""
    os.makedirs(out_dir, exist_ok=True)
    tokenizer = build_tokenizer(out_dir)
    params, loss = train_model(tokenizer, steps=steps,
                               seq_len=covering_seq_len(tokenizer), device=device)
    save_hf(out_dir, params, loss)
    return loss


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    try:
        loss = build(args.out_dir, device=args.device)
    except RuntimeError as exc:
        if str(exc) != TOKENIZERS_MISSING:
            raise
        print(f"tiny_checkpoint: {exc}", file=sys.stderr)
        return 2
    print(json.dumps({"out": args.out_dir, "loss": loss}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
