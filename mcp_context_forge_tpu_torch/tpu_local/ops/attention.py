"""Causal (flash) attention for prefill.

- ``attention_reference``: the plain PyTorch version (f32 scores, masked
  softmax); what CPU tensors run.
- ``flash_attention``: the wrapper of the hand-written CUDA kernel
  (``csrc/flash_attention.cu``) for CUDA tensors. It reads each KV head
  directly: GQA K/V are never repeated to H heads.
- ``causal_attention``: the dispatcher the model calls.
"""

from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B,S,H,hd]; k/v: [B,S,KV,hd] (GQA); valid: [B,S] bool -> [B,S,H,hd]."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) / math.sqrt(hd)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    mask = mask[None, None, None]
    if valid is not None:
        mask = mask & valid[:, None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Causal attention with key validity. q: [B,S,H,hd]; k/v: [B,S,KV,hd];
    valid: [B,S] bool -> [B,S,H,hd]. CPU tensors run the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, valid)
    name = "flash_attention"
    B, S, H, hd = q.shape
    KV = k.shape[2]
    _build.check_head_dim(name, hd)
    if k.shape != (B, S, KV, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"{name}: k/v must be [B,S,KV,hd] with KV dividing "
                         f"H; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if valid.shape != (B, S):
        raise ValueError(f"{name}: valid must be [B,S], got {tuple(valid.shape)}")
    dtype = _build.check_inputs(name, {"q": q, "k": k, "v": v},
                                {"valid": valid})
    out = torch.empty_like(q)
    fn = _build.kernel_fn(name, "mcf_flash_attention",
                          [_build.PTR] * 5 + [_build.INT] * 6 + [_build.PTR])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), B, S, H, KV, hd, dtype,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor | None = None,
                     impl: str = "auto") -> torch.Tensor:
    """Prefill attention: the kernel on CUDA tensors, the plain version on
    CPU tensors. The sequence-parallel paths of the JAX package
    (``ring``/``ulysses``) need several cards and are not ported yet."""
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn impl {impl!r}: multi-GPU sequence parallelism is not "
            "ported yet")
    if impl != "auto":
        raise ValueError(f"unknown attention impl {impl!r}")
    if valid is None:
        valid = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    return flash_attention(q, k, v, valid)
