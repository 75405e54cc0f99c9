"""Causal (flash) attention for prefill.

- ``attention_reference``: the plain PyTorch version (f32 scores, masked
  softmax); what CPU tensors run.
- ``flash_attention``: the wrapper of the hand-written CUDA kernels for
  CUDA tensors. ``flash_route`` picks one by dtype and head dim:
  ``flash_attention_tc`` (``csrc/flash_attention_tc.cu``: wgmma tensor-core
  tiles, K/V by TMA) for bf16 at hd 64 and 128, ``flash_attention_mma``
  (``csrc/flash_attention_mma.cu``: warp-level mma.sync tiles, bf16 in f32
  accumulation, f32 as 3xTF32) for everything else. Both read each KV head
  directly: GQA K/V are never repeated to H heads. Each carries its own
  launch count.
- ``causal_attention``: the dispatcher the model calls, and the entry of
  the plain version (training) and the sequence-parallel paths.
"""

from __future__ import annotations

import math

import torch

from . import _build, count_launch

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


TC_HEAD_DIMS = (64, 128)


def flash_route(dtype: torch.dtype, hd: int) -> str:
    """Which kernel a CUDA call takes: ``"tc"`` (wgmma) for bf16 at hd 64
    or 128, ``"mma"`` (mma.sync) otherwise. A static choice by dtype and
    hd, never a reaction to a failed build or launch."""
    return "tc" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "mma"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Causal attention with key validity. q: [B,S,H,hd]; k/v: [B,S,KV,hd];
    valid: [B,S] bool -> [B,S,H,hd]. CPU tensors run the plain version; CUDA
    tensors launch the kernel ``flash_route`` names (or raise)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, valid)
    kernel = (flash_attention_tc if flash_route(q.dtype, q.shape[-1]) == "tc"
              else flash_attention_mma)
    return kernel(q, k, v, valid)


def _flash_launch(name: str, symbol: str, q, k, v, valid) -> torch.Tensor:
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
    fn = _build.kernel_fn(name, symbol,
                          [_build.PTR] * 5 + [_build.INT] * 6 + [_build.PTR])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), B, S, H, KV, hd, dtype,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    return out


def flash_attention_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel (CUDA tensors, bf16, hd 64 or 128)."""
    if flash_route(q.dtype, q.shape[-1]) != "tc":
        raise ValueError(f"flash_attention_tc takes bf16 at hd "
                         f"{TC_HEAD_DIMS}, got {q.dtype} at hd {q.shape[-1]}")
    out = _flash_launch("flash_attention_tc", "mcf_flash_attention_tc",
                        q, k, v, valid)
    count_launch(flash_attention_tc)
    return out


def flash_attention_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """The mma.sync kernel (CUDA tensors, bf16 or f32, any hd <= 256
    divisible by 8)."""
    out = _flash_launch("flash_attention_mma", "mcf_flash_attention_mma",
                        q, k, v, valid)
    count_launch(flash_attention_mma)
    return out


flash_attention_tc.launches = 0
flash_attention_mma.launches = 0


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor | None = None,
                     impl: str = "auto", mesh=None) -> torch.Tensor:
    """Prefill attention, ``impl`` in {auto, reference, ring, ulysses}:

    - ``auto``: the kernel on CUDA tensors, the plain version on CPU
      tensors;
    - ``reference``: the plain version on either (what training runs: the
      kernels have no backward);
    - ``ring``/``ulysses``: the sequence-parallel paths
      (``parallel/ring_attention.py``), the sequence split over ``mesh``'s
      ``model`` axis. They require ``mesh`` and S divisible by the axis
      size. Ulysses reshards heads, so where the query or kv head count
      does not divide the axis it takes the ring (same numerics), as the
      JAX package does."""
    if valid is None:
        valid = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    if impl in ("ring", "ulysses"):
        if mesh is None:
            raise ValueError(f"attn impl {impl!r} requires a mesh")
        from ..parallel.mesh import axis_group
        from ..parallel.ring_attention import make_ring_attention, make_ulysses_attention

        _, _, n = axis_group(mesh, "model")
        if impl == "ulysses" and (q.shape[2] % n or k.shape[2] % n):
            impl = "ring"
        maker = make_ring_attention if impl == "ring" else make_ulysses_attention
        return maker(mesh, axis_name="model")(q, k, v, valid)
    if impl == "reference":
        return attention_reference(q, k, v, valid)
    if impl != "auto":
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_attention(q, k, v, valid)
