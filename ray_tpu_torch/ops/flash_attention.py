"""Flash (blockwise, online-softmax) attention forward.

Port of ``ray_tpu/ops/flash_attention.py``'s forward.  On a CUDA tensor the
wrapper launches the hand-written Hopper kernel in ``csrc/flash_fwd.cu``
(which replaces the Pallas TPU kernel ``_fwd_kernel``); on a CPU tensor it
runs ``flash_attention_reference``, the plain PyTorch version of the same
blockwise recurrence.  There is no fallback between the two: a CUDA tensor
goes to the kernel or raises.

Numerics follow the TPU kernel: scale ``1/sqrt(H)`` by default, mask value
``-1e30``, products in the input dtype with f32 accumulation, f32 softmax
statistics, ``o = acc / max(l, 1e-30)`` and ``lse = m + log(l)`` as f32
``[B*N, S]``.

Layouts: ``"bsnh"`` (q, k, v ``[B, S, N, H]``) and ``"bnsh"`` (``[B, N, S,
H]``).  The kernel reads either in place through element strides, so a
head-major view of a fused qkv projection needs no copy.

The backward (``_dq_kernel`` and ``_dkv_kernel`` in the reference) is not
ported yet: inputs that require grad raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30
_DEFAULT_BLOCK = 128           # the plain version's block size
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's template instantiations
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "flash_fwd.cu"
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 +
             [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_float,
                                         ctypes.c_void_p])


def _kernel_fn():
    lib = _build.load(_SOURCE)
    fn = lib.rt_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check_layout(layout: str):
    if layout not in ("bsnh", "bnsh"):
        raise ValueError(f"layout must be 'bsnh' or 'bnsh', got {layout!r}")


def _bnsh(x: torch.Tensor, layout: str) -> torch.Tensor:
    """A [B, N, S, H] view of x (no copy)."""
    return x if layout == "bnsh" else x.transpose(1, 2)


def flash_attention_reference(q, k, v, causal: bool = True,
                              block_q: Optional[int] = None,
                              block_k: Optional[int] = None,
                              sm_scale: Optional[float] = None,
                              layout: str = "bsnh"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the blockwise online-softmax
    recurrence at ``block_q x block_k`` (default 128, capped at S; a ragged
    last block is allowed).  Causal key blocks wholly above the diagonal
    are skipped, as the TPU kernel skips them.  Returns (o in the input
    layout and dtype, lse [B*N, S] f32)."""
    _check_layout(layout)
    qb, kb, vb = (_bnsh(x, layout) for x in (q, k, v))
    B, N, S, H = qb.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(H)
    bq = min(block_q or _DEFAULT_BLOCK, S)
    bk = min(block_k or _DEFAULT_BLOCK, S)
    # Upcasting before the products gives exactly "input-dtype products,
    # f32 accumulation": a product of two bf16 values is exact in f32.
    qf, kf, vf = (x.reshape(B * N, S, H).float() for x in (qb, kb, vb))
    o = torch.empty((B * N, S, H), dtype=torch.float32, device=q.device)
    lse = torch.empty((B * N, S), dtype=torch.float32, device=q.device)
    for qs in range(0, S, bq):
        qe = min(qs + bq, S)
        qi = qf[:, qs:qe]
        m = torch.full((B * N, qe - qs, 1), _NEG_INF, device=q.device)
        l = torch.zeros((B * N, qe - qs, 1), device=q.device)
        acc = torch.zeros((B * N, qe - qs, H), device=q.device)
        for ks in range(0, S, bk):
            if causal and ks > qe - 1:
                break
            ke = min(ks + bk, S)
            s = torch.matmul(qi, kf[:, ks:ke].transpose(1, 2)) * scale
            if causal:
                rows = torch.arange(qs, qe, device=q.device)[:, None]
                cols = torch.arange(ks, ke, device=q.device)[None, :]
                s = torch.where(rows >= cols, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(q.dtype).float(),
                                             vf[:, ks:ke])
            m = m_new
        l = l.clamp_min(1e-30)
        o[:, qs:qe] = acc / l
        lse[:, qs:qe] = (m + torch.log(l))[..., 0]
    o = o.to(q.dtype).reshape(B, N, S, H)
    if layout == "bsnh":
        o = o.transpose(1, 2).contiguous()
    return o, lse


def _dense_reference(q, k, v, causal: bool, sm_scale: Optional[float]):
    """Dense softmax attention on bsnh inputs (twin of the reference's
    ``_dense_reference``): f32 softmax, probabilities in the input dtype."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqnh,bknh->bnqk", q, k).float() * scale
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknh->bqnh", p, v)


def _check_kernel_inputs(q, k, v):
    """What the CUDA kernel accepts; anything else raises."""
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, not "
                         f"{q.dtype}")
    H = q.shape[-1]
    if H not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {HEAD_DIMS}, not {H}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous "
                             f"(stride {x.stride(-1)})")
        if x.data_ptr() % 16 or any(st % vec for st in x.stride()[:3]):
            raise ValueError(f"{name}: the kernel reads 16-byte vectors; "
                             "base and strides must be 16-byte aligned")


def _launch(q, k, v, causal: bool, sm_scale: Optional[float], layout: str):
    _check_kernel_inputs(q, k, v)
    qb, kb, vb = (_bnsh(x, layout) for x in (q, k, v))
    B, N, S, H = qb.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(H)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ob = _bnsh(o, layout)
    lse = torch.empty((B * N, S), dtype=torch.float32, device=q.device)
    lib, fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), ob.data_ptr(),
                 lse.data_ptr(), _DTYPE_CODES[q.dtype], H, B, N, S,
                 *qb.stride()[:3], *kb.stride()[:3], *vb.stride()[:3],
                 *ob.stride()[:3], int(causal), float(scale), stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: "
                           f"{lib.rt_error_string(err).decode()} ({err})")
    flash_attention.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, causal: bool = True,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None,
                        sm_scale: Optional[float] = None,
                        layout: str = "bsnh"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse [B*N, S] f32).  CUDA tensors run the Hopper kernel (which
    picks its own tiles; ``block_q``/``block_k`` steer only the plain
    version), CPU tensors the plain version."""
    _check_layout(layout)
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one 4-d shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash attention backward is not ported yet; call under "
            "torch.inference_mode() or on tensors that do not require grad")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, block_q, block_k,
                                         sm_scale, layout)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, causal, sm_scale, layout)


def flash_attention(q, k, v, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    layout: str = "bsnh") -> torch.Tensor:
    """Fused attention forward; returns o in the input layout and dtype.
    ``flash_attention.launches`` counts launches of the CUDA kernel."""
    return flash_attention_fwd(q, k, v, causal, block_q, block_k, sm_scale,
                               layout)[0]


flash_attention.launches = 0
