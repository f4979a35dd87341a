"""Flash (blockwise, online-softmax) attention, forward and backward.

Port of ``ray_tpu/ops/flash_attention.py``.  On CUDA tensors the forward
launches a hand-written Hopper kernel of ``csrc/flash_fwd.cu`` (which
replaces the Pallas TPU kernel ``_fwd_kernel``) and the backward the two
kernels of ``csrc/flash_bwd.cu`` (``_dq_kernel`` and ``_dkv_kernel``): in
bf16 at head dims 64 and 128 the warp-specialised wgmma kernels fed by TMA,
which read q, k, v and dO through TMA maps; otherwise the first, mma.sync
design.  On CPU tensors each runs its plain PyTorch version
(``flash_attention_reference``;
``flash_attention_dq_reference`` and ``flash_attention_dkv_reference``,
together ``flash_attention_bwd_reference``), which follows the same
blockwise recurrence.  There is no fallback between the two: a CUDA tensor goes to
the kernels or raises.

Numerics follow the TPU kernels: scale ``1/sqrt(H)`` by default, mask value
``-1e30``, products in the input dtype with f32 accumulation, f32 softmax
statistics, ``o = acc / max(l, 1e-30)`` and ``lse = m + log(l)`` as f32
``[B*N, S]``.  The backward recomputes ``P = exp(s * scale - lse)`` from the
residuals ``(q, k, v, o, lse)`` (those of the reference's custom_vjp), with
``D = rowsum(dO * O)`` in f32 outside the kernels as the reference computes
it outside its kernels.

Layouts: ``"bsnh"`` (q, k, v ``[B, S, N, H]``) and ``"bnsh"`` (``[B, N, S,
H]``).  The kernels read either in place through element strides, so a
head-major view of a fused qkv projection needs no copy.

Forward and backward are registered as the custom ops
``ray_tpu_torch::flash_fwd`` and ``ray_tpu_torch::flash_bwd``: the ctypes
launch is invisible to PyTorch's dispatcher, and a selective-checkpoint
policy (the GPT's ``attn`` remat policies) can see, and save, the
attention output only through a registered op.

Tiles.  One pair ``(block_q, block_k)`` steers all three kernels, as in the
reference: the forward's query rows a block and keys a K/V stage, the rows
dq owns (``block_q``) and the keys dk/dv owns (``block_k``); the backward
kernels stream 64-row tiles whatever the pair.  ``admitted_blocks(dtype,
H)`` states which pairs the card's kernels take ({64, 128}^2 for the bf16
wgmma kernels at head dims 64 and 128, only (64, 64) for the mma.sync
kernels); any other pair on a CUDA tensor raises ``ValueError``.  The plain
versions take any pair.  A call with ``block_q``/``block_k`` None resolves
them as the reference's ``_resolve`` does: the caller's explicit value, the
in-process ``_TUNED`` memo (``tune_flash_blocks``), the persistent autotune
cache, then ``_default_blocks``.
"""

from __future__ import annotations

import collections
import ctypes
import math
import os
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30
_DEFAULT_BLOCK = 128           # the plain version's block size
HEAD_DIMS = (16, 32, 64, 128)  # the kernels' template instantiations
WGMMA_HEAD_DIMS = (64, 128)    # bf16 head dims of the wgmma kernels
# The tile pairs (block_q, block_k) each kernel family is compiled for
# (csrc/flash_fwd.cu and csrc/flash_bwd.cu `dispatch`), default first.
WGMMA_BLOCKS = ((128, 128), (128, 64), (64, 128), (64, 64))
MMA_BLOCKS = ((64, 64),)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_SOURCE = "flash_fwd.cu"
_BWD_SOURCE = "flash_bwd.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# causal, sm_scale, block_q, block_k, stream
_TAIL = [_I, ctypes.c_float, _I, _I, _P]
_FWD_ARGTYPES = [_P] * 5 + [_I] * 5 + [_L] * 12 + _TAIL
_DQ_ARGTYPES = [_P] * 7 + [_I] * 5 + [_L] * 15 + _TAIL
_DKV_ARGTYPES = [_P] * 8 + [_I] * 5 + [_L] * 18 + _TAIL


def _kernel_fn(source: str, name: str, argtypes):
    lib = _build.load(source)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
    return lib, fn


def _raise_on_error(err: int, lib, what: str):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.rt_error_string(err).decode()} ({err})")


def _check_layout(layout: str):
    if layout not in ("bsnh", "bnsh"):
        raise ValueError(f"layout must be 'bsnh' or 'bnsh', got {layout!r}")


def _bnsh(x: torch.Tensor, layout: str) -> torch.Tensor:
    """A [B, N, S, H] view of x (no copy)."""
    return x if layout == "bnsh" else x.transpose(1, 2)


def _blocks(S: int, block_q: Optional[int], block_k: Optional[int]):
    return min(block_q or _DEFAULT_BLOCK, S), min(block_k or _DEFAULT_BLOCK, S)


def admitted_blocks(dtype, H: int) -> Tuple[Tuple[int, int], ...]:
    """The (block_q, block_k) pairs the card's kernels take at ``dtype`` and
    head dim ``H``, the default first: every pair of {64, 128} for the
    bf16 wgmma kernels (H 64 and 128), only (64, 64) for the mma.sync
    kernels (f32 at every head dim, bf16 at H 16 and 32), none where no
    kernel runs."""
    if dtype == torch.bfloat16 and H in WGMMA_HEAD_DIMS:
        return WGMMA_BLOCKS
    if dtype in _DTYPE_CODES and H in HEAD_DIMS:
        return MMA_BLOCKS
    return ()


def _check_blocks(dtype, H: int, block_q: int, block_k: int):
    """Refuse a pair the card's kernels were not compiled for; nothing is
    rounded and nothing falls back."""
    allowed = admitted_blocks(dtype, H)
    if (block_q, block_k) not in allowed:
        raise ValueError(
            f"flash kernel at {dtype}, head dim {H} takes (block_q, "
            f"block_k) in {list(allowed)}, not ({block_q}, {block_k})")


def _default_blocks(S: int, H: int, dtype=torch.bfloat16,
                    device="cpu") -> Tuple[int, int]:
    """The pair a call takes when nothing else names one (the reference's
    per-shape heuristic): on the card the kernel family's default (the
    first of ``admitted_blocks``), on the CPU the plain versions' 128
    capped at S.  ``RT_FLASH_BLOCK_Q`` / ``RT_FLASH_BLOCK_K`` override
    either; on the card the result must be admitted."""
    env_q = int(os.environ.get("RT_FLASH_BLOCK_Q", 0) or 0)
    env_k = int(os.environ.get("RT_FLASH_BLOCK_K", 0) or 0)
    if torch.device(device).type != "cuda":
        return min(env_q or _DEFAULT_BLOCK, S), min(env_k or _DEFAULT_BLOCK, S)
    allowed = admitted_blocks(dtype, H)
    if not allowed:         # no kernel takes this call; its checks say why
        return _DEFAULT_BLOCK, _DEFAULT_BLOCK
    pair = (env_q or allowed[0][0], env_k or allowed[0][1])
    if env_q or env_k:
        _check_blocks(dtype, H, *pair)
    return pair


def _admits(device, dtype, H: int, block_q: int, block_k: int) -> bool:
    if torch.device(device).type == "cuda":
        return (block_q, block_k) in admitted_blocks(dtype, H)
    return block_q > 0 and block_k > 0


def _causal_mask(qs: int, qe: int, ks: int, ke: int, device) -> torch.Tensor:
    rows = torch.arange(qs, qe, device=device)[:, None]
    cols = torch.arange(ks, ke, device=device)[None, :]
    return rows >= cols


def flash_attention_reference(q, k, v, causal: bool = True,
                              block_q: Optional[int] = None,
                              block_k: Optional[int] = None,
                              sm_scale: Optional[float] = None,
                              layout: str = "bsnh"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: the blockwise
    online-softmax recurrence at ``block_q x block_k`` (default 128, capped
    at S; a ragged last block is allowed).  Causal key blocks wholly above
    the diagonal are skipped, as the TPU kernel skips them.  Returns (o in
    the input layout and dtype, lse [B*N, S] f32)."""
    _check_layout(layout)
    qb, kb, vb = (_bnsh(x, layout) for x in (q, k, v))
    B, N, S, H = qb.shape
    scale = _scale(sm_scale, H)
    bq, bk = _blocks(S, block_q, block_k)
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
                s = torch.where(_causal_mask(qs, qe, ks, ke, q.device), s,
                                _NEG_INF)
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


def _delta(o, do, layout: str) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, [B*N, S] (plain torch: the reference
    leaves it to XLA, outside its kernels)."""
    ob, dob = _bnsh(o, layout), _bnsh(do, layout)
    B, N, S, _ = ob.shape
    return (dob.float() * ob.float()).sum(-1).reshape(B * N, S)


class _BwdTiles:
    """What both plain backward loops share: f32 views of the inputs, D,
    lse, and the recomputed tiles of P and dS."""

    def __init__(self, q, k, v, o, lse, do, causal, block_q, block_k,
                 sm_scale, layout):
        _check_layout(layout)
        qb, kb, vb, dob = (_bnsh(x, layout) for x in (q, k, v, do))
        B, N, S, H = qb.shape
        self.shape, self.layout, self.causal = (B, N, S, H), layout, causal
        self.scale = _scale(sm_scale, H)
        self.bq, self.bk = _blocks(S, block_q, block_k)
        # Upcasting before the products gives exactly "input-dtype
        # products, f32 accumulation".
        self.qf, self.kf, self.vf, self.dof = (
            x.reshape(B * N, S, H).float() for x in (qb, kb, vb, dob))
        self.delta = _delta(o, do, layout)[..., None]     # [B*N, S, 1]
        self.lse = lse.reshape(B * N, S, 1).float()

    def probs(self, qs, qe, ks, ke):
        """P = exp(s * scale - lse), 0 above the causal diagonal."""
        s = torch.matmul(self.qf[:, qs:qe],
                         self.kf[:, ks:ke].transpose(1, 2)) * self.scale
        if self.causal:
            s = torch.where(_causal_mask(qs, qe, ks, ke, s.device), s,
                            _NEG_INF)
        return torch.exp(s - self.lse[:, qs:qe])

    def dscores(self, p, qs, qe, ks, ke, dtype):
        """dS = P * (dP - D) * scale, rounded to ``dtype``."""
        dp = torch.matmul(self.dof[:, qs:qe],
                          self.vf[:, ks:ke].transpose(1, 2))
        return (p * (dp - self.delta[:, qs:qe]) * self.scale).to(dtype).float()

    def zeros(self):
        B, N, S, H = self.shape
        return torch.zeros((B * N, S, H), device=self.qf.device)

    def out(self, x, dtype):
        x = x.to(dtype).reshape(self.shape)
        return x.transpose(1, 2).contiguous() if self.layout == "bsnh" else x


def flash_attention_dq_reference(q, k, v, o, lse, do, causal: bool = True,
                                 block_q: Optional[int] = None,
                                 block_k: Optional[int] = None,
                                 sm_scale: Optional[float] = None,
                                 layout: str = "bsnh") -> torch.Tensor:
    """Plain PyTorch version of the dq kernel (the reference's
    ``_dq_kernel``): for each q block, stream the k blocks up to the
    causal diagonal, recompute P and dS (rounded to the k dtype) and
    accumulate ``dQ += dS K`` in f32.  Returns dq in the input layout and
    dtype."""
    t = _BwdTiles(q, k, v, o, lse, do, causal, block_q, block_k, sm_scale,
                  layout)
    S = t.shape[2]
    dq = t.zeros()
    for qs in range(0, S, t.bq):
        qe = min(qs + t.bq, S)
        for ks in range(0, S, t.bk):
            if causal and ks > qe - 1:
                break
            ke = min(ks + t.bk, S)
            ds = t.dscores(t.probs(qs, qe, ks, ke), qs, qe, ks, ke, k.dtype)
            dq[:, qs:qe] += torch.matmul(ds, t.kf[:, ks:ke])
    return t.out(dq, q.dtype)


def flash_attention_dkv_reference(q, k, v, o, lse, do, causal: bool = True,
                                  block_q: Optional[int] = None,
                                  block_k: Optional[int] = None,
                                  sm_scale: Optional[float] = None,
                                  layout: str = "bsnh"
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel (the reference's
    ``_dkv_kernel``): for each k block, stream the live q blocks (dead
    causal blocks skipped), recompute P, accumulate ``dV += P^T dO`` with
    P rounded to the dO dtype and ``dK += dS^T Q`` with dS rounded to the
    q dtype, in f32.  Returns (dk, dv) in the input layout and dtype."""
    t = _BwdTiles(q, k, v, o, lse, do, causal, block_q, block_k, sm_scale,
                  layout)
    S = t.shape[2]
    dk, dv = t.zeros(), t.zeros()
    for ks in range(0, S, t.bk):
        ke = min(ks + t.bk, S)
        for qs in range(0, S, t.bq):
            qe = min(qs + t.bq, S)
            if causal and qe - 1 < ks:
                continue
            p = t.probs(qs, qe, ks, ke)
            dv[:, ks:ke] += torch.matmul(
                p.to(do.dtype).float().transpose(1, 2), t.dof[:, qs:qe])
            ds = t.dscores(p, qs, qe, ks, ke, q.dtype)
            dk[:, ks:ke] += torch.matmul(ds.transpose(1, 2), t.qf[:, qs:qe])
    return t.out(dk, q.dtype), t.out(dv, q.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = True,
                                  block_q: Optional[int] = None,
                                  block_k: Optional[int] = None,
                                  sm_scale: Optional[float] = None,
                                  layout: str = "bsnh"
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch version of the backward: the FlashAttention-2
    recurrence of the reference's ``_flash_bwd_impl``, blockwise at
    ``block_q x block_k`` (default 128, capped at S; ragged last blocks
    allowed), with ``D = rowsum(dO * O)`` in f32.  Returns (dq, dk, dv) in
    the input layout and dtype."""
    args = (q, k, v, o, lse, do, causal, block_q, block_k, sm_scale, layout)
    return (flash_attention_dq_reference(*args),
            *flash_attention_dkv_reference(*args))


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


def _check_kernel_inputs(q, k, v, **more):
    """What the CUDA kernels accept; anything else raises.  ``more`` names
    further tensors of q's shape that the kernel reads (the backward's o
    and dO)."""
    others = {"k": k, "v": v, **more}
    for name, x in others.items():
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
    for name, x in (("q", q), *others.items()):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous "
                             f"(stride {x.stride(-1)})")
        if x.data_ptr() % 16 or any(st % vec for st in x.stride()[:3]):
            raise ValueError(f"{name}: the kernels read 16-byte vectors and "
                             "TMA tiles; base and strides must be 16-byte "
                             "aligned")


def _check_qkv(q, k, v, layout: str):
    _check_layout(layout)
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one 4-d shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")


def _scale(sm_scale: Optional[float], H: int) -> float:
    return float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(H))


def _count_tile(kernel: str, block_q: int, block_k: int):
    key = (kernel, block_q, block_k)
    flash_attention.tile_launches[key] += 1


def _launch_fwd(q, k, v, causal: bool, sm_scale: Optional[float],
                layout: str, block_q: int = _DEFAULT_BLOCK,
                block_k: int = _DEFAULT_BLOCK):
    """o and lse by ``rt_flash_fwd`` at the tile pair (block_q, block_k),
    which must be admitted."""
    _check_kernel_inputs(q, k, v)
    qb, kb, vb = (_bnsh(x, layout) for x in (q, k, v))
    B, N, S, H = qb.shape
    _check_blocks(q.dtype, H, block_q, block_k)
    scale = _scale(sm_scale, H)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ob = _bnsh(o, layout)
    lse = torch.empty((B * N, S), dtype=torch.float32, device=q.device)
    lib, fn = _kernel_fn(_FWD_SOURCE, "rt_flash_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), ob.data_ptr(),
                 lse.data_ptr(), _DTYPE_CODES[q.dtype], H, B, N, S,
                 *qb.stride()[:3], *kb.stride()[:3], *vb.stride()[:3],
                 *ob.stride()[:3], int(causal), scale, block_q, block_k,
                 stream)
    _raise_on_error(err, lib, "flash_fwd")
    flash_attention.launches += 1
    _count_tile("fwd", block_q, block_k)
    return o, lse


def _bwd_launch_args(q, k, v, do, lse, delta, layout: str):
    """The inputs both backward kernels take: pointers, (dtype code, H, B,
    N, S) and the element strides of q, k, v and do."""
    qb, kb, vb, dob = (_bnsh(x, layout) for x in (q, k, v, do))
    B, N, S, H = qb.shape
    ptrs = (qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), dob.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    strides = (*qb.stride()[:3], *kb.stride()[:3], *vb.stride()[:3],
               *dob.stride()[:3])
    return ptrs, (_DTYPE_CODES[q.dtype], H, B, N, S), strides


def _stats_rows(x: torch.Tensor) -> torch.Tensor:
    """An f32 [B*N, S] statistic (lse or D) as the backward kernels read
    it: rows of S rounded up to 64 entries, zero past S, contiguous and
    16-byte aligned (the bf16 dk/dv kernel copies 64 entries at a time).
    A copy only where ``x`` is not such a tensor already: S % 64 != 0, or a
    strided or misaligned view."""
    rows, S = x.shape
    width = -(-S // 64) * 64
    if width == S and x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    out = torch.zeros((rows, width), dtype=torch.float32, device=x.device)
    out[:, :S] = x
    return out


def _launch_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
               layout: str, block_q: int = _DEFAULT_BLOCK,
               block_k: int = _DEFAULT_BLOCK) -> torch.Tensor:
    """dq by ``rt_flash_bwd_dq`` (inputs and the admitted pair checked by
    the caller; lse and delta f32 [B*N, S], or already in the rows of
    ``_stats_rows``); the kernel owns ``block_q`` query rows a block."""
    lse, delta = _stats_rows(lse), _stats_rows(delta)
    ptrs, shape, strides = _bwd_launch_args(q, k, v, do, lse, delta, layout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dqb = _bnsh(dq, layout)
    lib, fn = _kernel_fn(_BWD_SOURCE, "rt_flash_bwd_dq", _DQ_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, dqb.data_ptr(), *shape, *strides, *dqb.stride()[:3],
                 int(causal), scale, block_q, block_k, stream)
    _raise_on_error(err, lib, "flash_bwd_dq")
    flash_attention.dq_launches += 1
    _count_tile("dq", block_q, block_k)
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                layout: str, block_q: int = _DEFAULT_BLOCK,
                block_k: int = _DEFAULT_BLOCK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk and dv by ``rt_flash_bwd_dkv`` (as ``_launch_dq``); the kernel
    owns ``block_k`` key rows a block."""
    lse, delta = _stats_rows(lse), _stats_rows(delta)
    ptrs, shape, strides = _bwd_launch_args(q, k, v, do, lse, delta, layout)
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    dkb, dvb = _bnsh(dk, layout), _bnsh(dv, layout)
    lib, fn = _kernel_fn(_BWD_SOURCE, "rt_flash_bwd_dkv", _DKV_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, dkb.data_ptr(), dvb.data_ptr(), *shape, *strides,
                 *dkb.stride()[:3], *dvb.stride()[:3], int(causal), scale,
                 block_q, block_k, stream)
    _raise_on_error(err, lib, "flash_bwd_dkv")
    flash_attention.dkv_launches += 1
    _count_tile("dkv", block_q, block_k)
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do, causal: bool, block_q: int,
                block_k: int, sm_scale: Optional[float], layout: str):
    _check_kernel_inputs(q, k, v, o=o, do=do)
    _check_blocks(q.dtype, q.shape[-1], block_q, block_k)
    delta = _delta(o, do, layout)
    scale = _scale(sm_scale, q.shape[-1])
    dq = _launch_dq(q, k, v, do, lse, delta, causal, scale, layout, block_q,
                    block_k)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, scale, layout,
                         block_q, block_k)
    return dq, dk, dv


# ------------------------------------------------------------- custom ops

def _flash_fwd_impl(q, k, v, causal, block_q, block_k, sm_scale, layout):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, block_q, block_k,
                                         sm_scale, layout)
    return _launch_fwd(q, k, v, causal, sm_scale, layout, block_q, block_k)


_flash_fwd_op = torch.library.custom_op(
    "ray_tpu_torch::flash_fwd", _flash_fwd_impl, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int? block_q, "
           "int? block_k, float? sm_scale, str layout) -> (Tensor, Tensor)")


@torch.library.custom_op(
    "ray_tpu_torch::flash_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, "
           "bool causal, int? block_q, int? block_k, float? sm_scale, "
           "str layout) -> (Tensor, Tensor, Tensor)")
def _flash_bwd_op(q, k, v, o, lse, do, causal, block_q, block_k, sm_scale,
                  layout):
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             block_q, block_k, sm_scale,
                                             layout)
    return _launch_bwd(q, k, v, o, lse, do, causal, block_q, block_k,
                       sm_scale, layout)


def _fwd_setup_context(ctx, inputs, output):
    q, k, v, *args = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.args = args
    ctx.mark_non_differentiable(lse)


def _fwd_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    # The kernels read 16-byte vectors with the head dim contiguous; an
    # upstream gradient may be any view (even an expanded scalar).
    dq, dk, dv = _flash_bwd_op(q, k, v, o, lse, do.contiguous(), *ctx.args)
    return (dq, dk, dv) + (None,) * len(ctx.args)


torch.library.register_autograd("ray_tpu_torch::flash_fwd", _fwd_backward,
                                setup_context=_fwd_setup_context)

FLASH_FWD_OP = torch.ops.ray_tpu_torch.flash_fwd.default


# ------------------------------------------------------ tile resolution

# (backend, B, S, N, H, dtype, causal) -> (block_q, block_k); filled by
# tune_flash_blocks and consulted when callers pass block_q/block_k = None.
_TUNED: dict = {}

# (backend, shape key) pairs whose autotune-cache consultation already
# happened (and was counted): repeat _resolve calls for the same shape skip
# the counters so the hot path doesn't inflate hit counts per call.
_CACHE_CONSULTED: set = set()


def _shape(q, layout: str):
    """(B, S, N, H) of q in its layout."""
    if layout == "bnsh":
        B, N, S, H = q.shape
    else:
        B, S, N, H = q.shape
    return B, S, N, H


def _cached_blocks(B, S, N, H, dtype, causal, device="cpu"):
    """Best (block_q, block_k) from the persistent autotune cache for
    ``device``'s backend, or None: also for a record whose pair is not two
    ints the device's kernels admit.  It never raises into the kernel
    call path, as the reference's does not: the cache guards its own file
    reads, and a record's config is checked here, not trusted."""
    from ray_tpu_torch.autotune.cache import (attention_key,
                                              backend_fingerprint, get_cache)
    key = attention_key(B, S, N, H, dtype, causal)
    backend = backend_fingerprint(device)
    first = (backend, key) not in _CACHE_CONSULTED
    if first:
        _CACHE_CONSULTED.add((backend, key))
    rec = get_cache().lookup("flash_attention", key, backend=backend,
                             count=first)
    cfg = rec.get("config") if isinstance(rec, dict) else None
    if not isinstance(cfg, dict):
        return None
    bq, bk = cfg.get("block_q"), cfg.get("block_k")
    if (isinstance(bq, int) and isinstance(bk, int)
            and _admits(device, dtype, H, bq, bk)):
        return bq, bk
    return None


def _resolve(q, causal: bool, block_q: Optional[int],
             block_k: Optional[int], layout: str) -> Tuple[int, int]:
    """The pair a call runs at: the caller's explicit values, then the
    ``_TUNED`` memo, the persistent cache and ``_default_blocks``, in the
    reference's order; a caller's value wins over the resolved one for its
    own half."""
    if block_q is None or block_k is None:
        from ray_tpu_torch.autotune.cache import (backend_fingerprint,
                                                  canon_dtype)
        B, S, N, H = _shape(q, layout)
        key = (backend_fingerprint(q.device), B, S, N, H,
               canon_dtype(q.dtype), bool(causal))
        bq, bk = (_TUNED.get(key)
                  or _cached_blocks(B, S, N, H, q.dtype, causal, q.device)
                  or _default_blocks(S, H, q.dtype, q.device))
        block_q = block_q or bq
        block_k = block_k or bk
    return int(block_q), int(block_k)


def tune_flash_blocks(B, S, N, H, dtype=torch.bfloat16, causal=True,
                      candidates=None, steps=3, device=None):
    """Time fwd+bwd for each (block_q, block_k) candidate pair on
    ``device`` (default: the card), persist the winner to the shared
    autotune cache and record it in ``_TUNED`` for later block_q=None
    calls in this process.  ``candidates``: block sizes whose pairs are
    swept, kept where the device's kernels admit them (None: every
    admitted pair on the card, the plain versions' candidates on the CPU).

    Returns ((block_q, block_k), best_seconds_per_step); the time is None
    when the answer came from a cache (the process-local ``_TUNED`` or the
    persistent file) rather than a fresh sweep, as in the reference."""
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.autotune import search as _search
    from ray_tpu_torch.autotune.cache import (attention_key,
                                              backend_fingerprint,
                                              canon_dtype, get_cache)
    dev = resolve_device(device)
    dtype = getattr(torch, canon_dtype(dtype))
    key = (backend_fingerprint(dev), B, S, N, H, canon_dtype(dtype),
           bool(causal))
    if key in _TUNED:
        return _TUNED[key], None
    ckey = attention_key(B, S, N, H, dtype, causal)
    cached = get_cache().lookup("flash_attention", ckey,
                                backend=backend_fingerprint(dev)) is not None
    if candidates is None:
        cands = _search.flash_candidates(_search.parse_key(ckey), dev)
    else:
        cands = [{"block_q": bq, "block_k": bk}
                 for bq in candidates for bk in candidates
                 if bq <= S and bk <= S and _admits(dev, dtype, H, bq, bk)]
    rec = _search.tune("flash_attention", ckey, device=dev,
                       candidates=cands, iters=steps) if cands else None
    default = _default_blocks(S, H, dtype, dev)
    if rec is None or not rec.get("config"):
        best, best_t = default, None
    else:
        cfg = rec["config"]
        best = (int(cfg.get("block_q", 0)) or default[0],
                int(cfg.get("block_k", 0)) or default[1])
        best_t = None if cached or rec.get("ms") is None \
            else rec["ms"] / 1e3
    _TUNED[key] = best
    return best, best_t


# ------------------------------------------------------------- public API

def flash_attention_fwd(q, k, v, causal: bool = True,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None,
                        sm_scale: Optional[float] = None,
                        layout: str = "bsnh"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse [B*N, S] f32), differentiable in q, k and v.  CUDA tensors
    run the Hopper kernels at the pair (block_q, block_k) (None: resolved
    by ``_resolve``; on the card it must be one of ``admitted_blocks``),
    CPU tensors the plain versions, which take any pair.  The backward
    runs at the same pair.  The call goes through the registered op only
    when autograd records it: the op's dispatch costs host time (tens of
    µs) that the host-bound inference path does not need to pay."""
    _check_qkv(q, k, v, layout)
    block_q, block_k = _resolve(q, causal, block_q, block_k, layout)
    args = (q, k, v, causal, block_q, block_k, sm_scale, layout)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _flash_fwd_op(*args)
    return _flash_fwd_impl(*args)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None,
                        sm_scale: Optional[float] = None,
                        layout: str = "bsnh"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's residuals and the output gradient
    ``do``: the backward kernels on CUDA tensors, the plain version on CPU
    tensors, at the pair ``_resolve`` gives.  Autograd calls this through
    ``flash_attention``."""
    _check_qkv(q, k, v, layout)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, q "
                             f"{tuple(q.shape)}")
    block_q, block_k = _resolve(q, causal, block_q, block_k, layout)
    return _flash_bwd_op(q, k, v, o, lse, do, causal, block_q, block_k,
                         sm_scale, layout)


def flash_attention(q, k, v, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    layout: str = "bsnh") -> torch.Tensor:
    """Fused attention; returns o in the input layout and dtype, and
    differentiates through the flash backward.  ``block_q``/``block_k``
    default to ``_resolve``'s pair (a ``tune_flash_blocks`` result or a
    cache record where one exists).  Launch counts of the CUDA kernels:
    ``flash_attention.launches`` (forward), ``flash_attention.dq_launches``
    and ``flash_attention.dkv_launches`` (backward), and per tile
    ``flash_attention.tile_launches[(kernel, block_q, block_k)]`` with
    kernel "fwd", "dq" or "dkv"."""
    return flash_attention_fwd(q, k, v, causal, block_q, block_k, sm_scale,
                               layout)[0]


flash_attention.launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0
flash_attention.tile_launches = collections.Counter()
