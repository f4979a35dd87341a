"""Splash attention: block-sparse attention driven by a mask's block map.

The port's own copy of what the repo uses from JAX's splash module
(``jax.experimental.pallas.ops.tpu.splash_attention``, reached through
``make_splash_kernel`` in ``ray_tpu/autotune/dispatch.py``), and nothing
more:

* masks: ``CausalMask`` (with its ``offset``) and ``MultiHeadMask``, the
  only mask classes the repo builds;
* ``process_mask``: the block map of a mask, built in numpy on the host
  once per (mask, block shape) and kept on each device once
  (``MaskInfo.tensors``);
* the kernels: on CUDA tensors the forward launches the hand-written
  Hopper kernel ``splash_fwd_kernel`` of ``csrc/splash_attention.cu``
  (replacing the TPU kernel ``flash_attention_kernel``), the backward
  ``splash_dq_kernel`` and ``splash_dkv_kernel`` (replacing
  ``_flash_attention_dq_kernel`` and ``_flash_attention_dkv_kernel``); on
  CPU tensors each runs its plain PyTorch version
  (``splash_attention_reference``, ``splash_dq_reference``,
  ``splash_dkv_reference``), which walks the same block lists.  There is no
  fallback between the two: a CUDA tensor goes to the kernels or raises.
  In bf16 all three are warp-specialised wgmma kernels fed by TMA; they
  read q, k, v and do through TMA maps, which is why the inputs' base and
  byte strides must be 16-byte aligned.

Numerics follow the reference: q arrives pre-scaled and nothing applies a
scale; masked scores take ``MASK_VALUE = -0.7 * finfo(f32).max``; softmax
statistics and accumulators are f32 and q.k^T runs in the input dtype
(p.v multiplies the f32 probabilities with v upcast, as the reference
does; the bf16 kernel rounds p to bf16 for the tensor cores, which is
what a TPU's default-precision f32 product does too); o is in the q dtype
and the logsumexp residual f32 ``[B, N, S]``; ``di = rowsum(o * do)`` is
f32, computed outside the kernels; dq accumulates ``ds`` rounded to the k
dtype, dk and dv accumulate ``p`` and ``ds`` rounded to the do dtype.

Layout: q, k, v ``[B, N, S, H]`` (batch in the kernels' grid in place of
the reference's vmap), read through element strides with the head dim
contiguous.  The mask must leave every query row at least one key: the
reference leaves a fully masked row's softmax undefined, and
``process_mask`` raises for one.

Forward and backward are the custom ops ``ray_tpu_torch::splash_fwd`` and
``ray_tpu_torch::splash_bwd`` with autograd registered, as flash's are.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.ops import _build

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
HEAD_DIMS = (64, 128)          # the kernels' template instantiations
MIN_BLOCK = 128                # map blocks are multiples of this, as in the
                               # reference (its lane width)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "splash_attention.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGTYPES = [_P] * 7 + [_I] * 8 + [_L] * 12 + [_P]
_DQ_ARGTYPES = [_P] * 9 + [_I] * 8 + [_L] * 15 + [_P]
_DKV_ARGTYPES = [_P] * 10 + [_I] * 8 + [_L] * 18 + [_P]


# ------------------------------------------------------------------- masks

@dataclasses.dataclass(frozen=True)
class CausalMask:
    """Causal mask of shape ``(q_len, kv_len)``: query i sees key j iff
    ``i + offset >= j`` (the reference's ``CausalMask``).  A negative
    offset leaves the first rows with no key, which ``process_mask``
    refuses."""

    shape: Tuple[int, int]
    offset: int = 0

    def __post_init__(self):
        shape = tuple(int(x) for x in self.shape)
        if len(shape) != 2:
            raise ValueError(f"a CausalMask is 2-d, got shape {shape}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "offset", int(self.offset))

    def __getitem__(self, idx) -> np.ndarray:
        """The bool mask of a (query slice, kv slice) block."""
        qs, ks = idx
        rows = np.arange(*qs.indices(self.shape[0]))
        cols = np.arange(*ks.indices(self.shape[1]))
        return rows[:, None] + self.offset >= cols[None, :]


@dataclasses.dataclass(frozen=True)
class MultiHeadMask:
    """One ``CausalMask`` per head (the reference's ``MultiHeadMask``)."""

    masks: Tuple[CausalMask, ...]

    def __post_init__(self):
        masks = tuple(self.masks)
        if not masks:
            raise ValueError("MultiHeadMask needs at least one mask")
        if not all(isinstance(m, CausalMask) for m in masks):
            raise ValueError("MultiHeadMask takes CausalMasks (the only mask "
                             "class the port has)")
        if any(m.shape != masks[0].shape for m in masks):
            raise ValueError("every head's mask must have one shape")
        object.__setattr__(self, "masks", masks)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self.masks),) + self.masks[0].shape


# --------------------------------------------------------------- block map

@dataclasses.dataclass(frozen=True, eq=False)
class MaskInfo:
    """The block map of a mask at one block shape.

    ``block_mask`` int8 ``[heads, S / block_q, S / block_kv]``: 0 empty, 1
    partial, 2 full (the reference's ``MaskInfo.block_mask``); ``heads`` is
    1 when every head has the same mask (the map is broadcast), else the
    mask's head count.  ``rows`` int32 ``[heads, S / block_q, 1 + S /
    block_kv]`` holds for each query block the count of its non-empty kv
    blocks, then those blocks ascending as ``(kv block << 1) | full``
    (the role of the reference's ``data_next``); ``cols`` is the
    transposed table (for each kv block its non-empty query blocks), which
    the dk/dv kernel walks.  ``offsets`` int32 ``[heads]`` is each map
    head's causal offset, which the kernels evaluate on partial blocks."""

    block_mask: np.ndarray
    rows: np.ndarray
    cols: np.ndarray
    offsets: np.ndarray
    block_q: int
    block_kv: int
    seq_len: int
    num_heads: int
    _on_device: Dict[str, Tuple[torch.Tensor, ...]] = dataclasses.field(
        default_factory=dict, repr=False)

    def tensors(self, device) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """(offsets, rows, cols) as int32 tensors on ``device``, copied
        there once."""
        key = str(torch.device(device))
        out = self._on_device.get(key)
        if out is None:
            out = tuple(torch.from_numpy(a).to(device)
                        for a in (self.offsets, self.rows, self.cols))
            self._on_device[key] = out
        return out


def _lists(kinds: np.ndarray) -> np.ndarray:
    """[heads, R, C] block kinds -> [heads, R, 1 + C] int32: per row the
    count of non-empty blocks, then (index << 1) | full, ascending."""
    h, R, C = kinds.shape
    out = np.zeros((h, R, 1 + C), np.int32)
    for i in range(h):
        for r in range(R):
            idx = np.nonzero(kinds[i, r])[0]
            out[i, r, 0] = len(idx)
            out[i, r, 1:1 + len(idx)] = (idx << 1) | (kinds[i, r, idx] == 2)
    return out


def _block_kinds(mask: CausalMask, bq: int, bkv: int) -> np.ndarray:
    S = mask.shape[0]
    kinds = np.zeros((S // bq, S // bkv), np.int8)
    row_any = np.zeros(S, bool)
    for i in range(S // bq):
        for j in range(S // bkv):
            blk = mask[i * bq:(i + 1) * bq, j * bkv:(j + 1) * bkv]
            kinds[i, j] = 2 if blk.all() else int(blk.any())
            row_any[i * bq:(i + 1) * bq] |= blk.any(axis=1)
    if not row_any.all():
        raise ValueError(
            f"{mask} leaves query row {int(np.argmin(row_any))} with no "
            "key: its softmax is undefined (the reference's too)")
    return kinds


@functools.lru_cache(maxsize=64)
def _process(mask: MultiHeadMask, block_q: int, block_kv: int) -> MaskInfo:
    N, S, S_kv = mask.shape
    if S != S_kv:
        raise ValueError(f"the kernels take square masks, got {(S, S_kv)}")
    for name, blk in (("block_q", block_q), ("block_kv", block_kv)):
        if blk <= 0 or blk % MIN_BLOCK or S % blk:
            raise ValueError(f"{name}={blk} must be a multiple of "
                             f"{MIN_BLOCK} that divides S={S}")
    unique = list(dict.fromkeys(mask.masks))
    heads = unique if len(unique) == 1 else list(mask.masks)
    per_mask = {m: _block_kinds(m, block_q, block_kv) for m in unique}
    kinds = np.stack([per_mask[m] for m in heads])
    return MaskInfo(
        block_mask=kinds, rows=_lists(kinds),
        cols=_lists(kinds.transpose(0, 2, 1)),
        offsets=np.array([m.offset for m in heads], np.int32),
        block_q=block_q, block_kv=block_kv, seq_len=S, num_heads=N)


def process_mask(mask: Union[MultiHeadMask, CausalMask],
                 block_shape: Tuple[int, int]) -> MaskInfo:
    """The block map of ``mask`` at ``block_shape = (block_q, block_kv)``
    (multiples of 128 that divide S), built once per (mask, block shape)
    and cached."""
    if isinstance(mask, CausalMask):
        mask = MultiHeadMask((mask,))
    bq, bkv = block_shape
    return _process(mask, int(bq), int(bkv))


# ---------------------------------------------------------- plain versions

def _head_groups(N: int, map_heads: int):
    """(map head, the heads it covers) pairs."""
    if map_heads == 1:
        return [(0, slice(None))]
    return [(n, slice(n, n + 1)) for n in range(N)]


def _visible(q0: int, bq: int, k0: int, bkv: int, offset: int, device):
    rows = torch.arange(q0, q0 + bq, device=device)[:, None]
    cols = torch.arange(k0, k0 + bkv, device=device)[None, :]
    return rows + offset >= cols


def _listed(table: np.ndarray, h: int, r: int):
    """(block index, full) of the non-empty blocks of one map row."""
    n = int(table[h, r, 0])
    return [(int(e) >> 1, bool(e & 1)) for e in table[h, r, 1:1 + n]]


def _scores(qi, kj, q0, bq, k0, bkv, full, offset):
    """q.k^T of one map block in f32 (products of the upcast inputs are
    exact for bf16), masked to MASK_VALUE unless the block is full."""
    s = torch.matmul(qi, kj.transpose(-1, -2))
    if not full:
        s = torch.where(_visible(q0, bq, k0, bkv, offset, s.device), s,
                        MASK_VALUE)
    return s


def _fwd_reference(q, k, v, offsets, rows, bq: int, bkv: int):
    B, N, S, H = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.empty((B, N, S, H), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, N, S), dtype=torch.float32, device=q.device)
    for hm, heads in _head_groups(N, rows.shape[0]):
        off = int(offsets[hm])
        for i in range(S // bq):
            q0 = i * bq
            qi = qf[:, heads, q0:q0 + bq]
            m = torch.full(qi.shape[:-1] + (1,), MASK_VALUE, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros_like(qi)
            for j, full in _listed(rows, hm, i):
                k0 = j * bkv
                s = _scores(qi, kf[:, heads, k0:k0 + bkv], q0, bq, k0, bkv,
                            full, off)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = torch.exp(s - m_new)
                alpha = torch.exp(m - m_new)
                l = alpha * l + p.sum(dim=-1, keepdim=True)
                acc = alpha * acc + torch.matmul(p, vf[:, heads, k0:k0 + bkv])
                m = m_new
            o[:, heads, q0:q0 + bq] = acc * (1.0 / l)
            lse[:, heads, q0:q0 + bq] = (torch.log(l) + m)[..., 0]
    return o.to(q.dtype), lse


def _di(o, do) -> torch.Tensor:
    """di = rowsum(o * do) in f32, [B, N, S] (plain torch: the reference
    leaves it to XLA, outside its kernels)."""
    return (o.float() * do.float()).sum(-1)


def _dq_reference(q, k, v, o, lse, do, offsets, rows, bq: int, bkv: int):
    B, N, S, H = q.shape
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    lse3, di3 = lse.float()[..., None], _di(o, do)[..., None]
    dq = torch.zeros((B, N, S, H), dtype=torch.float32, device=q.device)
    for hm, heads in _head_groups(N, rows.shape[0]):
        off = int(offsets[hm])
        for i in range(S // bq):
            q0 = i * bq
            qi, doi = qf[:, heads, q0:q0 + bq], dof[:, heads, q0:q0 + bq]
            for j, full in _listed(rows, hm, i):
                k0 = j * bkv
                kj = kf[:, heads, k0:k0 + bkv]
                s = _scores(qi, kj, q0, bq, k0, bkv, full, off)
                p = torch.exp(s - lse3[:, heads, q0:q0 + bq])
                dp = torch.matmul(doi, vf[:, heads, k0:k0 + bkv]
                                  .transpose(-1, -2))
                ds = (dp - di3[:, heads, q0:q0 + bq]) * p
                dq[:, heads, q0:q0 + bq] += torch.matmul(
                    ds.to(k.dtype).float(), kj)
    return dq.to(q.dtype)


def _dkv_reference(q, k, v, o, lse, do, offsets, cols, bq: int, bkv: int):
    B, N, S, H = q.shape
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    lse3, di3 = lse.float()[..., None], _di(o, do)[..., None]
    dk = torch.zeros((B, N, S, H), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for hm, heads in _head_groups(N, cols.shape[0]):
        off = int(offsets[hm])
        for j in range(S // bkv):
            k0 = j * bkv
            kj, vj = kf[:, heads, k0:k0 + bkv], vf[:, heads, k0:k0 + bkv]
            for i, full in _listed(cols, hm, j):
                q0 = i * bq
                qi, doi = qf[:, heads, q0:q0 + bq], dof[:, heads, q0:q0 + bq]
                s = _scores(qi, kj, q0, bq, k0, bkv, full, off)
                p = torch.exp(s - lse3[:, heads, q0:q0 + bq])
                dv[:, heads, k0:k0 + bkv] += torch.matmul(
                    p.to(do.dtype).float().transpose(-1, -2), doi)
                dp = torch.matmul(doi, vj.transpose(-1, -2))
                ds = (dp - di3[:, heads, q0:q0 + bq]) * p
                dk[:, heads, k0:k0 + bkv] += torch.matmul(
                    ds.to(do.dtype).float().transpose(-1, -2), qi)
    return dk.to(k.dtype), dv.to(v.dtype)


def splash_attention_reference(q, k, v, mask_info: MaskInfo
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: for each query block,
    the online softmax over its listed kv blocks, the mask applied only on
    partial blocks.  q pre-scaled; returns (o in the q dtype, logsumexp
    f32 [B, N, S])."""
    _check_qkv(q, k, v, mask_info)
    return _fwd_reference(q, k, v, mask_info.offsets, mask_info.rows,
                          mask_info.block_q, mask_info.block_kv)


def splash_dq_reference(q, k, v, o, lse, do, mask_info: MaskInfo
                        ) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel: for each query block, over
    its listed kv blocks, ``p = exp(qk - lse)``, ``ds = (do.v^T - di) * p``
    and ``dq += ds.k`` (ds rounded to the k dtype), f32 sums; dq in the q
    dtype."""
    _check_qkv(q, k, v, mask_info)
    return _dq_reference(q, k, v, o, lse, do, mask_info.offsets,
                         mask_info.rows, mask_info.block_q,
                         mask_info.block_kv)


def splash_dkv_reference(q, k, v, o, lse, do, mask_info: MaskInfo
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel: for each kv block, over
    its listed query blocks, ``dv += p^T.do`` and ``dk += ds^T.q`` (p and
    ds rounded to the do dtype), f32 sums; a kv block that no query block
    reaches gets zeros."""
    _check_qkv(q, k, v, mask_info)
    return _dkv_reference(q, k, v, o, lse, do, mask_info.offsets,
                          mask_info.cols, mask_info.block_q,
                          mask_info.block_kv)


# ----------------------------------------------------------------- kernels

def _check_qkv(q, k, v, mask_info: MaskInfo):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, N, S, H] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _, N, S, _ = q.shape
    if (S, N) != (mask_info.seq_len, mask_info.num_heads):
        raise ValueError(f"the mask is for {mask_info.num_heads} heads of "
                         f"length {mask_info.seq_len}, q has {N} of {S}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"splash attention runs on cuda or cpu, not "
                         f"{q.device}")


def _check_kernel_inputs(q, **others):
    """What the CUDA kernels accept; anything else raises.  Besides dtype
    and head dim, the TMA maps of the bf16 kernels (and the 16-byte vector
    loads of the others) need each tensor's head dim contiguous, its base
    16-byte aligned and its byte strides multiples of 16."""
    for name, x in others.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"splash kernels take float32 or bfloat16, not "
                         f"{q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"splash kernels take head dims {HEAD_DIMS}, not "
                         f"{q.shape[-1]}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), *others.items()):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous "
                             f"(stride {x.stride(-1)})")
        if x.data_ptr() % 16 or any(st % vec for st in x.stride()[:3]):
            raise ValueError(f"{name}: the kernels read 16-byte vectors and "
                             "TMA tiles; base and byte strides must be "
                             "multiples of 16")


def _kernel_fn(name: str, argtypes):
    lib = _build.load(_SOURCE)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(name, argtypes, ptrs, q, offsets, table, bq, bkv, views):
    """One kernel launch on q's device and current stream; raises on a
    launch error."""
    lib, fn = _kernel_fn(name, argtypes)
    B, N, S, H = q.shape
    strides = [st for x in views for st in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, offsets.data_ptr(), table.data_ptr(),
                 _DTYPE_CODES[q.dtype], H, B, N, S, table.shape[0], bq, bkv,
                 *strides, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.rt_error_string(err).decode()} ({err})")


def _launch_fwd(q, k, v, offsets, rows, bq: int, bkv: int):
    _check_kernel_inputs(q, k=k, v=v)
    B, N, S, H = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, N, S), dtype=torch.float32, device=q.device)
    _launch("rt_splash_fwd", _FWD_ARGTYPES,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr()), q, offsets, rows, bq, bkv, (q, k, v, o))
    splash_attention.launches += 1
    return o, lse


def _launch_dq(q, k, v, do, lse, di, offsets, rows, bq: int, bkv: int):
    """dq by ``rt_splash_bwd_dq`` (inputs checked by the caller; lse and di
    f32 [B, N, S], contiguous)."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("rt_splash_bwd_dq", _DQ_ARGTYPES,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), di.data_ptr(), dq.data_ptr()),
            q, offsets, rows, bq, bkv, (q, k, v, do, dq))
    splash_attention.dq_launches += 1
    return dq


def _launch_dkv(q, k, v, do, lse, di, offsets, cols, bq: int, bkv: int):
    """dk and dv by ``rt_splash_bwd_dkv`` (as ``_launch_dq``)."""
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    _launch("rt_splash_bwd_dkv", _DKV_ARGTYPES,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, offsets, cols, bq, bkv, (q, k, v, do, dk, dv))
    splash_attention.dkv_launches += 1
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do, offsets, rows, cols, bq, bkv):
    _check_kernel_inputs(q, k=k, v=v, o=o, do=do)
    di = _di(o, do)
    lse = lse.contiguous()
    if lse.data_ptr() % 16:
        raise ValueError("lse: the dk/dv kernel copies it in 16-byte "
                         "aligned runs; its base must be 16-byte aligned")
    dq = _launch_dq(q, k, v, do, lse, di, offsets, rows, bq, bkv)
    dk, dv = _launch_dkv(q, k, v, do, lse, di, offsets, cols, bq, bkv)
    return dq, dk, dv


# ------------------------------------------------------------- custom ops

def _splash_fwd_impl(q, k, v, offsets, rows, block_q, block_kv, bwd_rows,
                     bwd_cols, bwd_block_q, bwd_block_kv):
    if q.device.type == "cpu":
        return _fwd_reference(q, k, v, offsets.numpy(), rows.numpy(),
                              block_q, block_kv)
    return _launch_fwd(q, k, v, offsets, rows, block_q, block_kv)


_splash_fwd_op = torch.library.custom_op(
    "ray_tpu_torch::splash_fwd", _splash_fwd_impl, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor offsets, Tensor rows, "
           "int block_q, int block_kv, Tensor bwd_rows, Tensor bwd_cols, "
           "int bwd_block_q, int bwd_block_kv) -> (Tensor, Tensor)")


@torch.library.custom_op(
    "ray_tpu_torch::splash_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, "
           "Tensor offsets, Tensor rows, Tensor cols, int block_q, "
           "int block_kv) -> (Tensor, Tensor, Tensor)")
def _splash_bwd_op(q, k, v, o, lse, do, offsets, rows, cols, block_q,
                   block_kv):
    if q.device.type == "cpu":
        args = (q, k, v, o, lse, do, offsets.numpy())
        return (_dq_reference(*args, rows.numpy(), block_q, block_kv),
                *_dkv_reference(*args, cols.numpy(), block_q, block_kv))
    return _launch_bwd(q, k, v, o, lse, do, offsets, rows, cols, block_q,
                       block_kv)


def _fwd_setup_context(ctx, inputs, output):
    q, k, v, offsets, _, _, _, bwd_rows, bwd_cols, bbq, bbkv = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse, offsets, bwd_rows, bwd_cols)
    ctx.blocks = (bbq, bbkv)
    ctx.mark_non_differentiable(lse)


def _fwd_backward(ctx, do, _dlse):
    q, k, v, o, lse, offsets, rows, cols = ctx.saved_tensors
    # The kernels read 16-byte vectors with the head dim contiguous; an
    # upstream gradient may be any view (even an expanded scalar).
    dq, dk, dv = _splash_bwd_op(q, k, v, o, lse, do.contiguous(), offsets,
                                rows, cols, *ctx.blocks)
    return (dq, dk, dv) + (None,) * 8


torch.library.register_autograd("ray_tpu_torch::splash_fwd", _fwd_backward,
                                setup_context=_fwd_setup_context)


# ------------------------------------------------------------- public API

def splash_attention_fwd(q, k, v, mask_info: MaskInfo,
                         bwd_mask_info: Optional[MaskInfo] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, logsumexp f32 [B, N, S]) of pre-scaled q over ``mask_info``'s
    block map, differentiable in q, k and v; the backward walks
    ``bwd_mask_info`` (default: ``mask_info``), the map at the backward's
    block shape.  CUDA tensors run the Hopper kernels, CPU tensors the
    plain versions.  The registered op is taken only when autograd
    records."""
    _check_qkv(q, k, v, mask_info)
    bwd = bwd_mask_info or mask_info
    if (bwd.seq_len, bwd.num_heads) != (mask_info.seq_len,
                                        mask_info.num_heads):
        raise ValueError("the backward's map is of another mask shape")
    offsets, rows, _ = mask_info.tensors(q.device)
    _, bwd_rows, bwd_cols = bwd.tensors(q.device)
    args = (q, k, v, offsets, rows, mask_info.block_q, mask_info.block_kv,
            bwd_rows, bwd_cols, bwd.block_q, bwd.block_kv)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _splash_fwd_op(*args)
    return _splash_fwd_impl(*args)


def splash_attention_bwd(q, k, v, o, lse, do, mask_info: MaskInfo
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's residuals and the output gradient:
    the dq and dk/dv kernels on CUDA tensors, the plain versions on CPU
    tensors.  Autograd calls this through ``splash_attention``."""
    _check_qkv(q, k, v, mask_info)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, q "
                             f"{tuple(q.shape)}")
    offsets, rows, cols = mask_info.tensors(q.device)
    return _splash_bwd_op(q, k, v, o, lse, do, offsets, rows, cols,
                          mask_info.block_q, mask_info.block_kv)


def splash_attention(q, k, v, mask_info: MaskInfo,
                     bwd_mask_info: Optional[MaskInfo] = None
                     ) -> torch.Tensor:
    """Block-sparse attention of pre-scaled q over a mask's block map;
    returns o ``[B, N, S, H]`` in the q dtype and differentiates through
    the splash backward.  Launch counts of the CUDA kernels:
    ``splash_attention.launches`` (forward), ``.dq_launches`` and
    ``.dkv_launches`` (backward)."""
    return splash_attention_fwd(q, k, v, mask_info, bwd_mask_info)[0]


splash_attention.launches = 0
splash_attention.dq_launches = 0
splash_attention.dkv_launches = 0


def causal_mha_mask(num_heads: int, seq_len: int,
                    offsets: Sequence[int] = ()) -> MultiHeadMask:
    """The ``MultiHeadMask`` of ``num_heads`` causal masks over
    ``seq_len``, the mask ``make_splash_kernel`` builds (offsets 0 unless
    given per head)."""
    offs = list(offsets) or [0] * num_heads
    return MultiHeadMask(tuple(CausalMask((seq_len, seq_len), o)
                               for o in offs))
