"""Flash attention forward: the Hopper kernel (``csrc/flash_attention.cu``)
and its plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas`` (the
kernel) and ``repro.kernels.ref.flash_attention_ref`` (the oracle).  Layout
q (B, H, Sq, hd), k/v (B, KV, Skv, hd); query head h reads kv head
h // (H / KV).  Key j is visible to query i iff j < Skv and, when causal,
j <= i + q_offset and, with a window, j > i + q_offset - window.
``q_offset`` is one int for the whole batch, or a (B,) int32 tensor with one
offset per batch row (continuous batching decodes each slot at its own
position; the kernel reads the tensor in place).  A query
that sees no key gets 0 (the Pallas kernel's safe denominator).  The
softmax runs in f32; the output has q's dtype.  Asked for it, both versions
also return each row's log-sum-exp of scaled scores, lse (B, H, Sq) f32
(-inf for a row that sees no key), which the backward
(``flash_attention_bwd``) recomputes the probabilities from.

On the card, bf16 runs a tensor-core kernel and f32 one of register
micro-tiles in IEEE FMA (never TF32); both take blocks of ``ROWS``
position-major rows (position * rep + head) of one kv head.  When
their grid (B * KV * query tiles) is too small to fill the card, as at every
decode step, the keys are split into ``kv_splits`` contiguous ranges: one
launch then runs two device kernels, the partials per range and their
merge in range order (``flash_attention_split_ref`` is its plain version).
With per-row offsets the host chooses the ranges from the largest offset,
a host int the caller passes beside the tensor, and each row cuts its own
visible range into that many.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from . import build

#: dtype codes of csrc/common.cuh that the kernel takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: query rows of a block of either kernel, position-major (position * rep + head)
ROWS = 64
#: the most query heads per kv head, forward and backward (MAX_REP in csrc/)
MAX_REP = 64
#: streaming multiprocessors of the H100: a grid of fewer blocks splits the keys
SMS = 132

#: a query offset: one int for the batch, or a (B,) int32 tensor, one per row
Offset = Union[int, torch.Tensor]

_fn = None


def visible(q_len: int, kv_len: int, causal: bool, window: Optional[int],
            q_offset: Offset, device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask of the keys each query sees; (B, q_len,
    kv_len) for a (B,) tensor of per-row offsets."""
    q_pos = torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    if isinstance(q_offset, torch.Tensor):
        q_pos = q_pos[None] + q_offset.to(device=device, dtype=torch.int64)[:, None, None]
        k_pos = k_pos[None]
    else:
        q_pos = q_pos + q_offset
    mask = torch.ones(q_pos.shape[:-1] + (kv_len,), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _scaled(s: torch.Tensor, hd: int, scale: Optional[float]) -> torch.Tensor:
    """Scores s times ``scale``, or divided by sqrt(hd) where it is None."""
    return s / math.sqrt(hd) if scale is None else s * scale


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: Offset = 0, return_lse: bool = False,
                        scale: Optional[float] = None):
    """Plain version: the same online-softmax arithmetic in one pass, in f32.
    Returns the output, or (output, lse) with ``return_lse``.  ``scale``
    multiplies the scores (None: 1/sqrt(hd))."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    rep = H // KV
    qg = q.reshape(B, KV, rep, Sq, hd).float()
    s = _scaled(torch.einsum("bkrqd,bksd->bkrqs", qg, k.float()), hd, scale)
    mask = visible(Sq, Skv, causal, window, q_offset, q.device)
    if mask.ndim == 3:  # per-row offsets: (B, Sq, Skv)
        mask = mask[:, None, None]
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m == -math.inf, 0.0, m)  # a row that sees no key
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkrqs,bksd->bkrqd", p, v.float())
    out = out / torch.where(denom == 0.0, 1.0, denom)
    out = out.reshape(B, H, Sq, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(denom > 0.0, m + torch.log(denom), -math.inf)
    return out, lse.reshape(B, H, Sq)


def key_tile(hd: int) -> int:
    """Keys per tile of both kernels at head dim hd."""
    return 64 if hd <= 64 else 32


def query_tiles(rep: int, Sq: int) -> int:
    """Query tiles per (batch, kv head): a block of either dtype takes ROWS
    of the Sq * rep rows (position-major)."""
    return -(-Sq * rep // ROWS)


def key_range(Sq: int, Skv: int, causal: bool, window: Optional[int], q_offset: int,
              bk: int) -> Tuple[int, int]:
    """[k_begin, k_end) of the keys any of the Sq queries sees, k_begin
    rounded down to a whole tile of bk keys, as a kernel block trims it."""
    k_end = min(Skv, Sq + q_offset) if causal else Skv
    k_begin = max(0, q_offset - window + 1) if window else 0
    return k_begin // bk * bk, k_end


def key_tiles(Sq: int, Skv: int, causal: bool, window: Optional[int], q_offset: int,
              bk: int) -> Tuple[int, int]:
    """(k_begin, n_tiles): ``key_range`` in whole tiles of bk keys."""
    k_begin, k_end = key_range(Sq, Skv, causal, window, q_offset, bk)
    return k_begin, (-(-(k_end - k_begin) // bk) if k_end > k_begin else 0)


def split_ranges(n_tiles: int, splits: int):
    """Each split's tiles [lo, hi) of n_tiles: contiguous, as even as whole
    tiles allow (csrc/flash_attention.cu's split_tiles)."""
    return [(s * n_tiles // splits, (s + 1) * n_tiles // splits) for s in range(splits)]


def kv_splits(B: int, KV: int, rep: int, Sq: int, Skv: int, hd: int, causal: bool,
              window: Optional[int], q_offset: int) -> int:
    """Key ranges per query tile: 1 when B * KV * query tiles fills the
    card's SMS multiprocessors, else enough for about two blocks per
    multiprocessor, at most one per key tile of the visible range."""
    blocks = B * KV * query_tiles(rep, Sq)
    if blocks >= SMS:
        return 1
    _, n_tiles = key_tiles(Sq, Skv, causal, window, q_offset, key_tile(hd))
    return max(1, min(n_tiles, -(-2 * SMS // blocks)))


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, window: Optional[int] = None,
                              q_offset: Offset = 0, return_lse: bool = False,
                              splits: Optional[int] = None, bk: Optional[int] = None,
                              scale: Optional[float] = None):
    """Plain version of the split-KV arithmetic, in f32: the visible key
    range (whole tiles of ``bk`` keys) cut into ``splits`` ranges as
    ``split_ranges`` cuts it, each range's partial (m, l, unnormalised O)
    per row, then the partials merged in range order,
    O = sum_s O_s e^(m_s - M) / sum_s l_s e^(m_s - M) with M = max_s m_s.
    ``splits`` defaults to what ``kv_splits`` gives the kernel, ``bk`` to
    ``key_tile(hd)``.  Returns what ``flash_attention_ref`` returns.  With
    per-row offsets each row cuts its own visible range into ``splits``
    ranges, which default to the kernel's choice at the largest offset."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    rep = H // KV
    bk = bk or key_tile(hd)
    if isinstance(q_offset, torch.Tensor):
        offsets = q_offset.tolist()
        if splits is None:
            splits = kv_splits(B, KV, rep, Sq, Skv, hd, causal, window,
                               max(offsets))
        rows = [flash_attention_split_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal, window,
                                          off, True, splits, bk, scale)
                for b, off in enumerate(offsets)]
        out = torch.cat([o for o, _ in rows])
        return (out, torch.cat([lse for _, lse in rows])) if return_lse else out
    if splits is None:
        splits = kv_splits(B, KV, rep, Sq, Skv, hd, causal, window, q_offset)
    k_begin, n_tiles = key_tiles(Sq, Skv, causal, window, q_offset, bk)
    qg = q.reshape(B, KV, rep, Sq, hd).float()
    mask = visible(Sq, Skv, causal, window, q_offset, q.device)
    rows = (B, KV, rep, Sq)
    parts = []
    for t_lo, t_hi in split_ranges(n_tiles, splits):
        lo, hi = k_begin + t_lo * bk, min(k_begin + t_hi * bk, Skv)
        if hi <= lo:  # a range with no key
            parts.append((torch.full(rows, -math.inf, device=q.device),
                          torch.zeros(rows, device=q.device),
                          torch.zeros(rows + (hd,), device=q.device)))
            continue
        s = _scaled(torch.einsum("bkrqd,bksd->bkrqs", qg, k[:, :, lo:hi].float()), hd, scale)
        s = s.masked_fill(~mask[:, lo:hi], -math.inf)
        m = s.amax(dim=-1)
        p = torch.exp(s - torch.where(m == -math.inf, 0.0, m)[..., None])
        parts.append((m, p.sum(dim=-1), torch.einsum("bkrqs,bksd->bkrqd", p,
                                                      v[:, :, lo:hi].float())))
    M = torch.full(rows, -math.inf, device=q.device)
    for m, _, _ in parts:
        M = torch.maximum(M, m)
    L = torch.zeros(rows, device=q.device)
    acc = torch.zeros(rows + (hd,), device=q.device)
    for m, l, o in parts:  # in split order; a range a row sees no key of adds 0
        w = torch.where(m == -math.inf, 0.0, torch.exp(m - torch.where(M == -math.inf, 0.0, M)))
        L = L + l * w
        acc = acc + o * w[..., None]
    out = (acc / torch.where(L == 0.0, 1.0, L)[..., None]).reshape(B, H, Sq, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(L > 0.0, M + torch.log(L), -math.inf)
    return out, lse.reshape(B, H, Sq)


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether the kernels can copy t's (B, X, S, hd) rows 16 bytes at a
    time: a 16-byte aligned base and batch, head and position strides of
    whole 16 bytes (the head dim is contiguous)."""
    return t.data_ptr() % 16 == 0 and all(st * t.element_size() % 16 == 0
                                           for st in t.stride()[:3])


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").repro_flash_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int64] * 12 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: Optional[int], q_offset: int,
                         return_lse: bool = False,
                         q_offsets: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None):
    """Launch the kernel on CUDA tensors the wrapper (``ops.flash_attention``)
    has checked.  ``q_offsets``, a (B,) int32 tensor on the card, gives each
    batch row its own offset; ``q_offset`` is then the largest of them, from
    which the key ranges are chosen (the device tensor is never read here).
    The output is a (B, H, Sq, hd) view of a buffer laid out (B, Sq, H, hd),
    the layout the model consumes next; with ``return_lse`` the kernel also
    writes lse and (output, lse) is returned.  With
    ``kv_splits`` > 1 the call runs two device kernels (partials, then their
    merge) and allocates their f32 workspace.  The kernels copy rows 16
    bytes at a time, so an operand whose rows are not 16-byte aligned is
    first copied into a new contiguous tensor."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    rep = H // KV
    # a view at an odd offset: copy it aligned
    q, k, v = (t if rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    splits = kv_splits(B, KV, rep, Sq, Skv, hd, causal, window, q_offset)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse
           else None)
    ws = (torch.empty(splits * B * H * Sq * (hd + 2), dtype=torch.float32, device=q.device)
          if splits > 1 else None)
    with torch.cuda.device(q.device):
        err = _kernel()(
            DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if q_offsets is None else q_offsets.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            B, KV, Sq, Skv, rep, int(causal), window or 0, q_offset, splits,
            1.0 / math.sqrt(hd) if scale is None else scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    return (out, lse) if return_lse else out
