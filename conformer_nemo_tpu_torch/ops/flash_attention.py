"""Flash attention forward for the Conformer's self-attention.

Replaces the TPU kernel `_make_kernel` / `_flash_fwd_entry` of
conformer_nemo_tpu/ops/pallas/flash_attention.py, and its two-sided-band
twin `_make_fwd_streamed_kernel` / `_flash_fwd_streamed` (same function,
different VMEM strategy). With the sinusoidal decomposition of the
rel-pos bd term, the attention is exactly

    o = softmax(Qs Ks^T * scale + mask) V,   lse = logsumexp of the same row

over qs/ks [BH, T, d1] (d1 = dk + d_model = 576 at the flagship), v
[BH, T, dv], where key j is visible to query i iff j < lens[bh] and, with
a band, i - j <= left and j - i <= right. A row with no visible key gives
o = 0 and lse = 0.

The kernel (ops/csrc/flash_attention_fwd.cu) is hand-written CUDA for
sm_90a. What bounds it on an H100: `2 * sum(visible pairs) * (d1 + dv)`
FLOPs at 989 TFLOP/s bf16 dense against the bytes of the qs rows that see
a key, the ks and v rows that a query sees, o and lse (each once) at
3.35 TB/s. With full-length rows at the flagship shapes the
work is about 600 operations per byte, over the ridge of ~295, so the
tensor cores bound it; a bucket with many short rows does fewer operations
on the same bytes and can fall under the ridge. The design keeps every score tile on chip (online softmax, no [T, T] in
device memory) and runs both products on bf16 tensor cores (WMMA) with
fp32 accumulation. It skips key tiles outside the band and past the key
length. Speed beyond that is later work.

`flash_attention_fwd` launches the kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs
`flash_attention_fwd_reference`, the plain PyTorch version of the same
function. No CUDA call falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

_NEG_INF = -1e30
MAX_DV = 128

# launches of the CUDA kernel: total, and per (bh, t, d1, dv) shape
launches = 0
launches_by_shape: dict[tuple[int, int, int, int], int] = {}


def reset_launch_counts() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()


def visible_mask(t: int, lens: torch.Tensor, left: int = -1, right: int = -1) -> torch.Tensor:
    """[BH, T, T] bool: key j visible to query i."""
    idx = torch.arange(t, device=lens.device)
    i, j = idx[:, None], idx[None, :]
    mask = (j[None] < lens.to(torch.int64)[:, None, None]).expand(lens.shape[0], t, t)
    if left >= 0:
        mask = mask & (i - j <= left)[None]
    if right >= 0:
        mask = mask & (j - i <= right)[None]
    return mask


def flash_attention_fwd_reference(qs, ks, v, lens, scale: float, left: int = -1,
                                  right: int = -1):
    """Plain PyTorch version: dense fp32 masked softmax with the kernel's
    masking and empty-row rules. -> (o [BH,T,dv] in qs.dtype, lse [BH,T] fp32)."""
    t = qs.shape[1]
    mask = visible_mask(t, lens, left, right)
    s = torch.einsum("btd,bsd->bts", qs.to(torch.float32), ks.to(torch.float32)) * scale
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=s.device))
    m = s.amax(dim=-1)
    m_safe = torch.where(m <= _NEG_INF * 0.5, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), torch.zeros((), device=s.device))
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bts,bsd->btd", p, v.to(torch.float32)) / l_safe[..., None]
    return o.to(qs.dtype), m_safe + torch.log(l_safe)


def _library():
    from conformer_nemo_tpu_torch.ops.build import load

    lib = load("flash_attention_fwd.cu")
    fn = lib.flash_attention_fwd_bf16
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ctypes.c_float,
                       i32, i32, ptr]
        fn.restype = i32
    return fn


def _check(qs, ks, v, lens):
    if not (qs.device == ks.device == v.device == lens.device):
        raise ValueError("qs, ks, v and lens must be on one device")
    if qs.dim() != 3 or ks.shape != qs.shape or v.dim() != 3 or v.shape[:2] != qs.shape[:2]:
        raise ValueError(f"shapes: qs {tuple(qs.shape)}, ks {tuple(ks.shape)}, "
                         f"v {tuple(v.shape)}; want [BH,T,d1], [BH,T,d1], [BH,T,dv]")
    if lens.shape != (qs.shape[0],):
        raise ValueError(f"lens must be [BH] = [{qs.shape[0]}], got {tuple(lens.shape)}")


def flash_attention_fwd(qs, ks, v, lens, scale: float, left: int = -1, right: int = -1):
    """softmax(qs ks^T * scale + mask) v over [BH, T, d1] x [BH, T, dv] with
    per-row key lengths lens [BH] and an optional (left, right) band
    (-1 = unlimited). -> (o [BH, T, dv] in qs.dtype, lse [BH, T] fp32)."""
    _check(qs, ks, v, lens)
    if qs.device.type == "cpu":
        return flash_attention_fwd_reference(qs, ks, v, lens, scale, left, right)
    if qs.device.type != "cuda":
        raise ValueError(f"unsupported device {qs.device}")
    bh, t, d1 = qs.shape
    dv = v.shape[-1]
    if not (qs.dtype == ks.dtype == v.dtype == torch.bfloat16) or lens.dtype != torch.int32:
        raise TypeError("the CUDA kernel takes bf16 qs/ks/v and int32 lens, got "
                        f"{qs.dtype}/{ks.dtype}/{v.dtype}/{lens.dtype}")
    if not all(x.is_contiguous() for x in (qs, ks, v, lens)) or any(
            x.data_ptr() % 16 for x in (qs, ks, v)):  # the kernel loads 16-byte vectors
        raise ValueError("the CUDA kernel takes contiguous tensors, qs/ks/v 16-byte aligned")
    if bh > 65535:
        raise ValueError(f"the CUDA kernel takes BH <= 65535, got {bh}")
    if d1 % 8 or dv % 8 or d1 <= 0 or not 0 < dv <= MAX_DV:
        raise ValueError(f"the CUDA kernel takes d1 and dv <= {MAX_DV} as positive "
                         f"multiples of 8; got d1={d1}, dv={dv}")
    o = torch.empty((bh, t, dv), dtype=torch.bfloat16, device=qs.device)
    lse = torch.empty((bh, t), dtype=torch.float32, device=qs.device)
    if bh == 0 or t == 0:
        return o, lse
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()(qs.data_ptr(), ks.data_ptr(), v.data_ptr(), lens.data_ptr(),
                         o.data_ptr(), lse.data_ptr(), bh, t, d1, dv, float(scale),
                         int(left), int(right), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    key = (bh, t, d1, dv)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return o, lse
