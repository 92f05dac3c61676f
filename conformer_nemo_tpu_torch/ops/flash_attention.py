"""Flash attention for the Conformer's self-attention: forward, backward, and
the `torch.autograd.Function` around the pair.

Replaces the TPU kernels of conformer_nemo_tpu/ops/pallas/flash_attention.py:
the forward `_make_kernel` / `_flash_fwd_entry` and its two-sided-band twin
`_make_fwd_streamed_kernel` / `_flash_fwd_streamed`, and the backward
`_make_dq_kernel` + `_make_dkv_kernel` / `_flash_bwd_entry` and their
streamed twins (`_flash_bwd_streamed`); the TPU families differ only in
VMEM strategy. With the sinusoidal decomposition of the rel-pos bd term,
the attention is exactly

    o = softmax(Qs Ks^T * scale + mask) V,   lse = logsumexp of the same row

over qs/ks [BH, T, d1] (d1 = dk + d_model = 576 at the flagship), v
[BH, T, dv], where key j is visible to query i iff j < lens[bh] and, with
a band, i - j <= left and j - i <= right. A row with no visible key gives
o = 0 and lse = 0. The backward (`_flash_vjp_bwd`) takes delta =
rowsum(dO * O) and treats query rows past lens as padding: they get dq = 0
and add nothing to dk and dv.

The kernels are hand-written CUDA for sm_90a: ops/csrc/flash_attention_fwd.cu
and ops/csrc/flash_attention_bwd.cu (a dQ kernel tiled by query and a dK/dV
kernel tiled by key) for bf16 and fp16 operands (one template, fp32
accumulation on the tensor cores), and ops/csrc/flash_attention_f32.cu,
the same three functions in fp32: the forward on the CUDA cores (fp32 FMA:
TF32 alone would read about 1e-3 off an fp32 reference), the backward with
S and dP on the CUDA cores in the forward's chain and dQ, dK and dV on the
tensor cores in 3xTF32 (each fp32 operand split into two TF32 parts, three
products). What bounds them on an H100:
`2 * pairs * (d1 + dv)` FLOPs forward and `2 * pairs * (3 * d1 + 2 * dv)`
backward (S recomputed once) at 989 TFLOP/s bf16/fp16 dense or 67 TFLOP/s
fp32 (the fp32 backward's gradient products at 495 / 3 TFLOP/s), against
the bytes each reads and writes once at 3.35 TB/s; with
full-length rows at the flagship shapes that is several hundred operations
per byte, over the ridge of ~295, so the arithmetic bounds them. A bucket
with many short rows does fewer operations on the same bytes and can fall
under the ridge. All keep every score tile on chip (no [T, T] in device
memory) and skip tiles outside the band and past the length. The 16-bit
kernels use mma.sync from ldmatrix fragments, keep the tile they own
resident in shared memory while the other side streams through a ring,
and accumulate in registers: the forward keeps Qs and streams Ks in (key
tile x depth chunk) pieces and V, with S, P and O in registers; the dQ
kernel keeps Qs and dO and streams Ks and V, the dK/dV kernel keeps K and V
and streams Qs and dO, each with its gradient in registers in passes of
576 columns, and a smaller or single-stage ring where the depth needs it.

Widths: the 16-bit kernels load 16-byte rows, so the wrappers pad d1 and dv
with zero columns up to multiples of 8 (`padded`) and slice o, dq, dk and
dv back (`pad_fwd`, `pad_bwd`): a zero column changes no score and no true
output column. Conformer-CTC Small's heads (d1 = 44 + 176 = 220, dv = 44)
run at 224 and 48. What is left to refuse (`check_depth`): a dtype other
than bf16, fp16 and fp32, dv > 128, and in the 16-bit types a d1 past the
forward's shared memory (`flash_attention_fwd_smem_bytes`: 1216 padded);
the backward kernels take every depth the forward takes and report their
own limits (`flash_attention_bwd_dq_max_d1`, `flash_attention_bwd_dkv_max_d1`),
which `check_bwd_depth` asks (a CUDA `fit` too, before its first step).
Launches count per kernel and dtype (`counter`): K2-fwd, K2-bwd-dq and
K2-bwd-dkv in bf16, the same names with "-f16" or "-f32" after them in the
other dtypes, keyed at the caller's widths.

`flash_attention_fwd` and `flash_attention_bwd` launch their kernels for
CUDA tensors and raise on anything they do not take; for CPU tensors they
run `flash_attention_fwd_reference` / `flash_attention_bwd_reference`, the
plain PyTorch versions of the same functions. No CUDA call falls back to a
plain version.

The forward is the operator `torch.ops.conformer_nemo_tpu_torch.flash_attention_fwd`
(`torch.library.custom_op`, with a fake implementation that gives the
output shapes), so `torch.export` records one call of it in place of the
ctypes launch it cannot trace, and an exported program launches the
kernel on the card (counted as any launch). Inference calls it directly;
`FlashAttention` calls it inside its forward when a gradient is wanted.
"""

from __future__ import annotations

import ctypes

import torch

from conformer_nemo_tpu_torch.ops.build import SMEM_LIMIT, LaunchCount, launch_count, load

_NEG_INF = -1e30
MAX_DV = 128

# the dtypes the CUDA kernels take -> (forward source, backward source, the
# entry points' suffix): bf16 and fp16 are one template's two instances,
# fp32 has kernels of its own
KERNELS = {
    torch.bfloat16: ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "bf16"),
    torch.float16: ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "f16"),
    torch.float32: ("flash_attention_f32.cu", "flash_attention_f32.cu", "f32"),
}


def counter(kernel: str, dtype) -> LaunchCount:
    """The launch count of K2's `kernel` ("fwd", "dq" or "dkv") in `dtype`,
    keyed by the caller's (bh, t, d1, dv, left, right): K2-fwd, K2-bwd-dq and
    K2-bwd-dkv in bf16, with "-f16" or "-f32" after the name in the others."""
    name = {"fwd": "K2-fwd", "dq": "K2-bwd-dq", "dkv": "K2-bwd-dkv"}[kernel]
    return launch_count(name if dtype == torch.bfloat16 else f"{name}-{KERNELS[dtype][2]}")


for _dt in KERNELS:  # every count registered, so each reads 0 before its first launch
    for _k in ("fwd", "dq", "dkv"):
        counter(_k, _dt)
fwd_launches, dq_launches, dkv_launches = (counter(k, torch.bfloat16)
                                           for k in ("fwd", "dq", "dkv"))


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


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 for bf16/fp16/fp32 inputs, fp64 for fp64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def flash_attention_fwd_reference(qs, ks, v, lens, scale: float, left: int = -1,
                                  right: int = -1):
    """Plain PyTorch version: dense fp32 masked softmax with the kernel's
    masking and empty-row rules. -> (o [BH,T,dv] in qs.dtype, lse [BH,T] fp32)."""
    t = qs.shape[1]
    acc = _acc_dtype(qs)
    mask = visible_mask(t, lens, left, right)
    s = torch.einsum("btd,bsd->bts", qs.to(acc), ks.to(acc)) * scale
    s = torch.where(mask, s, torch.full((), _NEG_INF, dtype=acc, device=s.device))
    m = s.amax(dim=-1)
    m_safe = torch.where(m <= _NEG_INF * 0.5, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]),
                    torch.zeros((), dtype=acc, device=s.device))
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bts,bsd->btd", p, v.to(acc)) / l_safe[..., None]
    return o.to(qs.dtype), m_safe + torch.log(l_safe)


def flash_attention_bwd_reference(qs, ks, v, do, lse, delta, lens, scale: float,
                                  left: int = -1, right: int = -1):
    """Plain PyTorch version of the backward: dense fp32 recomputation of
    P = exp(min(S * scale - lse, 0)) over the visible pairs of valid query
    rows (lse is at least every score of its row, so the cap only bounds P
    by 1 where the scores pass fp32's resolution, as the kernels do).
    -> (dq, dk, dv) in the dtypes of qs, ks, v."""
    t = qs.shape[1]
    acc = _acc_dtype(qs)
    q_valid = torch.arange(t, device=lens.device)[None, :] < lens.to(torch.int64)[:, None]
    mask = visible_mask(t, lens, left, right) & q_valid[:, :, None]
    qf, kf, vf, dof = qs.to(acc), ks.to(acc), v.to(acc), do.to(acc)
    s = torch.einsum("btd,bsd->bts", qf, kf) * scale
    p = torch.where(mask, torch.exp((s - lse.to(acc)[..., None]).clamp(max=0.0)),
                    torch.zeros((), dtype=acc, device=s.device))
    dp = torch.einsum("btd,bsd->bts", dof, vf)
    ds = p * (dp - delta.to(acc)[..., None]) * scale
    dq = torch.einsum("bts,bsd->btd", ds, kf)
    dk = torch.einsum("bts,btd->bsd", ds, qf)
    dv = torch.einsum("bts,btd->bsd", p, dof)
    return dq.to(qs.dtype), dk.to(ks.dtype), dv.to(v.dtype)


def _fn(source: str, name: str, n_ptr: int, n_int: int, n_tail: int = 0):
    """A C entry point of `source`: n_ptr pointers, then n_int ints, a
    float scale, two ints (the band) and n_tail more ints, then the stream."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * n_ptr + [i32] * n_int + [ctypes.c_float, i32, i32]
                       + [i32] * n_tail + [ptr])
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


def padded(n: int) -> int:
    """A head depth rounded up to the kernels' granule: 16-byte rows of
    16-bit elements, a multiple of 8."""
    return -(-n // 8) * 8


def _pad(x: torch.Tensor) -> torch.Tensor:
    """x with zero columns up to a multiple of 8 (x itself where it is one)."""
    pad = padded(x.shape[-1]) - x.shape[-1]
    return x if pad == 0 else torch.nn.functional.pad(x, (0, pad))


def check_depth(d1: int, dv: int, dtype) -> None:
    """Raise ValueError if no flash kernel takes depths (d1, dv) in `dtype`
    on CUDA: the kernels take bf16, fp16 and fp32, dv <= MAX_DV, and in the
    16-bit types a d1 whose query tile fits the forward's shared memory
    (`flash_attention_fwd_smem_bytes`, at d1 and dv padded to multiples of
    8); the fp32 kernels stream the depth and take any d1."""
    if dtype not in KERNELS:
        raise TypeError(f"the CUDA flash kernels take {', '.join(map(str, KERNELS))}; "
                        f"got {dtype}")
    if not (d1 > 0 and 0 < dv <= MAX_DV):
        raise ValueError(f"the CUDA flash kernels take d1 > 0 and 0 < dv <= {MAX_DV}; got "
                         f"d1={d1}, dv={dv}")
    if dtype != torch.float32:
        d1p, dvp = padded(d1), padded(dv)
        smem = load("flash_attention_fwd.cu").flash_attention_fwd_smem_bytes(d1p, dvp)
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"the CUDA forward kernel keeps its query tile of qs and a ring of key pieces "
                f"in shared memory and needs {smem} bytes at d1={d1p}, dv={dvp} "
                f"(flash_attention_fwd_smem_bytes); a block has {SMEM_LIMIT}")


def _check_cuda(tensors: dict, lens, bh: int, d1: int, dv: int) -> None:
    """What the CUDA kernels take: operands of one dtype among bf16, fp16 and
    fp32, int32 lens, contiguous 16-byte-aligned tensors, BH <= 65535, and
    depths `check_depth` admits."""
    dtypes = {x.dtype for x in tensors.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in KERNELS or lens.dtype != torch.int32:
        raise TypeError("the CUDA kernels take " + "/".join(tensors) + " of one dtype among "
                        + ", ".join(map(str, KERNELS)) + " and int32 lens, got "
                        + "/".join(str(x.dtype) for x in tensors.values()) + f"/{lens.dtype}")
    if not all(x.is_contiguous() for x in (*tensors.values(), lens)) or any(
            x.data_ptr() % 16 for x in tensors.values()):  # the kernels load 16-byte vectors
        raise ValueError("the CUDA kernel takes contiguous tensors, "
                         + "/".join(tensors) + " 16-byte aligned")
    if bh > 65535:
        raise ValueError(f"the CUDA kernel takes BH <= 65535, got {bh}")
    check_depth(d1, dv, next(iter(dtypes)))


def _check_fwd_cuda(qs, ks, v, lens) -> None:
    """What the forward kernels take: `_check_cuda` on qs, ks and v, whose
    `check_depth` holds the 16-bit forward's query tile and key ring to a
    block's shared memory."""
    bh, _, d1 = qs.shape
    _check_cuda({"qs": qs, "ks": ks, "v": v}, lens, bh, d1, v.shape[-1])


@torch.library.custom_op(
    "conformer_nemo_tpu_torch::flash_attention_fwd", mutates_args=(),
    schema="(Tensor qs, Tensor ks, Tensor v, Tensor lens, float scale, int left, int right) "
           "-> (Tensor, Tensor)")
def _flash_fwd_op(qs, ks, v, lens, scale, left, right):
    _check(qs, ks, v, lens)
    if qs.device.type == "cpu":
        return flash_attention_fwd_reference(qs, ks, v, lens, scale, left, right)
    if qs.device.type != "cuda":
        raise ValueError(f"unsupported device {qs.device}")
    _check_fwd_cuda(qs, ks, v, lens)
    o, lse = pad_fwd(_launch_fwd, qs, ks, v, lens, scale, left, right)
    return o.contiguous(), lse


@_flash_fwd_op.register_fake
def _flash_fwd_fake(qs, ks, v, lens, scale, left, right):
    _check(qs, ks, v, lens)
    bh, t, _ = qs.shape
    return qs.new_empty((bh, t, v.shape[-1])), qs.new_empty((bh, t), dtype=_acc_dtype(qs))


def flash_attention_fwd(qs, ks, v, lens, scale: float, left: int = -1, right: int = -1):
    """softmax(qs ks^T * scale + mask) v over [BH, T, d1] x [BH, T, dv] with
    per-row key lengths lens [BH] and an optional (left, right) band
    (-1 = unlimited). -> (o [BH, T, dv] in qs.dtype, lse [BH, T] fp32).
    One call of the operator conformer_nemo_tpu_torch::flash_attention_fwd."""
    return _flash_fwd_op(qs, ks, v, lens, float(scale), int(left), int(right))


def pad_fwd(launch, qs, ks, v, lens, scale, left, right):
    """`launch` (the forward's signature) on qs, ks and v with zero columns
    up to the kernels' granule (`padded`), o sliced back to dv columns: zero
    columns change neither a score nor an output column. Launches are
    counted at the caller's widths."""
    bh, t, d1 = qs.shape
    dv = v.shape[-1]
    o, lse = launch(_pad(qs), _pad(ks), _pad(v), lens, scale, left, right,
                    key=(bh, t, d1, dv, int(left), int(right)))
    return o[..., :dv], lse


def _launch_fwd(qs, ks, v, lens, scale, left, right, rows: int = 0, key=None):
    """Launch the forward kernel of qs's dtype (CUDA tensors, checked, d1 and
    dv multiples of 8) with a query tile of `rows` rows, 64 or 128 (0: the
    library's choice; the fp32 kernel has one height); count it under `key`
    (default: these tensors' shape and band)."""
    bh, t, d1 = qs.shape
    dv = v.shape[-1]
    o = torch.empty((bh, t, dv), dtype=qs.dtype, device=qs.device)
    lse = torch.empty((bh, t), dtype=torch.float32, device=qs.device)
    if bh == 0 or t == 0:
        return o, lse
    source, _, suffix = KERNELS[qs.dtype]
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (qs.data_ptr(), ks.data_ptr(), v.data_ptr(), lens.data_ptr(), o.data_ptr(),
                lse.data_ptr(), bh, t, d1, dv, float(scale), int(left), int(right))
        if qs.dtype == torch.float32:
            err = _fn(source, "flash_attention_fwd_f32", 6, 4)(*args, stream)
        else:
            err = _fn(source, f"flash_attention_fwd_rows_{suffix}", 6, 4, 1)(
                *args, int(rows), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA error {err}")
    counter("fwd", qs.dtype).add(key or (bh, t, d1, dv, int(left), int(right)))
    return o, lse


def _check_bwd(qs, ks, v, do, lse, delta, lens) -> None:
    _check(qs, ks, v, lens)
    bh, t, _ = qs.shape
    if do.shape != v.shape or lse.shape != (bh, t) or delta.shape != (bh, t):
        raise ValueError(f"shapes: do {tuple(do.shape)}, lse {tuple(lse.shape)}, delta "
                         f"{tuple(delta.shape)}; want [BH,T,dv], [BH,T], [BH,T]")
    if not all(x.device == qs.device for x in (do, lse, delta)):
        raise ValueError("do, lse and delta must be on the device of qs")
    if qs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {qs.device}")


def check_bwd_depth(d1: int, dv: int, kernels: tuple = ("dq", "dkv"),
                    dtype=torch.bfloat16) -> None:
    """Raise ValueError if a backward kernel named in `kernels` ("dq",
    "dkv") cannot take depths (d1, dv) in `dtype`, by the limits its library
    reports at the depths padded to multiples of 8. The fp32 kernels take
    any depth (they stream it in 32-column boxes and take the gradient in
    passes of 576 columns: `flash_attention_bwd_f32_plan`); the 16-bit
    kernels report the largest d1 their shared memory takes at dv."""
    if dtype == torch.float32:
        return
    d1p, dvp = padded(d1), padded(dv)
    lib = load("flash_attention_bwd.cu")
    for name, what, limit in (
            ("dq", "dQ kernel keeps its query rows of qs in shared memory beside a ring of "
                   "key tiles", "flash_attention_bwd_dq_max_d1"),
            ("dkv", "dK/dV kernel keeps its key rows of ks in shared memory beside a ring of "
                    "query tiles", "flash_attention_bwd_dkv_max_d1")):
        if name in kernels:
            max_d1 = getattr(lib, limit)(dvp)
            if d1p > max_d1:
                raise ValueError(f"the CUDA {what} and takes d1 <= {max_d1} at dv={dvp} "
                                 f"({limit}); got d1={d1p}")


def _check_bwd_cuda(qs, ks, v, do, lse, delta, lens, kernels: tuple) -> None:
    """What the backward kernels named in `kernels` ("dq", "dkv") take, each
    against its own limits, checked before any of them launches."""
    bh, t, d1 = qs.shape
    dv = v.shape[-1]
    _check_cuda({"qs": qs, "ks": ks, "v": v, "do": do}, lens, bh, d1, dv)
    if lse.dtype != torch.float32 or delta.dtype != torch.float32 or not (
            lse.is_contiguous() and delta.is_contiguous()):
        raise TypeError("the CUDA kernel takes contiguous fp32 lse and delta")
    check_bwd_depth(d1, dv, kernels, qs.dtype)


def _bwd_kernel(name: str, outs, qs, ks, v, do, lse, delta, lens, scale, left, right, key):
    """Launch one of the two backward kernels of qs's dtype (CUDA tensors,
    checked, d1 and dv multiples of 8), counted under `key`."""
    bh, t, d1 = qs.shape
    dv = v.shape[-1]
    if bh == 0 or t == 0:
        return
    _, source, suffix = KERNELS[qs.dtype]
    with torch.cuda.device(qs.device):
        err = _fn(source, f"flash_attention_bwd_{name}_{suffix}", 7 + len(outs), 4)(
            qs.data_ptr(), ks.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), lens.data_ptr(), *(o.data_ptr() for o in outs), bh, t, d1, dv,
            float(scale), int(left), int(right), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd {name} kernel launch failed: CUDA error {err}")
    counter(name, qs.dtype).add(key)


def _launch_dq(qs, ks, v, do, lse, delta, lens, scale, left, right, key):
    dq = torch.empty_like(qs)
    _bwd_kernel("dq", (dq,), qs, ks, v, do, lse, delta, lens, scale, left, right, key)
    return (dq,)


def _launch_dkv(qs, ks, v, do, lse, delta, lens, scale, left, right, key):
    dk, dvo = torch.empty_like(ks), torch.empty_like(v)
    _bwd_kernel("dkv", (dk, dvo), qs, ks, v, do, lse, delta, lens, scale, left, right, key)
    return dk, dvo


def pad_bwd(launch, grads: str, qs, ks, v, do, lse, delta, lens, scale, left, right):
    """`launch` (a backward's signature, returning the gradients that `grads`
    names in order: "q", "k", "v") on qs, ks, v and dO with zero columns up
    to the kernels' granule, each gradient sliced back to its true width. A
    zero column of qs and ks adds nothing to a score, and one of v and dO
    nothing to dO v^T, so the true columns are those of the unpadded
    function. Launches are counted at the caller's widths."""
    bh, t, d1 = qs.shape
    dv = v.shape[-1]
    outs = launch(_pad(qs), _pad(ks), _pad(v), _pad(do), lse, delta, lens, scale, left, right,
                  key=(bh, t, d1, dv, int(left), int(right)))
    width = {"q": d1, "k": d1, "v": dv}
    return tuple(g[..., :width[name]] for name, g in zip(grads, outs))


def flash_attention_bwd_dq(qs, ks, v, do, lse, delta, lens, scale: float, left: int = -1,
                           right: int = -1):
    """The dQ kernel of the backward alone: -> dq (CPU tensors: the plain
    version's dq)."""
    args = (qs, ks, v, do, lse, delta, lens, scale, left, right)
    _check_bwd(*args[:7])
    if qs.device.type == "cpu":
        return flash_attention_bwd_reference(*args)[0]
    _check_bwd_cuda(*args[:7], ("dq",))
    return pad_bwd(_launch_dq, "q", *args)[0].contiguous()


def flash_attention_bwd_dkv(qs, ks, v, do, lse, delta, lens, scale: float, left: int = -1,
                            right: int = -1):
    """The dK/dV kernel of the backward alone: -> (dk, dv) (CPU tensors: the
    plain version's)."""
    args = (qs, ks, v, do, lse, delta, lens, scale, left, right)
    _check_bwd(*args[:7])
    if qs.device.type == "cpu":
        return flash_attention_bwd_reference(*args)[1:]
    _check_bwd_cuda(*args[:7], ("dkv",))
    return tuple(g.contiguous() for g in pad_bwd(_launch_dkv, "kv", *args))


def _launch_bwd(*args, key):
    return (*_launch_dq(*args, key=key), *_launch_dkv(*args, key=key))


def flash_attention_bwd(qs, ks, v, do, lse, delta, lens, scale: float, left: int = -1,
                        right: int = -1):
    """Gradients of `flash_attention_fwd`'s o with respect to qs, ks and v,
    given dO [BH, T, dv], the forward's lse [BH, T] and delta = rowsum(dO * O)
    [BH, T] (fp32). -> (dq, dk, dv) in the input dtypes."""
    args = (qs, ks, v, do, lse, delta, lens, scale, left, right)
    _check_bwd(*args[:7])
    if qs.device.type == "cpu":
        return flash_attention_bwd_reference(*args)
    _check_bwd_cuda(*args[:7], ("dq", "dkv"))  # both kernels' limits before either launches
    return tuple(g.contiguous() for g in pad_bwd(_launch_bwd, "qkv", *args))


class FlashAttention(torch.autograd.Function):
    """o = flash_attention_fwd(...)[0] with the fused backward: delta =
    rowsum(dO * O) in fp32 (plain ops, as the JAX package computes it
    outside Pallas), then `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, qs, ks, v, lens, scale: float, left: int, right: int):
        o, lse = flash_attention_fwd(qs, ks, v, lens, scale, left, right)
        ctx.save_for_backward(qs, ks, v, lens, o, lse)
        ctx.band = (scale, left, right)
        return o

    @staticmethod
    def backward(ctx, do):
        qs, ks, v, lens, o, lse = ctx.saved_tensors
        scale, left, right = ctx.band
        do = do.contiguous()
        acc = _acc_dtype(o)  # fp32; fp64 on the plain path under gradcheck
        delta = (do.to(acc) * o.to(acc)).sum(-1)
        dq, dk, dv = flash_attention_bwd(qs, ks, v, do, lse, delta, lens, scale, left, right)
        return dq, dk, dv, None, None, None, None


def flash_attention(qs, ks, v, lens, scale: float, left: int = -1, right: int = -1):
    """o of `flash_attention_fwd`: through `FlashAttention` where a gradient
    is wanted, else the operator alone (inference, `torch.export`)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (qs, ks, v)):
        return FlashAttention.apply(qs, ks, v, lens, float(scale), int(left), int(right))
    return flash_attention_fwd(qs, ks, v, lens, scale, left, right)[0]
