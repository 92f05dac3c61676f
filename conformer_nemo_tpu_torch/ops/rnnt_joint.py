"""RNN-T flash joint (K4): the joint network fused with the loss's
log-softmax prep, so the [B, T, U+1, V] logits never reach device memory.

Semantics of conformer_nemo_tpu/ops/pallas/rnnt_joint_kernel.py
(`joint_flash_fwd` / `joint_flash_bwd`, signatures and return dtypes kept).
For each cell (b, t, u), with the vocabulary split blank-last
(`split_blank`: blank_id must be V - 1):

    h     = drop(act(e[b, t] + p[b, u]))             (compute dtype)
    lab   = (h @ W_lab in fp32, rounded) + b_lab     (compute dtype)
    blank = (h . w_blank in fp32, rounded) + b_blank
    -> blank_lp = blank - lse, label_lp = lab[targets[u]] - lse, lse   [B, T, U+1] fp32

and the backward recomputes the tile and forms
dlogits = softmax * total - gb 1[blank] - gy 1[label], clamped, times g,
giving (de [B, T, H] in e's dtype, dp [B, U+1, H], dW [H, V], db [V] fp32).
label_lp's last column (u = U) selects target 0; the caller invalidates it.
Both take each sample's lattice lengths (t_lens, u_lens) beyond the JAX
signatures: only the cells inside the lattice (t < t_len, u <= u_len) are
computed, since the loss reads no other; the forward writes -1e30 (lse
1e30) outside it.

Dropout is a counter-based hash: murmur3's fmix32 of (index ^ seed) over
the padded [B, Tp, U+1, H] layout, Tp = ceil(T / bt) * bt with
bt = `pick_bt(T, bt)`, indices in uint32 with wrap-around; keep iff the top
byte >= drop_t, rescaled by 1 / (1 - drop_t / 256). `hash_keep_mask_reference`
gives the same mask outside the kernels, bit for bit. A seed tensor of two
entries carries a hash base beside the seed, added to every index
(`joint_seed`): a data-parallel rank passes its first row's offset in the
global batch, so its rows draw the mask that one process's run of the
global batch draws for them (the JAX package's data-sharded step hashes
the global row).

For CUDA tensors `joint_flash_fwd` / `joint_flash_bwd` launch the
hand-written kernels (design and bound described in their sources):
ops/csrc/rnnt_joint.cu in bf16 and fp16, ops/csrc/rnnt_joint_f32.cu in
fp32, and raise on anything they do not take; for CPU tensors they run
`joint_flash_fwd_reference` / `joint_flash_bwd_reference`, the plain
versions, which materialise the tile in torch. The backward runs in pieces
over windows of lattice cells (`joint_flash_bwd_windowed`: the cells
kernel, the sums kernel, the reduce), each with its plain version here, and
the plain pieces compose to `joint_flash_bwd_reference`.

Any H >= 1 runs: the CUDA wrappers pad e, p and W's rows with zeros to a
multiple of 16 (`pad_hidden`) and slice de, dp and dW back. The kernels take
the caller's H apart (`hash_h`): the dropout hash indexes the layout at that
width, and the padded units are 0 in h and in act' whatever the activation
(sigmoid(0) is 0.5). The plain versions take `hash_h` the same way, so that
a padded call through them gives the unpadded call's outputs. The limit on
H is the forward's shared memory (`check_smem`, `fwd_rows`: 1376 in the
16-bit dtypes; fp32 any H); the backward takes every H the forward takes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from conformer_nemo_tpu_torch.ops.build import SMEM_LIMIT, LaunchCount, launch_count, load
from conformer_nemo_tpu_torch.ops.rnnt_lattice import NEG_INF, valid_cells

ACTIVATIONS = ("relu", "sigmoid", "tanh")
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35
_MASK32 = 0xFFFFFFFF

# the library and entry-point suffix of each compute dtype the kernels take
KERNELS = {torch.bfloat16: ("rnnt_joint.cu", "bf16"), torch.float16: ("rnnt_joint.cu", "f16"),
           torch.float32: ("rnnt_joint_f32.cu", "f32")}
_NAMES = {"fwd": "K4-fwd", "cells": "K4-bwd", "sums": "K4-bwd-dw", "reduce": "K4-bwd-reduce"}


def counter(kernel: str, dtype) -> LaunchCount:
    """The launch count of K4's `kernel` ("fwd", "cells", "sums" or
    "reduce") in `dtype`, keyed by the caller's (B, T, U+1, H, V): K4-fwd,
    K4-bwd, K4-bwd-dw and K4-bwd-reduce in bf16, with "-f16" or "-f32" after
    the name in the others."""
    name = _NAMES[kernel]
    return launch_count(name if dtype == torch.bfloat16 else f"{name}-{KERNELS[dtype][1]}")


for _dt in KERNELS:  # every count registered, so each reads 0 before its first launch
    for _k in _NAMES:
        counter(_k, _dt)
fwd_launches, bwd_launches, bwd_sums_launches, bwd_reduce_launches = (
    counter(k, torch.bfloat16) for k in _NAMES)


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def hash_bits(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur3 fmix32 of (idx ^ seed) (`_hash_bits`): idx int64 holding
    uint32 values (taken mod 2^32), seed an int32; -> int64 in [0, 2^32)."""
    x = (idx & _MASK32) ^ (int(seed) & _MASK32)
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def keep_from_bits(bits: torch.Tensor, drop_t: int) -> torch.Tensor:
    """Top byte of the hash >= drop_t keeps the element (`_keep_from_bits`)."""
    return (bits >> 24) >= drop_t


def hash_keep_mask_reference(shape, seed, drop_t: int, device=None) -> torch.Tensor:
    """The keep mask the kernels generate for a [B, Tp, U1, H] tensor; seed a
    length-1 int tensor (or an int), or `joint_seed`'s pair."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape) + _hash_base(seed)
    return keep_from_bits(hash_bits(idx, _seed_int(seed)), drop_t)


def _seed_int(seed) -> int:
    return int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else int(seed)


def _hash_base(seed) -> int:
    """The hash base a seed tensor carries as its second entry (0 if none),
    in [0, 2^32)."""
    if not torch.is_tensor(seed) or seed.numel() < 2:
        return 0
    return int(seed.reshape(-1)[1]) & _MASK32


def joint_seed(seed: int, row_offset: int, t: int, u1: int, h: int, bt: int) -> torch.Tensor:
    """The seed tensor of rows that start at `row_offset` of the global
    batch: [seed, hash base] int32, the base the flat index of the global
    row `row_offset`'s first cell in the [B, Tp, U1, H] layout (mod 2^32,
    as the kernels' uint32 index wraps)."""
    return torch.tensor([seed, _i32((row_offset * padded_t(t, bt) * u1 * h) & _MASK32)],
                        dtype=torch.int32)


def _i32(x: int) -> int:
    """A uint32 as the int32 of the same bits (a C int argument)."""
    return x - (1 << 32) if x >= 1 << 31 else x


def pick_bt(t: int, bt: int) -> int:
    return max(1, min(bt, t))


def padded_t(t: int, bt: int) -> int:
    """Tp of the dropout layout: T rounded up to a multiple of pick_bt(T, bt)."""
    b = pick_bt(t, bt)
    return -(-t // b) * b


def inv_keep(drop_t: int) -> float:
    return 1.0 / (1.0 - drop_t / 256.0) if drop_t > 0 else 1.0


def split_blank(w, bias, blank_id: int):
    """[H, V] / [V] -> (w_lab [H, V-1], w_blank [H], b_lab [V-1], b_blank [1])."""
    v = w.shape[1]
    if blank_id != v - 1:
        raise ValueError(f"flash joint requires blank-last (blank_id={blank_id}, V={v}); "
                         "use joint_impl='dense' for other layouts")
    return w[:, : v - 1], w[:, v - 1], bias[: v - 1], bias[v - 1:]


def _act(x, activation: str):
    if activation == "relu":
        return torch.where(x.float() > 0.0, x, torch.zeros((), dtype=x.dtype))
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation == "tanh":
        return torch.tanh(x)
    raise ValueError(f"activation must be one of {ACTIVATIONS}, got {activation!r}")


def _act_grad(x, h, activation: str):
    if activation == "relu":
        return (x.float() > 0.0).to(h.dtype)
    if activation == "sigmoid":
        return h * (1 - h)
    return 1 - h * h


def padded_h(h: int) -> int:
    """H rounded up to the kernels' multiple of 16."""
    return -(-h // 16) * 16


def pad_hidden(e, p, w):
    """e [B,T,H], p [B,U1,H] and W [H,V] with zero hidden units up to
    `padded_h(H)`, contiguous; the same tensors where H is a multiple of 16."""
    h = e.shape[2]
    hp = padded_h(h)
    if hp == h:
        return e, p, w
    return (F.pad(e, (0, hp - h)).contiguous(), F.pad(p, (0, hp - h)).contiguous(),
            F.pad(w, (0, 0, 0, hp - h)).contiguous())


def _unpadded(hash_h, h: int) -> bool:
    """Whether a plain version's inputs carry padding units past hash_h."""
    return hash_h is not None and hash_h < h


def _pad_units(x, h: int, dim: int = -1):
    """x with zero units up to h along `dim` (-1 or 0)."""
    pad = h - x.shape[dim]
    return F.pad(x, (0, pad) if dim == -1 else (0, 0, 0, pad))


def _tile(e, p, w, bias, targets, seed, blank_id, activation, drop_t, bt):
    """The forward tile over the padded [B, Tp, U1] cells:
    (x, h dropped, keep or None, lab [.., V-1] fp32, blank fp32, target ids)."""
    dt = e.dtype
    w_lab, w_b, b_lab, b_b = split_blank(w, bias, blank_id)
    t = e.shape[1]
    ep = F.pad(e, (0, 0, 0, padded_t(t, bt) - t))
    x = ep[:, :, None, :] + p[:, None, :, :]  # [B, Tp, U1, H]
    h = _act(x, activation)
    keep = None
    if drop_t > 0:
        keep = hash_keep_mask_reference(x.shape, seed, drop_t, device=x.device)
        h = torch.where(keep, h * inv_keep(drop_t), torch.zeros((), dtype=dt))
    lab = (torch.matmul(h.float(), w_lab.float()).to(dt) + b_lab.to(dt)).float()
    blank = ((h.float() * w_b.float()).sum(-1).to(dt) + b_b.to(dt)).float()
    tgt = F.pad(targets.long(), (0, 1))[:, None, :, None].expand(*lab.shape[:3], 1)
    return x, h, keep, lab, blank, tgt


def joint_flash_fwd_reference(e, p, w, bias, targets, seed, *, t_lens, u_lens, blank_id: int,
                              activation: str = "relu", drop_t: int = 0, bt: int = 32,
                              hash_h: int | None = None):
    """Plain PyTorch version of K4-fwd -> (blank_lp, label_lp, lse) [B, T, U1]
    fp32; outside each sample's lattice blank_lp = label_lp = -1e30 and
    lse = 1e30. hash_h: the caller's width where e, p and W carry zero units
    past it (`pad_hidden`), as the kernels take it: the call at that width."""
    if _unpadded(hash_h, e.shape[2]):
        return joint_flash_fwd_reference(
            e[..., :hash_h], p[..., :hash_h], w[:hash_h], bias, targets, seed, t_lens=t_lens,
            u_lens=u_lens, blank_id=blank_id, activation=activation, drop_t=drop_t, bt=bt)
    t = e.shape[1]
    _, _, _, lab, blank, tgt = _tile(e, p, w, bias, targets, seed, blank_id, activation,
                                     drop_t, bt)
    m = torch.maximum(lab.amax(-1), blank)
    lse = m + torch.log(torch.exp(lab - m[..., None]).sum(-1) + torch.exp(blank - m))
    label = torch.gather(lab, 3, tgt)[..., 0]
    inside = valid_cells((e.shape[0], t, p.shape[1]), t_lens, u_lens).to(e.device)
    out = lambda x, fill: torch.where(inside, x[:, :t], fill)
    return out(blank - lse, NEG_INF), out(label - lse, NEG_INF), out(lse, -NEG_INF)


def joint_flash_bwd_reference(e, p, w, bias, targets, lse, total, gb, gy, g, seed, *,
                              t_lens, u_lens, blank_id: int, activation: str = "relu",
                              drop_t: int = 0, bt: int = 32, clamp: float = -1.0,
                              hash_h: int | None = None):
    """Plain PyTorch version of K4-bwd -> (de [B, T, H] e.dtype, dp [B, U1, H],
    dw [H, V], db [V] fp32). Cells outside each sample's lattice add
    nothing (whatever lse, total, gb and gy hold there). hash_h as the
    forward's: the padding units' de, dp and dW rows are 0, as the kernels
    write them."""
    if _unpadded(hash_h, e.shape[2]):
        de, dp, dw, db = joint_flash_bwd_reference(
            e[..., :hash_h], p[..., :hash_h], w[:hash_h], bias, targets, lse, total, gb, gy, g,
            seed, t_lens=t_lens, u_lens=u_lens, blank_id=blank_id, activation=activation,
            drop_t=drop_t, bt=bt, clamp=clamp)
        h = e.shape[2]
        return _pad_units(de, h), _pad_units(dp, h), _pad_units(dw, h, 0), db
    dt = e.dtype
    t = e.shape[1]
    tp = padded_t(t, bt)
    x, h, keep, lab, blank, tgt = _tile(e, p, w, bias, targets, seed, blank_id, activation,
                                        drop_t, bt)
    w_lab, w_b, _, _ = split_blank(w, bias, blank_id)
    # padded frames and cells outside the lattice: lse 1e30 so that
    # exp(logits - lse) is 0, posteriors 0
    inside = valid_cells(lse.shape, t_lens, u_lens).to(e.device)
    pad = lambda z, v: F.pad(torch.where(inside, z.float(), v), (0, 0, 0, tp - t), value=v)
    lse_p, total_p, gb_p, gy_p = pad(lse, 1e30), pad(total, 0.0), pad(gb, 0.0), pad(gy, 0.0)
    dlab = torch.exp(lab - lse_p[..., None]) * total_p[..., None]
    dlab = dlab - torch.zeros_like(dlab).scatter_(3, tgt, gy_p[..., None])
    dblank = torch.exp(blank - lse_p) * total_p - gb_p
    if clamp > 0:
        dlab, dblank = dlab.clamp(-clamp, clamp), dblank.clamp(-clamp, clamp)
    gg = g.float()[:, None, None]
    dlab, dblank = dlab * gg[..., None], dblank * gg
    dlab_c = dlab.to(dt)
    dh = (torch.matmul(dlab_c.float(), w_lab.float().T)
          + dblank[..., None] * w_b.float()).to(dt)
    if keep is not None:
        dh = torch.where(keep, dh * inv_keep(drop_t), torch.zeros((), dtype=dt))
    h_act = h if drop_t == 0 else _act(x, activation)
    dx = dh * _act_grad(x, h_act, activation)
    de = dx.float().sum(2).to(dt)[:, :t]
    dp = dx.float().sum(1)
    hf = h.float().reshape(-1, h.shape[-1])
    dwl = hf.T @ dlab_c.float().reshape(-1, dlab.shape[-1])
    dwb = (hf * dblank.reshape(-1, 1)).sum(0)
    dw = torch.cat([dwl, dwb[:, None]], dim=1)
    db = torch.cat([dlab.reshape(-1, dlab.shape[-1]).sum(0), dblank.sum()[None]])
    return de, dp, dw, db


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

TILE_CELLS = 64  # lattice cells per tile of the cells kernel
KSPLIT = 24  # fixed number of K splits of the dW product
# label columns per pass of the backward kernels over the label block
PASS_COLS = {torch.bfloat16: 320, torch.float16: 320, torch.float32: 128}
WINDOW_BYTES = 320 << 20  # at most a window's scratch (dlab, dblank, dx, h, db partials, dh)

_CHECKED_LIBS: set = set()


def _load_checked(dtype):
    """The library of `dtype`'s kernels. The backward's layout constants, which
    size the buffers allocated here, are held against the library's once."""
    lib = load(KERNELS[dtype][0])
    if id(lib) not in _CHECKED_LIBS:
        got = (lib.rnnt_joint_bwd_tile_cells(), lib.rnnt_joint_bwd_ksplit(),
               lib.rnnt_joint_bwd_pass_cols())
        want = (TILE_CELLS, KSPLIT, PASS_COLS[dtype])
        if got != want:
            raise RuntimeError(f"{KERNELS[dtype][0]}'s (tile cells, K splits, pass columns) are "
                               f"{got}, this module's {want}")
        _CHECKED_LIBS.add(id(lib))
    return lib


def _lib():
    """rnnt_joint.cu's library: the bf16 and fp16 kernels."""
    return _load_checked(torch.bfloat16)


def _lib_f32():
    """rnnt_joint_f32.cu's library: the fp32 kernels."""
    return _load_checked(torch.float32)


def _lib_of(dtype):
    return _lib_f32() if dtype == torch.float32 else _lib()


def _c_fn(dtype, name: str, n_ptr: int, n_int: int, tail: tuple = ()):
    """`dtype`'s entry point `name`: pointers, ints, the `tail` types (ctypes),
    the stream."""
    fn = getattr(_lib_of(dtype), f"{name}_{KERNELS[dtype][1]}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + list(tail) + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _shapes(e, p, w, bias, targets):
    if e.dim() != 3 or p.dim() != 3 or w.dim() != 2 or bias.dim() != 1 or targets.dim() != 2:
        raise ValueError("want e [B,T,H], p [B,U+1,H], w [H,V], bias [V], targets [B,U]")
    b, t, h = e.shape
    u1, v = p.shape[1], w.shape[1]
    if p.shape != (b, u1, h) or w.shape[0] != h or bias.shape != (v,) or \
            targets.shape != (b, u1 - 1):
        raise ValueError(f"shapes: e {tuple(e.shape)}, p {tuple(p.shape)}, w {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)}, targets {tuple(targets.shape)}")
    return b, t, u1, h, v


def _check_cuda(tensors: dict, h: int, v: int, which: tuple) -> None:
    """Raise on what the CUDA kernels do not take: e, p, w and bias of one
    dtype among KERNELS', int32 targets, contiguous tensors on one card, and
    H and V as `check_smem` takes them for the kernels in `which`."""
    dt = tensors["e"].dtype
    if dt not in KERNELS:
        raise TypeError(f"the CUDA joint kernels take {', '.join(map(str, KERNELS))}; got {dt}")
    same = {k: x for k, x in tensors.items() if k in ("e", "p", "w", "w_pad", "w_blank", "bias")}
    if any(x.dtype != dt for x in same.values()):
        raise TypeError("the CUDA kernels take e, p, w and bias of one dtype, got "
                        + ", ".join(f"{k} {x.dtype}" for k, x in same.items()))
    if tensors["targets"].dtype != torch.int32:
        raise TypeError("the CUDA kernels take int32 targets")
    dev = tensors["e"].device
    if not all(x.is_cuda and x.device == dev and x.is_contiguous() for x in tensors.values()):
        raise ValueError("the CUDA kernels take contiguous tensors on one card")
    if padded_h(h) == h and (tensors["e"].data_ptr() % 16 or tensors["p"].data_ptr() % 16):
        raise ValueError("the CUDA kernels read e and p in 16-byte vectors: both must start "
                         "16-byte aligned")
    check_smem(h, v, which, dt)


def check_smem(h: int, v: int, which: tuple = (0, 1, 2), dtype=torch.bfloat16) -> None:
    """The CUDA joint kernels' range, the one rule that the wrappers, `joint_impl:
    auto` and the training loss's early check apply: raise unless H >= 1 (the
    wrappers pad it to a multiple of 16), V >= 2 and each kernel in `which`
    (0 the forward, 1 and 2 the backward's cells and sums) of `dtype` fits a
    block's shared memory at the padded H. The backward takes every H the
    forward takes; a training caller checks (1, 2) before the forward runs."""
    if dtype not in KERNELS:
        raise TypeError(f"the CUDA joint kernels take {', '.join(map(str, KERNELS))}; "
                        f"got {dtype}")
    if h < 1 or v < 2:
        raise ValueError(f"the CUDA joint kernels take H >= 1 and V >= 2, got H={h}, V={v}")
    lib = _lib_of(dtype)
    lib.rnnt_joint_smem_bytes.restype = ctypes.c_longlong
    hp = padded_h(h)
    for k in which:
        smem = lib.rnnt_joint_smem_bytes(hp, v, k)
        if smem > SMEM_LIMIT:
            raise ValueError(f"the CUDA joint kernel {k} needs {smem} bytes of shared memory "
                             f"at H={h} (padded to {hp}), V={v}; a block has {SMEM_LIMIT}")


def fwd_weight(w):
    """W [H, V] as the forward reads it: rows of a multiple of 8 columns
    (16 bytes in the 16-bit dtypes, whose tensor copies need it; 32 in fp32),
    16-byte aligned, zeros past column V - 1 (the blank, last: column VL
    joins the label product). W itself where it already is so; else a
    zero-padded copy [H, ceil(V / 8) * 8]."""
    v = w.shape[1]
    if v % 8 == 0 and w.is_contiguous() and w.data_ptr() % 16 == 0:
        return w
    return F.pad(w, (0, -v % 8)).contiguous()


def fwd_rows(h: int, dtype=torch.bfloat16) -> int:
    """Lattice cells per tile the CUDA forward of `dtype` takes at H (padded
    to 16): 128 or 64 in the 16-bit dtypes, 0 where neither tile fits a
    block's shared memory (`check_smem` refuses); 64 in fp32 at any H."""
    return _lib_of(dtype).rnnt_joint_fwd_rows(padded_h(h))


def fwd_grid(cells: int, rows: int, n_sm: int) -> int:
    """Blocks of the 16-bit forward's persistent grid over B * T * U1 `cells`
    in tiles of `rows`: one per SM, no more than the tiles. Block x takes the
    lattice's tiles x, x + grid, ... (tile k: lattice cells k * rows ..
    k * rows + rows - 1 in `lattice_cells` order), and the sentinels of the
    full [B, T, U1] index in a grid-stride loop, so any grid covers every
    cell once. (The fp32 forward launches a block per tile instead.)"""
    return max(1, min(n_sm, -(-cells // rows)))


def _act_code(activation: str) -> int:
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, got {activation!r}")
    return ACTIVATIONS.index(activation)


def _lens(t_lens, u_lens, b: int):
    if t_lens.shape != (b,) or u_lens.shape != (b,):
        raise ValueError(f"t_lens and u_lens must be [B] = [{b}]")
    if t_lens.dtype != torch.int32 or u_lens.dtype != torch.int32:
        raise TypeError("the CUDA kernels take int32 t_lens and u_lens")


def joint_flash_fwd(e, p, w, bias, targets, seed, *, t_lens, u_lens, blank_id: int,
                    activation: str = "relu", drop_t: int = 0, bt: int = 32):
    """K4-fwd: e [B,T,H], p [B,U1,H], w [H,V], bias [V] (bf16, fp16 or fp32),
    targets [B,U] int, seed [1] int32, t_lens / u_lens [B] -> (blank_lp,
    label_lp, lse) each [B,T,U1] fp32. Only the cells inside each sample's
    lattice (t < t_len, u <= u_len) are computed; outside it blank_lp =
    label_lp = -1e30 and lse = 1e30 (the lattice and the backward never read
    them)."""
    b, t, u1, h, v = _shapes(e, p, w, bias, targets)
    split_blank(w, bias, blank_id)
    act = _act_code(activation)
    if e.device.type == "cpu":
        return joint_flash_fwd_reference(e, p, w, bias, targets, seed, t_lens=t_lens,
                                         u_lens=u_lens, blank_id=blank_id,
                                         activation=activation, drop_t=drop_t, bt=bt)
    if e.device.type != "cuda":
        raise ValueError(f"unsupported device {e.device}")
    _lens(t_lens, u_lens, b)
    _check_cuda({"e": e, "p": p, "w": w, "bias": bias, "targets": targets, "t_lens": t_lens,
                 "u_lens": u_lens}, h, v, (0,))
    outs = [torch.empty((b, t, u1), dtype=torch.float32, device=e.device) for _ in range(3)]
    if b == 0 or t == 0:
        return tuple(outs)
    ep, pp, wp = pad_hidden(e, p, w)
    _launch_fwd(ep, pp, fwd_weight(wp), bias, targets, seed, t_lens, u_lens, outs, v, act,
                int(drop_t), bt, hash_h=h)
    return tuple(outs)


def _launch_fwd(e, p, w_fwd, bias, targets, seed, t_lens, u_lens, outs, v: int, act: int,
                drop_t: int, bt: int, grid: int | None = None, hash_h: int | None = None) -> None:
    """One launch of the forward on checked inputs of a width a multiple of 16:
    w_fwd from `fwd_weight`, grid the 16-bit persistent grid's blocks (default
    `fwd_grid`'s), hash_h the caller's width where e, p and W are padded."""
    b, t, h = e.shape
    u1, dt = p.shape[1], e.dtype
    hh = h if hash_h is None else hash_h
    if grid is None:
        grid = fwd_grid(b * t * u1, fwd_rows(h, dt),
                        torch.cuda.get_device_properties(e.device).multi_processor_count)
    cell_off = lattice_offsets(t_lens, u_lens, t, u1)
    with torch.cuda.device(e.device):
        err = _c_fn(dt, "rnnt_joint_fwd", 11, 13)(
            e.data_ptr(), p.data_ptr(), w_fwd.data_ptr(), bias.data_ptr(), targets.data_ptr(),
            t_lens.data_ptr(), u_lens.data_ptr(), cell_off.data_ptr(),
            *(o.data_ptr() for o in outs), b, t, u1, h, hh, v, w_fwd.shape[1], padded_t(t, bt),
            act, drop_t, _seed_int(seed), _i32(_hash_base(seed)), int(grid),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"joint_flash_fwd kernel launch failed: CUDA error {err}")
    counter("fwd", dt).add((b, t, u1, hh, v))


def joint_flash_bwd(e, p, w, bias, targets, lse, total, gb, gy, g, seed, *, t_lens, u_lens,
                    blank_id: int, activation: str = "relu", drop_t: int = 0, bt: int = 32,
                    clamp: float = -1.0):
    """K4-bwd: the backward of the fused joint + loss prep. total, gb, gy
    [B,T,U1] fp32 are the lattice posteriors; g [B] fp32 is the upstream
    gradient, applied after the clamp; t_lens / u_lens [B] bound each
    sample's lattice, and the cells outside it add nothing. -> (de [B,T,H]
    e.dtype, dp [B,U1,H], dw [H,V], db [V] fp32). On CUDA: per window of
    lattice cells the cells kernel and the sums kernel, then the reduce
    (`joint_flash_bwd_windowed`), at H padded to 16 and sliced back."""
    b, t, u1, h, v = _shapes(e, p, w, bias, targets)
    split_blank(w, bias, blank_id)
    _act_code(activation)
    if any(x.shape != (b, t, u1) for x in (lse, total, gb, gy)) or g.shape != (b,):
        raise ValueError("lse, total, gb, gy must be [B, T, U+1] and g [B]")
    if e.device.type == "cpu":
        return joint_flash_bwd_reference(e, p, w, bias, targets, lse, total, gb, gy, g, seed,
                                         t_lens=t_lens, u_lens=u_lens, blank_id=blank_id,
                                         activation=activation, drop_t=drop_t, bt=bt,
                                         clamp=clamp)
    if e.device.type != "cuda":
        raise ValueError(f"unsupported device {e.device}")
    _lens(t_lens, u_lens, b)
    _check_cuda({"e": e, "p": p, "w": w, "bias": bias, "targets": targets, "t_lens": t_lens,
                 "u_lens": u_lens}, h, v, (1, 2))
    if b == 0 or t == 0:
        f32 = dict(dtype=torch.float32, device=e.device)
        return (torch.zeros((b, t, h), dtype=e.dtype, device=e.device),
                torch.zeros((b, u1, h), **f32), torch.zeros((h, v), **f32),
                torch.zeros((v,), **f32))
    ep, pp, wp = pad_hidden(e, p, w)
    de, dp, dw, db = joint_flash_bwd_windowed(
        ep, pp, wp, bias, targets, lse, total, gb, gy, g, seed, t_lens=t_lens, u_lens=u_lens,
        blank_id=blank_id, activation=activation, drop_t=drop_t, bt=bt, clamp=clamp, hash_h=h)
    if ep.shape[2] != h:
        de, dp, dw = de[..., :h].contiguous(), dp[..., :h].contiguous(), dw[:h].contiguous()
    return de, dp, dw, db


# ---------------------------------------------------------------------------
# K4-bwd in pieces: per window of lattice cells, the cells kernel (dlab,
# dblank, dx) and the sums kernel (dW, de, dp, db into fp32 accumulators);
# then the reduce. Each piece runs its plain version on CPU tensors.
# ---------------------------------------------------------------------------


def padded_vl(v: int) -> int:
    """V - 1 rounded up to a multiple of 32: the label block's padded width."""
    return -(-(v - 1) // 32) * 32


def _window_bytes_per_cell(h: int, v: int, dtype) -> float:
    """A window's scratch per cell at the padded H: dlab, dx and h in the
    dtype, fp32 dblank, the db partials, and fp32 dh between the passes over
    a label block wider than a pass."""
    es, vlp = torch.tensor([], dtype=dtype).element_size(), padded_vl(v)
    return es * (2 * h + vlp) + 4 + 4 * v / TILE_CELLS + (4 * h if vlp > PASS_COLS[dtype] else 0)


def bwd_windows(cells: int, h: int, v: int, window: int | None = None, dtype=torch.bfloat16):
    """(cells per window, windows) of the backward over a lattice of `cells`
    cells at width H (padded to 16): a window holds at most `window` cells
    (default: as many as fit WINDOW_BYTES of scratch at H, V in `dtype`), a
    multiple of 64, and no more than the lattice needs."""
    if window is None:
        window = int(WINDOW_BYTES // _window_bytes_per_cell(padded_h(h), v, dtype))
    win = max(TILE_CELLS, min(window // TILE_CELLS, -(-cells // TILE_CELLS)) * TILE_CELLS)
    return win, -(-cells // win)


def bwd_scratch_bytes(cells: int, b: int, t: int, u1: int, h: int, v: int,
                      window: int | None = None, dtype=torch.bfloat16) -> int:
    """Device bytes the backward allocates besides its outputs: the copies of
    e, p and W padded to 16 hidden units (where H is not), the padded label
    block (and its transpose in fp32), the lattice offsets, one window's
    scratch and the fp32 accumulators."""
    hp = padded_h(h)
    win, _ = bwd_windows(cells, h, v, window, dtype)
    vlp, es = padded_vl(v), torch.tensor([], dtype=dtype).element_size()
    pad_copies = es * hp * (b * t + b * u1 + v) if hp != h else 0
    w_copies = es * hp * (vlp + 1) + (4 * hp * vlp if dtype == torch.float32 else 0)
    return int(pad_copies + w_copies + 8 * (b + 1) + win * _window_bytes_per_cell(hp, v, dtype)
               + 4 * b * t * hp + 4 * KSPLIT * hp * (vlp + 1) + 4 * v)


def pad_label_block(w, blank_id: int):
    """W [H, V] -> (W_lab zero-padded to [H, VLp], w_blank [H]), contiguous."""
    w_lab, w_b, _, _ = split_blank(w, w[0], blank_id)
    vl = w_lab.shape[1]
    return F.pad(w_lab, (0, padded_vl(vl + 1) - vl)).contiguous(), w_b.contiguous()


def bwd_accumulators(b: int, t: int, u1: int, h: int, v: int, device):
    """Zeroed fp32 (de [B,T,H], dp [B,U1,H], dW_lab splits [KSPLIT,H,VLp],
    dW[:, VL] splits [KSPLIT,H], db [V]) that the sums add into."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return (z(b, t, h), z(b, u1, h), z(KSPLIT, h, padded_vl(v)), z(KSPLIT, h), z(v))


def joint_flash_bwd_windowed(e, p, w, bias, targets, lse, total, gb, gy, g, seed, *, t_lens,
                             u_lens, blank_id: int, activation: str = "relu", drop_t: int = 0,
                             bt: int = 32, clamp: float = -1.0, window: int | None = None,
                             hash_h: int | None = None):
    """K4-bwd as the kernels run it: the lattice's cells in windows of at most
    `window` cells, each through the cells kernel and the sums kernel
    (`joint_flash_bwd_cells` and `joint_flash_bwd_sums` launch them the
    same way), then `joint_flash_bwd_reduce`. The windows cover B * T * U1
    cells, the most a lattice of these shapes can hold (the lattice's own
    count stays on the card; a window past it exits at once). On CUDA H must
    be a multiple of 16 (`pad_hidden`), with hash_h the caller's width. On
    CPU tensors every piece is its plain version, and the whole equals
    `joint_flash_bwd_reference`."""
    b, t, u1, h, v = _shapes(e, p, w, bias, targets)
    dt = e.dtype
    w_pad, w_blank = pad_label_block(w, blank_id)
    win, n_win = bwd_windows(b * t * u1, h, v, window, dt)
    acc = bwd_accumulators(b, t, u1, h, v, e.device)
    cells_in = (e, p, w_pad, w_blank, bias, targets, lse, total, gb, gy, g, seed)
    if e.device.type == "cpu":
        for k in range(n_win):
            scratch = joint_flash_bwd_cells_reference(
                *cells_in, t_lens=t_lens, u_lens=u_lens, c0=k * win, win=win,
                activation=activation, drop_t=drop_t, bt=bt, clamp=clamp, hash_h=hash_h)
            joint_flash_bwd_sums_reference(scratch, acc, t_lens=t_lens, u_lens=u_lens,
                                           c0=k * win, win=win)
        return joint_flash_bwd_reduce_reference(acc, dt)
    # checked once; then two launches per window
    hh = _check_cells(*cells_in[:-1], t_lens, u_lens, win, hash_h)
    scratch, dh_part = _cells_scratch(e, w_pad, bias, win)
    wt = _transposed(w_pad)
    cell_off = lattice_offsets(t_lens, u_lens, t, u1)
    for k in range(n_win):
        _launch_cells(cells_in, t_lens, u_lens, cell_off, scratch, dh_part, k * win, win,
                      activation, drop_t, bt, clamp, hh, wt)
        _launch_sums(t_lens, u_lens, cell_off, scratch, acc, k * win, win, hh)
    return joint_flash_bwd_reduce(acc, dt, hh)


def lattice_offsets(t_lens, u_lens, t: int, u1: int):
    """int64 [B + 1]: each sample's first lattice cell in the kernels' order
    (the last entry: the lattice's cells), computed on the lengths' device."""
    n = t_lens.long().clamp(0, t) * (u_lens.long().clamp(max=u1 - 1) + 1).clamp(min=0)
    return F.pad(torch.cumsum(n, 0), (1, 0)).contiguous()


def lattice_cells(t_lens, u_lens, t: int, u1: int, device=None):
    """(b, t, u) int64 [N] of every lattice cell in the kernels' order:
    sample-major, then t-major (cell j of sample b is t = j // n_u,
    u = j % n_u, n_u = u_len + 1)."""
    n_t = t_lens.long().clamp(0, t).tolist()
    n_u = (u_lens.long().clamp(max=u1 - 1) + 1).clamp(min=0).tolist()
    parts = [[], [], []]
    for b, (nt, nu) in enumerate(zip(n_t, n_u)):
        parts[0].append(torch.full((nt * nu,), b, dtype=torch.int64))
        parts[1].append(torch.arange(nt).repeat_interleave(nu))
        parts[2].append(torch.arange(nu).repeat(nt))
    return tuple(torch.cat(x).to(device) for x in parts)


def _cell_hidden(e, p, cells, seed, activation: str, drop_t: int, bt: int):
    """x, h = drop(act(x)) and keep (or None) [N, H] for the cells (b, t, u)."""
    bi, ti, ui = cells
    _, t, h_dim = e.shape
    u1 = p.shape[1]
    x = e[bi, ti] + p[bi, ui]
    h = _act(x, activation)
    keep = None
    if drop_t > 0:
        idx = ((bi * padded_t(t, bt) + ti) * u1 + ui)[:, None] * h_dim + \
            torch.arange(h_dim, device=e.device) + _hash_base(seed)
        keep = keep_from_bits(hash_bits(idx, _seed_int(seed)), drop_t)
        h = torch.where(keep, h * inv_keep(drop_t), torch.zeros((), dtype=e.dtype))
    return x, h, keep


def _window(cells, c0: int, win: int):
    n_w = max(0, min(win, cells[0].shape[0] - c0))
    return n_w, tuple(x[c0: c0 + n_w] for x in cells)


def joint_flash_bwd_cells_reference(e, p, w_pad, w_blank, bias, targets, lse, total, gb, gy, g,
                                    seed, *, t_lens, u_lens, c0: int, win: int,
                                    activation: str = "relu", drop_t: int = 0, bt: int = 32,
                                    clamp: float = -1.0, hash_h: int | None = None):
    """Plain version of the cells kernel for the window of lattice cells
    [c0, c0 + win) -> (dlab [win, VLp] e.dtype, dblank [win] fp32, dx
    [win, H] e.dtype, h [win, H] e.dtype, db partials [win // 64, V] fp32:
    each 64-cell tile's sums of the fp32 dlab, and of dblank in the last
    column). Rows past the lattice's cells are zero; hash_h as the forward's
    (the padding units' dx and h are 0)."""
    if _unpadded(hash_h, e.shape[2]):
        dlab, dblank, dx, h, dbl = joint_flash_bwd_cells_reference(
            e[..., :hash_h], p[..., :hash_h], w_pad[:hash_h], w_blank[:hash_h], bias, targets,
            lse, total, gb, gy, g, seed, t_lens=t_lens, u_lens=u_lens, c0=c0, win=win,
            activation=activation, drop_t=drop_t, bt=bt, clamp=clamp)
        return dlab, dblank, _pad_units(dx, e.shape[2]), _pad_units(h, e.shape[2]), dbl
    dt = e.dtype
    b, t, h_dim = e.shape
    u1, v, vlp = p.shape[1], bias.shape[0], w_pad.shape[1]
    vl = v - 1
    n_w, cells = _window(lattice_cells(t_lens, u_lens, t, u1, e.device), c0, win)
    bi, ti, ui = cells
    x, h, keep = _cell_hidden(e, p, cells, seed, activation, drop_t, bt)
    w_lab = w_pad[:, :vl]
    lab = (torch.matmul(h.float(), w_lab.float()).to(dt) + bias[:vl].to(dt)).float()
    blank = ((h.float() * w_blank.float()).sum(-1).to(dt) + bias[vl:].to(dt)).float()
    at = lambda z: z[bi, ti, ui].float()
    lse_c, tot = at(lse), at(total)
    tgt = F.pad(targets.long(), (0, 1))[bi, ui]
    dlab = torch.exp(lab - lse_c[:, None]) * tot[:, None]
    dlab = dlab - torch.zeros_like(dlab).scatter_(1, tgt[:, None], at(gy)[:, None])
    dblank = torch.exp(blank - lse_c) * tot - at(gb)
    if clamp > 0:
        dlab, dblank = dlab.clamp(-clamp, clamp), dblank.clamp(-clamp, clamp)
    gg = g.float()[bi]
    dlab, dblank = dlab * gg[:, None], dblank * gg
    dlab_c = dlab.to(dt)
    dh = (torch.matmul(dlab_c.float(), w_lab.float().T) + dblank[:, None] * w_blank.float()).to(dt)
    if keep is not None:
        dh = torch.where(keep, dh * inv_keep(drop_t), torch.zeros((), dtype=dt))
    h_act = h if drop_t == 0 else _act(x, activation)
    dx = dh * _act_grad(x, h_act, activation)
    n_tiles = -(-n_w // TILE_CELLS)
    rows = lambda z: F.pad(z, (0, 0, 0, n_tiles * TILE_CELLS - n_w))
    tile_sums = torch.cat([rows(dlab), rows(dblank[:, None])], 1)
    dbl = torch.zeros((win // TILE_CELLS, v), dtype=torch.float32, device=e.device)
    dbl[:n_tiles] = tile_sums.reshape(n_tiles, TILE_CELLS, v).sum(1)
    out = lambda z, dtype, *shape: torch.cat(
        [z.to(dtype), torch.zeros((win - n_w, *shape), dtype=dtype, device=e.device)])
    return (out(F.pad(dlab_c, (0, vlp - vl)), dt, vlp), out(dblank, torch.float32),
            out(dx, dt, h_dim), out(h, dt, h_dim), dbl)


def joint_flash_bwd_sums_reference(scratch, acc, *, t_lens, u_lens, c0: int, win: int):
    """Plain version of the sums kernel: adds the window's dW_lab = h^T dlab
    (split s of KSPLIT over the window's 64-cell tiles into acc[2][s]),
    dW[:, VL] = h^T dblank (acc[3][s]), de, dp and db to the accumulators of
    `bwd_accumulators`, in place -> acc."""
    dlab, dblank, dx, h, dbl = scratch
    de_acc, dp, dw_part, dwb_part, db_acc = acc
    t, u1 = de_acc.shape[1], dp.shape[1]
    n_w, (bi, ti, ui) = _window(lattice_cells(t_lens, u_lens, t, u1, dx.device), c0, win)
    if n_w == 0:
        return acc
    hf = h[:n_w].float()
    n_tiles = -(-n_w // TILE_CELLS)
    per = -(-n_tiles // KSPLIT) * TILE_CELLS
    for s in range(KSPLIT):
        cs, ce = s * per, min((s + 1) * per, n_w)
        if cs < ce:
            dw_part[s] += hf[cs:ce].T @ dlab[cs:ce].float()
            dwb_part[s] += (hf[cs:ce] * dblank[cs:ce, None]).sum(0)
    dxf = dx[:n_w].float()
    de_acc.index_put_((bi, ti), dxf, accumulate=True)
    dp.index_put_((bi, ui), dxf, accumulate=True)
    db_acc += dbl[:n_tiles].sum(0)
    return acc


def joint_flash_bwd_reduce_reference(acc, dtype):
    """Plain version of the reduce kernel -> (de [B,T,H] dtype, dp, dw [H,V],
    db [V] fp32)."""
    de_acc, dp, dw_part, dwb_part, db_acc = acc
    vl = db_acc.shape[0] - 1
    dw = torch.cat([dw_part.sum(0)[:, :vl], dwb_part.sum(0)[:, None]], dim=1)
    return de_acc.to(dtype), dp.clone(), dw, db_acc.clone()


def _launch(what: str, count, shape, dev, fn, *args) -> None:
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"joint_flash_bwd {what} kernel launch failed: CUDA error {err}")
    count.add(shape)


def _check_cells(e, p, w_pad, w_blank, bias, targets, lse, total, gb, gy, g, t_lens, u_lens,
                 win: int, hash_h: int | None = None) -> int:
    """Raise on what the cells kernel does not take. -> the caller's width."""
    b, t, h = e.shape
    v = bias.shape[0]
    hh = h if hash_h is None else hash_h
    if win % TILE_CELLS or w_pad.shape != (h, padded_vl(v)) or w_blank.shape != (h,):
        raise ValueError("want win a multiple of 64, w_pad [H, VLp] and w_blank [H]")
    if h % 16 or not 0 < hh <= h < hh + 16:
        raise ValueError(f"the backward's kernels take e, p and w padded to a multiple of 16 "
                         f"hidden units (pad_hidden) with hash_h the width before it; got H={h}, "
                         f"hash_h={hh}")
    _lens(t_lens, u_lens, b)
    if any(x.dtype != torch.float32 for x in (lse, total, gb, gy, g)):
        raise TypeError("the CUDA kernels take fp32 lse, total, gb, gy and g")
    _check_cuda({"e": e, "p": p, "w_pad": w_pad, "w_blank": w_blank, "bias": bias,
                 "targets": targets, "t_lens": t_lens, "u_lens": u_lens, "lse": lse,
                 "total": total, "gb": gb, "gy": gy, "g": g}, h, v, (1, 2))
    return hh


def _transposed(w_pad):
    """W_lab^T [VLp, H], contiguous: the fp32 cells kernel's dh operand (None
    in the 16-bit dtypes, whose kernel reads W_pad's rows as it)."""
    return w_pad.t().contiguous() if w_pad.dtype == torch.float32 else None


def _cells_scratch(e, w_pad, bias, win: int):
    """The cells kernel's window scratch (dlab, dblank, dx, h, db partials) and
    its fp32 dh between passes ([win, H], or None for one pass)."""
    h, vlp, v, dev, dt = e.shape[2], w_pad.shape[1], bias.shape[0], e.device, e.dtype
    scratch = (torch.empty((win, vlp), dtype=dt, device=dev),
               torch.empty((win,), dtype=torch.float32, device=dev),
               torch.empty((win, h), dtype=dt, device=dev),
               torch.empty((win, h), dtype=dt, device=dev),
               torch.empty((win // TILE_CELLS, v), dtype=torch.float32, device=dev))
    dh_part = (torch.empty((win, h), dtype=torch.float32, device=dev) if vlp > PASS_COLS[dt]
               else None)
    return scratch, dh_part


def _launch_cells(cells_in, t_lens, u_lens, cell_off, scratch, dh_part, c0: int, win: int,
                  activation: str, drop_t: int, bt: int, clamp: float, hash_h: int,
                  wt=None) -> None:
    """One launch of the cells kernel on checked inputs (wt: `_transposed`)."""
    e, p, w_pad, w_blank, bias, targets, lse, total, gb, gy, g, seed = cells_in
    b, t, h = e.shape
    u1, v, dt = p.shape[1], bias.shape[0], e.dtype
    ptrs = (e, p, w_pad, *(() if wt is None else (wt,)), w_blank, bias, targets, t_lens, u_lens,
            cell_off, lse, total, gb, gy, g, *scratch)
    _launch("cells", counter("cells", dt), (b, t, u1, hash_h, v), e.device,
            _c_fn(dt, "rnnt_joint_bwd_cells", len(ptrs) + 1, 13,
                  (ctypes.c_longlong, ctypes.c_float)),
            *(x.data_ptr() for x in ptrs), None if dh_part is None else dh_part.data_ptr(),
            b, t, u1, h, hash_h, v, w_pad.shape[1], padded_t(t, bt), _act_code(activation),
            int(drop_t), _seed_int(seed), _i32(_hash_base(seed)), win, c0, float(clamp))


def _launch_sums(t_lens, u_lens, cell_off, scratch, acc, c0: int, win: int, hash_h: int) -> None:
    """One launch of the sums kernel on checked inputs."""
    b, t, h = acc[0].shape
    u1, v, dt = acc[1].shape[1], acc[4].shape[0], scratch[0].dtype
    _launch("sums", counter("sums", dt), (b, t, u1, hash_h, v), acc[0].device,
            _c_fn(dt, "rnnt_joint_bwd_sums", 13, 7, (ctypes.c_longlong,)),
            *(x.data_ptr() for x in (t_lens, u_lens, cell_off, *scratch, *acc)),
            b, t, u1, h, v, padded_vl(v), win, c0)


def joint_flash_bwd_cells(e, p, w_pad, w_blank, bias, targets, lse, total, gb, gy, g, seed, *,
                          t_lens, u_lens, c0: int, win: int, activation: str = "relu",
                          drop_t: int = 0, bt: int = 32, clamp: float = -1.0,
                          hash_h: int | None = None):
    """K4-bwd's cells kernel over the window [c0, c0 + win) of lattice
    cells (win a multiple of 64): w_pad [H, VLp] and w_blank [H] from
    `pad_label_block` -> (dlab, dblank, dx, h, db partials) as
    `joint_flash_bwd_cells_reference` gives them; on CUDA H a multiple of 16
    (`pad_hidden`, hash_h the width before it) and the rows past the
    lattice's cells are left unwritten."""
    cells_in = (e, p, w_pad, w_blank, bias, targets, lse, total, gb, gy, g, seed)
    if e.device.type == "cpu":
        return joint_flash_bwd_cells_reference(
            *cells_in, t_lens=t_lens, u_lens=u_lens, c0=c0, win=win, activation=activation,
            drop_t=drop_t, bt=bt, clamp=clamp, hash_h=hash_h)
    hh = _check_cells(*cells_in[:-1], t_lens, u_lens, win, hash_h)
    scratch, dh_part = _cells_scratch(e, w_pad, bias, win)
    _launch_cells(cells_in, t_lens, u_lens, lattice_offsets(t_lens, u_lens, e.shape[1], p.shape[1]),
                  scratch, dh_part, c0, win, activation, drop_t, bt, clamp, hh,
                  _transposed(w_pad))
    return scratch


def joint_flash_bwd_sums(scratch, acc, *, t_lens, u_lens, c0: int, win: int,
                         hash_h: int | None = None):
    """K4-bwd's sums kernel: adds the window's dW, de, dp and db from the
    cells kernel's scratch to `acc` (`bwd_accumulators`) in place, as
    `joint_flash_bwd_sums_reference`; hash_h names the caller's width in
    the launch count."""
    if acc[0].device.type == "cpu":
        return joint_flash_bwd_sums_reference(scratch, acc, t_lens=t_lens, u_lens=u_lens, c0=c0,
                                              win=win)
    b, t, h = acc[0].shape
    u1, vlp = acc[1].shape[1], padded_vl(acc[4].shape[0])
    if not all(x.is_cuda and x.is_contiguous() for x in (*scratch, *acc)):
        raise ValueError("the CUDA kernels take contiguous scratch and accumulators on the card")
    if scratch[0].shape != (win, vlp) or acc[2].shape != (KSPLIT, h, vlp) or \
            scratch[0].dtype not in KERNELS or h % 16:
        raise ValueError("want the scratch of `joint_flash_bwd_cells` and `bwd_accumulators`")
    _lens(t_lens, u_lens, b)
    _launch_sums(t_lens, u_lens, lattice_offsets(t_lens, u_lens, t, u1), scratch, acc, c0, win,
                 h if hash_h is None else hash_h)
    return acc


def joint_flash_bwd_reduce(acc, dtype, hash_h: int | None = None):
    """K4-bwd's reduce kernel: the K splits summed in a fixed order -> (de
    [B,T,H] dtype, dp [B,U1,H], dw [H,V], db [V] fp32); hash_h names the
    caller's width in the launch count."""
    if acc[0].device.type == "cpu":
        return joint_flash_bwd_reduce_reference(acc, dtype)
    de_acc, dp, dw_part, dwb_part, db_acc = acc
    b, t, h = de_acc.shape
    u1, v, vlp = dp.shape[1], db_acc.shape[0], dw_part.shape[2]
    if dtype not in KERNELS:
        raise TypeError(f"the CUDA kernels write de in {', '.join(map(str, KERNELS))}; "
                        f"got {dtype}")
    dev = de_acc.device
    dw = torch.empty((h, v), dtype=torch.float32, device=dev)
    db = torch.empty((v,), dtype=torch.float32, device=dev)
    de = torch.empty((b, t, h), dtype=dtype, device=dev)
    _launch("reduce", counter("reduce", dtype), (b, t, u1, h if hash_h is None else hash_h, v),
            dev, _c_fn(dtype, "rnnt_joint_bwd_reduce", 7, 5),
            *(x.data_ptr() for x in (dw_part, dwb_part, db_acc, de_acc, dw, db, de)),
            b, t, h, v, vlp)
    return de, dp, dw, db
