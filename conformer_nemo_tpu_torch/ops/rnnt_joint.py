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
gives the same mask outside the kernels, bit for bit.

For CUDA tensors `joint_flash_fwd` / `joint_flash_bwd` launch the
hand-written bf16 kernels of ops/csrc/rnnt_joint.cu (forward; backward as a
kernel that writes per-block partials and a kernel that reduces them;
design and bound described there) and raise on anything they do not take; for CPU tensors they run
`joint_flash_fwd_reference` / `joint_flash_bwd_reference`, the plain
versions, which materialise the tile in torch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from conformer_nemo_tpu_torch.ops.build import SMEM_LIMIT, launch_count, load
from conformer_nemo_tpu_torch.ops.rnnt_lattice import NEG_INF, valid_cells

ACTIVATIONS = ("relu", "sigmoid", "tanh")
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35
_MASK32 = 0xFFFFFFFF

# launches per kernel, keyed by (B, T, U+1, H, V)
fwd_launches = launch_count("K4-fwd")
bwd_launches = launch_count("K4-bwd")
bwd_reduce_launches = launch_count("K4-bwd-reduce")


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
    length-1 int tensor (or an int)."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return keep_from_bits(hash_bits(idx, _seed_int(seed)), drop_t)


def _seed_int(seed) -> int:
    return int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else int(seed)


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
                              activation: str = "relu", drop_t: int = 0, bt: int = 32):
    """Plain PyTorch version of K4-fwd -> (blank_lp, label_lp, lse) [B, T, U1]
    fp32; outside each sample's lattice blank_lp = label_lp = -1e30 and
    lse = 1e30."""
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
                              drop_t: int = 0, bt: int = 32, clamp: float = -1.0):
    """Plain PyTorch version of K4-bwd -> (de [B, T, H] e.dtype, dp [B, U1, H],
    dw [H, V], db [V] fp32). Cells outside each sample's lattice add
    nothing (whatever lse, total, gb and gy hold there)."""
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


def _c_fn(name: str, n_ptr: int, n_int: int, with_clamp: bool = False):
    fn = getattr(load("rnnt_joint.cu"), name)
    if fn.argtypes is None:
        args = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
        if with_clamp:
            args.append(ctypes.c_float)
        fn.argtypes = args + [ctypes.c_void_p]
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
    bf = {k: x for k, x in tensors.items() if k in ("e", "p", "w", "bias")}
    if any(x.dtype != torch.bfloat16 for x in bf.values()):
        raise TypeError("the CUDA kernels take bf16 e, p, w and bias, got "
                        + ", ".join(f"{k} {x.dtype}" for k, x in bf.items()))
    if tensors["targets"].dtype != torch.int32:
        raise TypeError("the CUDA kernels take int32 targets")
    dev = tensors["e"].device
    if not all(x.is_cuda and x.device == dev and x.is_contiguous() for x in tensors.values()):
        raise ValueError("the CUDA kernels take contiguous tensors on one card")
    if h % 16 or h <= 0 or v < 2:
        raise ValueError(f"the CUDA kernels take H a positive multiple of 16 and V >= 2, "
                         f"got H={h}, V={v}")
    lib = load("rnnt_joint.cu")
    lib.rnnt_joint_smem_bytes.restype = ctypes.c_longlong
    for k in which:
        smem = lib.rnnt_joint_smem_bytes(h, v, k)
        if smem > SMEM_LIMIT:
            raise ValueError(f"the CUDA joint kernel {k} needs {smem} bytes of shared memory "
                             f"at H={h}, V={v}; a block has {SMEM_LIMIT}")


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
    """K4-fwd: e [B,T,H], p [B,U1,H], w [H,V], bias [V], targets [B,U] int,
    seed [1] int32, t_lens / u_lens [B] -> (blank_lp, label_lp, lse) each
    [B,T,U1] fp32. Only the cells inside each sample's lattice (t < t_len,
    u <= u_len) are computed; outside it blank_lp = label_lp = -1e30 and
    lse = 1e30 (the lattice and the backward never read them)."""
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
    with torch.cuda.device(e.device):
        err = _c_fn("rnnt_joint_fwd_bf16", 10, 9)(
            e.data_ptr(), p.data_ptr(), w.data_ptr(), bias.data_ptr(), targets.data_ptr(),
            t_lens.data_ptr(), u_lens.data_ptr(), *(o.data_ptr() for o in outs), b, t, u1, h, v,
            padded_t(t, bt), act, int(drop_t), _seed_int(seed),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"joint_flash_fwd kernel launch failed: CUDA error {err}")
    fwd_launches.add((b, t, u1, h, v))
    return tuple(outs)


def joint_flash_bwd(e, p, w, bias, targets, lse, total, gb, gy, g, seed, *, t_lens, u_lens,
                    blank_id: int, activation: str = "relu", drop_t: int = 0, bt: int = 32,
                    clamp: float = -1.0):
    """K4-bwd: the backward of the fused joint + loss prep. total, gb, gy
    [B,T,U1] fp32 are the lattice posteriors; g [B] fp32 is the upstream
    gradient, applied after the clamp; t_lens / u_lens [B] bound each
    sample's lattice, and the cells outside it add nothing. -> (de [B,T,H]
    e.dtype, dp [B,U1,H], dw [H,V], db [V] fp32). On CUDA: the backward
    kernel (`joint_flash_bwd_partials`), then its reduce
    (`joint_flash_bwd_reduce`)."""
    b, t, u1, h, v = _shapes(e, p, w, bias, targets)
    split_blank(w, bias, blank_id)
    act = _act_code(activation)
    if any(x.shape != (b, t, u1) for x in (lse, total, gb, gy)) or g.shape != (b,):
        raise ValueError("lse, total, gb, gy must be [B, T, U+1] and g [B]")
    if e.device.type == "cpu":
        return joint_flash_bwd_reference(e, p, w, bias, targets, lse, total, gb, gy, g, seed,
                                         t_lens=t_lens, u_lens=u_lens, blank_id=blank_id,
                                         activation=activation, drop_t=drop_t, bt=bt,
                                         clamp=clamp)
    if e.device.type != "cuda":
        raise ValueError(f"unsupported device {e.device}")
    if b == 0 or t == 0:
        f32 = dict(dtype=torch.float32, device=e.device)
        return (torch.zeros((b, t, h), dtype=e.dtype, device=e.device),
                torch.zeros((b, u1, h), **f32), torch.zeros((h, v), **f32),
                torch.zeros((v,), **f32))
    de, partials = joint_flash_bwd_partials(e, p, w, bias, targets, lse, total, gb, gy, g,
                                            seed, t_lens=t_lens, u_lens=u_lens, act=act,
                                            drop_t=drop_t, bt=bt, clamp=clamp)
    return (de, *joint_flash_bwd_reduce(partials, b, t))


def _launch(what: str, counter, shape, dev, fn, *args) -> None:
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"joint_flash_bwd {what} kernel launch failed: CUDA error {err}")
    counter.add(shape)


def joint_flash_bwd_partials(e, p, w, bias, targets, lse, total, gb, gy, g, seed, *, t_lens,
                             u_lens, act: int, drop_t: int, bt: int, clamp: float):
    """K4-bwd's first kernel on CUDA tensors (B, T > 0): de [B,T,H] and the
    per-block fp32 partials (dp [units, U1, H], dW_lab [units, H, VLp],
    db_lab [units, V-1], dw_blank [units, H], db_blank [units]; units =
    B * ceil(T / 16) blocks, VLp = V-1 rounded up to 64) -> (de, partials)."""
    b, t, u1, h, v = _shapes(e, p, w, bias, targets)
    dev = e.device
    _lens(t_lens, u_lens, b)
    streams = {"lse": lse, "total": total, "gb": gb, "gy": gy, "g": g}
    if any(x.dtype != torch.float32 for x in streams.values()):
        raise TypeError("the CUDA kernels take fp32 lse, total, gb, gy and g")
    _check_cuda({"e": e, "p": p, "w": w, "bias": bias, "targets": targets, "t_lens": t_lens,
                 "u_lens": u_lens, **streams}, h, v, (1,))
    units = b * -(-t // load("rnnt_joint.cu").rnnt_joint_frames_per_tile())
    vlp = -(-(v - 1) // 64) * 64
    f32 = dict(dtype=torch.float32, device=dev)
    de = torch.empty((b, t, h), dtype=e.dtype, device=dev)
    partials = (torch.empty((units, u1, h), **f32), torch.empty((units, h, vlp), **f32),
                torch.empty((units, v - 1), **f32), torch.empty((units, h), **f32),
                torch.empty((units,), **f32))
    _launch("backward", bwd_launches, (b, t, u1, h, v), dev,
            _c_fn("rnnt_joint_bwd_dx_bf16", 18, 9, with_clamp=True),
            e.data_ptr(), p.data_ptr(), w.data_ptr(), bias.data_ptr(), targets.data_ptr(),
            t_lens.data_ptr(), u_lens.data_ptr(), lse.data_ptr(), total.data_ptr(),
            gb.data_ptr(), gy.data_ptr(), g.data_ptr(), de.data_ptr(),
            *(x.data_ptr() for x in partials), b, t, u1, h, v, padded_t(t, bt), act,
            int(drop_t), _seed_int(seed), float(clamp))
    return de, partials


def joint_flash_bwd_reduce(partials, b: int, t: int):
    """K4-bwd's reduce kernel: the partials of `joint_flash_bwd_partials`
    summed in a fixed order -> (dp [B,U1,H], dw [H,V], db [V]) fp32."""
    dp_part, dw_part, dbl_part, _, _ = partials
    u1, h, v = dp_part.shape[1], dp_part.shape[2], dbl_part.shape[1] + 1
    dev = dp_part.device
    f32 = dict(dtype=torch.float32, device=dev)
    dp, dw, db = torch.empty((b, u1, h), **f32), torch.empty((h, v), **f32), \
        torch.empty((v,), **f32)
    _launch("reduce", bwd_reduce_launches, (b, t, u1, h, v), dev,
            _c_fn("rnnt_joint_bwd_reduce_f32", 8, 5), dw_part.data_ptr(), dp_part.data_ptr(),
            *(x.data_ptr() for x in partials[2:]), dw.data_ptr(), db.data_ptr(), dp.data_ptr(),
            b, t, u1, h, v)
    return dp, dw, db


def joint_flash_bwd_reduce_reference(partials, b: int, t: int):
    """Plain PyTorch version of the reduce kernel -> (dp, dw, db) fp32."""
    dp_part, dw_part, dbl_part, dwb_part, dbb_part = partials
    units, u1, h = dp_part.shape
    vl = dbl_part.shape[1]
    dp = dp_part.reshape(b, units // b, u1, h).sum(1)
    dw = torch.cat([dw_part.sum(0)[:, :vl], dwb_part.sum(0)[:, None]], dim=1)
    return dp, dw, torch.cat([dbl_part.sum(0), dbb_part.sum()[None]])
