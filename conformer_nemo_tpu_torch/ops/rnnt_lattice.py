"""RNN-T lattice recursions (K3): the forward variable alpha and the backward
variable beta over each sample's [T, U+1] lattice.

Semantics of `_compute_alphas` / `_compute_betas` in
conformer_nemo_tpu/ops/rnnt_loss.py (both their "scan" and "pallas"
implementations): with valid(t, u) = t < t_len and u <= u_len, blank_lp and
label_lp are set to -1e30 outside the valid cells, and

    alpha[0, 0] = 0
    alpha[t, u] = lse(alpha[t-1, u] + blank[t-1, u], alpha[t, u-1] + label[t, u-1])
    beta[t, u]  = max(lse(blank[t, u] + beta[t+1, u], label[t, u] + beta[t, u+1]), term[t, u])

where term is blank_lp at the terminal cell (t_len - 1, u_len) and -1e30
elsewhere; both outputs are -1e30 outside the valid cells, and
beta[:, 0, 0] is the log-likelihood. -1e30 stands for -inf, and `_lse`
returns -1e30 when both terms are below -5e29.

`rnnt_alphas` / `rnnt_betas` take [B, T, U+1] fp32 and return [B, T, U+1]
fp32. For CUDA tensors they launch the hand-written kernels of
ops/csrc/rnnt_lattice.cu and raise on anything the kernels do not take; for
CPU tensors they run `rnnt_alphas_reference` / `rnnt_betas_reference`, the
plain versions: the scan path's diagonal sweep (one step per anti-diagonal
d = t + u), vectorised over B and T.

The kernels take one block per sample and size its sweep to the sample's
own width u_len + 1 on the device: one warp with a shuffle per diagonal up
to 64 columns (the warp path), the block's warps with a barrier
per diagonal past it, in strips of u past the block's width (the block
path). The wrapper reads no length back; `_launch(..., plan=)` receives
the path each sample took and the dependent diagonals it swept.

The JAX package skews the lattice so that each diagonal is a column
(`_skew` / `_unskew`) and caps the Pallas lattice at
`_PALLAS_LATTICE_MAX_CELLS`: a TPU lane-layout trick and a VMEM limit. The
kernels here take the unskewed layout and have no cap; the plain versions
gather each diagonal by index.
"""

from __future__ import annotations

import ctypes

import torch

from conformer_nemo_tpu_torch.ops.build import launch_count, load
from conformer_nemo_tpu_torch.ops.ctc_loss import lse2 as lse

NEG_INF = -1e30
# as ops/csrc/rnnt_lattice.cu: cells a thread holds, the block's bounds; each
# sample's path, as the kernels report it
CELLS = 2
MIN_THREADS, MAX_THREADS = 128, 512
PATHS = ("empty", "warp", "block")

# launches per kernel, keyed by (B, T, U+1)
alpha_launches = launch_count("K3-alpha")
beta_launches = launch_count("K3-beta")


def valid_cells(shape, t_lens: torch.Tensor, u_lens: torch.Tensor) -> torch.Tensor:
    """[B, T, U+1] bool: t < t_len and u <= u_len."""
    _, t_max, u1 = shape
    dev = t_lens.device
    return ((torch.arange(t_max, device=dev)[None, :, None] < t_lens.long()[:, None, None])
            & (torch.arange(u1, device=dev)[None, None, :] <= u_lens.long()[:, None, None]))


def terminal_cells(shape, t_lens: torch.Tensor, u_lens: torch.Tensor) -> torch.Tensor:
    """[B, T, U+1] bool: the cell (t_len - 1, u_len) of each sample."""
    _, t_max, u1 = shape
    dev = t_lens.device
    return ((torch.arange(t_max, device=dev)[None, :, None] == (t_lens.long() - 1)[:, None, None])
            & (torch.arange(u1, device=dev)[None, None, :] == u_lens.long()[:, None, None]))


def _diagonals(x: torch.Tensor) -> torch.Tensor:
    """[B, T, U1] -> [B, T, W] with out[b, t, d] = x[b, t, d - t] on the
    lattice and -1e30 off it (W = T + U1)."""
    b, t_max, u1 = x.shape
    d = torch.arange(t_max + u1, device=x.device)[None, :]
    u = d - torch.arange(t_max, device=x.device)[:, None]  # [T, W]
    on = (u >= 0) & (u < u1)
    g = torch.gather(x, 2, u.clamp(0, u1 - 1)[None].expand(b, -1, -1))
    return torch.where(on[None], g, NEG_INF)


def _cells(cols: torch.Tensor, u1: int) -> torch.Tensor:
    """Inverse of `_diagonals`: [B, T, W] -> [B, T, U1]."""
    b, t_max, _ = cols.shape
    d = torch.arange(t_max, device=cols.device)[:, None] + torch.arange(u1, device=cols.device)
    return torch.gather(cols, 2, d[None].expand(b, -1, -1))


def rnnt_alphas_reference(blank_lp, label_lp, t_lens, u_lens):
    """Plain PyTorch version of K3-alpha -> alpha [B, T, U+1] fp32."""
    b, t_max, u1 = blank_lp.shape
    ok = valid_cells(blank_lp.shape, t_lens, u_lens)
    bl = _diagonals(torch.where(ok, blank_lp.float(), NEG_INF))
    lb = _diagonals(torch.where(ok, label_lp.float(), NEG_INF))
    col = torch.full((b, t_max), NEG_INF, device=blank_lp.device)
    col[:, 0] = 0.0
    cols = [col]
    for d in range(1, t_max + u1 - 1):
        left = col + bl[:, :, d - 1]
        from_left = torch.cat([torch.full_like(left[:, :1], NEG_INF), left[:, :-1]], dim=1)
        col = lse(from_left, col + lb[:, :, d - 1])
        cols.append(col)
    cols.append(torch.full_like(col, NEG_INF))  # column W-1 holds no cell
    alpha = _cells(torch.stack(cols, dim=2), u1)
    return torch.where(ok, alpha, NEG_INF)


def rnnt_betas_reference(blank_lp, label_lp, t_lens, u_lens):
    """Plain PyTorch version of K3-beta -> beta [B, T, U+1] fp32."""
    b, t_max, u1 = blank_lp.shape
    ok = valid_cells(blank_lp.shape, t_lens, u_lens)
    bl = _diagonals(torch.where(ok, blank_lp.float(), NEG_INF))
    lb = _diagonals(torch.where(ok, label_lp.float(), NEG_INF))
    term = _diagonals(torch.where(terminal_cells(blank_lp.shape, t_lens, u_lens),
                                  blank_lp.float(), NEG_INF))
    col = torch.full((b, t_max), NEG_INF, device=blank_lp.device)
    cols = []
    for d in range(t_max + u1 - 1, -1, -1):
        blank_child = torch.cat([col[:, 1:], torch.full_like(col[:, :1], NEG_INF)], dim=1)
        col = torch.maximum(lse(bl[:, :, d] + blank_child, lb[:, :, d] + col), term[:, :, d])
        cols.append(col)
    beta = _cells(torch.stack(cols[::-1], dim=2), u1)
    return torch.where(ok, beta, NEG_INF)


def lattice_threads(u1: int) -> int:
    """The block the kernels take at width U+1: a thread per CELLS columns,
    in whole warps, at least MIN_THREADS (the warps the sweep leaves idle
    write the -1e30 cells) and at most MAX_THREADS."""
    return min(max(-(-u1 // (32 * CELLS)) * 32, MIN_THREADS), MAX_THREADS)


def _c_fn(name: str):
    fn = getattr(load("rnnt_lattice.cu"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(blank_lp, label_lp, t_lens, u_lens) -> None:
    if blank_lp.dim() != 3 or label_lp.shape != blank_lp.shape:
        raise ValueError(f"shapes: blank_lp {tuple(blank_lp.shape)}, label_lp "
                         f"{tuple(label_lp.shape)}; want two [B, T, U+1]")
    b = blank_lp.shape[0]
    if t_lens.shape != (b,) or u_lens.shape != (b,):
        raise ValueError(f"t_lens and u_lens must be [B] = [{b}]")
    if not all(x.device == blank_lp.device for x in (label_lp, t_lens, u_lens)):
        raise ValueError("blank_lp, label_lp, t_lens and u_lens must be on one device")
    if blank_lp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {blank_lp.device}")


def _check_launch(blank_lp, label_lp, t_lens, u_lens, threads, plan) -> int:
    """What the CUDA kernels take: fp32 [B, T >= 1, 1 <= U+1 < 2^30] log-probs
    and int32 lengths, contiguous (a row's byte stride is a 32-bit operand of
    the kernels' address arithmetic; no diagonal is kept in shared memory, so
    no shared-memory rule bounds U+1). -> the block."""
    if blank_lp.dtype != torch.float32 or label_lp.dtype != torch.float32 or \
            t_lens.dtype != torch.int32 or u_lens.dtype != torch.int32:
        raise TypeError("the CUDA kernels take fp32 blank_lp/label_lp and int32 lengths")
    if not all(x.is_contiguous() for x in (blank_lp, label_lp, t_lens, u_lens)):
        raise ValueError("the CUDA kernels take contiguous tensors")
    b, t_max, u1 = blank_lp.shape
    if t_max < 1 or not 1 <= u1 < 2 ** 30:
        raise ValueError(f"the CUDA kernels take T >= 1 and 1 <= U+1 < 2^30, got "
                         f"{tuple(blank_lp.shape)}")
    if threads is None:
        threads = lattice_threads(u1)
    elif threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"threads = {threads}: the block is whole warps, 32 to {MAX_THREADS}")
    if plan is not None and (plan.dtype != torch.int32 or plan.shape != (b, 2)
                             or not plan.is_contiguous() or plan.device != blank_lp.device):
        raise ValueError(f"plan must be a contiguous int32 [{b}, 2] on {blank_lp.device}")
    return threads


def _launch(name: str, counter, blank_lp, label_lp, t_lens, u_lens, threads=None, plan=None):
    """Launch one kernel. `threads` forces the block (32 sends every sample
    to the block path, in strips of 64 columns); `plan`, an int32 [B, 2]
    tensor, receives each sample's path as an index into `PATHS` and the
    dependent diagonals its sweep took (each strip's t_len + width - 1)."""
    threads = _check_launch(blank_lp, label_lp, t_lens, u_lens, threads, plan)
    b, t_max, u1 = blank_lp.shape
    out = torch.empty_like(blank_lp)
    if b == 0:
        return out
    with torch.cuda.device(blank_lp.device):
        err = _c_fn(name)(blank_lp.data_ptr(), label_lp.data_ptr(), t_lens.data_ptr(),
                          u_lens.data_ptr(), out.data_ptr(),
                          None if plan is None else plan.data_ptr(), b, t_max, u1, threads,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    counter.add((b, t_max, u1))
    return out


def chain_probe(device, beta: bool = False, steps: int = 16384) -> dict:
    """The warp path's dependent step alone, timed on the card: one warp
    runs `steps` exchanges with its neighbouring lane and lse's on values in
    registers (no loads or stores) and reads the SM clock and the global
    timer around them. -> {"cycles_per_step", "ns_per_step"}."""
    out = torch.zeros(3, dtype=torch.int64, device=device)
    fn = load("rnnt_lattice.cu").rnnt_lattice_chain_probe
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(out.device):
        err = fn(int(beta), -0.7, -1.3, steps, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rnnt_lattice_chain_probe launch failed: CUDA error {err}")
    cycles, ns, _ = out.tolist()
    return {"cycles_per_step": cycles / steps, "ns_per_step": ns / steps}


def rnnt_alphas(blank_lp, label_lp, t_lens, u_lens):
    """K3-alpha: alpha [B, T, U+1] fp32 from blank_lp and label_lp [B, T, U+1]
    fp32 (label_lp[:, t, u] = log p(y_{u+1} | t, u)) and lengths [B]."""
    _check(blank_lp, label_lp, t_lens, u_lens)
    if blank_lp.device.type == "cpu":
        return rnnt_alphas_reference(blank_lp, label_lp, t_lens, u_lens)
    return _launch("rnnt_alpha_f32", alpha_launches, blank_lp, label_lp, t_lens, u_lens)


def rnnt_betas(blank_lp, label_lp, t_lens, u_lens):
    """K3-beta: beta [B, T, U+1] fp32; beta[:, 0, 0] is the log-likelihood."""
    _check(blank_lp, label_lp, t_lens, u_lens)
    if blank_lp.device.type == "cpu":
        return rnnt_betas_reference(blank_lp, label_lp, t_lens, u_lens)
    return _launch("rnnt_beta_f32", beta_launches, blank_lp, label_lp, t_lens, u_lens)
