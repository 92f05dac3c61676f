"""The port's flash joint (K4) in every dtype and at every width the JAX
package runs, on the CPU (plain versions) against the JAX package's Pallas
kernels in interpret mode, and the range rule of its CUDA wrappers.

* fp16: the forward and backward within 4e-3 of the largest entry of each
  output (both round h, the logits, dlab, dh and dx to fp16 at the same
  points; 11 bits where bf16 keeps 8, so bf16's 2e-2 becomes 4e-3).
* H 20 and 36 (not multiples of 16) in fp32 with dropout: within F32_TOL, the
  hash mask indexing the [B, Tp, U+1, H] layout at the true H.
* The CUDA wrappers pad e, p and W's rows with zeros to a multiple of 16
  (`pad_hidden`) and pass the true H apart (`hash_h`): through the plain
  versions the padded call gives the unpadded call's outputs bit for bit,
  and zero in the padding units' de, dp and dW rows, sigmoid (act(0) = 0.5)
  included.
* The range rule (`check_smem`, with the joint library's shared-memory query
  stood in for, as the CPU tests have no card): a joint width that is not a
  multiple of 16 under `joint_impl: auto` resolves to the flash joint, and
  the wrappers' own check takes it; the construction check takes fp16 and
  fp32 joints and refuses fp64.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from conformer_nemo_tpu_torch.models import rnnt
from conformer_nemo_tpu_torch.ops import rnnt_joint as port
from conformer_nemo_tpu_torch.ops.build import SMEM_LIMIT
from test_torch_rnnt_joint import F32_TOL, _inputs, _np, _run

F16_REL = 4e-3


@pytest.mark.parametrize("activation,drop_t", [("relu", 0), ("tanh", 26)])
def test_joint_fp16_matches_jax_within_rounding(activation, drop_t):
    d = _inputs(seed=5, t=9, u=4, h=32)
    want_f, got_f, want_b, got_b = _run(d, "float16", activation, 4, drop_t)
    for name, a, b in zip(("blank_lp", "label_lp", "lse", "de", "dp", "dw", "db"),
                          (*got_f, *got_b), (*want_f, *want_b)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape and np.isfinite(a).all(), name
        assert np.abs(a - b).max() <= F16_REL * np.abs(b).max(), name
    assert got_b[0].dtype == torch.float16 and got_b[1].dtype == torch.float32


@pytest.mark.parametrize("h", [20, 36])
@pytest.mark.parametrize("activation", ["relu", "sigmoid"])
def test_joint_at_widths_not_multiples_of_16_matches_jax(h, activation):
    d = _inputs(seed=h, t=9, u=4, h=h)
    want_f, got_f, want_b, got_b = _run(d, "float32", activation, 4, 64, clamp=2.0)
    for name, a, b in zip(("blank_lp", "label_lp", "lse", "de", "dp", "dw", "db"),
                          (*got_f, *got_b), (*want_f, *want_b)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(_np(a), _np(b), rtol=F32_TOL, atol=F32_TOL, err_msg=name)


def _torch_args(d, dtype=torch.float32):
    tx = {k: torch.from_numpy(x) for k, x in d.items()}
    for k in ("e", "p", "w", "bias"):
        tx[k] = tx[k].to(dtype)
    return tx


@pytest.mark.parametrize("h", [20, 36])
@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid"])
def test_padded_call_through_the_plain_versions_is_the_unpadded_call(h, activation):
    """pad_hidden + hash_h, as the CUDA wrappers call the kernels, through
    the plain forward, backward and windowed pieces: the unpadded call's
    outputs bit for bit, the padding units' gradients zero."""
    d = _inputs(seed=h + 1, b=3, t=20, u=6, h=h)
    tx = _torch_args(d)
    b, t, u1 = d["lse"].shape
    v = d["w"].shape[1]
    tl, ul = torch.tensor([20, 11, 1], dtype=torch.int32), torch.tensor([6, 0, 3], dtype=torch.int32)
    seed = port.joint_seed(4242, 3, t, u1, h, 4)
    kw = dict(t_lens=tl, u_lens=ul, blank_id=v - 1, activation=activation, drop_t=64, bt=4)
    ep, pp, wp = port.pad_hidden(tx["e"], tx["p"], tx["w"])
    hp = port.padded_h(h)
    assert ep.shape[2] == pp.shape[2] == wp.shape[0] == hp and hp % 16 == 0 and hp - h < 16
    assert torch.equal(ep[..., :h], tx["e"]) and not ep[..., h:].any() and not wp[h:].any()

    fwd = port.joint_flash_fwd_reference(tx["e"], tx["p"], tx["w"], tx["bias"], tx["targets"],
                                         seed, **kw)
    fwd_p = port.joint_flash_fwd_reference(ep, pp, wp, tx["bias"], tx["targets"], seed,
                                           hash_h=h, **kw)
    assert all(torch.equal(a, r) for a, r in zip(fwd, fwd_p))

    rest = [tx[k] for k in ("lse", "total", "gb", "gy", "g")]
    rest[-1] = torch.tensor([1.0, 0.5, 2.0])
    bwd = port.joint_flash_bwd_reference(tx["e"], tx["p"], tx["w"], tx["bias"], tx["targets"],
                                         *rest, seed, clamp=2.0, **kw)
    bwd_p = port.joint_flash_bwd_reference(ep, pp, wp, tx["bias"], tx["targets"], *rest, seed,
                                           clamp=2.0, hash_h=h, **kw)
    win_p = port.joint_flash_bwd_windowed(ep, pp, wp, tx["bias"], tx["targets"], *rest, seed,
                                          clamp=2.0, hash_h=h, window=64, **kw)
    for name, a, r, w_ in zip(("de", "dp", "dw", "db"), bwd, bwd_p, win_p):
        sl = (slice(None),) * (r.dim() - 1) + (slice(0, h),) if name in ("de", "dp") else \
            (slice(0, h),) if name == "dw" else (slice(None),)
        assert torch.equal(a, r[sl]), name
        torch.testing.assert_close(w_, r, rtol=F32_TOL, atol=F32_TOL)
        if name in ("de", "dp"):
            assert not r[..., h:].any() and not w_[..., h:].any(), name
        if name == "dw":
            assert not r[h:].any() and not w_[h:].any(), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_windowed_pieces_compose_in_every_dtype(dtype):
    """The backward's plain pieces in windows of 64 cells against the whole
    plain backward in that dtype (the same roundings, dW and the sums in
    another order)."""
    d = _inputs(seed=3, b=3, t=20, u=6, h=32)
    d["g"] = np.array([1.0, 0.5, 2.0], np.float32)
    tx = _torch_args(d, dtype)
    v = d["w"].shape[1]
    tl, ul = torch.tensor([20, 11, 1], dtype=torch.int32), torch.tensor([6, 0, 3], dtype=torch.int32)
    kw = dict(t_lens=tl, u_lens=ul, blank_id=v - 1, activation="tanh", drop_t=26, bt=4,
              clamp=2.0)
    args = [tx[k] for k in ("e", "p", "w", "bias", "targets", "lse", "total", "gb", "gy", "g")]
    seed = torch.tensor([99], dtype=torch.int32)
    whole = port.joint_flash_bwd_reference(*args, seed, **kw)
    pieces = port.joint_flash_bwd_windowed(*args, seed, window=64, **kw)
    for a, r in zip(pieces, whole):
        assert a.dtype == r.dtype
        a, r = a.float(), r.float()
        assert (a - r).abs().max() <= 1e-5 + (1e-2 if dtype != torch.float32 else 0) * r.abs().max()


def _stand_in(monkeypatch, limit_h=1376):
    """The libraries' shared-memory query stood in for: every kernel fits up
    to the 16-bit kernels' H 1376, any H in fp32."""
    def smem16(h, v, which):
        return SMEM_LIMIT if h <= limit_h else SMEM_LIMIT + 1

    def smem32(h, v, which):
        return 65536

    monkeypatch.setattr(port, "_lib", lambda: types.SimpleNamespace(
        rnnt_joint_smem_bytes=smem16,
        rnnt_joint_fwd_rows=lambda h: 128 if h <= 672 else 64 if h <= limit_h else 0))
    monkeypatch.setattr(port, "_lib_f32", lambda: types.SimpleNamespace(
        rnnt_joint_smem_bytes=smem32, rnnt_joint_fwd_rows=lambda h: 64), raising=False)
    monkeypatch.setattr(rnnt, "_DENSE_FOR_WIDTH", set())


def _on_card(dtype):
    """A stand-in for a contiguous, aligned tensor on the card: what the
    wrappers' checks read of one."""
    return types.SimpleNamespace(dtype=dtype, is_cuda=True, device=torch.device("cuda", 0),
                                 is_contiguous=lambda: True, data_ptr=lambda: 0)


def test_auto_takes_the_flash_joint_at_h_600_and_its_wrappers_take_it(monkeypatch):
    """joint_hidden 600 under `auto` past the dense estimate resolves to the
    flash joint; the CUDA wrappers' own range check takes H 600 (they pad it
    to 608), so the first training step does not refuse it."""
    _stand_in(monkeypatch)
    cfg = rnnt.RNNTModelConfig(decoder=rnnt.RNNTDecoderConfig(vocab_size=1024),
                               joint=rnnt.RNNTJointConfig(joint_hidden=600))
    b, t, u1 = 16, 400, 200
    assert 3 * 2 * b * t * u1 * cfg.num_classes_with_blank > cfg.joint_flash_hbm_threshold
    assert cfg.resolve_joint_impl(b, t, u1, "cuda") == "flash"
    v = cfg.num_classes_with_blank
    tensors = {"e": _on_card(torch.bfloat16), "p": _on_card(torch.bfloat16),
               "w": _on_card(torch.bfloat16), "bias": _on_card(torch.bfloat16),
               "targets": _on_card(torch.int32), "t_lens": _on_card(torch.int32),
               "u_lens": _on_card(torch.int32)}
    for which in ((0,), (1, 2)):  # the forward's check and the backward's
        port._check_cuda(tensors, 600, v, which)
    rnnt.check_joint(dataclasses.replace(cfg, joint_impl="flash"), "cuda")
    assert port.fwd_rows(600) == 128 and port.padded_h(600) == 608


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_cuda_transducer_joint_takes_fp16_and_fp32(monkeypatch, dtype):
    _stand_in(monkeypatch)
    for impl in ("flash", "auto"):
        cfg = rnnt.RNNTModelConfig(joint=rnnt.RNNTJointConfig(joint_hidden=640, dtype=dtype),
                                   joint_impl=impl)
        rnnt.check_joint(cfg, "cuda")
    wide = rnnt.RNNTModelConfig(joint=rnnt.RNNTJointConfig(joint_hidden=1400, dtype=dtype),
                                joint_impl="flash")
    if dtype == torch.float32:  # the fp32 kernels take any H
        rnnt.check_joint(wide, "cuda")
    else:
        with pytest.raises(ValueError, match="joint_hidden=1400.*shared memory"):
            rnnt.check_joint(wide, "cuda")
    with pytest.raises(ValueError, match="float64"):
        rnnt.check_joint(rnnt.RNNTModelConfig(joint=rnnt.RNNTJointConfig(dtype=torch.float64),
                                              joint_impl="auto"), "cuda")
    rnnt.check_joint(rnnt.RNNTModelConfig(joint=rnnt.RNNTJointConfig(dtype=torch.float64),
                                          joint_impl="dense"), "cuda")


def test_window_sizes_follow_the_dtype():
    """The backward's windows hold WINDOW_BYTES of scratch at the padded H in
    the dtype's element size and pass width (fp32 passes of 128 columns keep
    a dh row in fp32 past VLp 128)."""
    cells = 16 * 391 * 129
    w16, n16 = port.bwd_windows(cells, 640, 296)
    w32, n32 = port.bwd_windows(cells, 640, 296, dtype=torch.float32)
    assert w16 % 64 == 0 and w32 % 64 == 0 and w32 < w16 and n32 > n16
    assert port.bwd_windows(cells, 600, 296) == port.bwd_windows(cells, 608, 296)
    per32 = 4 * (2 * 640 + 320) + 4 + 4 * 296 / 64 + 4 * 640
    assert w32 == int(port.WINDOW_BYTES // per32) // 64 * 64
