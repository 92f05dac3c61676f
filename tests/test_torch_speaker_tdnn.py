"""The port's ECAPA / TDNN speaker stack (models/tdnn.py) and the
classification losses (ops/classification_losses.py) against the JAX
package's, on the CPU.

The encoder, the masked SE, both pools and the speaker decoder in its three
pool modes (angular and plain heads) run on the same inputs and bridged
weights in both packages, in inference and training mode (batch statistics
and the running statistics after the forward; the SE's BatchNorm over its
pooled [B, C] vector). The losses and their gradients are held against the
JAX functions, and the angular loss also against the reference's formula
in torch. A tiny ECAPA + angular loss overfits two separable speakers.

Tolerances: outputs 1e-5 absolute on unit-scale values (fp32 on both
sides; measured ~1e-6); losses 1e-5 relative, gradients 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.models import tdnn as jt
from conformer_nemo_tpu.ops import classification_losses as jl
from conformer_nemo_tpu_torch.convert.jax_params import (
    label_state_dict_from_jax,
    label_variables_to_jax,
)
from conformer_nemo_tpu_torch.models import tdnn as pt
from conformer_nemo_tpu_torch.ops import classification_losses as pl

torch.set_num_threads(2)

ATOL = 1e-5


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _compare(jmod, pmod, args_j, args_p, *, train_kw=True, layout=lambda g: g):
    """Init the JAX module, bridge, compare eval and train outputs (the
    port's through `layout` into the JAX layout) and the updated statistics."""
    kw = {"train": False} if train_kw else {}
    variables = _np(jax.jit(lambda: jmod.init(jax.random.PRNGKey(0), *args_j, **kw))())
    sd = label_state_dict_from_jax(variables, pmod)
    pmod.load_state_dict(sd)
    want = jax.jit(lambda v: jmod.apply(v, *args_j, **kw))(variables)
    got = pmod.eval()(*args_p)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(layout(g.detach().numpy()), np.asarray(w), atol=ATOL)
    if not train_kw or "batch_stats" not in variables:
        return variables
    want, upd = jax.jit(lambda v: jmod.apply(v, *args_j, train=True,
                                             mutable=["batch_stats"]))(variables)
    got = pmod.train()(*args_p)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(layout(g.detach().numpy()), np.asarray(w), atol=ATOL)
    stats = label_variables_to_jax(pmod.state_dict(), pmod)["batch_stats"]
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(stats)[0],
                            jax.tree.leaves(upd["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, err_msg=str(path))
    return variables


def _x(b=3, c=8, t=20, seed=0):
    x = np.random.RandomState(seed).randn(b, t, c).astype(np.float32)
    return x, np.array([t, t - 6, 4][:b], np.int32)


def test_ecapa_encoder_matches_jax():
    kw = dict(feat_in=8, filters=(16, 16, 16, 32), kernel_sizes=(5, 3, 3, 1),
              dilations=(1, 2, 3, 1), scale=4)
    x, lens = _x()
    jenc = jt.ECAPAEncoder(jt.ECAPAEncoderConfig(**kw, dtype=jnp.float32))
    penc = pt.ECAPAEncoder(pt.ECAPAEncoderConfig(**kw, dtype=torch.float32))
    _compare(jenc, penc, (jnp.asarray(x), jnp.asarray(lens)),
             (torch.from_numpy(x.transpose(0, 2, 1).copy()), torch.from_numpy(lens)),
             layout=lambda g: g.transpose(0, 2, 1) if g.ndim == 3 else g)
    out, out_lens = penc.eval()(torch.from_numpy(x.transpose(0, 2, 1).copy()),
                                torch.from_numpy(lens))
    assert out.shape == (3, 32, 20) and out_lens.tolist() == lens.tolist()


def test_masked_se_statistics_over_the_batch():
    x, lens = _x(c=16)
    jse = jt.MaskedSEModule(4, 16, jnp.float32)
    pse = pt.MaskedSEModule(16, 4, 16, torch.float32)
    variables = _np(jse.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lens),
                             train=False))
    pse.load_state_dict(label_state_dict_from_jax(variables, pse))
    want, upd = jse.apply(variables, jnp.asarray(x), jnp.asarray(lens), train=True,
                          mutable=["batch_stats"])
    got = pse.train()(torch.from_numpy(x.transpose(0, 2, 1).copy()), torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 1), np.asarray(want),
                               atol=ATOL)
    np.testing.assert_allclose(pse.bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["mean"]), atol=ATOL)
    # padding past a row's length does not reach its gate
    x2 = x.copy()
    x2[2, 4:] = 50.0
    a = pse.eval()(torch.from_numpy(x.transpose(0, 2, 1).copy()), torch.from_numpy(lens))
    b = pse(torch.from_numpy(x2.transpose(0, 2, 1).copy()), torch.from_numpy(lens))
    np.testing.assert_allclose(a[2, :, :4].detach().numpy(), b[2, :, :4].detach().numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["xvector", "tap"])
def test_stats_pool_matches_jax(mode):
    x, lens = _x()
    want = jt.StatsPool(mode).apply({}, jnp.asarray(x), jnp.asarray(lens))
    got = pt.StatsPool(mode)(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_attentive_pool_matches_jax_and_ignores_padding():
    x, lens = _x()
    jp = jt.AttentivePool(6, jnp.float32)
    pp = pt.AttentivePool(8, 6, torch.float32)
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy())
    _compare(jp, pp, (jnp.asarray(x), jnp.asarray(lens)), (xt, torch.from_numpy(lens)))
    x2 = x.copy()
    x2[1, lens[1]:] = 99.0
    a = pp.eval()(xt, torch.from_numpy(lens))
    b = pp(torch.from_numpy(x2.transpose(0, 2, 1).copy()), torch.from_numpy(lens))
    np.testing.assert_allclose(a[1].detach().numpy(), b[1].detach().numpy(), atol=ATOL)


@pytest.mark.parametrize("pool,angular", [("xvector", False), ("tap", False),
                                          ("attention", True), ("xvector", True)])
def test_speaker_decoder_matches_jax(pool, angular):
    x, lens = _x(b=4, t=12)
    lens = np.full(4, 12, np.int32)
    kw = dict(feat_in=8, num_classes=5, emb_sizes=(6, 4), pool_mode=pool, angular=angular,
              attention_channels=6)
    jdec = jt.SpeakerDecoder(jt.SpeakerDecoderConfig(**kw, dtype=jnp.float32))
    pdec = pt.SpeakerDecoder(pt.SpeakerDecoderConfig(**kw, dtype=torch.float32))
    _compare(jdec, pdec, (jnp.asarray(x), jnp.asarray(lens)),
             (torch.from_numpy(x.transpose(0, 2, 1).copy()), torch.from_numpy(lens)))
    logits, emb = pdec.eval()(torch.from_numpy(x.transpose(0, 2, 1).copy()),
                              torch.from_numpy(lens))
    assert logits.shape == (4, 5) and emb.shape == (4, 4)
    if angular:
        assert float(logits.abs().max()) <= 1.0 + 1e-5


def _torch_angular_loss(logits, labels, scale, margin, eps=1e-7):
    """The reference's angular loss, literally."""
    logits = torch.tensor(logits)
    labels = torch.tensor(labels)
    numerator = scale * torch.cos(torch.acos(torch.clamp(
        torch.diagonal(logits.transpose(0, 1)[labels]), -1.0 + eps, 1 - eps)) + margin)
    excl = torch.cat([torch.cat((logits[i, :y], logits[i, y + 1:])).unsqueeze(0)
                      for i, y in enumerate(labels)], dim=0)
    denominator = torch.exp(numerator) + torch.sum(torch.exp(scale * excl), dim=1)
    return float(-torch.mean(numerator - torch.log(denominator)))


@pytest.mark.parametrize("which", ["ce", "ce_smooth", "angular", "angular_edge", "mse"])
def test_losses_and_grads_match_jax(which):
    rs = np.random.RandomState(1)
    logits = np.tanh(rs.randn(6, 9)).astype(np.float32)
    labels = rs.randint(0, 9, size=6).astype(np.int32)
    if which == "angular_edge":  # cosines at the clip
        logits[np.arange(6), labels] = [1.0, -1.0, 0.9999999, 1.0, 0.0, -1.0]
    fns = {"ce": (lambda l, y, m: m.cross_entropy_loss(l, y)),
           "ce_smooth": (lambda l, y, m: m.cross_entropy_loss(l, y, label_smoothing=0.1)),
           "angular": (lambda l, y, m: m.angular_softmax_loss(l, y, 20.0, 1.35)),
           "angular_edge": (lambda l, y, m: m.angular_softmax_loss(l, y, 30.0, 0.2)),
           "mse": (lambda l, y, m: m.mse_loss(l[:, 0], y * 0.5))}
    fn = fns[which]
    want, gw = jax.value_and_grad(lambda l: fn(l, jnp.asarray(labels), jl))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = fn(lt, torch.from_numpy(labels).long(), pl)
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gw), atol=1e-5)
    if which == "angular":
        assert float(got) == pytest.approx(_torch_angular_loss(logits, labels, 20.0, 1.35),
                                           abs=1e-4)
    if which == "ce":
        assert float(got) == pytest.approx(float(torch.nn.functional.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels).long())), abs=1e-6)


def test_top_k_counts_match_jax():
    rs = np.random.RandomState(2)
    logits = rs.randn(10, 7).astype(np.float32)
    labels = rs.randint(0, 7, size=10).astype(np.int32)
    c, t = pl.top_k_counts(torch.from_numpy(logits), torch.from_numpy(labels), (1, 2, 5))
    jc, jt_ = jl.top_k_counts(jnp.asarray(logits), jnp.asarray(labels), (1, 2, 5))
    assert c.tolist() == np.asarray(jc).tolist() and t.tolist() == np.asarray(jt_).tolist()
    c, t = pl.top_k_counts(torch.tensor([[0.1, 0.9, 0.0], [0.8, 0.1, 0.1], [0.2, 0.3, 0.5]]),
                           torch.tensor([1, 2, 1]), (1, 2))
    assert c.tolist() == [1, 2] and t.tolist() == [3, 3]


def test_speaker_overfit_tiny():
    """ECAPA + attentive decoder + angular loss separates two speakers."""
    from conformer_nemo_tpu_torch.api_label import SpeakerNet
    from conformer_nemo_tpu_torch.train.optim import apply_updates, make_optimizer

    torch.manual_seed(0)
    net = SpeakerNet(pt.ECAPAEncoderConfig(feat_in=8, filters=(16, 16, 16, 32),
                                           kernel_sizes=(5, 3, 3, 1), dilations=(1, 1, 1, 1),
                                           scale=4, dtype=torch.float32),
                     pt.SpeakerDecoderConfig(feat_in=32, num_classes=2, emb_sizes=(8,),
                                             pool_mode="attention", angular=True,
                                             dtype=torch.float32))
    net.decoder.reset_final(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    x = np.zeros((8, 8, 24), np.float32)
    labels = np.arange(8) % 2
    x[labels == 0, :4] = rs.rand(4, 4, 24) + 2.0
    x[labels == 1, 4:] = rs.rand(4, 4, 24) + 2.0
    x, y, lens = torch.from_numpy(x), torch.from_numpy(labels), torch.full((8,), 24)
    params = list(net.parameters())
    opt = make_optimizer("adam", lambda c: 5e-3, betas=(0.9, 0.999))
    state = opt.init(params)
    first = None
    for _ in range(30):
        net.train()
        logits, _ = net(x, lens)
        loss = pl.angular_softmax_loss(logits, y, 20.0, 0.3)
        first = float(loss) if first is None else first
        grads = torch.autograd.grad(loss, params)
        upd, state = opt.update(list(grads), state, params)
        apply_updates(params, upd)
    logits, _ = net.eval()(x, lens)
    assert float(loss) < first and bool((logits.argmax(-1) == y).all())
