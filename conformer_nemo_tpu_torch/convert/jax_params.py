"""The JAX package's variables <-> the port's state_dict (NeMo names and layouts).

`ctc_state_dict_from_jax` and `rnnt_state_dict_from_jax` are the exact
inverses of `convert_ctc_model_state` and `convert_rnnt_model_state` in
conformer_nemo_tpu/convert/nemo_weights.py, which map a NeMo state_dict onto
the JAX package's flax tree; `ctc_variables_to_jax` and
`rnnt_variables_to_jax` are the port's own copies of those two converters
(the port's state_dict has NeMo's names), used to write `.cntpu` archives
the JAX package restores. Inputs and outputs are plain numpy arrays (the
`{"params", "batch_stats"}` tree off the device); nothing here imports JAX.
Layout rules (flax -> torch; the other direction inverts each):

  Dense kernel [in, out]          -> Linear weight [out, in]        (T)
  Conv kernel [kh, kw, in, out]   -> Conv2d weight [out, in, kh, kw]
  Dense kernel of a 1x1 Conv1d    -> Conv1d weight [out, in, 1]
  depthwise kernel [k, 1, d]      -> Conv1d weight [d, 1, k]
  LayerNorm/BatchNorm scale, bias -> weight, bias; BatchNorm stats
                                     mean, var -> running_mean, running_var
  ConvSubsampling out kernel      -> rows un-permuted: the JAX model flattens
                                     [B, T, F', C] f-major, NeMo and the port
                                     [B, C, T, F'] c-major (F' the mode's own).
  pre_encode convs and BatchNorms -> NeMo's module indices per mode
                                     (`_conv_modules`); the BatchNorms'
                                     statistics travel in batch_stats.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from conformer_nemo_tpu_torch.models.conformer import freq_out, uses_conv_subsampling
from conformer_nemo_tpu_torch.models.rnnt import forget_offset


def _np(x) -> np.ndarray:
    """A leaf (numpy, or a torch tensor on any device) as fp32 numpy of its own."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32)
    return np.array(x, dtype=np.float32)


def _tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32).copy())


def _conv_modules(mode: str, j: int) -> list:
    """[(JAX conv name, NeMo conv key, JAX BatchNorm name or None, NeMo
    BatchNorm key or None)] of repetition j of a conv mode (the JAX
    converter's mapping, conformer_nemo_tpu/convert/nemo_weights.py)."""
    if mode == "striding":
        return [(f"conv{j}", f"pre_encode.conv.{2 * j}", None, None)]
    if mode == "vggnet":
        return [(f"conv{j}a", f"pre_encode.conv.{5 * j}", None, None),
                (f"conv{j}b", f"pre_encode.conv.{5 * j + 2}", None, None)]
    if mode == "resnet":
        blk = f"pre_encode.conv.{2 * j}"
        return [(f"res{j}{t}", f"{blk}.conv{n}", f"res{j}{t}_bn", f"{blk}.batchnorm{n}")
                for t, n in (("a", 1), ("b", 2))]
    blk = f"pre_encode.conv.{j}"  # subencoder
    return [(f"se{j}{t}", f"{blk}.conv{n}", f"se{j}{t}_bn", f"{blk}.batchnorm{n}")
            for t, n in (("a", 1), ("b", 2), ("c", 3))]


def _out_perm(cfg) -> np.ndarray:
    """Row r of the JAX pre_encode.out kernel (f-major, f*C + c) is row
    perm[r] of NeMo's (c-major, c*F' + f), F' the mode's own frequency size."""
    channels = cfg.subsampling_conv_channels if cfg.subsampling_conv_channels > 0 else cfg.d_model
    f_out = freq_out(cfg)
    r = np.arange(channels * f_out)
    return (r % channels) * f_out + (r // channels)


def _pre_encode_state(pe: dict, pe_stats: dict, cfg, prefix: str) -> dict:
    """The JAX pre_encode subtree (and its batch_stats, possibly empty) ->
    NeMo-named entries, in every subsampling mode."""
    sd: dict[str, np.ndarray] = {}
    if cfg.subsampling == "stacking" and cfg.subsampling_factor > 1:
        sd[prefix + "pre_encode.proj_out.weight"] = _np(pe["proj_out"]["kernel"]).T
        sd[prefix + "pre_encode.proj_out.bias"] = _np(pe["proj_out"]["bias"])
        return sd
    if not uses_conv_subsampling(cfg):
        sd[prefix + "pre_encode.weight"] = _np(pe["kernel"]).T
        sd[prefix + "pre_encode.bias"] = _np(pe["bias"])
        return sd
    for j in range(int(math.log2(cfg.subsampling_factor))):
        for conv, key, bn, bn_key in _conv_modules(cfg.subsampling, j):
            sd[prefix + key + ".weight"] = _np(pe[conv]["kernel"]).transpose(3, 2, 0, 1)
            sd[prefix + key + ".bias"] = _np(pe[conv]["bias"])
            if bn is not None:
                sd[prefix + bn_key + ".weight"] = _np(pe[bn]["scale"])
                sd[prefix + bn_key + ".bias"] = _np(pe[bn]["bias"])
                if bn in pe_stats:
                    sd[prefix + bn_key + ".running_mean"] = _np(pe_stats[bn]["mean"])
                    sd[prefix + bn_key + ".running_var"] = _np(pe_stats[bn]["var"])
    kernel = _np(pe["out"]["kernel"])  # rows f*C + c
    w_t = np.empty_like(kernel)
    w_t[_out_perm(cfg)] = kernel
    sd[prefix + "pre_encode.out.weight"] = w_t.T
    sd[prefix + "pre_encode.out.bias"] = _np(pe["out"]["bias"])
    return sd


def _pre_encode_variables(sd: dict, cfg, prefix: str) -> tuple:
    """NeMo-named pre_encode entries -> (the JAX pre_encode subtree, its
    batch_stats subtree, empty where the mode has no BatchNorm)."""
    g = lambda k: sd[prefix + k]
    if cfg.subsampling == "stacking" and cfg.subsampling_factor > 1:
        return {"proj_out": _dense(sd, prefix + "pre_encode.proj_out")}, {}
    if not uses_conv_subsampling(cfg):
        return _dense(sd, prefix + "pre_encode"), {}
    pe, stats = {}, {}
    for j in range(int(math.log2(cfg.subsampling_factor))):
        for conv, key, bn, bn_key in _conv_modules(cfg.subsampling, j):
            w = _np(g(key + ".weight"))  # [out, in, kh, kw] -> [kh, kw, in, out]
            pe[conv] = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                        "bias": _np(g(key + ".bias"))}
            if bn is not None:
                pe[bn] = _scale_bias(sd, prefix + bn_key)
                stats[bn] = {"mean": _np(g(bn_key + ".running_mean")),
                             "var": _np(g(bn_key + ".running_var"))}
    w = np.ascontiguousarray(_np(g("pre_encode.out.weight")).T)  # rows c*F' + f
    pe["out"] = {"kernel": np.ascontiguousarray(w[_out_perm(cfg)]),
                 "bias": _np(g("pre_encode.out.bias"))}
    return pe, stats


def _encoder_state(p: dict, stats: dict, cfg, prefix: str) -> dict:
    """BatchNorm statistics absent from `stats` (a params-only archive) are
    left out, so the model keeps its construction values."""
    sd: dict[str, np.ndarray] = {}

    def dense(key: str, node: dict):
        sd[key + ".weight"] = _np(node["kernel"]).T
        if "bias" in node:
            sd[key + ".bias"] = _np(node["bias"])

    def conv1x1(key: str, node: dict):
        sd[key + ".weight"] = _np(node["kernel"]).T[:, :, None]
        sd[key + ".bias"] = _np(node["bias"])

    def norm(key: str, node: dict):
        sd[key + ".weight"] = _np(node["scale"])
        sd[key + ".bias"] = _np(node["bias"])

    sd.update(_pre_encode_state(p["pre_encode"], stats.get("pre_encode", {}), cfg, prefix))

    shared = not cfg.untie_biases and cfg.self_attention_model == "rel_pos"
    if shared:
        sd[prefix + "pos_bias_u"] = _np(p["pos_bias_u"])
        sd[prefix + "pos_bias_v"] = _np(p["pos_bias_v"])

    for i in range(cfg.n_layers):
        lp = prefix + f"layers.{i}."
        layer = p[f"layers_{i}"]
        for name in ("norm_feed_forward1", "norm_self_att", "norm_conv",
                     "norm_feed_forward2", "norm_out"):
            norm(lp + name, layer[name])
        for ff in ("feed_forward1", "feed_forward2"):
            dense(lp + ff + ".linear1", layer[ff]["linear1"])
            dense(lp + ff + ".linear2", layer[ff]["linear2"])
        attn = layer["self_attn"]
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            dense(lp + "self_attn." + name, attn[name])
        if cfg.self_attention_model == "rel_pos":
            sd[lp + "self_attn.linear_pos.weight"] = _np(attn["linear_pos_kernel"]).T
            src = p if shared else attn
            sd[lp + "self_attn.pos_bias_u"] = _np(src["pos_bias_u"])
            sd[lp + "self_attn.pos_bias_v"] = _np(src["pos_bias_v"])
        conv = layer["conv"]
        conv1x1(lp + "conv.pointwise_conv1", conv["pointwise_conv1"])
        conv1x1(lp + "conv.pointwise_conv2", conv["pointwise_conv2"])
        sd[lp + "conv.depthwise_conv.weight"] = _np(conv["depthwise_kernel"]).transpose(2, 1, 0)
        sd[lp + "conv.depthwise_conv.bias"] = _np(conv["depthwise_bias"])
        norm(lp + "conv.batch_norm", conv["norm"])
        if cfg.conv_norm_type == "batch_norm" and f"layers_{i}" in stats:
            st = stats[f"layers_{i}"]["conv"]["norm"]
            sd[lp + "conv.batch_norm.running_mean"] = _np(st["mean"])
            sd[lp + "conv.batch_norm.running_var"] = _np(st["var"])
    if cfg.feat_out > 0 and cfg.feat_out != cfg.d_model:
        dense(prefix + "out_proj", p["out_proj"])
    return sd


def ctc_state_dict_from_jax(variables: dict, cfg) -> dict[str, torch.Tensor]:
    """JAX `{"params", "batch_stats"}` (numpy leaves) -> the port's CTCModel
    state_dict. `cfg`: the port's (or the JAX package's) CTCModelConfig."""
    params = variables["params"]
    stats = (variables.get("batch_stats") or {}).get("encoder", {})
    sd = _encoder_state(params["encoder"], stats, cfg.encoder, "encoder.")
    head = params["decoder"]["decoder_layers"]
    sd["decoder.decoder_layers.0.weight"] = _np(head["kernel"]).T[:, :, None]
    sd["decoder.decoder_layers.0.bias"] = _np(head["bias"])
    return {k: _tensor(v) for k, v in sd.items()}


def rnnt_state_dict_from_jax(variables: dict, cfg) -> dict[str, torch.Tensor]:
    """JAX `{"params", "batch_stats"}` (numpy leaves) -> the port's RNNTModel
    state_dict; the exact inverse of `convert_rnnt_model_state`. `cfg`: the
    port's (or the JAX package's) RNNTModelConfig.

    The JAX LSTM keeps one fused bias b and adds forget_gate_bias at run
    time; NeMo's state_dict (and so the port's) keeps bias_ih + bias_hh
    with the constant in bias_ih's forget chunk. The split is not unique:
    this puts b plus the constant in bias_ih and zeros in bias_hh, which is
    how the port writes its one trained bias."""
    params = variables["params"]
    stats = (variables.get("batch_stats") or {}).get("encoder", {})
    sd = _encoder_state(params["encoder"], stats, cfg.encoder, "encoder.")
    dec, dcfg = params["decoder"], cfg.decoder
    h = dcfg.pred_hidden
    pre = "decoder.prediction."
    sd[pre + "embed.weight"] = _np(dec["embed"]["embedding"])
    for k in range(dcfg.pred_rnn_layers):
        lstm = pre + "dec_rnn.lstm."
        sd[lstm + f"weight_ih_l{k}"] = _np(dec[f"lstm{k}_wx"]).T
        sd[lstm + f"weight_hh_l{k}"] = _np(dec[f"lstm{k}_wh"]).T
        b = _np(dec[f"lstm{k}_b"]).copy()
        if forget_offset(dcfg):
            b[h: 2 * h] += forget_offset(dcfg)
        sd[lstm + f"bias_ih_l{k}"] = b
        sd[lstm + f"bias_hh_l{k}"] = np.zeros_like(b)
        if dcfg.norm == "layer":
            for name in ("ln_i", "ln_h", "ln_c"):
                sd[lstm + f"{name}_l{k}.weight"] = _np(dec[f"lstm{k}_{name}_scale"])
                sd[lstm + f"{name}_l{k}.bias"] = _np(dec[f"lstm{k}_{name}_bias"])
    joint = params["joint"]
    for name in ("enc", "pred"):
        sd[f"joint.{name}.weight"] = _np(joint[name]["kernel"]).T
        sd[f"joint.{name}.bias"] = _np(joint[name]["bias"])
    sd["joint.joint_net.2.weight"] = _np(joint["out_kernel"]).T
    sd["joint.joint_net.2.bias"] = _np(joint["out_bias"])
    return {k: _tensor(v) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# The port's state_dict -> the JAX package's variables
# ---------------------------------------------------------------------------


def _dense(sd: dict, key: str) -> dict:
    out = {"kernel": np.ascontiguousarray(_np(sd[key + ".weight"]).T)}
    if key + ".bias" in sd:
        out["bias"] = _np(sd[key + ".bias"])
    return out


def _scale_bias(sd: dict, key: str) -> dict:
    return {"scale": _np(sd[key + ".weight"]), "bias": _np(sd[key + ".bias"])}


def _conv1x1(sd: dict, key: str) -> dict:
    return {"kernel": np.ascontiguousarray(_np(sd[key + ".weight"])[:, :, 0].T),
            "bias": _np(sd[key + ".bias"])}


def _encoder_variables(sd: dict, cfg, prefix: str = "encoder.") -> tuple:
    """-> (params, batch_stats) of the JAX ConformerEncoder
    (`convert_conformer_encoder`), in every subsampling mode."""
    g = lambda k: sd[prefix + k]
    pe, pe_stats = _pre_encode_variables(sd, cfg, prefix)
    p = {"pre_encode": pe}
    stats = {"pre_encode": pe_stats} if pe_stats else {}
    if not cfg.untie_biases and cfg.self_attention_model == "rel_pos":
        p["pos_bias_u"] = _np(g("layers.0.self_attn.pos_bias_u"))
        p["pos_bias_v"] = _np(g("layers.0.self_attn.pos_bias_v"))
    for i in range(cfg.n_layers):
        lp = prefix + f"layers.{i}."
        layer = {name: _scale_bias(sd, lp + name)
                 for name in ("norm_feed_forward1", "norm_self_att", "norm_conv",
                              "norm_feed_forward2", "norm_out")}
        for ff in ("feed_forward1", "feed_forward2"):
            layer[ff] = {"linear1": _dense(sd, lp + ff + ".linear1"),
                         "linear2": _dense(sd, lp + ff + ".linear2")}
        attn = {name: _dense(sd, lp + "self_attn." + name)
                for name in ("linear_q", "linear_k", "linear_v", "linear_out")}
        if cfg.self_attention_model == "rel_pos":
            attn["linear_pos_kernel"] = np.ascontiguousarray(
                _np(sd[lp + "self_attn.linear_pos.weight"]).T)
            if cfg.untie_biases:
                attn["pos_bias_u"] = _np(sd[lp + "self_attn.pos_bias_u"])
                attn["pos_bias_v"] = _np(sd[lp + "self_attn.pos_bias_v"])
        layer["self_attn"] = attn
        dw = _np(sd[lp + "conv.depthwise_conv.weight"])  # [d, 1, k] -> [k, 1, d]
        layer["conv"] = {
            "pointwise_conv1": _conv1x1(sd, lp + "conv.pointwise_conv1"),
            "pointwise_conv2": _conv1x1(sd, lp + "conv.pointwise_conv2"),
            "depthwise_kernel": np.ascontiguousarray(dw.transpose(2, 1, 0)),
            "depthwise_bias": _np(sd[lp + "conv.depthwise_conv.bias"]),
            "norm": _scale_bias(sd, lp + "conv.batch_norm"),
        }
        if cfg.conv_norm_type == "batch_norm":
            stats[f"layers_{i}"] = {"conv": {"norm": {
                "mean": _np(sd[lp + "conv.batch_norm.running_mean"]),
                "var": _np(sd[lp + "conv.batch_norm.running_var"])}}}
        p[f"layers_{i}"] = layer
    if cfg.feat_out > 0 and cfg.feat_out != cfg.d_model:
        p["out_proj"] = _dense(sd, prefix + "out_proj")
    return p, stats


def _with_stats(params: dict, enc_stats: dict) -> dict:
    out = {"params": params}
    if enc_stats:
        out["batch_stats"] = {"encoder": enc_stats}
    return out


def ctc_variables_to_jax(state_dict: dict, cfg) -> dict:
    """The port's CTCModel state_dict -> the JAX CTCModel's `{"params",
    "batch_stats"}` (numpy), as `convert_ctc_model_state` maps NeMo's.
    `cfg`: the port's (or the JAX package's) CTCModelConfig."""
    enc_p, enc_s = _encoder_variables(state_dict, cfg.encoder)
    return _with_stats({"encoder": enc_p,
                        "decoder": {"decoder_layers": _conv1x1(state_dict,
                                                               "decoder.decoder_layers.0")}},
                       enc_s)


def rnnt_variables_to_jax(state_dict: dict, cfg) -> dict:
    """The port's RNNTModel state_dict -> the JAX RNNTModel's `{"params",
    "batch_stats"}` (numpy), as `convert_rnnt_model_state` maps NeMo's.
    `cfg`: the port's (or the JAX package's) RNNTModelConfig.

    The LSTM bias is bias_ih + bias_hh less forget_gate_bias in the forget
    chunk (the JAX cell adds it at run time), in fp32 as the JAX converter
    computes it. Written back, b - c + c is b exactly while b lies in
    [c/2, 2c] (Sterbenz); elsewhere it may differ from b by an ulp."""
    sd = state_dict
    enc_p, enc_s = _encoder_variables(sd, cfg.encoder)
    dcfg = cfg.decoder
    h = dcfg.pred_hidden
    pre = "decoder.prediction."
    dec = {"embed": {"embedding": _np(sd[pre + "embed.weight"])}}
    lstm = pre + "dec_rnn.lstm."
    for k in range(dcfg.pred_rnn_layers):
        dec[f"lstm{k}_wx"] = np.ascontiguousarray(_np(sd[lstm + f"weight_ih_l{k}"]).T)
        dec[f"lstm{k}_wh"] = np.ascontiguousarray(_np(sd[lstm + f"weight_hh_l{k}"]).T)
        b = _np(sd[lstm + f"bias_ih_l{k}"]) + _np(sd[lstm + f"bias_hh_l{k}"])
        if forget_offset(dcfg):
            b[h: 2 * h] -= forget_offset(dcfg)
        dec[f"lstm{k}_b"] = b
        if dcfg.norm == "layer":
            for name in ("ln_i", "ln_h", "ln_c"):
                dec[f"lstm{k}_{name}_scale"] = _np(sd[lstm + f"{name}_l{k}.weight"])
                dec[f"lstm{k}_{name}_bias"] = _np(sd[lstm + f"{name}_l{k}.bias"])
    joint = {"enc": _dense(sd, "joint.enc"), "pred": _dense(sd, "joint.pred"),
             "out_kernel": np.ascontiguousarray(_np(sd["joint.joint_net.2.weight"]).T),
             "out_bias": _np(sd["joint.joint_net.2.bias"])}
    return _with_stats({"encoder": enc_p, "decoder": dec, "joint": joint}, enc_s)


# ---------------------------------------------------------------------------
# Mirrored trees: modules whose submodules carry the flax names (the SSL
# decoder and loss head, the label models). Each leaf maps by its module's
# type: Linear (kernel [in, out] <-> weight [out, in]), Conv1d (kernel
# [k, in/groups, out] <-> weight [out, in/groups, k]), the port's BatchNorm
# (scale, bias; batch_stats mean, var), LayerNorm and GroupNorm (scale,
# bias); any other parameter keeps its name and layout.
# ---------------------------------------------------------------------------


def _mirror_leaves(module, prefix: str = "") -> dict:
    """-> {state_dict key: (collection, flax path, layout function)}; every
    layout function is its own inverse."""
    from torch import nn

    from conformer_nemo_tpu_torch.models.conformer import BatchNorm

    same = lambda x: x
    out = {}
    for name, mod in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        key = prefix + (name + "." if name else "")
        if isinstance(mod, nn.Linear):
            rules = {"weight": ("params", "kernel", lambda x: x.T), "bias": ("params", "bias", same)}
        elif isinstance(mod, nn.Conv1d):
            rules = {"weight": ("params", "kernel", lambda x: x.transpose(2, 1, 0)),
                     "bias": ("params", "bias", same)}
        elif isinstance(mod, BatchNorm):
            rules = {"weight": ("params", "scale", same), "bias": ("params", "bias", same),
                     "running_mean": ("batch_stats", "mean", same),
                     "running_var": ("batch_stats", "var", same)}
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            rules = {"weight": ("params", "scale", same), "bias": ("params", "bias", same)}
        else:
            rules = {}
        owned = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for leaf, tensor in owned:
            if tensor is None or leaf in getattr(mod, "_non_persistent_buffers_set", ()):
                continue
            coll, flax_name, fn = rules.get(leaf, ("params", leaf, same))
            out[key + leaf] = (coll, path + (flax_name,), fn)
    return out


def _nested_get(tree: dict, path: tuple):
    for p in path:
        tree = tree[p]
    return tree


def _nested_set(tree: dict, path: tuple, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def mirrored_to_jax(state_dict: dict, module, prefix: str = "") -> dict:
    """The `prefix`-ed leaves of a mirrored module's state_dict -> the flax
    {"params", "batch_stats"} subtrees (numpy)."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, (coll, path, fn) in _mirror_leaves(module, prefix).items():
        _nested_set(out[coll], path, np.ascontiguousarray(fn(_np(state_dict[key]))))
    return out


def mirrored_from_jax(variables: dict, module, prefix: str = "") -> dict:
    """The flax {"params", "batch_stats"} subtrees of a mirrored module ->
    its state_dict entries (numpy), keys `prefix`-ed."""
    return {key: fn(_np(_nested_get(variables[coll], path)))
            for key, (coll, path, fn) in _mirror_leaves(module, prefix).items()}


def _ssl_heads(dec_cfg, loss_cfg) -> tuple:
    """The decoder and loss modules of these configs, on the meta device
    (only their structure is read)."""
    from conformer_nemo_tpu_torch.models.ssl import ReconstructionDecoder
    from conformer_nemo_tpu_torch.ops.contrastive_loss import ContrastiveLoss

    with torch.device("meta"):
        return ReconstructionDecoder(dec_cfg), ContrastiveLoss(loss_cfg)


def ssl_variables_to_jax(state_dict: dict, enc_cfg, dec_cfg, loss_cfg) -> dict:
    """The port's SSLNet state_dict (api_ssl.py) -> the JAX `_SSLNet`'s
    {"params", "batch_stats"} (numpy): the encoder by the CTC bridge's
    rules, `decoder_ssl` and `loss` (target_proj or quantizer) mirrored."""
    enc_p, enc_s = _encoder_variables(state_dict, enc_cfg)
    dec, loss = _ssl_heads(dec_cfg, loss_cfg)
    d = mirrored_to_jax(state_dict, dec, "decoder_ssl.")
    lo = mirrored_to_jax(state_dict, loss, "loss.")
    out = {"params": {"encoder": enc_p, "decoder_ssl": d["params"], "loss": lo["params"]},
           "batch_stats": {}}
    if enc_s:
        out["batch_stats"]["encoder"] = enc_s
    if d["batch_stats"]:
        out["batch_stats"]["decoder_ssl"] = d["batch_stats"]
    return out


def ssl_state_dict_from_jax(variables: dict, enc_cfg, dec_cfg, loss_cfg) -> dict:
    """The JAX `_SSLNet`'s {"params", "batch_stats"} (numpy) -> the port's
    SSLNet state_dict; the exact inverse of `ssl_variables_to_jax`."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    sd = _encoder_state(params["encoder"], stats.get("encoder", {}), enc_cfg, "encoder.")
    dec, loss = _ssl_heads(dec_cfg, loss_cfg)
    sd.update(mirrored_from_jax({"params": params["decoder_ssl"],
                                 "batch_stats": stats.get("decoder_ssl", {})},
                                dec, "decoder_ssl."))
    sd.update(mirrored_from_jax({"params": params["loss"], "batch_stats": {}}, loss, "loss."))
    return {k: _tensor(v) for k, v in sd.items()}


def label_variables_to_jax(state_dict: dict, net) -> dict:
    """A label model's state_dict (api_label.py: classification, regression
    or speaker; every submodule carries the flax name) -> the JAX model's
    {"params", "batch_stats"} (numpy). `net`: the model's module, or one of
    the same architecture (its structure is read)."""
    return mirrored_to_jax(state_dict, net)


def label_state_dict_from_jax(variables: dict, net) -> dict:
    """The exact inverse of `label_variables_to_jax`."""
    return {k: _tensor(v) for k, v in mirrored_from_jax(
        {"params": variables["params"], "batch_stats": variables.get("batch_stats") or {}},
        net).items()}


# ---------------------------------------------------------------------------
# The RNN encoder and the LSTM head (models/rnn_encoder.py): the pre-encode by
# the conformer front end's rules, every other submodule mirrored (the LSTM
# leaves wx, wh, b keep the JAX names and layouts)
# ---------------------------------------------------------------------------


def _rnn_children(module):
    """(name, submodule) of every child but the pre-encode."""
    return [(n, m) for n, m in module.named_children() if n != "pre_encode"]


def _rnn_encoder_module(cfg):
    """An RNNEncoder of `cfg` on the CPU (only its structure is read; the
    front end's sizes need real tensors, which the meta device lacks)."""
    from conformer_nemo_tpu_torch.models.rnn_encoder import RNNEncoder

    with torch.device("cpu"):
        return RNNEncoder(cfg)


def rnn_encoder_state_dict_from_jax(variables: dict, cfg) -> dict:
    """The JAX `RNNEncoder`'s {"params"(, "batch_stats")} (numpy) -> the
    port's RNNEncoder state_dict."""
    from conformer_nemo_tpu_torch.models.rnn_encoder import pre_encode_config

    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    sd = _pre_encode_state(params["pre_encode"], stats.get("pre_encode", {}),
                           pre_encode_config(cfg), "")
    for name, child in _rnn_children(_rnn_encoder_module(cfg)):
        sd.update(mirrored_from_jax({"params": params[name], "batch_stats": {}}, child,
                                    name + "."))
    return {k: _tensor(v) for k, v in sd.items()}


def rnn_encoder_variables_to_jax(state_dict: dict, cfg) -> dict:
    """The exact inverse of `rnn_encoder_state_dict_from_jax`."""
    from conformer_nemo_tpu_torch.models.rnn_encoder import pre_encode_config

    pe, pe_stats = _pre_encode_variables(state_dict, pre_encode_config(cfg), "")
    out = {"params": {"pre_encode": pe}}
    for name, child in _rnn_children(_rnn_encoder_module(cfg)):
        out["params"][name] = mirrored_to_jax(state_dict, child, name + ".")["params"]
    if pe_stats:
        out["batch_stats"] = {"pre_encode": pe_stats}
    return out


def lstm_decoder_state_dict_from_jax(variables: dict, cfg) -> dict:
    """The JAX `LSTMDecoder`'s {"params"} (numpy) -> the port's state_dict."""
    from conformer_nemo_tpu_torch.models.rnn_encoder import LSTMDecoder

    with torch.device("meta"):
        head = LSTMDecoder(cfg)
    return {k: _tensor(v) for k, v in mirrored_from_jax(
        {"params": variables["params"], "batch_stats": {}}, head).items()}


def lstm_decoder_variables_to_jax(state_dict: dict, cfg) -> dict:
    """The exact inverse of `lstm_decoder_state_dict_from_jax`."""
    from conformer_nemo_tpu_torch.models.rnn_encoder import LSTMDecoder

    with torch.device("meta"):
        head = LSTMDecoder(cfg)
    return {"params": mirrored_to_jax(state_dict, head)["params"]}
