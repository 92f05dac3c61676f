#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):
  env         torch/CUDA/nvcc versions, triton and yaml presence, the card
  build       compiles every CUDA kernel from conformer_nemo_tpu_torch/ops/csrc
  profile     (inside transcribe) one traced transcribe: device busy share
              and the kernels that take the device time
  transcribe  ConformerCTC.transcribe at full width (configs/conformer_ctc_bpe.yaml,
              18 layers, d_model 512, seeded random weights) over generated
              WAVs: a dense-attention bucket, a batched flash bucket and one
              whole-utterance long-form file; the launch counts prove the main
              path went through the kernel, and a second model with the flash
              path switched off must agree with it
  kernels     each kernel against its plain PyTorch version on the card, on
              the same bf16 inputs, at the shapes and lengths of the counted
              transcribe's own calls and a few edge cases, with times, the
              card's bound and a library yardstick
Then the kernels summary line, the card's name and power limit as nvidia-smi
gives them, and a last line {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package, and exits non-zero without
printing a result when CUDA is not available.
"""

import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "conformer_ctc_bpe.yaml")
TOKENIZER = os.path.join(ROOT, "tests", "fixtures", "sp_bpe_bytefallback.model")
OVERRIDES = {"model.tokenizer.model_file": TOKENIZER}
SR = 16000
SEED = 0
BATCH = 8  # transcribe's batch_size

# H100 SXM published peaks (dense bf16 tensor cores; HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# kernel vs plain version on the same bf16 unit-scale inputs: bf16 rounding
# of the output plus a different summation order
O_TOL = 2e-2
LSE_TOL = 2e-3
ARGMAX_AGREEMENT_MIN = 0.99

FLASH_SOURCE = "conformer_nemo_tpu_torch/ops/csrc/flash_attention_fwd.cu"
FLASH_REPLACES = ("conformer_nemo_tpu/ops/pallas/flash_attention.py:102 "
                  "(_make_kernel, via _flash_fwd_entry :158)")


def check(ok: bool, what) -> None:
    """Fail the run (a raise, not an assert: it must hold under -O too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _import_version(name: str):
    """The module's version if it imports here, else None."""
    try:
        return getattr(importlib.import_module(name), "__version__", "unknown")
    except ImportError:
        return None


def phase_env() -> dict:
    from conformer_nemo_tpu_torch.ops.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    info = {
        "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvcc": nvcc,
        "triton": _import_version("triton"), "yaml": _import_version("yaml"),
        "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "nvidia_smi": gpu_line(),
    }
    emit("env", **info)
    return info


def phase_build() -> None:
    from conformer_nemo_tpu_torch.ops.build import build_all

    t0 = time.perf_counter()
    report = build_all(force=True, verbose=True)
    ptxas = {src: [ln.strip() for ln in r["log"].splitlines()
                   if "registers" in ln or "spill" in ln] for src, r in report.items()}
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(report), ptxas=ptxas)


def _flash_case(name, bh, t, d1, dv, lens, band, gen, dev):
    from conformer_nemo_tpu_torch.ops import flash_attention as fa

    qs = torch.randn(bh, t, d1, generator=gen, device=dev).to(torch.bfloat16)
    ks = torch.randn(bh, t, d1, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(bh, t, dv, generator=gen, device=dev).to(torch.bfloat16)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(64.0)
    left, right = band
    o, lse = fa.flash_attention_fwd(qs, ks, v, lens, scale, left, right)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(qs, ks, v, lens, scale, left, right)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    check(math.isfinite(err_o) and err_o <= O_TOL, (name, "o", err_o))
    check(math.isfinite(err_lse) and err_lse <= LSE_TOL, (name, "lse", err_lse))
    row = {"case": name, "bh": bh, "t": t, "d1": d1, "dv": dv, "band": list(band),
           "max_abs_err_o": err_o, "max_abs_err_lse": err_lse, "tol_o": O_TOL,
           "tol_lse": LSE_TOL}
    mask = fa.visible_mask(t, lens, left, right)
    pairs = int(mask.sum().item())
    flops = 2.0 * pairs * (d1 + dv)
    # bytes the function must move: the qs rows that see a key, the ks and v
    # rows that some query sees, lens; o and lse are written in full
    q_rows, k_rows = int(mask.any(2).sum().item()), int(mask.any(1).sum().item())
    nbytes = 2 * (q_rows * d1 + k_rows * (d1 + dv)) + 4 * bh + 2 * bh * t * dv + 4 * bh * t
    bound_ops, bound_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    sdpa_mask = mask[:, None]
    q4, k4, v4 = qs[:, None], ks[:, None], v[:, None]
    row.update(
        ms=time_ms(lambda: fa.flash_attention_fwd(qs, ks, v, lens, scale, left, right), 20),
        plain_ms=time_ms(lambda: fa.flash_attention_fwd_reference(
            qs, ks, v, lens, scale, left, right), 3, warmup=1),
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=sdpa_mask, scale=scale), 5, warmup=1),
        bound_ms=max(bound_ops, bound_bytes),
        bound_by="operations" if bound_ops >= bound_bytes else "bytes",
        visible_pairs=pairs, flops=flops, bytes=nbytes)
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    emit("kernels", **row)
    return row


def encoder_frames(cfg, samples) -> list:
    """Encoder frames for each sample count under the model config `cfg`."""
    from conformer_nemo_tpu_torch.audio.features import mel_seq_len
    from conformer_nemo_tpu_torch.models.conformer import calc_sub_length

    enc = cfg.encoder
    feats = mel_seq_len(cfg.preprocessor, torch.tensor(samples, dtype=torch.int64))
    return calc_sub_length(feats, enc.subsampling, int(math.log2(enc.subsampling_factor))).tolist()


def phase_kernels(dev, cfg, flash_calls) -> list:
    """Each main-path flash call, (T, lens [BH]) as the counted transcribe
    made it, then edge cases off the main path."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d1, dv = cfg.encoder.d_head + cfg.encoder.d_model, cfg.encoder.d_head
    rows = [_flash_case(f"main_bh{len(lens)}_t{t}", len(lens), t, d1, dv, lens, (-1, -1),
                        gen, dev) for t, lens in flash_calls]
    # tiny depths, empty rows, a two-sided band
    _flash_case("tiny", 4, 200, 80, 16, [200, 100, 1, 0], (-1, -1), gen, dev)
    _flash_case("band_128_32", 8, 3001, d1, dv, [3001, 2500, 1876, 1200, 700, 64, 1, 0],
                (128, 32), gen, dev)
    return rows


def _write_inputs(tmp: str) -> dict:
    from conformer_nemo_tpu_torch.data.audio_io import write_wav

    rng = np.random.RandomState(SEED)
    groups = {
        "dense": list(np.round(rng.uniform(2.0, 15.0, 8), 2)),
        "flash_batched": [50.0] + list(np.round(rng.uniform(30.0, 50.0, 3), 2)),
        "longform": [75.0],
    }
    paths = {}
    for g, secs in groups.items():
        for i, s in enumerate(secs):
            n = int(s * SR)
            t = np.arange(n) / SR
            tones = sum(0.1 * np.sin(2 * np.pi * f * t) for f in rng.uniform(150, 3000, 3))
            wav = (0.05 * rng.randn(n) + tones).astype(np.float32)
            path = os.path.join(tmp, f"{g}_{i}.wav")
            write_wav(path, wav, SR)
            paths.setdefault(g, []).append(path)
    return paths


def profile_transcribe(model, paths) -> None:
    """One traced transcribe, apart from the timed run: how busy the device
    was and which kernels took its time (torch.profiler, CUPTI). Only
    device-side events (kernels, memcpys, memsets) count: an `aten::` op's
    device time is that of the kernels it launched, which are listed too.
    They run on one stream, so their times add up without overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.transcribe(paths, batch_size=BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: e.self_device_time_total
    busy_s = sum(dev_us(e) for e in events) / 1e6
    check(busy_s > 0, "the profiler saw no device time")
    top = sorted(events, key=dev_us, reverse=True)[:12]
    emit("profile", traced_wall_s=wall, device_busy_s=busy_s,
         device_idle_share=1.0 - busy_s / wall,
         top=[{"name": e.key[:100], "device_ms": dev_us(e) / 1e3, "calls": e.count}
              for e in top])


def phase_transcribe(model, groups, gpu: str) -> dict:
    from conformer_nemo_tpu_torch.api import ConformerCTC
    from conformer_nemo_tpu_torch.ops import flash_attention as fa

    enc = model.cfg.encoder
    n_params = sum(p.numel() for p in model.model.parameters())
    paths = [p for g in ("dense", "flash_batched", "longform") for p in groups[g]]

    timings = []
    orig = model._decode_audio_batch

    def timed(audio, lens, mode="text"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(audio, lens, mode=mode)
        torch.cuda.synchronize()
        timings.append({"rows": audio.shape[0], "samples": audio.shape[1],
                        "lens": lens.tolist(), "audio_s": float(lens.sum()) / SR,
                        "seconds": time.perf_counter() - t0})
        return out

    model.transcribe(paths, batch_size=BATCH)  # warm-up (cuDNN, allocator)
    model._decode_audio_batch = timed
    fa.reset_launch_counts()
    texts = model.transcribe(paths, batch_size=BATCH)
    launches, by_shape = fa.launches, dict(fa.launches_by_shape)
    model._decode_audio_batch = orig

    check(len(texts) == len(paths) and all(isinstance(s, str) for s in texts), texts)
    # encoder forwards with T >= flash_attention_min_t go through the kernel
    frames = encoder_frames(model.cfg, [t["samples"] for t in timings])
    flash_forwards = sum(f >= enc.flash_attention_min_t for f in frames)
    check(flash_forwards == 2 and launches == enc.n_layers * flash_forwards == 36,
          ("launches", launches, "flash forwards", flash_forwards))
    buckets = [{"rows": t["rows"], "encoder_t": f, "audio_s": t["audio_s"],
                "seconds": t["seconds"], "audio_s_per_s": t["audio_s"] / t["seconds"],
                "gpu": gpu} for t, f in zip(timings, frames)]
    # the flash calls this run made: (T, lens [BH], batch-major, per head)
    flash_calls = [(f, [n for n in encoder_frames(model.cfg, t["lens"])
                        for _ in range(enc.n_heads)])
                   for t, f in zip(timings, frames) if f >= enc.flash_attention_min_t]
    profile_transcribe(model, paths)

    lp_flash = model.transcribe(paths, batch_size=BATCH, logprobs=True)
    dense = ConformerCTC.from_config_file(
        CONFIG, overrides={**OVERRIDES, "model.encoder.use_flash_attention": False})
    dense.load_state_dict(model.state_dict())
    lp_dense = dense.transcribe(paths, batch_size=BATCH, logprobs=True)
    del dense
    torch.cuda.empty_cache()

    v1 = model.cfg.num_classes + 1
    for a, b in zip(lp_flash, lp_dense):
        check(a.shape == b.shape and a.ndim == 2 and a.shape[1] == v1, (a.shape, b.shape))
        check(np.isfinite(a).all() and np.isfinite(b).all(), "non-finite log-probs")
        check(np.abs(np.exp(a).sum(-1) - 1.0).max() < 1e-3, "log-probs do not normalise")
    agree = [(a.argmax(-1) == b.argmax(-1)) for a, b in zip(lp_flash, lp_dense)]
    agreement = float(np.concatenate(agree).mean())
    flash_files = slice(len(groups["dense"]), None)  # the files decoded with T >= 1024
    agreement_flash = float(np.concatenate(agree[flash_files]).mean())
    max_diff = max(float(np.abs(a - b).max()) for a, b in zip(lp_flash, lp_dense))
    check(agreement >= ARGMAX_AGREEMENT_MIN, ("argmax agreement", agreement))
    emit("transcribe", config="configs/conformer_ctc_bpe.yaml", n_layers=enc.n_layers,
         d_model=enc.d_model, n_heads=enc.n_heads, params=n_params, files=len(paths),
         launches=launches, launches_by_shape={str(k): n for k, n in by_shape.items()},
         buckets=buckets, flash_vs_dense_max_abs_logprob=max_diff,
         argmax_agreement=agreement, argmax_agreement_flash_files=agreement_flash,
         agreement_min=ARGMAX_AGREEMENT_MIN, sample_text=texts[0][:60])
    return by_shape, flash_calls


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from conformer_nemo_tpu_torch.api import ConformerCTC

    dev = torch.device("cuda")
    env = phase_env()
    phase_build()
    model = ConformerCTC.from_config_file(CONFIG, overrides=OVERRIDES, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        groups = _write_inputs(tmp)
        by_shape, flash_calls = phase_transcribe(model, groups, env["nvidia_smi"])
    rows = phase_kernels(dev, model.cfg, flash_calls)

    kernels = []
    for r in rows:
        kernels.append({
            "name": f"flash_attention_fwd[BH={r['bh']},T={r['t']},d1={r['d1']},dv={r['dv']}]",
            "route": "cuda", "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
            "launches": by_shape.get((r["bh"], r["t"], r["d1"], r["dv"]), 0),
            "max_abs_err": max(r["max_abs_err_o"], r["max_abs_err_lse"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    check(all(k["launches"] > 0 for k in kernels), kernels)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(env["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
