#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):
  env          torch/CUDA/nvcc versions, triton and yaml presence, the card
  build        compiles every CUDA kernel from conformer_nemo_tpu_torch/ops/csrc, and
               the host libraries (FLAC decoder, Ogg/Vorbis and Ogg/Opus shims, the
               CTC beam decoder and its KenLM readers) from
               conformer_nemo_tpu_torch/data/csrc
  transcribe   ConformerCTC.transcribe at full width (configs/conformer_ctc_bpe.yaml,
               18 layers, d_model 512, seeded random weights) over generated
               WAVs: a dense-attention bucket, a batched flash bucket and one
               whole-utterance long-form file; the launch counts prove the main
               path went through the kernel, and a second model with the flash
               path switched off must agree with it (profile: one traced
               transcribe, device busy share and the kernels that take its time)
  decode_ctc   on the same model: beamsearch_ngram through change_decoding_strategy
               (beam 16, alpha 1.0, beta 1.5, a 3-gram ARPA the phase writes) over
               the short bucket and one 30-50 s file, whose batch launches K2-fwd
               (counted); twice at once, the same texts; the same texts from the
               port's decoder on transcribe(logprobs=True)'s arrays, run beside the
               two calls; word timestamps
               (non-decreasing, within the audio, joined = the greedy transcript)
  train        ConformerCTC.fit at full width on configs/conformer_ctc_bpe_longform.yaml
               (batch 8, remat, flash) over 16 generated 45-75 s WAVs, 3 steps
               with validation; per step the launch counts of all six kernels,
               finite loss and gradient norm, changed parameters and BatchNorm
               statistics, the step time and audio-seconds trained per second;
               then transcribe of a training file (profile_train: one traced
               train step)
  bpe_step     one fit step of configs/conformer_ctc_bpe.yaml (batch 16, 10-16 s
               clips): K1 launches and no K2 launch, since dropout_att is 0.1
  train_parity the same weights and batch, dropout, SpecAugment and dither off:
               one step through the flash and K1 kernels against one through
               the dense attention and the plain CTC recursion (loss, gradient
               cosine, largest per-tensor relative error)
  widths       K2 at every head width and dtype the JAX package runs, at full
               width, over 12 generated 60 s files (encoder T 1501): Conformer-CTC
               Small (configs/conformer_ctc_bpe.yaml at d_model 176, 4 heads, 16
               layers: d1 220 and dv 44, padded to 224 and 48 on the card)
               transcribes one file through flash ("auto") against a flash-off
               copy (argmax agreement) and fits SMALL_STEPS steps with flash forced
               (one batch of 16 rows, 12 live); the XLarge widths (d_model 1024, 8 heads, 4x
               feed-forward, conv kernel 31: d1 1152, dv 128; its 24 layers cut
               to WIDE_LAYERS) take a flash step against a dense one at the
               initial weights (loss within WIDE_LOSS_REL, gradient cosine >=
               WIDE_GRAD_COSINE), transcribe a file against the dense copy and
               fit WIDE_STEPS steps at batch 4; the long-form Large model in fp16
               and in fp32 (dtype= through the API, cut to DTYPE_LAYERS) the
               same comparisons on the train phase's batch and one fit step;
               every step's K2 launches counted under the dtype's kernel names
               (K2-fwd-f16, K2-bwd-dq-f32, ...), by shape at the model's widths
  rnnt_train   ConformerTransducer.fit at full width on configs/conformer_transducer_bpe.yaml
               (its depth cut to RNNT_LAYERS, as every transducer run's here)
               with the flash joint (joint_impl flash, one bucket) over 16 generated
               10-16 s WAVs, 3 steps; per step one launch each of K4-fwd, K3-alpha,
               K3-beta and K4-bwd-reduce, one K4-bwd and one K4-bwd-dw per window
               of lattice cells, and none of K1/K2, finite loss
               and gradient norm, changed parameters, step time and audio-s/s; then
               a timed greedy transcribe of one file (profile_rnnt: one traced
               train step); then save_portable and restore_portable of that model
               (the same bits but the LSTM forget chunk, held to one ulp; the same
               greedy texts), timed
  decode_rnnt  that archive through scripts/evaluate.main once per strategy
               (greedy_batch, beam, tsd, alsd, maes, beam_batch; the JAX script's
               options) on the phase's shortest file, each evaluate's texts
               equal to a second call's; alsd with the config's own beam block; the
               card's encoder output in fp32 decoded on the card and on the CPU
               with the same fp32 weights (equal tokens, or best scores within
               DECODE_SCORE_ATOL: near-ties counted); word timestamps; seconds per
               file and audio-s/s per strategy; one file's default beam traced
               (profile_decode_beam: joint calls, wall and device ms per call).
               evaluate's restore of the archive reuses the phase's one restore
  rnnt_dense_step two steps with joint_impl auto, which resolves to the dense
               joint: K3 launches, no K4 launch, each step's time
  rnnt_parity  the same weights and batch, dropout, SpecAugment and dither off: one
               step through K4 + K3 against one through the dense joint and the
               plain lattice
  joints       K4 in every dtype and at the widths the JAX package runs, at full
               width (conformer_transducer_bpe.yaml at RNNT_LAYERS) on rnnt_train's
               manifest: in fp16 and fp32 (dtype= through the API) a flash-joint
               probe step against a dense one at the same weights (quiet settings;
               loss within WIDE_LOSS_REL, gradient cosine >= WIDE_GRAD_COSINE), one
               fit step (K4's launches under the dtype's names, K4-fwd-f16, ...)
               and a greedy transcribe of JOINT_SERVE_FILES files; in fp32 the
               encoder output and the first decode step's joint logits on the card
               (cuDNN's TF32 off) against the same weights on the CPU, within
               JOINT_CARD_CPU_REL, with TF32 on as a control that must fall
               outside it; bf16 at joint_hidden 1024 (probe pair, fit step) and at
               joint_hidden 600 under joint_impl auto (its threshold lowered), which
               must resolve to the flash joint (padded to 608 on the card); K4's
               launches by kernel, dtype and shape
  multilang    the data pipeline into both multilang recipes at full width: 16
               generated 10-16 s FLAC files (half en, half es) checked bit for bit
               against the int16 they were written from, the fixture FLACs' lengths,
               an MP3, Ogg/Vorbis and Ogg/Opus copy within CODEC_MIN_SNR_DB of its
               source where the card box has the codec (an absent one must raise
               naming its library), host decode rates; configs/conformer_ctc_bpe_multilang.yaml
               (both multilang configs at full width, their depth cut to
               MULTILANG_LAYERS)
               (aggregate tokenizer, V + 1 584) fits 3 steps through the pcm16
               transport, 8 loader workers, a speed + white-noise augmentor and
               the prefetch (K1 launches, no K2: T < 1024), then transcribes its
               files and the fixture FLACs; H2D bytes per batch of each transport,
               the loader's seconds per batch, the traced step fed by the prefetch
               against the synchronous copy in turns (idle shares);
               configs/conformer_transducer_bpe_multilang.yaml with the flash joint
               fits 3 steps (K3, K4 at V 584) and greedy-transcribes 1 file
  distributed  multi-GPU training on the one card: NCCL at world 1 in this process,
               the train phase's 3-step long-form fit through the distributed path
               (gradient all-reduce, synchronised BatchNorm, the global loss), its
               losses the train phase's bit for bit and its K1/K2 launches per step
               as train's; NCCL asked for two ranks on the one card (its answer
               reported); a gloo world of two ranks sharing the card (child
               processes, `--dist-worker`), full width at DIST_LAYERS layers,
               dropout, SpecAugment and dither off: CTC at dp2 (4 rows a rank) and at
               dp1 x tp2 (K2 at half the heads) and at dp1 x tp2 with the conv
               module's LayerNorm (ctc_dp1_tp2_layer_norm: each rank its half of the
               channels, the norm's statistics all-reduced; its loss within
               DIST_LN_LOSS_REL, and its control ctc_dp1_tp2_layer_norm_local, each
               rank on its own channels' statistics, outside), the transducer at dp2
               with the flash joint and its dropout on (each rank hashes its rows at
               their offset in the global batch); each against one process's first step
               on the whole global batch (loss within DIST_LOSS_REL, gradient
               cosine >= DIST_GRAD_COSINE), the ranks' losses equal and their
               tensors bit for bit where they hold the same slice; a control, CTC
               dp2 with its BatchNorm unsynchronised, must fall outside those
               limits; steady step, the gradient all-reduce's bytes and time,
               launches by shape. Every world's rendezvous store is held by this
               process on a port the system picks, bound before the ranks learn it
               (`_agent_store`, torchrun's agent store); the ranks join as clients
  lifecycle    after the other fits, a training run that survives a restart, at
               full width on the long-form config (its depth cut to LIFECYCLE_LAYERS)
               and the train phase's manifests:
               the CTC training CLI
               (speech_to_text_ctc.main) fits 2 steps with an experiment manager
               (per-step K1/K2 launch counts as in train; metrics.jsonl, step_2/,
               last); a fresh model resumes from the checkpoint, bit for bit
               (parameters, BatchNorm statistics, Adam moments and count, generator,
               step), and one more step from each on the same batch gives the same
               loss; save_portable with the tokenizer as an artifact, then
               restore_portable: the same bits, texts and log-probs (<= 1e-3);
               transcribe_speech.main serves the archive (K2-fwd launches, the same
               texts); the timings of the async save's two halves, the resume's
               restore and the archive's save and restore, and their bytes
  streaming    after lifecycle: configs/conformer_ctc_bpe_streaming.yaml at full width
               (d_model 512, band [128, 32], remat, bf16, batch 8; its 18 layers cut
               to STREAMING_LAYERS) fits 3 steps over 16 generated 60-120 s files
               (encoder T 1,500-3,000): per step K2-fwd twice a layer, dQ and dK/dV
               once, every one keyed with the band,
               and K1 once each, finite loss and gradient norm, changed parameters, the
               steady step and audio-s/s; 3 of those files through transcribe (whole
               utterances, banded K2-fwd) and through a flash-off copy (argmax agreement
               >= ARGMAX_AGREEMENT_MIN in fp32, where fp32 copies of the weights run both
               paths; in bf16 the flash path's agreement with the fp32 dense reference
               within 1 - ARGMAX_AGREEMENT_MIN of the dense path's)
               (profile_streaming: one traced step before them);
               transcribe_buffered twice at its defaults (the
               same texts, no K2 launch: T 100) and once with a 24 s buffer (T 600: banded
               K2-fwd counted), times, one traced buffered call (busy and idle share); the
               transducer's transcribe_buffered on rnnt_train's archive (1 file, twice,
               the same texts); each model cut to its first STREAMING_SERVE_LAYERS
               layers (full width) for export and .nemo loading: export of the streaming
               model (batch 2, 30 s) reloaded with load_exported: K2-fwd's count rises
               while the program runs, log-probs within EXPORT_LOGPROB_ATOL of the live
               forward, argmax equal; the transducer's encoder and decoder_joint exported
               and reloaded, greedy through them = transcribe's tokens; a .nemo of each
               model (NeMo's layout,
               the tokenizer md5-mangled; the transducer's joint with dropout, so
               joint_net.2) through scripts/convert_nemo.main and restore_portable: the
               same tensors and texts (CTC log-probs within LOGPROB_ATOL), the CTC one
               served by transcribe_speech.main; change_vocabulary of both to the 288-piece
               unigram model (the encoder bit for bit) and one step each: K1 at V+1 289,
               K3 and K4 at V 289
  frontends    after streaming, every subsampling mode and optimizer: resnet CTC
               (conformer_ctc_bpe.yaml with subsampling resnet, in memory) at full
               width, RESNET_LAYERS deep: flash against a flash-off copy as seeded (argmax >=
               ARGMAX_AGREEMENT_MIN), 3 fit steps on bpe_step's manifest (K1 once each
               a step, no K2), the transcribe phase's files (K2-fwd x36, counted by
               shape), the train state written as the JAX package's state.msgpack and
               as state.pt, two fresh models resuming one each: the next loss and
               every tensor after that step bit for bit; the subencoder transducer
               (flash joint) at RNNT_LAYERS, 3 steps (K3, K4 per window) and a greedy
               transcribe; vggnet, stacking and factor 1 at FRONTEND_LAYERS layers, 3
               steps each; per mode the steady step, audio-s/s, a traced step with the
               pre-encode's device seconds in it and their share of its busy time,
               peak memory; each of the ten optimizers 3 fit steps through K1 at
               FRONTEND_LAYERS layers, and OPT_UPDATES updates of fixed gradients on the
               card against the CPU (within OPT_UPDATE_REL)
  ssl          after frontends: scripts/ssl_pretrain.main on configs/conformer_ctc_bpe_longform.yaml
               with quantised targets at full width (d_model 512, remat, bf16; its
               18 layers cut to SSL_LAYERS) at the config's own optim.lr, 3 steps over
               32 files of 45-71 s (SSL_SPANS: the fit's 4 buckets each hold one full
               batch of 8): per step K2-fwd twice a layer, dQ and dK/dV once and no
               K1, K3 or K4; finite
               losses and weights; the written .cntpu restored bit for bit; one traced
               step (the contrastive loss's share of its device time); on the longest
               timed batch, a flash step against a dense one from the same weights,
               masks, negatives and dropout, from the CLI's initial weights (loss
               within PARITY_LOSS_REL, gradient cosine >= PARITY_GRAD_COSINE) and from
               its trained ones (finite gradients, loss within PARITY_LOSS_REL; the
               cosine reported: scores in the millions, past an fp32 softmax's
               resolution); K2 on the trained model's first and last layers' own
               inputs against the plain version in fp64, in bf16 and cast to fp32
               (ssl_trained_layer*, *_fp32: each error within CAPTURED_ERR_RATIO of
               the plain fp32 version's, or within the dtype's K2_TOLS);
               transfer_encoder_to a ConformerCTC of the config and one finite fit
               step; steady step, audio-s/s, peak memory
  labels       the label models at their default widths through their CLIs:
               speech_classification (MatchboxNet 3x1x64, 64 mel features, 3 steps at
               batch 32 x 4 s, then --predict), speaker_tasks train / verify / embed
               (ECAPA 512 x 4 + 1536, embedding 192, 3 steps at batch 32 x 3 s), the
               classification model's vad_frame_probs over a 60 s file (0.63 s
               windows every 0.01 s, batch 256) into postprocess_frame_predictions;
               logits, embeddings and frame probabilities against a CPU copy of the
               same weights (LABEL_CARD_CPU_ATOL, VAD_CARD_CPU_ATOL; cuDNN's TF32 off;
               the logits under cuDNN's TF32 as a control that must exceed
               LABEL_CARD_CPU_ATOL); steady step, rows/s, VAD audio-s/s;
               no kernel of the port runs
  diarization  speaker_tasks train of a default-width ECAPA on two synthetic voices
               (DIAR_STEPS steps at batch DIAR_BATCH x DIAR_FIXED_S); speaker_tasks
               diarize --num-speakers 2 of a DIAR_SESSION_S session of alternating
               DIAR_TURN_S turns (80 windows, one batch) on the card and with
               --device cpu (the same RTTM text), the window embeddings against a
               CPU copy (LABEL_CARD_CPU_ATOL), speaker_tasks score against the true
               RTTM (both speakers found, DER <= DIAR_DER_MAX); the transcribe
               phase's model's transcribe_with_timestamps of the session through the
               port's profile_trace (the trace names the flash kernel; K2-fwd
               counted, summary path `diarization`) into transcribe_with_speakers
               (every word a speaker, the same on a host copy of the words); MFCC at
               MFCCConfig() defaults card vs CPU (MFCC_CARD_CPU_REL); RNNEncoder at
               RNNEncoderConfig() defaults with an LSTM head on 8 x 20 s of features,
               fp32 and bf16, card vs CPU (RNN_FP32_REL, RNN_BF16_REL), the forward's
               time and one traced forward's idle share (profile_rnn_encoder)
  kernels      each kernel against its plain PyTorch version on the card, on
               the same inputs, at the shapes and lengths of the counted
               transcribe's and train step's own calls and a few edge cases,
               with times, the card's bound and a library yardstick (K3 and
               K4 at the counted transducer step's shapes and lengths, edge
               cases up to U+1 1100, K3 about its warp/block boundary, at
               B 200 and at full-width rows, each K3 row with its two-call
               bits, each sample's path and a chain bound from a clock probe
               of its dependent step, the joint at V 401, at the step's shapes
               at V 1025 (joint_v1025) and its forward alone at H 1376 (64-cell
               tiles), and CTC at U 4200,
               and the dropout mask read back bit for bit, also at a rank's row
               offset whose hash base wraps, and the joint's kernels at a row
               offset); K2 at the distributed phase's dp1 x tp2 shape (summary
               path `distributed`); the K1 and K4
               backwards also as whole functions (rows of their own in the
               summary, against the library's whole backward), run twice for
               the same bits, as K4-fwd and K2's forward, dQ and dK/dV kernels are,
               K1-fwd's alphas held against the plain recursion's, and
               K4-bwd's scratch bytes; K2-fwd at the main shapes also timed
               at both query-tile heights in turns (64, 128, 128, 64 rows),
               and at the top of its range (d1 1152, dv 128), and the dQ
               kernel alone in two passes of columns (d1 656); and K1
               and K4 at the multilang steps' shapes (V + 1 584, V 584), whose
               rows go into the summary line under the path `multilang`; K2-fwd,
               dQ and dK/dV at the streaming step's shapes, lengths and band (path
               `streaming`); K2-fwd at the resnet serve's calls, K1 at its fit's, K3
               and K4 at the subencoder fit's (path `frontends`); K2-fwd, dQ and dK/dV
               at the SSL step's (path `ssl`), and at the same shapes on exact
               scores of 1e9 and more in bf16 and fp32 (ssl_extreme,
               ssl_extreme_fp32: lse equal to the plain one bit for bit, the
               backward within the dtype's K2_TOLS); K2-fwd at the diarization
               transcript's call (path `diarization`); K2-fwd, dQ and dK/dV at the
               widths phase's fits' calls (path `widths`): Small's (d1 220, dv 44),
               XLarge's (1152, 128), and the flagship shapes in fp16 and in fp32
               (the fp32 kernels of ops/csrc/flash_attention_f32.cu; bounds at the
               fp32 FMA rate, and for the fp32 backward also its own: S and dP at
               that rate, the gradient products at 495 / 3 TFLOP/s, the larger of
               the two times); K4 at the joints phase's calls (path `joints`): fp16
               and fp32 (ops/csrc/rnnt_joint_f32.cu, TF32 off) at the transducer
               step's shapes, bf16 at joint widths 1024 and 600, each held to its
               dtype's limit (JOINT_TOLS) and run twice for the same bits; and K4
               in bf16 at the step's shapes at H 1376 and H 100 (edge rows)
Then the kernels summary line, the card's name and power limit as nvidia-smi
gives them, and a last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --dist-worker SPEC RANK

is one rank of the distributed phase's gloo world (or of its NCCL probe),
started by that phase.

    python3 chip_smoke.py --joint-bench DIR

runs env, build and the K4 cases alone (the transducer step's shapes at the
config's V and at V 1025) with conformer_nemo_tpu_torch imported from the
checkout at DIR, so that two versions of the joint can be timed in turns (run
each checkout's own script from its root with DIR `.`: the cases follow the
package's interface).

    python3 chip_smoke.py --flash-bench DIR

runs env, build and the K2 cases alone (forward, dQ and dK/dV in bf16, fp16
and fp32 at the train step's shapes and at the widths phase's Small and
XLarge shapes, lengths from the loader, and at the train step's shapes with
every row full) with conformer_nemo_tpu_torch
imported from the checkout at DIR; run it once with DIR a copy of the parent
commit and once with `.` to time the two versions' kernels in turns on one
card (the cases follow the package's interface).

It imports nothing of JAX or of the JAX package, and exits non-zero without
printing a result when CUDA is not available.
"""

import contextlib
import dataclasses
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "conformer_ctc_bpe.yaml")
LONGFORM = os.path.join(ROOT, "configs", "conformer_ctc_bpe_longform.yaml")
TOKENIZER = os.path.join(ROOT, "tests", "fixtures", "sp_bpe_bytefallback.model")
OVERRIDES = {"model.tokenizer.model_file": TOKENIZER}
TRAIN_OVERRIDES = {**OVERRIDES, "model.train_ds.num_buckets": 1}
SR = 16000
SEED = 0
BATCH = 8  # transcribe's batch_size
TRAIN_STEPS = 3

# H100 SXM published peaks (dense bf16 tensor cores; fp32 outside them; HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3  # fp32 products as three TF32 tensor-core products
PEAK_BYTES_PER_S = 3.35e12

# K2-fwd vs its plain version on the same bf16 unit-scale inputs: bf16
# rounding of the output plus a different summation order
O_TOL = 2e-2
LSE_TOL = 2e-3
ARGMAX_AGREEMENT_MIN = 0.99
# K2-bwd vs its plain version, max|kernel - plain| / max|plain| per output:
# the kernel rounds P and dS to bf16 before the dV, dQ and dK products
BWD_REL_TOL = 2e-2
# K2 against its plain version by dtype: (o absolute, lse absolute, the
# backward's relative error): fp16 rounds o, P and dS to 11 bits where bf16
# rounds to 8; the fp32 kernels sum in another order than the plain version,
# over up to d1 products a score and T pairs a gradient entry
K2_TOLS = {torch.bfloat16: (O_TOL, LSE_TOL, BWD_REL_TOL), torch.float16: (4e-3, 2e-3, 4e-3),
           torch.float32: (2e-5, 2e-5, 2e-5)}
# K2 on a trained SSL model's own attention inputs (scores in the millions):
# each output's error against the plain version in fp64, at most this many
# times the plain fp32 version's
CAPTURED_ERR_RATIO = 4.0
# the extreme-score K2 case: qs entries are integers times this (scores 1e9+)
EXTREME_Q_SCALE = 2.0 ** 24
EXP_F32_MAX_ARG = 88.72  # expf of more is past fp32's range
# K1 vs its plain version in fp32: nll relative (rounding accumulated over
# ~1900 log-sum-exp steps); gradient absolute (posteriors lie in [0, 1] and
# alpha + beta - ll cancels at |ll| ~ T log V, leaving ~ulp(|ll|))
NLL_REL_TOL = 1e-4
GRAD_ABS_TOL = 1e-2
# torch.nn.functional.ctc_loss's nll on the feasible rows: its own fp32 recursion
LIB_NLL_REL_TOL = 1e-3
# train_parity: flash + K1 kernels vs dense attention + plain CTC, bf16 compute
PARITY_LOSS_REL = 1e-2
PARITY_GRAD_COSINE = 0.99
# gradients zero in exact arithmetic (the key bias under softmax's shift
# invariance; the depthwise bias before training BatchNorm): their relative
# error between two summation orders is meaningless
ZERO_GRAD = ("self_attn.linear_k.bias", "conv.depthwise_conv.bias")
LIFECYCLE_STEPS = 2
# resume: the next step's loss from the restored model against the saved
# model's, relative, where the two are not bitwise equal
NEXT_LOSS_REL = 1e-4
# the restored archive's CTC log-probs against the saved model's (bf16 compute)
LOGPROB_ATOL = 1e-3


def per_step_launches(n_layers: int, remat: bool = True, suffix: str = "") -> dict:
    """A flash CTC step's launches: K2's forward once a layer, twice with
    remat (the long-form recipe), its two backward kernels once, K1's three
    kernels once; `suffix` names K2's kernels of another dtype ("-f16")."""
    return {"K2-fwd" + suffix: (2 if remat else 1) * n_layers, "K2-bwd-dq" + suffix: n_layers,
            "K2-bwd-dkv" + suffix: n_layers, "K1-fwd": 1, "K1-bwd": 1, "K1-bwd-grad": 1}


PER_STEP_LAUNCHES = per_step_launches(18)
# the lifecycle phase at full width, its depth cut (the run's time budget)
LIFECYCLE_LAYERS = 6
LIFECYCLE_OVERRIDES = {**TRAIN_OVERRIDES, "model.encoder.n_layers": LIFECYCLE_LAYERS}
RNNT_CONFIG = os.path.join(ROOT, "configs", "conformer_transducer_bpe.yaml")
# the transducer runs at full width, their depth cut (the run's time budget:
# the archive's save and three restores, the fits' model builds); K3 and K4
# run once a step whatever the depth
RNNT_LAYERS = 6
RNNT_OVERRIDES = {**TRAIN_OVERRIDES, "model.joint.joint_impl": "flash",
                  "model.encoder.n_layers": RNNT_LAYERS}
# one transducer step through the flash joint: K4-bwd is the cells and sums
# kernels once per window of lattice cells, then the reduce; no CTC or
# flash-attention kernel
RNNT_KERNELS = ("K3-alpha", "K3-beta", "K4-fwd", "K4-bwd", "K4-bwd-dw", "K4-bwd-reduce")
NOT_RNNT = ("K2-fwd", "K2-bwd-dq", "K2-bwd-dkv", "K1-fwd", "K1-bwd", "K1-bwd-grad")
# one file: greedy at max_symbols 30 on random weights is host-bound
# (13.4 s for 3 files on the card)
RNNT_TRANSCRIBE_FILES = 1
# K3 vs its plain version in fp32: the same recursion in the same order
LATTICE_REL_TOL = 1e-5
# K4 vs its plain version in bf16: max|kernel - plain| <= 2e-2 * max|plain| per output
JOINT_REL_TOL = 2e-2
# by dtype, as K2's: fp16 rounds h, the logits, dlab, dh and dx to 11 bits
# where bf16 rounds to 8; fp32 (FMA, TF32 off) sums in another order
JOINT_TOLS = {torch.bfloat16: JOINT_REL_TOL, torch.float16: 4e-3, torch.float32: 2e-5}
# the JAX joint kernel's flagship vocabulary: 1024 BPE pieces and the blank
JOINT_FLAGSHIP_V = 1025
# the joints phase: K4 in fp16 and fp32 at the shipped joint, and in bf16 at
# joint widths past the old backward's 640 (JOINT_WIDE_H) and not a multiple
# of 16 (JOINT_ODD_H, padded to 608 on the card); the fp32 serving path's
# encoder output and first-step logits, card vs CPU, within this share of
# the CPU's largest entry
JOINT_WIDE_H = 1024
JOINT_ODD_H = 600
JOINT_SERVE_FILES = 2
JOINT_CARD_CPU_REL = 1e-4
# flash against dense at the same weights and batch: dropout, SpecAugment
# and dither off
JOINTS_QUIET = {"model.encoder.dropout": 0.0, "model.encoder.dropout_att": 0.0,
                "model.encoder.dropout_emb": 0.0, "model.decoder.prednet.dropout": 0.0,
                "model.joint.jointnet.dropout": 0.0, "model.spec_augment.freq_masks": 0,
                "model.spec_augment.time_masks": 0, "model.spec_augment.specshot_ratio": 0.0,
                "model.preprocessor.dither": 0.0}

# multilang: the aggregate tokenizer over two fixture models (295 + 288
# pieces, V + 1 = 584), FLAC audio, the pcm16 transport, 8 loader workers
# and a speed + white-noise augmentor on the training loader
MULTILANG_CTC = os.path.join(ROOT, "configs", "conformer_ctc_bpe_multilang.yaml")
MULTILANG_RNNT = os.path.join(ROOT, "configs", "conformer_transducer_bpe_multilang.yaml")
LANG_MODELS = {"en": TOKENIZER, "es": os.path.join(ROOT, "tests", "fixtures", "sp_unigram.model")}
# full width, depth cut to 6 layers (the distributed phase's share of the run's time)
MULTILANG_LAYERS = 6
MULTILANG_OVERRIDES = {
    **{f"model.tokenizer.langs.{lang}.model_file": path for lang, path in LANG_MODELS.items()},
    "model.encoder.n_layers": MULTILANG_LAYERS,
    "model.train_ds.num_buckets": 1, "model.train_ds.num_workers": 8,
    "model.train_ds.transport": "pcm16",
    "model.train_ds.augmentor": {"speed": {"prob": 0.5}, "white_noise": {"prob": 1.0}}}
MULTILANG_V1 = 584
MULTILANG_FILES = 16
# a lossy round trip against its source, as tests/test_torch_codecs.py fixes it
CODEC_MIN_SNR_DB = 10.0
CODEC_LIBRARIES = {"mp3": ("libmpg123",), "ogg": ("libvorbisfile",), "opus": ("libopus", "libogg")}
FIXTURE_FLAC_SAMPLES = {"utt1.flac": 16320, "utt3.flac": 14080, "utt5.flac": 14080}
PREFETCH_TURNS = ("prefetch", "sync", "sync", "prefetch")
# decode: CTC prefix beam search with a 3-gram the phase writes, the transducer's
# strategies through scripts/evaluate.main with the JAX script's options
# beam 16: the host C++ search took 86-89 s at beam 64 on the card
CTC_BEAM = {"beam_width": 16, "alpha": 1.0, "beta": 1.5}
LM_WORDS = 18  # the 3-gram's vocabulary: the fixture tokenizer's pieces of 2+ letters
RNNT_STRATEGIES = ("greedy_batch", "beam", "tsd", "alsd", "maes", "beam_batch")
# the distributed phase's gloo worlds share the one card: full width, depth
# cut to DIST_LAYERS, dropout, SpecAugment and dither off, DIST_STEPS steps
# on one global batch split by data index
DIST_LAYERS = 4
DIST_STEPS = 3
DIST_QUIET = {"model.encoder.dropout": 0.0, "model.encoder.dropout_att": 0.0,
              "model.encoder.dropout_emb": 0.0, "model.spec_augment.freq_masks": 0,
              "model.spec_augment.time_masks": 0, "model.preprocessor.dither": 0.0,
              "model.encoder.n_layers": DIST_LAYERS}
DIST_TIMEOUT_S = 420
# a gloo variant's first step against one process's step on the whole
# global batch (bf16): the limits lie between the sound variants' readings
# (loss 2.7e-6 to 6.9e-6 relative, cosine 0.999992 and above) and those of
# the control, dp2 with its BatchNorm left unsynchronised (each rank
# normalising by its own rows' statistics: 1.17e-4, 0.99939), at about the
# geometric mean of each pair; the control must fall outside them, or the
# check could not tell the two apart
DIST_LOSS_REL = 3e-5
# the LayerNorm variant's loss limit: in this bf16 model the norm's fp32
# statistics alone move the loss by 2e-5 to 4e-5 (a one-process step with
# the long-form config at 4 layers, 2 rows of 18-20 s: nn.LayerNorm against
# the sum-of-squares formula, or that formula summed in two halves), and the
# card's tp2 step read 4.75e-5 against one process; its control (each rank
# normalising by its own channels' statistics) moved that step's loss by
# 1.46e-2 (cosine 0.9695): the limit sits between, and the control must fail it
DIST_LN_LOSS_REL = 2e-4
DIST_GRAD_COSINE = 0.99993
RNNT_BEAM_SIZE = 4  # the JAX script's --beam-size default
RNNT_DECODE_FILES = 1  # every strategy decodes on the host
# the card's fp32 decode against the CPU's: equal tokens, or best scores this close
DECODE_SCORE_ATOL = 1e-3
# streaming: the banded recipe at full width (d_model 512, band [128, 32],
# remat, bf16, batch 8), its depth cut to STREAMING_LAYERS (the run's time
# budget), over generated 60-120 s files (encoder T 1,500-3,000), then
# buffered decode of both families, change_vocabulary, export and .nemo
# loading
STREAMING_CONFIG = os.path.join(ROOT, "configs", "conformer_ctc_bpe_streaming.yaml")
STREAMING_LAYERS = 6
STREAMING_OVERRIDES = {**TRAIN_OVERRIDES, "model.encoder.n_layers": STREAMING_LAYERS}
STREAMING_BAND = (128, 32)
STREAMING_FILES = 16
STREAMING_TRANSCRIBE_FILES = 3
# the transducer's buffered decode: one file (1.1-1.2 audio-s/s on random
# weights at max_symbols 30)
STREAMING_RNNT_FILES = 1
# buffered decode at its defaults (encoder T 100: the dense banded path) and
# with a 24 s buffer (T 600 >= flash_attention_min_t 512: K2-fwd)
BUFFERED_DEFAULT = {"frame_len": 1.6, "total_buffer": 4.0, "batch_size": 4}
BUFFERED_FLASH = {"frame_len": 8.0, "total_buffer": 24.0, "batch_size": 4}
EXPORT_BATCH, EXPORT_SECONDS = 2, 30.0
# export and .nemo loading serve each model cut to its first 6 layers (full
# width): at full depth their saves and loads took 200 s of the run
STREAMING_SERVE_LAYERS = 3
# the exported program's log-probs against the live model's on the same card
EXPORT_LOGPROB_ATOL = 1e-3


# frontends (PR 15): every subsampling mode and optimizer on the card
FRONTEND_LAYERS = 3  # vggnet, stacking and factor 1, and the optimizers' model
# the resnet CTC model at full width, its depth cut (the run's time budget:
# two models for the flash-vs-dense check, the state.msgpack crossing's
# writes and two resumes); its front end's cost does not depend on depth
RESNET_LAYERS = 6
RESNET_OVERRIDES = {"model.encoder.subsampling": "resnet", "model.encoder.n_layers": RESNET_LAYERS}
# the subencoder transducer's greedy transcribe: random weights emit up to
# max_symbols a frame, one host sync each (5 s a file on the card)
FRONTEND_TRANSCRIBE_FILES = 1
# the host-bound transducer decodes on random weights (up to max_symbols
# symbols a frame, one host read each) take the first DECODE_CLIP_S seconds
# of their file (a whole 10-16 s file took 13-19 s a greedy transcribe),
# the buffered decode the first STREAMING_CLIP_S (two and more 4 s buffers)
DECODE_CLIP_S = 4.0
STREAMING_CLIP_S = 8.0
OPT_UPDATES = 2  # rprop's first update moves nothing (optax 0.2.6), its second does
# card vs CPU, the same fp32 update from the same parameters and gradients:
# reductions (norms, factored means, block RMS) sum in other orders and the
# card's rsqrt, pow and division round otherwise, a few ulps of each
# update entry; each update held within 1e-3 of its largest entry
OPT_UPDATE_REL = 1e-3
# ssl: the SSL CLI at full width on the long-form config with quantised
# targets, its depth cut to SSL_LAYERS (the run's time budget); a step is K2's
# forward twice a layer (remat) and its two backward kernels once, and
# nothing of K1, K3 or K4
SSL_STEPS = 3
SSL_LAYERS = 6
# the SSL manifest: 8 files in each quarter of these spans, so that each of
# the fit's 4 duration buckets (quantile boundaries) holds one full batch
SSL_SPANS = ((45.0, 50.0), (52.0, 57.0), (59.0, 64.0), (66.0, 71.0))
SSL_FILES_PER_SPAN = 8
SSL_STEP_LAUNCHES = {"K2-fwd": 2 * SSL_LAYERS, "K2-bwd-dq": SSL_LAYERS,
                     "K2-bwd-dkv": SSL_LAYERS}
NOT_SSL = ("K1-fwd", "K1-bwd", "K1-bwd-grad", "K3-alpha", "K3-beta", "K4-fwd", "K4-bwd",
           "K4-bwd-dw", "K4-bwd-reduce")
# labels: the label models' fits, and their outputs on the card
# against a CPU copy of the same weights; both fp32 (cuDNN's TF32 is off),
# their convolutions and reductions summed in other orders: logits and
# embeddings of order 1-10 within 1e-3, probabilities within 1e-4
LABEL_STEPS = 3
# fp32 with TF32 off reads 2.1e-7 to 2.7e-7 (logits) and 1.4e-6 to 1.7e-6
# (embeddings) card vs CPU; cuDNN's TF32 reads 7.4e-5 to 7.9e-5 on the
# logits (PERF.md): the limit sits between, and the TF32 control must fail it
LABEL_CARD_CPU_ATOL = 1e-5
VAD_CARD_CPU_ATOL = 1e-4
VAD_SECONDS = 60
VAD_CPU_WINDOWS = 512  # the card's first windows recomputed on the CPU
# diarization: a default-width ECAPA trained through speaker_tasks on the two
# synthetic voices of tests/test_diarization.py (f0 140 and 520 Hz, a second
# harmonic, noise), a generated session of alternating turns diarized and
# scored through the CLI
DIAR_VOICES = {"A": 140.0, "B": 520.0}
DIAR_FILES_PER_VOICE = 8
DIAR_STEPS = 40
DIAR_BATCH = 8
DIAR_FIXED_S = 0.8
DIAR_LR = 3e-3  # the JAX test's rate
DIAR_SESSION_S = 60.0  # 80 windows of 1.5 s at 0.75 s shift, one batch
DIAR_TURN_S = 5.0
DIAR_COLLAR = 0.25
# the DER bound stated in PERF.md before the phase's first run: windows split
# at their midpoints miss each of the 11 turn changes by up to a quarter
# window past the collar
DIAR_DER_MAX = 0.15
# MFCC card vs CPU, both fp32 with TF32 off: the products sum in other orders
MFCC_CARD_CPU_REL = 1e-4  # of the CPU output's largest magnitude
# the RNN encoder (RNNEncoderConfig() defaults: 4 bidirectional layers, d_model
# 512, striding x4) and an LSTM head on 8 x 20 s of features, card vs CPU as
# a share of the CPU output's largest magnitude: fp32 sums in other orders;
# bf16 rounds the gates' products (one ulp 4e-3 relative) on both sides
RNN_ROWS = 8
RNN_FRAMES = 2000  # 20 s at 10 ms a frame
RNN_CPU_ROWS = 2  # the CPU copy's rows: the first ones (rows do not mix)
RNN_FP32_REL = 1e-5
RNN_BF16_REL = 2e-2
# widths: K2 at every head width and dtype the JAX package runs.
# Conformer-CTC Small (stt_en_conformer_ctc_small: d_model 176, 4 heads, 16
# layers; d1 = 44 + 176 = 220, dv = 44, padded to 224 and 48 on the card) and
# NeMo's Conformer-CTC XLarge widths (stt_en_conformer_ctc_xlarge: d_model
# 1024, 8 heads, 4x feed-forward, conv kernel 31; d1 1152, dv 128), each as
# overrides of configs/conformer_ctc_bpe.yaml; XLarge's 24 layers cut to
# WIDE_LAYERS (the run's time budget). Training through flash needs
# dropout_att 0 (the kernel has no dropout epilogue), and 60 s files a
# max_duration past the config's 16.7 s, as the long-form recipe sets both.
# Then the long-form Large model in fp16 and fp32 (dtype= through the API),
# its 18 layers cut to DTYPE_LAYERS, on the train phase's batch (BH 64, T
# 1843: the flagship shapes).
SMALL_OVERRIDES = {**TRAIN_OVERRIDES, "model.encoder.d_model": 176, "model.encoder.n_heads": 4,
                   "model.encoder.n_layers": 16, "model.train_ds.max_duration": 70.0}
SMALL_FIT = {"model.encoder.use_flash_attention": True, "model.encoder.dropout_att": 0.0}
SMALL_STEPS = 2
WIDE_LAYERS = 6
WIDE_OVERRIDES = {**TRAIN_OVERRIDES, "model.encoder.d_model": 1024, "model.encoder.n_heads": 8,
                  "model.encoder.n_layers": WIDE_LAYERS, "model.encoder.ff_expansion_factor": 4,
                  "model.encoder.conv_kernel_size": 31, "model.encoder.dropout_att": 0.0,
                  "model.train_ds.batch_size": 4, "model.train_ds.max_duration": 70.0}
WIDE_STEPS = 3
# every file 60 s (encoder T 1501 >= flash_attention_min_t): one shape a run
WIDTHS_FILES, WIDTHS_SECONDS = 12, 60.0
DTYPE_LAYERS = 6
# flash against the dense path at the same weights and batch, dropout,
# SpecAugment and dither off: the loss within bf16 rounding, the gradients'
# cosine at least this
WIDE_LOSS_REL = 2.0 ** -8
WIDE_GRAD_COSINE = 0.999
# the quiet settings of such a comparison
QUIET = {"model.encoder.dropout": 0.0, "model.encoder.dropout_emb": 0.0,
         "model.spec_augment.freq_masks": 0, "model.spec_augment.time_masks": 0,
         "model.preprocessor.dither": 0.0}
# a CTC step of conformer_ctc_bpe.yaml: K1 once each; its dropout_att 0.1
# keeps training attention dense
CTC_STEP_LAUNCHES = {"K1-fwd": 1, "K1-bwd": 1, "K1-bwd-grad": 1, "K2-fwd": 0, "K2-bwd-dq": 0,
                     "K2-bwd-dkv": 0}


def watched(model) -> tuple:
    """Parameters and BatchNorm statistics a train step must change."""
    enc = model.model.cfg.encoder
    last = enc.n_layers - 1
    head = (("joint.joint_net.2.weight", "decoder.prediction.dec_rnn.lstm.weight_hh_l0")
            if hasattr(model.model, "joint") else ("decoder.decoder_layers.0.weight",))
    return (*head, f"encoder.layers.{last}.self_attn.linear_q.weight",
            "encoder.layers.0.conv.batch_norm.running_mean",
            f"encoder.layers.{last}.conv.batch_norm.running_var")

FLASH_FWD = ("conformer_nemo_tpu_torch/ops/csrc/flash_attention_fwd.cu",
             "conformer_nemo_tpu/ops/pallas/flash_attention.py:102 "
             "(_make_kernel, via _flash_fwd_entry :158)")
FLASH_DQ = ("conformer_nemo_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "conformer_nemo_tpu/ops/pallas/flash_attention.py:188 "
            "(_make_dq_kernel, via _flash_bwd_entry :291)")
FLASH_DKV = ("conformer_nemo_tpu_torch/ops/csrc/flash_attention_bwd.cu",
             "conformer_nemo_tpu/ops/pallas/flash_attention.py:234 "
             "(_make_dkv_kernel, via _flash_bwd_entry :291)")
FLASH_F32 = "conformer_nemo_tpu_torch/ops/csrc/flash_attention_f32.cu"
FLASH_F32_FWD = (FLASH_F32, FLASH_FWD[1])
FLASH_F32_DQ = (FLASH_F32, FLASH_DQ[1])
FLASH_F32_DKV = (FLASH_F32, FLASH_DKV[1])
CTC_FWD = ("conformer_nemo_tpu_torch/ops/csrc/ctc_loss.cu",
           "conformer_nemo_tpu/ops/pallas/ctc_kernel.py:56 (_fwd_kernel, via _run_fwd :128)")
CTC_BWD = ("conformer_nemo_tpu_torch/ops/csrc/ctc_loss.cu",
           "conformer_nemo_tpu/ops/pallas/ctc_kernel.py:80 (_bwd_kernel, via _run_bwd :147 "
           "-> :150, and _ctc_bwd :233)")
RNNT_ALPHA = ("conformer_nemo_tpu_torch/ops/csrc/rnnt_lattice.cu",
              "conformer_nemo_tpu/ops/pallas/rnnt_kernel.py:42 "
              "(_alpha_kernel, via alphas_skewed_pallas :105)")
RNNT_BETA = ("conformer_nemo_tpu_torch/ops/csrc/rnnt_lattice.cu",
             "conformer_nemo_tpu/ops/pallas/rnnt_kernel.py:68 "
             "(_beta_kernel, via betas_skewed_pallas :128)")
JOINT_FWD = ("conformer_nemo_tpu_torch/ops/csrc/rnnt_joint.cu",
             "conformer_nemo_tpu/ops/pallas/rnnt_joint_kernel.py:166 "
             "(_make_fwd_kernel, via joint_flash_fwd :326)")
JOINT_BWD = ("conformer_nemo_tpu_torch/ops/csrc/rnnt_joint.cu",
             "conformer_nemo_tpu/ops/pallas/rnnt_joint_kernel.py:191 "
             "(_make_bwd_kernel, via joint_flash_bwd :372 -> :393)")
JOINT_F32 = "conformer_nemo_tpu_torch/ops/csrc/rnnt_joint_f32.cu"


def check(ok: bool, what) -> None:
    """Fail the run (a raise, not an assert: it must hold under -O too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; `t_s` is the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, "t_s": time.perf_counter() - T0}), flush=True)


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


def kernel_device_ms(fn, kernels: dict, iters: int = 5) -> dict:
    """Device time per call of fn() of each kernel named in `kernels`
    ({label: substring of its name}), summed over its launches in a call,
    from torch.profiler over `iters` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = {}
    for label, name in kernels.items():
        us = sum(e.self_device_time_total for e in events if name in e.key)
        check(us > 0, ("the profiler saw no", name))
        out[label] = us / iters / 1e3
    return out


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate for their type and the bytes over the memory rate."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": nbytes}


def free_cuda() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# env, build
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
        # the port needs none of these: it reads and writes flax's msgpack
        # itself, and logs to TensorBoard only where a writer imports
        "msgpack": _import_version("msgpack"), "tensorboardX": _import_version("tensorboardX"),
        "tensorboard": _import_version("tensorboard"),
        "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "nvidia_smi": gpu_line(),
    }
    emit("env", **info)
    return info


def phase_build() -> None:
    from conformer_nemo_tpu_torch.ops.build import build_all, build_host_all

    t0 = time.perf_counter()
    host = build_host_all(force=True)  # the data pipeline's g++/gcc libraries: seconds
    report = build_all(force=True, verbose=True)
    ptxas = {src: [ln.strip() for ln in r["log"].splitlines()
                   if "registers" in ln or "spill" in ln] for src, r in report.items()}
    check("seconds" in host["flac_decoder"], ("the FLAC decoder did not build", host))
    check("seconds" in host["ctc_beam"], ("the CTC beam decoder did not build", host))
    check("seconds" in host["edit_distance"], ("the edit distance did not build", host))
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(report), ptxas=ptxas,
         host_libraries=host)


# ---------------------------------------------------------------------------
# kernel cases: the kernel against its plain version, times and bounds
# ---------------------------------------------------------------------------


def _flash_inputs(bh, t, d1, dv, lens, gen, dev, dtype=torch.bfloat16):
    qs = torch.randn(bh, t, d1, generator=gen, device=dev).to(dtype)
    ks = torch.randn(bh, t, d1, generator=gen, device=dev).to(dtype)
    v = torch.randn(bh, t, dv, generator=gen, device=dev).to(dtype)
    return qs, ks, v, torch.tensor(lens, dtype=torch.int32, device=dev)


def _k2_peak(dtype) -> float:
    """The card's peak rate for K2's products in `dtype`: the tensor cores
    for bf16 and fp16, fp32 FMA outside them for fp32 (the fp32 forward; the
    fp32 backward's bound is `_f32_bwd_bound`'s)."""
    return PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS


def _flash_case(name, bh, t, d1, dv, lens, band, gen, dev, compare_rows=False,
                dtype=torch.bfloat16):
    """K2-fwd against its plain version, twice for the same bits, timed;
    with compare_rows, both query-tile heights timed in turns (64, 128,
    128, 64 rows), which is what chose the library's pick; in `dtype`
    (the row's kernel named by `fa.counter`)."""
    from conformer_nemo_tpu_torch.ops import flash_attention as fa
    from conformer_nemo_tpu_torch.ops.build import load

    qs, ks, v, lens = _flash_inputs(bh, t, d1, dv, lens, gen, dev, dtype)
    scale = 1.0 / math.sqrt(64.0)
    left, right = band
    o_tol, lse_tol, _ = K2_TOLS[dtype]
    o, lse = fa.flash_attention_fwd(qs, ks, v, lens, scale, left, right)
    o2, lse2 = fa.flash_attention_fwd(qs, ks, v, lens, scale, left, right)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(qs, ks, v, lens, scale, left, right)
    torch.cuda.synchronize()
    check(torch.equal(o, o2) and torch.equal(lse, lse2), (name, "K2-fwd is not deterministic"))
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    check(math.isfinite(err_o) and err_o <= o_tol, (name, "o", err_o))
    check(math.isfinite(err_lse) and err_lse <= lse_tol, (name, "lse", err_lse))
    row = {"case": name, "kernel": fa.counter("fwd", dtype).name, "dtype": str(dtype),
           "bh": bh, "t": t, "d1": d1, "dv": dv,
           "band": list(band), "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
           "tol_o": o_tol, "tol_lse": lse_tol, "deterministic": True,
           "rows": (load("flash_attention_fwd.cu").flash_attention_fwd_rows(
               bh, t, fa.padded(d1), fa.padded(dv)) if dtype != torch.float32 else 128),
           "max_abs_err": max(err_o, err_lse)}
    if compare_rows:
        turns = {64: [], 128: []}
        for rows in (64, 128, 128, 64):
            turns[rows].append(time_ms(lambda: fa._launch_fwd(qs, ks, v, lens, scale, left,
                                                              right, rows=rows), 10))
        row["ms_by_rows"] = {str(r): ms for r, ms in turns.items()}
    mask = fa.visible_mask(t, lens, left, right)
    pairs = int(mask.sum().item())
    # bytes the function must move: the qs rows that see a key, the ks and v
    # rows that some query sees, lens; o and lse are written in full
    q_rows, k_rows = int(mask.any(2).sum().item()), int(mask.any(1).sum().item())
    isz = qs.element_size()
    nbytes = isz * (q_rows * d1 + k_rows * (d1 + dv)) + 4 * bh + isz * bh * t * dv + 4 * bh * t
    sdpa_mask = mask[:, None]
    q4, k4, v4 = qs[:, None], ks[:, None], v[:, None]
    row.update(
        ms=time_ms(lambda: fa.flash_attention_fwd(qs, ks, v, lens, scale, left, right),
                   20 if dtype != torch.float32 else 5),
        plain_ms=time_ms(lambda: fa.flash_attention_fwd_reference(
            qs, ks, v, lens, scale, left, right), 3, warmup=1),
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=sdpa_mask, scale=scale), 5, warmup=1),
        visible_pairs=pairs, **bound(2.0 * pairs * (d1 + dv), nbytes, _k2_peak(dtype)))
    row["tflops"] = row["flops"] / (row["ms"] * 1e-3) / 1e12
    emit("kernels", **row)
    return row


def _flash_bwd_inputs(bh, t, d1, dv, lens, band, gen, dev, dtype=torch.bfloat16):
    """(qs, ks, v, do, lse, delta, lens, scale, left, right) of a backward
    case, lse and delta from the forward kernel, as the main path has them."""
    from conformer_nemo_tpu_torch.ops import flash_attention as fa

    qs, ks, v, lens = _flash_inputs(bh, t, d1, dv, lens, gen, dev, dtype)
    do = torch.randn(bh, t, dv, generator=gen, device=dev).to(dtype)
    scale = 1.0 / math.sqrt(64.0)
    o, lse = fa.flash_attention_fwd(qs, ks, v, lens, scale, *band)
    delta = (do.float() * o.float()).sum(-1)
    return qs, ks, v, do, lse, delta, lens, scale, *band


def _flash_dq_wide_case(name, bh, t, d1, dv, lens, gen, dev) -> None:
    """The dQ kernel alone past one pass of 576 dQ columns (32-key tiles):
    against the plain version, twice for the same bits, zero past the
    length; untimed."""
    from conformer_nemo_tpu_torch.ops import flash_attention as fa

    args = _flash_bwd_inputs(bh, t, d1, dv, lens, (-1, -1), gen, dev)
    dq, dq2 = fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dq(*args)
    want = fa.flash_attention_bwd_reference(*args)[0]
    torch.cuda.synchronize()
    check(torch.equal(dq, dq2), (name, "dQ is not deterministic"))
    err = ((dq.float() - want.float()).abs().max() / want.float().abs().max()).item()
    check(math.isfinite(err) and err <= BWD_REL_TOL, (name, "dq", err))
    q_valid = torch.arange(t, device=dev)[None, :] < args[6][:, None]
    check(dq[~q_valid].abs().max().item() == 0.0, (name, "dq past the length"))
    emit("kernels", case=name, kernel="K2-bwd-dq", bh=bh, t=t, d1=d1, dv=dv, rel_err=err,
         tol_rel=BWD_REL_TOL, deterministic=True,
         max_d1=fa.load("flash_attention_bwd.cu").flash_attention_bwd_dq_max_d1(dv))


def _flash_bwd_case(name, bh, t, d1, dv, lens, band, gen, dev, dtype=torch.bfloat16):
    """K2 dQ and dK/dV against the plain backward -> (dq row, dkv row), in
    `dtype`."""
    from conformer_nemo_tpu_torch.ops import flash_attention as fa

    rel_tol = K2_TOLS[dtype][2]
    args = _flash_bwd_inputs(bh, t, d1, dv, lens, band, gen, dev, dtype)
    qs, ks, v, do, lse, delta, lens, scale, left, right = args
    dq, dq2 = fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dq(*args)
    dk, dvv = fa.flash_attention_bwd_dkv(*args)
    dk2, dvv2 = fa.flash_attention_bwd_dkv(*args)
    ref = fa.flash_attention_bwd_reference(*args)
    torch.cuda.synchronize()
    check(torch.equal(dq, dq2), (name, "dQ is not deterministic"))
    check(torch.equal(dk, dk2) and torch.equal(dvv, dvv2), (name, "dK/dV is not deterministic"))
    errs, abs_errs = {}, {}
    for out_name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dvv), ref):
        abs_errs[out_name] = (a.float() - b.float()).abs().max().item()
        errs[out_name] = abs_errs[out_name] / max(b.float().abs().max().item(), 1e-30)
        check(math.isfinite(errs[out_name]) and errs[out_name] <= rel_tol,
              (name, out_name, errs[out_name]))
    q_valid = torch.arange(t, device=dev)[None, :] < lens[:, None]
    check(dq[~q_valid].abs().max().item() == 0.0 if (~q_valid).any() else True,
          (name, "dq past the length"))
    mask = fa.visible_mask(t, lens, left, right) & q_valid[:, :, None]
    pairs = int(mask.sum().item())
    q_rows, k_rows = int(mask.any(2).sum().item()), int(mask.any(1).sum().item())
    # inputs each kernel must read once: the qs and dO rows of queries that
    # see a key, the ks and v rows some such query sees, lens, lse, delta
    isz = qs.element_size()
    inputs = isz * (q_rows * (d1 + dv) + k_rows * (d1 + dv)) + 4 * bh + 8 * bh * t
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_reference(*args), 2, warmup=1)
    library_ms = None
    if (lens > 0).all():  # SDPA gives NaN on a row without a visible key
        q4, k4, v4 = (x[:, None].detach().requires_grad_() for x in (qs, ks, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=fa.visible_mask(t, lens, left, right)[:, None], scale=scale)
        do4 = do[:, None]
        library_ms = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                                         retain_graph=True), 3, warmup=1)
        del out
    common = {"case": name, "dtype": str(dtype), "bh": bh, "t": t, "d1": d1, "dv": dv,
              "band": list(band), "visible_pairs": pairs, "rel_err": errs, "abs_err": abs_errs,
              "tol_rel": rel_tol, "deterministic": True,
              "plain_ms": plain_ms, "library_ms": library_ms}
    rows, peak = [], _k2_peak(dtype)
    iters = 10 if dtype != torch.float32 else 3
    for kind, kernel, fn, flops, out_bytes, err in (
            ("dq", fa.counter("dq", dtype).name, lambda: fa.flash_attention_bwd_dq(*args),
             2.0 * pairs * (2 * d1 + dv), isz * bh * t * d1, abs_errs["dq"]),
            ("dkv", fa.counter("dkv", dtype).name, lambda: fa.flash_attention_bwd_dkv(*args),
             2.0 * pairs * (2 * d1 + 2 * dv), isz * bh * t * (d1 + dv),
             max(abs_errs["dk"], abs_errs["dv"]))):
        row = {**common, "kernel": kernel, "max_abs_err": err, "ms": time_ms(fn, iters),
               **bound(flops, inputs + out_bytes, peak)}
        row["tflops"] = row["flops"] / (row["ms"] * 1e-3) / 1e12
        if dtype == torch.float32:
            row.update(_f32_bwd_bound(kind, pairs, d1, dv, inputs + out_bytes))
        emit("kernels", **row)
        rows.append(row)
    # the pair as one function: S once, dP, dQ, dK, dV
    pair_bytes = inputs + isz * bh * t * (2 * d1 + dv)
    pair = bound(2.0 * pairs * (3 * d1 + 2 * dv), pair_bytes, peak)
    if dtype == torch.float32:
        pair.update(_f32_bwd_bound("pair", pairs, d1, dv, pair_bytes))
    emit("kernels", case=name, dtype=str(dtype), kernel="K2-bwd pair",
         ms=rows[0]["ms"] + rows[1]["ms"], **pair)
    return rows


def _f32_bwd_bound(kind: str, pairs: int, d1: int, dv: int, nbytes: float) -> dict:
    """The fp32 backward's bound in its own arithmetic, which replaces the
    row's `bound_ms` and `bound_by`: S and dP, 2 * pairs * (d1 + dv) FLOPs, at
    PEAK_FP32_FLOPS on the CUDA cores, and the gradient products (dQ: 2 *
    pairs * d1; dK and dV: 2 * pairs * (d1 + dv); the pair both) at
    PEAK_3XTF32_FLOPS on the tensor cores; the two pipes work at once, so the
    larger of the two times, or of the bytes' time (`nbytes` at
    PEAK_BYTES_PER_S) where that is larger. Beside it, `bound_all_fma_ms`:
    every operation at the fp32 FMA rate, as `_k2_peak` bounds the forward.
    With the kernel's plan (flash_attention_bwd_f32_plan) for a kernel's row,
    where the library reports it."""
    from conformer_nemo_tpu_torch.ops import flash_attention as fa

    grad_cols = {"dq": d1, "dkv": d1 + dv, "pair": 2 * d1 + dv}[kind]
    fma_ms = 2.0 * pairs * (d1 + dv) / PEAK_FP32_FLOPS * 1e3
    tc_ms = 2.0 * pairs * grad_cols / PEAK_3XTF32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    out = {"bound_ms": max(fma_ms, tc_ms, bytes_ms),
           "bound_by": "operations" if max(fma_ms, tc_ms) >= bytes_ms else "bytes",
           "bound_fma_ms": fma_ms, "bound_tc_ms": tc_ms,
           "bound_all_fma_ms": 2.0 * pairs * (d1 + dv + grad_cols) / PEAK_FP32_FLOPS * 1e3}
    if kind == "pair":
        return out
    lib = fa.load("flash_attention_f32.cu")
    if hasattr(lib, "flash_attention_bwd_f32_plan"):
        import ctypes

        res, stages, passes = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        smem = lib.flash_attention_bwd_f32_plan(fa.padded(d1), fa.padded(dv), int(kind == "dkv"),
                                                ctypes.byref(res), ctypes.byref(stages),
                                                ctypes.byref(passes))
        out["plan"] = {"smem_bytes": smem, "resident": bool(res.value), "stages": stages.value,
                       "passes": passes.value}
    return out


def _flash_extreme_inputs(bh, t, d1, dv, lens, gen, dev, dtype=torch.bfloat16) -> tuple:
    """K2 inputs whose scores lie far past fp32's integer range and still come
    out exact from any order of summation: qs holds integers in [-8, 8] times
    EXTREME_Q_SCALE in its first d1 / 2 columns and 0 past them, ks integers
    in [-8, 8], keys 2i and 2i + 1 equal in those columns (each score tied
    with its pair's). Every partial sum of S is an integer below 2^15 times
    EXTREME_Q_SCALE, so the kernels and the plain version see the same
    scores (~1e9 to 1e10 after the scale), and each softmax row splits
    evenly over its top pair (or pairs): dQ, dK and dV are well defined."""
    half = d1 // 2

    def ints(*shape):
        return torch.randint(-8, 9, shape, generator=gen, device=dev).float()

    qs = torch.zeros(bh, t, d1, device=dev)
    qs[..., :half] = ints(bh, t, half) * EXTREME_Q_SCALE
    ks = ints(bh, t, d1)
    ks[:, 1::2, :half] = ks[:, 0::2, :half][:, : t // 2]
    v, do = (torch.randn(bh, t, dv, generator=gen, device=dev) for _ in range(2))
    return (*(x.to(dtype) for x in (qs, ks, v, do)),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _flash_extreme_case(name, bh, t, d1, dv, lens, gen, dev, dtype=torch.bfloat16) -> dict:
    """K2-fwd, dQ and dK/dV against their plain versions at scores of 1e9 and
    more (_flash_extreme_inputs, in `dtype`): lse equal to the plain one bit
    for bit, o and dQ, dK and dV finite and within the dtype's limits
    (K2_TOLS). Beside them, the rows where the forward's earlier lse (the
    row max kept as x * scale * log2 e, back through ln 2) would have put
    exp(x - lse) past fp32's range, as an SSL step at the long-form config's
    rate met it."""
    from conformer_nemo_tpu_torch.ops import flash_attention as fa

    o_tol, _, rel_tol = K2_TOLS[dtype]
    qs, ks, v, do, lens_t = _flash_extreme_inputs(bh, t, d1, dv, lens, gen, dev, dtype)
    scale = 1.0 / math.sqrt(64.0)
    o, lse = fa.flash_attention_fwd(qs, ks, v, lens_t, scale)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(qs, ks, v, lens_t, scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (qs, ks, v, do, lse, delta, lens_t, scale, -1, -1)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dvv = fa.flash_attention_bwd_dkv(*args)
    ref = fa.flash_attention_bwd_reference(*args)
    torch.cuda.synchronize()
    lse_equal = torch.equal(lse, lse_ref)
    err_o = (o.float() - o_ref.float()).abs().max().item()
    errs = {}
    for out_name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dvv), ref):
        check(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()),
              (name, out_name, "not finite"))
        errs[out_name] = ((a.float() - b.float()).abs().max()
                          / b.float().abs().max().clamp_min(1e-30)).item()
    # the earlier lse: m2 = fl(S * fl(scale * log2 e)) at the row max, then
    # fl(m2 * ln 2 + log 2) (the pair's tie); the backward's exponent was
    # fl(x - lse) with x the row max exactly
    s_max = lse_ref.double() / scale  # the raw row max: lse is that max exactly here
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(1.4426950408889634,
                                                                  dtype=torch.float32)
    m2 = (s_max * sl2.double()).float().double()
    lse_old = (m2 * float(torch.tensor(0.6931471805599453, dtype=torch.float32))
               + math.log(2.0)).float()
    gap = (lse_ref.double() - lse_old.double()).float()
    rows_old_overflow = int((gap > EXP_F32_MAX_ARG).sum())
    row = {"case": name, "kernel": "K2-fwd + K2-bwd", "dtype": str(dtype), "bh": bh, "t": t,
           "d1": d1, "dv": dv, "q_scale": EXTREME_Q_SCALE,
           "max_abs_lse": lse_ref.abs().max().item(), "lse_equal": lse_equal,
           "max_abs_err_o": err_o, "tol_o": o_tol, "rel_err": errs, "tol_rel": rel_tol,
           "rows": bh * t, "rows_past_exp_range_before": rows_old_overflow}
    emit("kernels", **row)
    check(lse_equal, (name, "lse differs from the plain version's"))
    check(err_o <= o_tol, (name, "o", err_o))
    for out_name, err in errs.items():
        check(err <= rel_tol, (name, out_name, err))
    # the inputs reach the fault's regime (a property of the data, not of a kernel)
    check(rows_old_overflow > 0, (name, "no row reaches past exp's range", row))
    return row


def _ctc_case(name, lp, targets, il, tl, blank, timed=True):
    """K1-fwd, K1-bwd (betas) and K1-bwd-grad (the collect) against their
    plain versions -> (fwd row, bwd row, collect row, whole backward row);
    untimed, one row of errors only and no rows returned."""
    from conformer_nemo_tpu_torch.ops import ctc_loss as ctc

    b, t, v1 = lp.shape
    u = targets.shape[1]
    g = torch.ones(b, device=lp.device)
    alphas, nll = ctc.ctc_alphas(lp, targets, il, tl, blank)
    grad = ctc.ctc_grad(lp, targets, il, tl, alphas, nll, g, blank)
    grad2 = ctc.ctc_grad(lp, targets, il, tl, alphas, nll, g, blank)
    a_ref, nll_ref = ctc.ctc_alphas_reference(lp, targets, il, tl, blank)
    b_ref, c_ref = ctc.ctc_betas_reference(lp, targets, il, tl, blank)
    # ctc_grad_reference is these two plain pieces composed
    grad_ref = ctc.ctc_collect_reference(lp, targets, il, tl, a_ref, b_ref, c_ref, nll_ref, g,
                                         blank)
    betas, chains = ctc.ctc_betas(lp, targets, il, tl, blank)
    coll = ctc.ctc_collect(lp, targets, il, tl, alphas, betas, chains, nll, g, blank)
    coll_ref = ctc.ctc_collect_reference(lp, targets, il, tl, alphas, betas, chains, nll, g, blank)
    torch.cuda.synchronize()
    feasible = nll_ref < 1e29
    check(torch.isfinite(nll).all().item() and torch.isfinite(grad).all().item(),
          (name, "non-finite"))
    check(bool((nll[~feasible] >= 1e29).all()), (name, "infeasible rows keep the sentinel"))
    check(torch.equal(grad, grad2), (name, "the backward is not deterministic"))
    check(torch.equal(chains, c_ref), (name, "label chains"))
    live = a_ref > -1e29  # the states an alignment reaches
    check(torch.equal(alphas > -1e29, live), (name, "reachable states of the alphas"))
    alpha_err = ((alphas - a_ref).abs() / a_ref.abs().clamp(min=1.0))[live].max().item()
    check(alpha_err <= NLL_REL_TOL, (name, "alphas", alpha_err))
    nll_err = ((nll - nll_ref).abs() / nll_ref.abs().clamp(min=1.0))[feasible].max().item()
    nll_abs = (nll - nll_ref).abs()[feasible].max().item()
    grad_err = (grad - grad_ref).abs().max().item()
    beta_err = ((betas - b_ref).abs() / b_ref.abs().clamp(min=1.0)).max().item()
    coll_err = (coll - coll_ref).abs().max().item()
    check(nll_err <= NLL_REL_TOL, (name, "nll", nll_err))
    check(grad_err <= GRAD_ABS_TOL, (name, "grad", grad_err))
    check(beta_err <= NLL_REL_TOL, (name, "betas", beta_err))
    check(coll_err <= GRAD_ABS_TOL, (name, "collect", coll_err))
    errors = {"case": name, "b": b, "t": t, "u": u, "v1": v1, "nll_rel_err": nll_err,
              "alphas_rel_err": alpha_err,
              "grad_abs_err": grad_err, "betas_rel_err": beta_err, "collect_abs_err": coll_err,
              "deterministic": True}
    if not timed:
        emit("kernels", kernel="K1 (untimed)", **errors)
        return []
    # library yardstick: torch.nn.functional.ctc_loss (reduction none, blank = V);
    # only its nll is compared, its gradient follows PyTorch's own convention
    lib_args = (lp.transpose(0, 1), targets.long(), il.long(), tl.long())
    lib_nll = torch.nn.functional.ctc_loss(*lib_args, blank=blank, reduction="none")
    ok = feasible & torch.isfinite(lib_nll)
    lib_err = ((lib_nll - nll_ref).abs() / nll_ref.abs().clamp(min=1.0))[ok].max().item()
    check(lib_err <= LIB_NLL_REL_TOL, (name, "library nll", lib_err))
    lp_req = lp.detach().requires_grad_()
    lib_fwd_ms = time_ms(lambda: torch.nn.functional.ctc_loss(
        *lib_args, blank=blank, reduction="none"), 5)
    lib_fb_ms = time_ms(lambda: torch.autograd.grad(torch.nn.functional.ctc_loss(
        lp_req.transpose(0, 1), *lib_args[1:], blank=blank, reduction="none").sum(),
        lp_req), 5)
    # its backward alone: autograd.grad on a retained forward graph
    lib_loss = torch.nn.functional.ctc_loss(lp_req.transpose(0, 1), *lib_args[1:], blank=blank,
                                            reduction="none").sum()
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(lib_loss, lp_req, retain_graph=True), 5)
    del lib_loss
    # bytes: each sample's log-prob entries of the classes its lattice uses,
    # every frame; alphas written (fwd), betas written (betas) or alphas and
    # betas read (collect); the gradient written
    s = 2 * u + 1
    ext = torch.full((b, s), blank, dtype=torch.int64, device=lp.device)
    ext[:, 1::2] = targets.long()
    in_lattice = torch.arange(s, device=lp.device)[None, :] < (2 * tl.long().clamp(0, u) + 1)[:, None]
    classes = sum(len(set(ext[i][in_lattice[i]].tolist())) for i in range(b))
    entries = 4 * t * classes
    lattice_ops = 20.0 * b * t * s  # a handful of fp32 flops per state and step
    common = {**errors, "serial_steps": t, "nll_abs_err": nll_abs, "tol_nll_rel": NLL_REL_TOL,
              "tol_grad_abs": GRAD_ABS_TOL, "library_nll_rel_err": lib_err,
              "library_fwd_bwd_ms": lib_fb_ms, "library_bwd_ms": lib_bwd_ms}
    rows = []
    for kernel, fn, plain, lib_ms, flops, nbytes, err in (
            ("K1-fwd", lambda: ctc.ctc_alphas(lp, targets, il, tl, blank),
             lambda: ctc.ctc_alphas_reference(lp, targets, il, tl, blank), lib_fwd_ms,
             lattice_ops, entries + 4 * b * t * s + 4 * b, nll_abs),
            # the serial half of the backward: no PyTorch call computes it alone
            ("K1-bwd", lambda: ctc.ctc_betas(lp, targets, il, tl, blank),
             lambda: ctc.ctc_betas_reference(lp, targets, il, tl, blank), None,
             lattice_ops, entries + 4 * b * t * s + 8 * b, beta_err),
            ("K1-bwd-grad", lambda: ctc.ctc_collect(lp, targets, il, tl, alphas, betas, chains,
                                                    nll, g, blank),
             lambda: ctc.ctc_collect_reference(lp, targets, il, tl, alphas, betas, chains, nll,
                                               g, blank), None,
             4.0 * b * t * s, 8 * b * t * s + 4 * b * t * v1 + 8 * b + 8 * b * u, coll_err)):
        row = {**common, "kernel": kernel, "max_abs_err": err, "ms": time_ms(fn, 10),
               "plain_ms": time_ms(plain, 1, warmup=1), "library_ms": lib_ms,
               **bound(flops, nbytes, PEAK_FP32_FLOPS)}
        if kernel != "K1-bwd-grad":
            row["us_per_step"] = row["ms"] * 1e3 / t
        emit("kernels", **row)
        rows.append(row)
    # the whole backward as one function (betas, then the collect), against
    # F.ctc_loss's backward alone
    row = {**common, "kernel": "K1-bwd-whole", "max_abs_err": grad_err,
           "ms": time_ms(lambda: ctc.ctc_grad(lp, targets, il, tl, alphas, nll, g, blank), 10),
           "plain_ms": time_ms(lambda: ctc.ctc_grad_reference(lp, targets, il, tl, alphas, nll, g,
                                                              blank), 1, warmup=0),
           "library_ms": lib_bwd_ms,
           **bound(lattice_ops, entries + 4 * b * t * s + 4 * b * t * v1 + 8 * b,
                   PEAK_FP32_FLOPS)}
    emit("kernels", **row)
    rows.append(row)
    return rows


def _chain_probe(dev) -> dict:
    """The K3 warp path's dependent step alone, per kernel (clock64 probe)."""
    from conformer_nemo_tpu_torch.ops import rnnt_lattice as lat

    return {kernel: lat.chain_probe(dev, beta=kernel == "K3-beta")
            for kernel in ("K3-alpha", "K3-beta")}


def _lattice_case(name, t, u1, t_lens, u_lens, gen, dev, chain):
    """K3-alpha and K3-beta against their plain versions, the same bits on a
    second call, each sample's path and sweep as the kernel reports them
    (`plan`), the same for both -> (alpha row, beta row). `chain`:
    `_chain_probe`'s latency of one dependent step."""
    from conformer_nemo_tpu_torch.ops import rnnt_lattice as lat

    b = len(t_lens)
    bl = torch.log(torch.rand(b, t, u1, generator=gen, device=dev) * 0.9 + 0.05)
    lb = torch.log(torch.rand(b, t, u1, generator=gen, device=dev) * 0.9 + 0.05)
    lb[:, :, -1] = -1e30
    tl = torch.tensor(t_lens, dtype=torch.int32, device=dev)
    ul = torch.tensor(u_lens, dtype=torch.int32, device=dev)
    inside = lat.valid_cells(bl.shape, tl, ul)
    cells = int(inside.sum().item())
    serial = max(min(a, t) + min(c, u1 - 1) for a, c in zip(t_lens, u_lens))  # diagonals
    rows, plans = [], []
    for kernel, fn, plain, c_name, counter in (
            ("K3-alpha", lat.rnnt_alphas, lat.rnnt_alphas_reference, "rnnt_alpha_f32",
             lat.alpha_launches),
            ("K3-beta", lat.rnnt_betas, lat.rnnt_betas_reference, "rnnt_beta_f32",
             lat.beta_launches)):
        got, again, want = fn(bl, lb, tl, ul), fn(bl, lb, tl, ul), plain(bl, lb, tl, ul)
        plan = torch.full((b, 2), -1, dtype=torch.int32, device=dev)
        lat._launch(c_name, counter, bl, lb, tl, ul, plan=plan)
        torch.cuda.synchronize()
        plans.append(plan.tolist())
        # dependent steps of the longest sweep: a strip's diagonals, strips in turn
        steps = max(n for _, n in plans[-1])
        rel = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
        abs_err = (got - want)[inside].abs().max().item()
        check(all(0 <= p < len(lat.PATHS) and n >= 0 for p, n in plans[-1]),
              (name, kernel, "plan not written", plans[-1]))
        path_names = [lat.PATHS[p] for p, _ in plans[-1]]
        check(math.isfinite(rel) and rel <= LATTICE_REL_TOL, (name, kernel, rel))
        check(bool((got[~inside] == -1e30).all()), (name, kernel, "outside the lattice"))
        check(torch.equal(got, again), (name, kernel, "not the same bits on a second call"))
        check(plans[-1] == plans[0], (name, kernel, "not the path and sweep of K3-alpha"))
        # bytes: blank_lp and label_lp read once in the lattice's cells, the
        # lattice written once in full (-1e30 outside); operations: ~10 fp32
        # flops per valid cell (two adds, the lse). The chain bound: the
        # longest sweep's dependent steps times the latency of one step (the
        # exchange with the neighbouring lane and an lse), from the probe
        ns = chain[kernel]["ns_per_step"]
        row = {"case": name, "kernel": kernel, "shape": [b, t, u1], "t_lens": t_lens,
               "u_lens": u_lens, "valid_cells": cells, "serial_steps": serial,
               "sweep_steps": steps, "paths": {p: path_names.count(p) for p in lat.PATHS},
               "bitwise_equal_two_calls": True,
               "max_abs_err": abs_err, "max_rel_err": rel, "tol_rel": LATTICE_REL_TOL,
               "ms": time_ms(lambda: fn(bl, lb, tl, ul), 20),
               "plain_ms": time_ms(lambda: plain(bl, lb, tl, ul), 1, warmup=1),
               "library_ms": None,
               **bound(10.0 * cells, 8.0 * cells + 4.0 * b * t * u1 + 8 * b,
                       PEAK_FP32_FLOPS),
               "chain_bound_ms": steps * ns * 1e-6,
               "chain_ns_per_step": ns, "chain_cycles_per_step": chain[kernel]["cycles_per_step"],
               "chain_method": "clock64/globaltimer probe: one warp, 16384 dependent steps "
                               "of the warp path (shuffle + lse per cell), no memory access"}
        row["us_per_step"] = row["ms"] * 1e3 / serial
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["share_of_chain_bound"] = row["chain_bound_ms"] / row["ms"]
        emit("kernels", **row)
        rows.append(row)
    return rows


def _joint_case(name, b, t, u, h, v, t_lens, u_lens, gen, dev, activation="relu", drop_t=26,
                fastemit=0.0, clamp=-1.0, bt=16, row_offset=0, dtype=torch.bfloat16):
    """K4-fwd and the three K4-bwd kernels in `dtype` against their plain
    versions (JOINT_TOLS), on posteriors from the K3 lattice of the kernel's
    own forward; the forward and the whole backward checked for the same
    bits on a second call, the backward timed as one function and its
    scratch measured. row_offset: the rows' first index in a global batch
    (the hash base, `joint_seed`). An H that is not a multiple of 16 runs the
    pieces on e, p and W padded as the wrappers pad them (`pad_hidden`, the
    hash at the true H)."""
    from conformer_nemo_tpu_torch.ops import rnnt_joint as jt
    from conformer_nemo_tpu_torch.ops import rnnt_lattice as lat
    from conformer_nemo_tpu_torch.ops.rnnt_loss import posteriors

    tol = JOINT_TOLS[dtype]
    suffix = jt.counter("fwd", dtype).name[len("K4-fwd"):]
    es = torch.tensor([], dtype=dtype).element_size()
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    bf = lambda *shape, scale: (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)
    e, p = bf(b, t, h, scale=0.5), bf(b, u + 1, h, scale=0.5)
    w, bias = bf(h, v, scale=h ** -0.5), bf(v, scale=0.1)
    targets = torch.randint(0, v - 1, (b, u), generator=gen, device=dev).to(torch.int32)
    tl = torch.tensor(t_lens, dtype=torch.int32, device=dev)
    ul = torch.tensor(u_lens, dtype=torch.int32, device=dev)
    seed = jt.joint_seed(20250, row_offset, t, u + 1, h, bt)
    kw = dict(t_lens=tl, u_lens=ul, blank_id=v - 1, activation=activation, drop_t=drop_t, bt=bt)
    fwd = jt.joint_flash_fwd(e, p, w, bias, targets, seed, **kw)
    fwd_ref = jt.joint_flash_fwd_reference(e, p, w, bias, targets, seed, **kw)
    fwd2 = jt.joint_flash_fwd(e, p, w, bias, targets, seed, **kw)
    blank_lp, label_lp, lse = fwd
    label_lp = label_lp.clone()
    label_lp[:, :, -1] = -1e30
    alpha = lat.rnnt_alphas(blank_lp, label_lp, tl, ul)
    beta = lat.rnnt_betas(blank_lp, label_lp, tl, ul)
    gb, gy = posteriors(alpha, beta, blank_lp, label_lp, tl, ul)
    if fastemit > 0:
        gb, gy = gb * (1 + fastemit), gy * (1 + fastemit)
    inside = lat.valid_cells(blank_lp.shape, tl, ul)
    g = torch.rand(b, generator=gen, device=dev) + 0.5
    # as RNNTLossFused passes them: K4-bwd reads the lattice's cells only
    args = (e, p, w, bias, targets, lse, (gb + gy).contiguous(), gb.contiguous(), gy.contiguous(),
            g, seed)
    bwd = jt.joint_flash_bwd(*args, clamp=clamp, **kw)
    bwd_ref = jt.joint_flash_bwd_reference(*args, clamp=clamp, **kw)
    bwd2 = jt.joint_flash_bwd(*args, clamp=clamp, **kw)
    # each backward kernel against its plain version on the same inputs (at
    # the padded H, as the wrappers call them): the first window's cells,
    # its sums into fresh accumulators, their reduce
    ep, pp, wp = jt.pad_hidden(e, p, w)
    hp = ep.shape[2]
    w_pad, w_blank = jt.pad_label_block(wp, v - 1)
    cells_in = int(inside.sum().item())
    win, n_win = jt.bwd_windows(b * t * (u + 1), h, v, dtype=dtype)
    pkw = dict(t_lens=tl, u_lens=ul, activation=activation, drop_t=drop_t, bt=bt, hash_h=h)
    cells_args = (ep, pp, w_pad, w_blank, *args[3:])
    new_acc = lambda: jt.bwd_accumulators(b, t, u + 1, hp, v, dev)
    cells = jt.joint_flash_bwd_cells(*cells_args, c0=0, win=win, clamp=clamp, **pkw)
    cells_ref = jt.joint_flash_bwd_cells_reference(*cells_args, c0=0, win=win, clamp=clamp, **pkw)
    skw = dict(t_lens=tl, u_lens=ul, win=win)
    acc = jt.joint_flash_bwd_sums(cells, new_acc(), c0=0, hash_h=h, **skw)
    acc_ref = jt.joint_flash_bwd_sums_reference(cells, new_acc(), c0=0, **skw)
    red = jt.joint_flash_bwd_reduce(acc, e.dtype, hash_h=h)
    red_ref = jt.joint_flash_bwd_reduce_reference(acc, e.dtype)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(bwd, bwd2)), (name, "K4-bwd not deterministic"))
    check(all(torch.equal(x, y) for x, y in zip(fwd, fwd2)), (name, "K4-fwd not deterministic"))
    n0 = min(win, cells_in)  # the first window's cells
    n_tiles0 = -(-n0 // jt.TILE_CELLS)
    pairs = list(zip(("blank_lp", "label_lp", "lse"), fwd, fwd_ref)) + \
        list(zip(("de", "dp", "dw", "db"), bwd, bwd_ref)) + \
        [(k, x[:n], y[:n]) for k, x, y, n in zip(
            ("cells_dlab", "cells_dblank", "cells_dx", "cells_h", "cells_db_tiles"), cells,
            cells_ref, (n0, n0, n0, n0, n_tiles0))] + \
        list(zip(("sums_de", "sums_dp", "sums_dw", "sums_dw_blank", "sums_db"), acc, acc_ref)) + \
        list(zip(("reduce_de", "reduce_dp", "reduce_dw", "reduce_db"), red, red_ref))
    errs = {}
    for out, a, r in pairs:
        if out in ("blank_lp", "label_lp", "lse"):  # outside the lattice: the sentinels
            check(torch.equal(a[~inside], r[~inside]), (name, out, "outside the lattice"))
            a, r = a[inside], r[inside]
        a, r = a.float(), r.float()
        check(bool(torch.isfinite(a).all()), (name, out, "non-finite"))
        err = (a - r).abs().max().item()
        errs[out] = {"abs": err, "rel_to_max": err / max(r.abs().max().item(), 1e-30)}
        check(errs[out]["rel_to_max"] <= tol, (name, out, errs[out]))
    del cells_ref, acc_ref

    # library yardstick: the dense torch joint (matmul, logsumexp, gather) over
    # every cell, and its backward through autograd from a cotangent on the logits
    act = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid}[activation]
    tgt = torch.nn.functional.pad(targets.long(), (0, 1))[:, None, :, None].expand(b, t, u + 1, 1)

    def dense(e_, p_, w_, b_):
        logits = torch.matmul(act(e_[:, :, None, :] + p_[:, None, :, :]), w_) + b_
        return logits

    def dense_prep():
        logits = dense(e, p, w, bias).float()
        lse_d = torch.logsumexp(logits, -1)
        return logits[..., v - 1] - lse_d, torch.gather(logits, 3, tgt)[..., 0] - lse_d, lse_d

    leaves = [x.detach().requires_grad_() for x in (e, p, w, bias)]
    logits = dense(*leaves)
    cot = torch.randn(logits.shape, generator=gen, device=dev).to(logits.dtype)
    lib_fwd_ms = time_ms(dense_prep, 5, warmup=1)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(logits, leaves, cot, retain_graph=True), 3,
                         warmup=1)
    del logits, cot, leaves

    # the backward's scratch: as the wrapper sizes it, and the peak it measures
    free_cuda()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    jt.joint_flash_bwd(*args, clamp=clamp, **kw)
    torch.cuda.synchronize()
    peak_bytes = torch.cuda.max_memory_allocated() - base
    scratch_bytes = jt.bwd_scratch_bytes(b * t * (u + 1), b, t, u + 1, h, v, dtype=dtype)

    # bytes and operations the function needs: the lattice's cells only (the
    # loss reads no other), the e and p rows they use, W and the bias; the
    # forward writes its three streams in full (sentinels outside the lattice)
    cells_all = b * t * (u + 1)
    t_in = sum(min(x, t) for x in t_lens)
    u_in = sum(min(y, u) + 1 for y in u_lens)
    product = 2.0 * h * v  # FLOPs per cell of one [H] x [H, V] product
    vlp = jt.padded_vl(v)
    in_bytes = es * (t_in * h + u_in * h + h * v + v) + 4 * (u_in - b) + 8 * b
    fwd_bytes = in_bytes + 12 * cells_all
    out_bytes = es * b * t * h + 4 * (b * (u + 1) * h + h * v + v)
    bwd_bytes = in_bytes + 16 * cells_in + 4 * b + out_bytes
    scratch_io = cells_in * (es * vlp + 4 + 2 * es * h) + 4 * n_win * (win // jt.TILE_CELLS) * v
    acc_bytes = 4 * (b * t * h + b * (u + 1) * h + jt.KSPLIT * h * (vlp + 1) + v)
    # each kernel's device time in one whole backward (all its windows)
    times = kernel_device_ms(lambda: jt.joint_flash_bwd(*args, clamp=clamp, **kw),
                             {"K4-bwd": "joint_bwd_cells", "K4-bwd-dw": "joint_bwd_sums",
                              "K4-bwd-reduce": "joint_bwd_reduce"})
    # the plain versions of the windows that hold cells
    active = range(-(-cells_in // win))
    plain = {"K4-bwd": time_ms(lambda: [jt.joint_flash_bwd_cells_reference(
                 *cells_args, c0=k * win, win=win, clamp=clamp, **pkw) for k in active], 1,
                 warmup=0),
             "K4-bwd-dw": time_ms(lambda: [jt.joint_flash_bwd_sums_reference(
                 cells, new_acc(), c0=k * win, **skw) for k in active], 1, warmup=0)}
    whole_ms = time_ms(lambda: jt.joint_flash_bwd(*args, clamp=clamp, **kw), 5)
    whole_plain_ms = time_ms(lambda: jt.joint_flash_bwd_reference(*args, clamp=clamp, **kw), 1,
                             warmup=1)
    common = {"case": name, "shape": [b, t, u + 1, h, v], "t_lens": list(t_lens),
              "u_lens": list(u_lens), "dtype": str(dtype), "padded_h": hp,
              "activation": activation, "drop_t": drop_t, "fastemit": fastemit, "clamp": clamp,
              "errors": errs, "tol_rel_to_max": tol, "cells": cells_all,
              "lattice_cells": cells_in, "window_cells": win, "windows": n_win}
    rows = [
        {**common, "kernel": "K4-fwd" + suffix,
         "max_abs_err": max(errs[k]["abs"] for k in ("blank_lp", "label_lp", "lse")),
         "ms": time_ms(lambda: jt.joint_flash_fwd(e, p, w, bias, targets, seed, **kw), 10),
         "plain_ms": time_ms(lambda: jt.joint_flash_fwd_reference(e, p, w, bias, targets, seed,
                                                                  **kw), 1, warmup=1),
         "library_ms": lib_fwd_ms, "deterministic": True,
         "tile_cells": jt.fwd_rows(h, dtype),
         **bound(product * cells_in, fwd_bytes, peak)},
        # the cells kernel: the logits again and dh, two products per lattice
        # cell, writing the windows' scratch (no PyTorch call computes this
        # piece alone)
        {**common, "kernel": "K4-bwd" + suffix,
         "max_abs_err": max(errs[k]["abs"] for k in ("cells_dlab", "cells_dblank", "cells_dx",
                                                      "cells_h")),
         "ms": times["K4-bwd"], "plain_ms": plain["K4-bwd"], "library_ms": None,
         "deterministic": True, "scratch_bytes": scratch_bytes, "peak_bytes": peak_bytes,
         **bound(2 * product * cells_in, in_bytes + 16 * cells_in + 4 * b + scratch_io, peak)},
        # the sums: dW = h^T dlab (one product per cell) and the fixed-order
        # sums of de, dp and db from the scratch into the accumulators
        {**common, "kernel": "K4-bwd-dw" + suffix,
         "max_abs_err": max(errs[k]["abs"] for k in ("sums_de", "sums_dp", "sums_dw",
                                                      "sums_dw_blank", "sums_db")),
         "ms": times["K4-bwd-dw"], "plain_ms": plain["K4-bwd-dw"], "library_ms": None,
         **bound(product * cells_in, in_bytes + scratch_io + acc_bytes, peak)},
        # the reduce: reads the K splits' label columns and dW[:, VL] splits,
        # db and de's fp32 sums once; writes dW, db and de once (dp passes
        # through untouched)
        {**common, "kernel": "K4-bwd-reduce" + suffix,
         "max_abs_err": max(errs[k]["abs"] for k in ("reduce_de", "reduce_dp", "reduce_dw",
                                                      "reduce_db")),
         "ms": times["K4-bwd-reduce"],
         "plain_ms": time_ms(lambda: jt.joint_flash_bwd_reduce_reference(acc, e.dtype), 5),
         "library_ms": None,
         **bound(float(jt.KSPLIT * hp * v),
                 4 * (jt.KSPLIT * hp * (v - 1) + jt.KSPLIT * hp + v + b * t * hp)
                 + 4 * (hp * v + v) + es * b * t * hp, PEAK_FP32_FLOPS)},
        # the whole backward as one function (cells, dw and reduce over every
        # window): three products per lattice cell, against the dense joint's
        # autograd backward
        {**common, "kernel": "K4-bwd-whole" + suffix,
         "max_abs_err": max(errs[k]["abs"] for k in ("de", "dp", "dw", "db")),
         "ms": whole_ms, "plain_ms": whole_plain_ms, "library_ms": lib_bwd_ms,
         "split_ms": {k: times[k] for k in ("K4-bwd", "K4-bwd-dw", "K4-bwd-reduce")},
         "deterministic": True, "scratch_bytes": scratch_bytes, "peak_bytes": peak_bytes,
         **bound(3 * product * cells_in, bwd_bytes, peak)},
    ]
    for row in rows:
        row["tflops"] = row["flops"] / max(row["ms"], 1e-9) / 1e9
        emit("kernels", **row)
    return rows


def _joint_fwd_wide_case(name, b, t, u, h, v, t_lens, u_lens, gen, dev, drop_t=26, bt=16):
    """K4-fwd alone at an H past the backward's range, where it takes 64-cell
    tiles: against its plain version, the sentinels, the same bits twice."""
    from conformer_nemo_tpu_torch.ops import rnnt_joint as jt
    from conformer_nemo_tpu_torch.ops import rnnt_lattice as lat

    bf = lambda *shape, scale: (torch.randn(*shape, generator=gen, device=dev) * scale).to(
        torch.bfloat16)
    e, p = bf(b, t, h, scale=0.5), bf(b, u + 1, h, scale=0.5)
    w, bias = bf(h, v, scale=h ** -0.5), bf(v, scale=0.1)
    targets = torch.randint(0, v - 1, (b, u), generator=gen, device=dev).to(torch.int32)
    tl = torch.tensor(t_lens, dtype=torch.int32, device=dev)
    ul = torch.tensor(u_lens, dtype=torch.int32, device=dev)
    seed = torch.tensor([777], dtype=torch.int32)
    kw = dict(t_lens=tl, u_lens=ul, blank_id=v - 1, drop_t=drop_t, bt=bt)
    fwd = jt.joint_flash_fwd(e, p, w, bias, targets, seed, **kw)
    fwd2 = jt.joint_flash_fwd(e, p, w, bias, targets, seed, **kw)
    ref = jt.joint_flash_fwd_reference(e, p, w, bias, targets, seed, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(fwd, fwd2)), (name, "K4-fwd not deterministic"))
    inside = lat.valid_cells(fwd[0].shape, tl, ul)
    errs = {}
    for out, a, r in zip(("blank_lp", "label_lp", "lse"), fwd, ref):
        check(torch.equal(a[~inside], r[~inside]), (name, out, "outside the lattice"))
        a, r = a[inside], r[inside]
        check(bool(torch.isfinite(a).all()), (name, out, "non-finite"))
        err = (a - r).abs().max().item()
        errs[out] = {"abs": err, "rel_to_max": err / max(r.abs().max().item(), 1e-30)}
        check(errs[out]["rel_to_max"] <= JOINT_REL_TOL, (name, out, errs[out]))
    out = {"case": name, "kernel": "K4-fwd", "shape": [b, t, u + 1, h, v], "t_lens": t_lens,
           "u_lens": u_lens, "tile_cells": jt.fwd_rows(h), "errors": errs,
           "tol_rel_to_max": JOINT_REL_TOL, "deterministic": True}
    emit("kernels", **out)
    return out


def _dropout_mask_probe(b, t, u, h, gen, dev, bt=16, drop_t=26, row_offset=0) -> dict:
    """W_lab the identity, p = 0, e a positive constant: each cell's label
    logit is its h at the target column, c * inv_keep if kept and 0 if
    dropped, so the kernel's keep bit there is read off label_lp + lse and
    held against hash_keep_mask_reference bit for bit (with row_offset, at
    that offset in a global batch: `joint_seed`'s hash base)."""
    from conformer_nemo_tpu_torch.ops import rnnt_joint as jt

    targets = torch.randint(0, h, (b, u), generator=gen, device=dev).to(torch.int32)
    e = torch.full((b, t, h), 0.5, dtype=torch.bfloat16, device=dev)
    p = torch.zeros((b, u + 1, h), dtype=torch.bfloat16, device=dev)
    w = torch.cat([torch.eye(h, device=dev), torch.zeros(h, 1, device=dev)], 1).to(torch.bfloat16)
    bias = torch.zeros(h + 1, dtype=torch.bfloat16, device=dev)
    seed = jt.joint_seed(-987654321, row_offset, t, u + 1, h, bt)
    full = lambda n: torch.full((b,), n, dtype=torch.int32, device=dev)
    _, label_lp, lse = jt.joint_flash_fwd(e, p, w, bias, targets, seed, t_lens=full(t),
                                          u_lens=full(u), blank_id=h, drop_t=drop_t, bt=bt)
    kept = (label_lp + lse) > 0.25
    mask = jt.hash_keep_mask_reference((b, jt.padded_t(t, bt), u + 1, h), seed, drop_t,
                                       device=dev)[:, :t]
    tgt = torch.nn.functional.pad(targets.long(), (0, 1))[:, None, :, None].expand(b, t, u + 1, 1)
    want = torch.gather(mask, 3, tgt)[..., 0]
    mismatches = int((kept != want).sum().item())
    check(mismatches == 0, ("dropout mask", mismatches))
    out = {"case": "dropout_mask_probe", "shape": [b, t, u + 1, h], "drop_t": drop_t,
           "row_offset": row_offset, "hash_base": int(seed[1]) & 0xFFFFFFFF,
           "cells_probed": kept.numel(), "mismatches": mismatches,
           "kept_share": want.float().mean().item()}
    emit("kernels", **out)
    return out


# ---------------------------------------------------------------------------
# transcribe
# ---------------------------------------------------------------------------


def encoder_frames(cfg, samples) -> list:
    """Encoder frames for each sample count under the model config `cfg`."""
    from conformer_nemo_tpu_torch.audio.features import mel_seq_len
    from conformer_nemo_tpu_torch.models.conformer import encoder_lengths

    feats = mel_seq_len(cfg.preprocessor, torch.tensor(samples, dtype=torch.int64))
    return encoder_lengths(cfg.encoder, feats, int(feats.max())).tolist()


def _wav(rng, seconds: float) -> np.ndarray:
    n = int(seconds * SR)
    t = np.arange(n) / SR
    tones = sum(0.1 * np.sin(2 * np.pi * f * t) for f in rng.uniform(150, 3000, 3))
    return (0.05 * rng.randn(n) + tones).astype(np.float32)


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
            path = os.path.join(tmp, f"{g}_{i}.wav")
            write_wav(path, _wav(rng, s), SR)
            paths.setdefault(g, []).append(path)
    return paths


def _span_device_s(events: list, span: str) -> float:
    """Device seconds of the work of the `record_function` range `span` in
    a trace's events: the kernels launched inside the range, and those of
    the backward nodes of the ops recorded inside it (a node's event bears
    the sequence number of the forward op that made it). An op that makes
    no node records the number the next node takes, so at most the first
    node after the range may count with it."""
    from torch.autograd import DeviceType

    ranges = [e for e in events if e.name == span and e.device_type == DeviceType.CPU]
    check(ranges, ("no trace range", span))
    inside, seq = set(), set()
    stack = list(ranges)
    while stack:
        e = stack.pop()
        inside.add(e.id)
        if e.sequence_nr >= 0 and e.name != span:
            seq.add(e.sequence_nr)
        stack += e.cpu_children
    is_node = lambda e: (e.id not in inside and e.device_type == DeviceType.CPU
                         and e.sequence_nr in seq and "Backward" in e.name)
    nodes = [e for e in events if is_node(e)]
    outer = [e for e in nodes if e.cpu_parent is None or not is_node(e.cpu_parent)]
    check(outer, ("no backward node of", span))
    return (sum(e.device_time_total for e in ranges)
            + sum(e.device_time_total for e in outer)) / 1e6


def _profile(run, phase: str, span: str | None = None, **fields) -> dict:
    """One traced run of `run()`: how busy the device was and which kernels
    took its time (torch.profiler, CUPTI). Only device-side events (kernels,
    memcpys, memsets) count: an `aten::` op's device time is that of the
    kernels it launched, which are listed too. They run on one stream, so
    their times add up without overlap. With `span`, the name of a
    `record_function` range in the run, also that range's device seconds
    (`_span_device_s`) and their share of the busy time (the range's own
    device-side annotation is not a kernel and counts in neither)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.key != span]
    dev_us = lambda e: e.self_device_time_total
    busy_s = sum(dev_us(e) for e in events) / 1e6
    check(busy_s > 0, "the profiler saw no device time")
    top = sorted(events, key=dev_us, reverse=True)[:15]
    out = {"traced_wall_s": wall, "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall,
           "top": [{"name": e.key[:100], "device_ms": dev_us(e) / 1e3, "calls": e.count}
                   for e in top], **fields}
    if span is not None:
        span_s = _span_device_s(prof.events(), span)
        check(0 < span_s <= busy_s, (span, span_s, busy_s))
        out.update({f"{span}_device_s": span_s, f"{span}_share": span_s / busy_s})
    emit(phase, **out)
    return out


def phase_transcribe(model, groups, gpu: str) -> tuple:
    from conformer_nemo_tpu_torch.api import ConformerCTC
    from conformer_nemo_tpu_torch.ops import flash_attention as fa
    from conformer_nemo_tpu_torch.ops.build import reset_launch_counts

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
    reset_launch_counts()
    texts = model.transcribe(paths, batch_size=BATCH)
    launches, by_shape = fa.fwd_launches.total, dict(fa.fwd_launches.by_shape)
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
    _profile(lambda: model.transcribe(paths, batch_size=BATCH), "profile")

    lp_flash = model.transcribe(paths, batch_size=BATCH, logprobs=True)
    dense = ConformerCTC.from_config_file(
        CONFIG, overrides={**OVERRIDES, "model.encoder.use_flash_attention": False})
    dense.load_state_dict(model.state_dict())
    lp_dense = dense.transcribe(paths, batch_size=BATCH, logprobs=True)
    del dense
    free_cuda()

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


# ---------------------------------------------------------------------------
# frontends: the subsampling modes, the optimizers, the JAX checkpoint
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _module_span(module, span: str):
    """Mark `module`'s forward as the trace range `span` (module hooks)."""
    from torch.profiler import record_function

    open_ranges = []

    def enter(mod, args):
        open_ranges.append(record_function(span).__enter__())

    def leave(mod, args, out):
        open_ranges.pop().__exit__(None, None, None)

    hooks = [module.register_forward_pre_hook(enter), module.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def _pre_encode_span(model, span: str):
    """Mark the encoder's pre-encode forward as the trace range `span`
    (module hooks; the factor-1 Linear, which the encoder applies through
    `_linear`, by wrapping that call)."""
    from conformer_nemo_tpu_torch.models import conformer as conf
    from torch.profiler import record_function

    pre = model.model.encoder.pre_encode
    if isinstance(pre, torch.nn.Linear):
        orig = conf._linear

        def spanned(mod, x, dtype):
            if mod is not pre:
                return orig(mod, x, dtype)
            with record_function(span):
                return orig(mod, x, dtype)

        conf._linear = spanned
        try:
            yield
        finally:
            conf._linear = orig
        return
    with _module_span(pre, span):
        yield


def _mode_fit(cls, config: str, overrides: dict, manifest: str, want: dict, gpu: str,
              mode: str) -> tuple:
    """fit 3 steps of one subsampling mode; per step the launches `want`
    and finite, changed state; the steady step, audio-s/s, peak memory, a
    traced step and the pre-encode's device ms. -> (model, its row, the
    counted steps). `want`: launches per step, or a function of (model,
    batch) giving them."""
    from conformer_nemo_tpu_torch.ops.build import reset_launch_counts

    model = cls.from_config_file(config, overrides=overrides, seed=SEED)
    steps: list = []
    model._make_train_step = _counted_steps(model, steps)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = model.fit(manifest, max_steps=TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    del model._make_train_step
    check(len(steps) == TRAIN_STEPS and out["steps"] == TRAIN_STEPS, (mode, len(steps)))
    for i, s in enumerate(steps):
        w = want(model, s["batch"]) if callable(want) else want
        got = {k: s["launches"].get(k, 0) for k in w}
        check(got == w, (mode, "step", i, "launches", got, "want", w))
        check(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]), (mode, i, s["loss"]))
        check(all(s["changed"].values()), (mode, "step", i, "unchanged", s["changed"]))
    batch = steps[0]["batch"]
    step = model._make_train_step(model._make_optimizer())
    with _pre_encode_span(model, "pre_encode"):
        prof = _profile(lambda: step(batch), f"profile_frontends_{mode}", span="pre_encode",
                        mode=mode)
    model.model.eval()  # as fit leaves it
    del step
    enc = model._encoder_config
    steady = steps[1:]
    row = {"mode": mode, "n_layers": enc.n_layers, "d_model": enc.d_model,
           "subsampling_factor": enc.subsampling_factor, "batch": int(batch.audio.shape[0]),
           "encoder_t": encoder_frames(types.SimpleNamespace(
               encoder=enc, preprocessor=model.cfg.preprocessor), [batch.audio.shape[1]])[0],
           "params": sum(p.numel() for p in model.model.parameters()),
           "losses": [s["loss"] for s in steps], "step_s": [s["seconds"] for s in steps],
           "steady_step_s": sum(s["seconds"] for s in steady) / len(steady),
           "steady_audio_s_per_s": sum(s["audio_s"] for s in steady) / sum(
               s["seconds"] for s in steady),
           "launches_per_step": steps[-1]["launches"],
           "peak_memory_bytes": peak, "traced_step_device_busy_s": prof["device_busy_s"],
           "traced_step_idle_share": prof["device_idle_share"],
           "pre_encode_device_s": prof["pre_encode_device_s"],
           "pre_encode_share": prof["pre_encode_share"], "gpu": gpu}
    return model, row, steps


def _resnet_parity(model, paths: list) -> dict:
    """The resnet model's log-probs through flash (T >= 1024) against a
    flash-off copy's: argmax agreement >= ARGMAX_AGREEMENT_MIN. Taken on the
    model as seeded, before its fit: three steps from random weights leave
    bf16 log-probs whose top two tie on many frames (my chip call 2, PR 15),
    where either path's rounding picks the argmax."""
    from conformer_nemo_tpu_torch.api import ConformerCTC

    lp_flash = model.transcribe(paths, batch_size=BATCH, logprobs=True)
    dense = ConformerCTC.from_config_file(CONFIG, overrides={
        **OVERRIDES, **RESNET_OVERRIDES,
        "model.encoder.use_flash_attention": False})
    dense.load_state_dict(model.state_dict())
    lp_dense = dense.transcribe(paths, batch_size=BATCH, logprobs=True)
    del dense
    free_cuda()
    for a, b in zip(lp_flash, lp_dense):
        check(a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all(),
              (a.shape, b.shape))
    agree = np.concatenate([a.argmax(-1) == b.argmax(-1) for a, b in zip(lp_flash, lp_dense)])
    top2 = np.concatenate([np.sort(b, -1)[:, -2:] for b in lp_dense])
    out = {"argmax_agreement": float(agree.mean()),
           "tied_share": float((top2[:, 1] == top2[:, 0]).mean()),
           "max_abs_logprob_diff": max(float(np.abs(a - b).max())
                                       for a, b in zip(lp_flash, lp_dense))}
    check(out["argmax_agreement"] >= ARGMAX_AGREEMENT_MIN, ("resnet argmax agreement", out))
    return out


def _resnet_serve(model, paths: list) -> tuple:
    """The transcribe phase's buckets through the trained resnet model:
    K2-fwd at the two flash forwards, counted by shape; texts, audio-s/s.
    -> (its summary, K2-fwd launches by shape, the flash calls as
    `phase_transcribe` returns them)."""
    from conformer_nemo_tpu_torch.ops import flash_attention as fa
    from conformer_nemo_tpu_torch.ops.build import reset_launch_counts

    model.transcribe(paths[:2], batch_size=BATCH)  # warm-up
    batches = []
    orig = model._decode_audio_batch

    def seen(audio, lens, mode="text"):
        batches.append((audio.shape[1], lens.tolist()))
        return orig(audio, lens, mode=mode)

    model._decode_audio_batch = seen
    reset_launch_counts()
    texts, seconds = _timed(lambda: model.transcribe(paths, batch_size=BATCH))
    launches, by_shape = fa.fwd_launches.total, dict(fa.fwd_launches.by_shape)
    del model._decode_audio_batch
    enc = model.cfg.encoder
    check(launches == 2 * enc.n_layers and len(by_shape) == 2
          and min(sh[1] for sh in by_shape) >= 1024, ("resnet K2-fwd", launches, by_shape))
    check(len(texts) == len(paths) and all(isinstance(x, str) for x in texts), texts)
    flash_calls = []
    for samples, lens in batches:
        t = encoder_frames(model.cfg, [samples])[0]
        if t >= enc.flash_attention_min_t:
            flash_calls.append((t, [n for n in encoder_frames(model.cfg, lens)
                                    for _ in range(enc.n_heads)]))
    check(len(flash_calls) == 2, ("resnet flash forwards", flash_calls))
    audio_s = sum(_wav_seconds(p) for p in paths)
    return {"files": len(paths), "seconds": seconds, "audio_s_per_s": audio_s / seconds,
            "k2_fwd_launches": launches,
            "k2_fwd_by_shape": {str(k): v for k, v in by_shape.items()}}, by_shape, flash_calls


def _wav_seconds(path: str) -> float:
    from conformer_nemo_tpu_torch.data.audio_io import load_audio

    return len(load_audio(path, target_sr=SR)) / SR


def _checkpoint_crossing(model, steps: list, tmp: str) -> dict:
    """The resnet run's train state written as the JAX package's
    state.msgpack and as state.pt; two fresh models resume one each, take
    one generator state (the random stream crosses by rule, not bit for
    bit) and step on the same batch: the same loss, bit for bit."""
    from conformer_nemo_tpu_torch.api import ConformerCTC
    from conformer_nemo_tpu_torch.convert import jax_train_state
    from conformer_nemo_tpu_torch.train import checkpoint as ckpt

    state = model.train_state
    jdir, pdir = os.path.join(tmp, "ck_jax"), os.path.join(tmp, "ck_pt")
    step_dir = os.path.join(jdir, f"step_{state.step}")
    os.makedirs(step_dir, exist_ok=True)
    _, write_s = _timed(lambda: jax_train_state.write_train_state(
        os.path.join(step_dir, jax_train_state.STATE_FILE), state, "adamw",
        model.raw_cfg.get("trainer", {}).get("gradient_clip_val")))
    with open(os.path.join(step_dir, "meta.json"), "w") as f:
        json.dump({"step": state.step, "metrics": {}}, f)
    with open(os.path.join(jdir, "last"), "w") as f:
        f.write(f"step_{state.step}")
    ckpt.save_train_state(pdir, state, state.step)
    losses, restore_s, after = [], [], []
    for d in (jdir, pdir):
        m = ConformerCTC.from_config_file(CONFIG, overrides={
            **TRAIN_OVERRIDES, **RESNET_OVERRIDES}, seed=SEED + 5)
        m.train_state = m._init_state(m._make_optimizer())
        (_, meta), sec = _timed(lambda: ckpt.restore_train_state(d, m.train_state))
        check(meta["step"] == state.step and m.train_state.step == state.step, meta)
        m.train_state.generator.set_state(state.generator.get_state())
        losses.append(float(m._make_train_step(m._make_optimizer())(steps[0]["batch"])["loss"]))
        restore_s.append(sec)
        # the step's update read the optimizer state: its parameters and
        # statistics after it hold the moments and counts that crossed
        after.append({k: v.detach().cpu() for k, v in m.model.state_dict().items()})
        del m
        free_cuda()
    check(losses[0] == losses[1], ("state.msgpack vs state.pt resume", losses))
    differ = [k for k in after[1] if not torch.equal(after[0][k], after[1][k])]
    check(after[0].keys() == after[1].keys() and not differ,
          ("state.msgpack vs state.pt: tensors after the next step", differ[:10]))
    return {"next_loss_msgpack": losses[0], "next_loss_pt": losses[1],
            "tensors_equal_after_the_step": len(after[1]), "write_msgpack_s": write_s,
            "restore_msgpack_s": restore_s[0], "restore_pt_s": restore_s[1],
            "msgpack_bytes": os.path.getsize(os.path.join(step_dir, jax_train_state.STATE_FILE))}


def _update_card_vs_cpu(model) -> dict:
    """Each optimizer's OPT_UPDATES updates of the model's parameters with
    fixed seeded gradients, on the card and on the CPU (fp32 both): the
    largest difference of an update entry over the update's largest entry,
    per optimizer (an update of zeros must be zeros on both)."""
    from conformer_nemo_tpu_torch.train.optim import NAMES, apply_updates, make_optimizer

    base = [p.detach().float().cpu() for p in model.model.parameters()]
    gen = torch.Generator().manual_seed(SEED + 7)
    grads = [[1e-3 * torch.randn(p.shape, generator=gen) for p in base]
             for _ in range(OPT_UPDATES)]
    out = {}
    for name in NAMES:
        updates = {}
        for dev in ("cuda", "cpu"):
            params = [p.clone().to(dev) for p in base]
            opt = make_optimizer(name, lambda count: 1e-3, weight_decay=1e-3, grad_clip=1.0)
            st = opt.init(params)
            updates[dev] = []
            for g in grads:
                upd, st = opt.update([x.to(dev) for x in g], st, params)
                apply_updates(params, upd)
                updates[dev].append([u.cpu() for u in upd])
        rel = []
        for card, cpu in zip(updates["cuda"], updates["cpu"]):
            diff = max(float((a - b).abs().max()) for a, b in zip(card, cpu))
            size = max(float(b.abs().max()) for b in cpu)
            check(diff <= OPT_UPDATE_REL * size, (name, "card vs cpu update", diff, size))
            rel.append(diff / size if size else 0.0)
        out[name] = {"update_rel_diff": rel, "update_max": [
            max(float(b.abs().max()) for b in cpu) for cpu in updates["cpu"]]}
    return out


def phase_frontends(tmp: str, groups: dict, rnnt_manifest: str, gpu: str) -> dict:
    """The fork's subsampling front ends, the remaining optimizers and the
    JAX checkpoint, each on its main path at full width. -> the resnet and
    subencoder runs' launches by shape and their kernels' inputs."""
    from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
    from conformer_nemo_tpu_torch.ops.build import launch_count, reset_launch_counts
    from conformer_nemo_tpu_torch.train.optim import NAMES

    t_start = time.perf_counter()
    ctc_m = os.path.join(tmp, "bpe_train.json")  # bpe_step's 16 files of 10-16 s
    modes = []
    # resnet CTC at full width, RESNET_LAYERS deep: flash against dense as seeded, fit,
    # serve, cross the JAX checkpoint
    paths = [p for g in ("dense", "flash_batched", "longform") for p in groups[g]]
    resnet = {**TRAIN_OVERRIDES, **RESNET_OVERRIDES}
    parity = _resnet_parity(ConformerCTC.from_config_file(CONFIG, overrides=resnet, seed=SEED),
                            paths)
    free_cuda()
    model, row, steps = _mode_fit(ConformerCTC, CONFIG, resnet, ctc_m, CTC_STEP_LAUNCHES, gpu,
                                  "resnet")
    by_shape = {k: dict(launch_count(k).by_shape) for k in ("K1-fwd", "K1-bwd", "K1-bwd-grad")}
    row["serve"], by_shape["K2-fwd"], flash_calls = _resnet_serve(model, paths)
    row["flash_vs_dense_as_seeded"] = parity
    row["checkpoint_crossing"] = _checkpoint_crossing(model, steps, tmp)
    modes.append(row)
    batch = steps[0]["batch"]
    cfg = model.cfg
    # the main path's kernel calls, for phase_kernels: K1 at the resnet
    # step's shapes and lengths, K2-fwd at the serve's
    inputs = {"flash_calls": flash_calls, "v1": cfg.num_classes + 1, "blank": cfg.blank_id,
              "ctc_t": encoder_frames(cfg, [batch.audio.shape[1]])[0],
              "ctc": (batch.tokens, encoder_frames(cfg, batch.audio_lens.tolist()),
                      batch.token_lens)}
    del model, steps, batch
    free_cuda()
    # subencoder transducer at full width, RNNT_LAYERS deep, with the flash joint
    model, row, steps = _mode_fit(ConformerTransducer, RNNT_CONFIG, {
        **RNNT_OVERRIDES, "model.encoder.subsampling": "subencoder"}, rnnt_manifest,
        rnnt_step_launches, gpu, "subencoder")
    by_shape.update({k: dict(launch_count(k).by_shape) for k in RNNT_KERNELS})
    batch = steps[0]["batch"]
    cfg = model.cfg.model
    # K3 and K4 at the subencoder step's shapes and lengths, for phase_kernels
    inputs["rnnt"] = {"t": _frames(model, [batch.audio.shape[1]])[0],
                      "enc_lens": _frames(model, batch.audio_lens.tolist()),
                      "tokens": batch.tokens, "token_lens": batch.token_lens.tolist(),
                      "h": cfg.joint.joint_hidden, "v": cfg.num_classes_with_blank}
    with open(rnnt_manifest, encoding="utf-8") as f:
        wavs = [_crop_wav(json.loads(line)["audio_filepath"], tmp, DECODE_CLIP_S)
                for line in f][:FRONTEND_TRANSCRIBE_FILES]
    texts, row["transcribe_s"] = _timed(lambda: model.transcribe(wavs, batch_size=len(wavs)))
    check(len(texts) == len(wavs) and all(isinstance(x, str) for x in texts), texts)
    row["transcribe_files"] = len(wavs)
    modes.append(row)
    del model, steps, batch
    free_cuda()
    # vggnet, stacking and factor 1 at full width, FRONTEND_LAYERS layers
    for mode, over in (("vggnet", {"model.encoder.subsampling": "vggnet"}),
                       ("stacking", {"model.encoder.subsampling": "stacking"}),
                       ("none", {"model.encoder.subsampling": "none",
                                 "model.encoder.subsampling_factor": 1})):
        model, row, _ = _mode_fit(ConformerCTC, CONFIG, {
            **TRAIN_OVERRIDES, "model.encoder.n_layers": FRONTEND_LAYERS, **over}, ctc_m,
            CTC_STEP_LAUNCHES, gpu, mode)
        modes.append(row)
        del model
        free_cuda()
    # the ten optimizers: 3 fit steps each through K1 on a striding model of
    # FRONTEND_LAYERS layers, then one update on the card against the CPU
    model = ConformerCTC.from_config_file(CONFIG, overrides={
        **TRAIN_OVERRIDES, "model.encoder.n_layers": FRONTEND_LAYERS}, seed=SEED)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    optims = {}
    for name in NAMES:
        model.load_state_dict(init)
        model.raw_cfg["model"]["optim"]["name"] = name
        model.train_state = None
        steps = []
        model._make_train_step = _counted_steps(model, steps)
        reset_launch_counts()
        model.fit(ctc_m, max_steps=TRAIN_STEPS)
        del model._make_train_step
        for i, s in enumerate(steps):
            got = {k: s["launches"].get(k, 0) for k in ("K1-fwd", "K1-bwd", "K1-bwd-grad")}
            check(all(v == 1 for v in got.values()), (name, i, got))
            check(math.isfinite(s["loss"]), (name, i, s["loss"]))
        check(any(not torch.equal(init[k], v) for k, v in model.state_dict().items()
                  if k in init and "running" not in k), (name, "no parameter moved"))
        optims[name] = {"losses": [s["loss"] for s in steps],
                        "steady_step_s": sum(s["seconds"] for s in steps[1:]) / (len(steps) - 1)}
    updates = _update_card_vs_cpu(model)
    for name in NAMES:
        optims[name].update(updates[name])
    del model
    free_cuda()
    emit("frontends",
         config="configs/conformer_ctc_bpe.yaml, configs/conformer_transducer_bpe.yaml",
         modes=modes, optimizers=optims, opt_update_rel=OPT_UPDATE_REL,
         launches_by_shape={k: {str(sh): n for sh, n in d.items()} for k, d in by_shape.items()},
         phase_s=time.perf_counter() - t_start, gpu=gpu)
    return {"by_shape": by_shape, **inputs}


# ---------------------------------------------------------------------------
# ssl: self-supervised pretraining through the flash kernels
# ---------------------------------------------------------------------------


def _ssl_grads(model, spec, lens, masked, spec_masks, noise, seed) -> tuple:
    """One SSL objective and its gradients (fp32 copies) on fixed inputs."""
    params = list(model.model.parameters())
    loss = model.loss(spec, lens, masked, spec_masks, step=model.train_state.step, noise=noise,
                      dropout_seed=seed)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    model.model.eval()
    return float(loss), [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                         for p, g in zip(params, grads)]


def _ssl_flash_vs_dense(model, inputs: tuple, what: str, hold_cosine: bool = True) -> dict:
    """One step of `model` (flash attention) against a dense-attention copy of
    its weights on the same features, masks, negatives and dropout seed:
    both gradients finite, the losses within PARITY_LOSS_REL and, with
    hold_cosine, the gradients' cosine at least PARITY_GRAD_COSINE."""
    from conformer_nemo_tpu_torch.api_ssl import SpeechSSLModel
    from conformer_nemo_tpu_torch.ops.build import launch_counts

    loss_f, g_f = _ssl_grads(model, *inputs, SEED + 7)
    dense = SpeechSSLModel(encoder=dataclasses.replace(model.enc_cfg, use_flash_attention=False),
                           mel=model.mel, loss=model.loss_cfg, seed=SEED)
    dense.model.load_state_dict(model.model.state_dict())
    dense.train_state = model.train_state
    before = launch_counts()
    loss_d, g_d = _ssl_grads(dense, *inputs, SEED + 7)
    check(launch_counts().get("K2-fwd", 0) == before.get("K2-fwd", 0), "the dense step ran K2")
    finite = [all(bool(torch.isfinite(g).all()) for g in gs) for gs in (g_f, g_d)]
    dot = sum((a.double() * b.double()).sum() for a, b in zip(g_f, g_d)).item()
    nf = math.sqrt(sum((a.double() ** 2).sum().item() for a in g_f))
    nd = math.sqrt(sum((b.double() ** 2).sum().item() for b in g_d))
    out = {"weights": what, "loss_flash": loss_f, "loss_dense": loss_d,
           "loss_rel_err": abs(loss_f - loss_d) / abs(loss_d), "tol_loss_rel": PARITY_LOSS_REL,
           "grad_cosine": dot / (nf * nd), "min_cosine": PARITY_GRAD_COSINE,
           "grads_finite": {"flash": finite[0], "dense": finite[1]}}
    del dense, g_f, g_d
    free_cuda()
    check(all(finite), ("ssl gradients not finite", what, out))
    check(math.isfinite(loss_f) and out["loss_rel_err"] <= PARITY_LOSS_REL, ("ssl loss", out))
    check(not hold_cosine or out["grad_cosine"] >= PARITY_GRAD_COSINE,
          ("ssl gradient cosine", out))
    return out


@contextlib.contextmanager
def _captured_attention(out: list, calls: tuple):
    """Keep the inputs (qs, ks, v, lens, scale, left, right) of the encoder's
    flash attention calls numbered `calls` (counted over forwards that
    record a gradient: the layers in order, before remat recomputes them)."""
    from conformer_nemo_tpu_torch.models import conformer

    orig, seen = conformer.flash_attention, [0]

    def keep(*args):
        if torch.is_grad_enabled():
            if seen[0] in calls:
                out.append(tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args))
            seen[0] += 1
        return orig(*args)

    conformer.flash_attention = keep
    try:
        yield
    finally:
        conformer.flash_attention = orig


def _flash_captured_case(name, qs, ks, v, lens, scale, left, right, gen,
                         dtype=torch.bfloat16) -> dict:
    """K2 on attention inputs captured from a model (cast to `dtype`): the
    kernels and the plain fp32 version, each against the plain version in
    fp64 on the same inputs (a random dO). Where the scores reach millions,
    fp32 itself cannot resolve the softmax (a unit in the last place of the
    scores is worth a factor e in P), so the kernels are held to what the
    plain fp32 version achieves there: every output finite, and each error at
    most CAPTURED_ERR_RATIO times the plain fp32 version's, or within the
    dtype's limits (K2_TOLS). The inputs come from a bf16 model, so in fp32
    their scores' sums come out about the same in any order: that the fp32
    backward's S is its forward's chain is held by the card test that reads
    P back (test_flash_f32_backward_keeps_the_forward_chain), not here."""
    from conformer_nemo_tpu_torch.ops import flash_attention as fa

    dev = qs.device
    band = (left, right)
    qs, ks, v = (x.to(dtype) for x in (qs, ks, v))
    do = torch.randn(v.shape, generator=gen, device=dev).to(dtype)
    o, lse = fa.flash_attention_fwd(qs, ks, v, lens, scale, *band)
    got = (fa.flash_attention_bwd_dq(qs, ks, v, do, lse, (do.float() * o.float()).sum(-1), lens,
                                     scale, *band),
           *fa.flash_attention_bwd_dkv(qs, ks, v, do, lse, (do.float() * o.float()).sum(-1),
                                       lens, scale, *band))
    o32, lse32 = fa.flash_attention_fwd_reference(qs, ks, v, lens, scale, *band)
    plain = fa.flash_attention_bwd_reference(qs, ks, v, do, lse32,
                                             (do.float() * o32.float()).sum(-1), lens, scale,
                                             *band)
    q64, k64, v64, do64 = (x.double() for x in (qs, ks, v, do))
    o64, lse64 = fa.flash_attention_fwd_reference(q64, k64, v64, lens, scale, *band)
    exact = fa.flash_attention_bwd_reference(q64, k64, v64, do64, lse64, (do64 * o64).sum(-1),
                                             lens, scale, *band)
    torch.cuda.synchronize()

    def rel(a, b):
        return ((a.double() - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()

    o_tol, _, rel_tol = K2_TOLS[dtype]
    errs, limits = {}, {"o": o_tol, "dq": rel_tol, "dk": rel_tol, "dv": rel_tol}
    for out_name, k_out, p_out, x_out in zip(("o", "dq", "dk", "dv"), (o, *got),
                                             (o32, *plain), (o64, *exact)):
        check(bool(torch.isfinite(k_out).all()), (name, out_name, "not finite"))
        errs[out_name] = {"kernel": rel(k_out, x_out), "plain_fp32": rel(p_out, x_out)}
    row = {"case": name, "kernel": "K2-fwd + K2-bwd", "dtype": str(dtype), "bh": qs.shape[0],
           "t": qs.shape[1], "d1": qs.shape[2], "dv": v.shape[2], "scale": scale,
           "max_abs_lse": lse64.abs().max().item(),
           "lse_abs_err": {"kernel": (lse.double() - lse64).abs().max().item(),
                           "plain_fp32": (lse32.double() - lse64).abs().max().item()},
           "rel_err_vs_fp64": errs, "max_ratio": CAPTURED_ERR_RATIO, "limits": limits}
    emit("kernels", **row)
    for out_name, e in errs.items():
        check(e["kernel"] <= max(limits[out_name], CAPTURED_ERR_RATIO * e["plain_fp32"]),
              (name, out_name, e))
    return row


def _write_ssl_manifest(tmp: str) -> str:
    """SSL_FILES_PER_SPAN files in each of SSL_SPANS, one manifest."""
    rng = np.random.RandomState(SEED + 5)
    lines = []
    for i, (lo, hi) in enumerate(SSL_SPANS):
        with open(_write_manifest(tmp, f"ssl_{i}", SSL_FILES_PER_SPAN, lo, hi, rng),
                  encoding="utf-8") as f:
            lines += f.readlines()
    path = os.path.join(tmp, "ssl_train.json")
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(lines)
    return path


def phase_ssl(tmp: str, gpu: str) -> dict:
    """The SSL CLI at full width on the long-form config with quantised
    targets, at SSL_LAYERS layers and the config's own rate: SSL_STEPS steps
    over full batches of 45-71 s files, per step K2-fwd twice a layer, dQ
    and dK/dV once and no other kernel; the archive restored bit for bit; one traced step (the
    contrastive loss's share of its device time); on the longest timed
    batch, a flash step against a dense one from the same weights, masks and
    negatives, at the CLI's initial weights and at its trained ones; the
    encoder transferred into a ConformerCTC of the same config, which takes
    one finite fit step."""
    from conformer_nemo_tpu_torch.api import ConformerCTC
    from conformer_nemo_tpu_torch.api_ssl import SpeechSSLModel, mask_inputs
    from conformer_nemo_tpu_torch.audio.features import log_mel_spectrogram
    from conformer_nemo_tpu_torch.config.loader import load_config
    from conformer_nemo_tpu_torch.ops.build import (
        launch_count,
        launch_counts,
        reset_launch_counts,
    )
    from conformer_nemo_tpu_torch.scripts import ssl_pretrain
    from conformer_nemo_tpu_torch.train.optim import constant_adamw
    from conformer_nemo_tpu_torch.train.trainer import TrainState

    t_start = time.perf_counter()
    train_manifest = _write_ssl_manifest(tmp)
    out_path = os.path.join(tmp, "ssl.cntpu")
    steps: list = []
    orig = SpeechSSLModel.make_train_step

    def counted(self, optimizer):
        step = orig(self, optimizer)

        def run(batch):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(batch)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            after = launch_counts()
            audio_s = float(batch.audio_lens.sum()) / SR
            steps.append({"seconds": seconds, "audio_s": audio_s,
                          "audio_s_per_s": audio_s / seconds, "loss": float(metrics["loss"]),
                          "rows": int(batch.audio.shape[0]),
                          "rows_live": int((batch.audio_lens > 0).sum()),
                          "launches": {k: after[k] - before.get(k, 0) for k in after},
                          "batch": batch})
            return metrics

        return run

    # the script's own rate: adamw at the config's model.optim.lr, as the JAX
    # package's script takes it (2.0 in this config)
    argv = ["--config", LONGFORM, "--quantized-targets", "--out", out_path,
            f"model.train_ds.manifest_filepath={train_manifest}",
            f"model.encoder.n_layers={SSL_LAYERS}",
            f"trainer.max_steps={SSL_STEPS}", "trainer.log_every_n_steps=1"]
    SpeechSSLModel.make_train_step = counted
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        model, result = ssl_pretrain.main(argv)
    finally:
        SpeechSSLModel.make_train_step = orig
    by_shape = {k: dict(launch_count(k).by_shape) for k in SSL_STEP_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    enc = model.enc_cfg
    lr = float(load_config(LONGFORM)["model"]["optim"]["lr"])
    check(len(steps) == SSL_STEPS and result["steps"] == SSL_STEPS, (len(steps), result))
    for i, s in enumerate(steps):
        got = {k: s["launches"].get(k, 0) for k in (*SSL_STEP_LAUNCHES, *NOT_SSL)}
        want = {**SSL_STEP_LAUNCHES, **{k: 0 for k in NOT_SSL}}
        check(got == want, ("ssl step", i, "launches", got, "want", want))
        check(math.isfinite(s["loss"]), ("ssl step", i, s["loss"]))
        check(s["rows_live"] == s["rows"], ("ssl step", i, "rows with audio", s["rows_live"],
                                            "of", s["rows"]))
    bad = [n for n, p in model.model.named_parameters() if not bool(torch.isfinite(p).all())]
    check(not bad, ("non-finite parameters after the CLI's steps", bad[:5]))

    # the written archive, restored into a fresh model: bit for bit
    restored = SpeechSSLModel(encoder=enc, mel=model.mel, loss=model.loss_cfg, seed=SEED + 3)
    _, restore_s = _timed(lambda: restored.restore_weights(out_path))
    saved = model.model.state_dict()
    same = sum(torch.equal(v, saved[k]) for k, v in restored.model.state_dict().items())
    check(same == len(saved), ("ssl archive restore", same, len(saved)))
    del restored
    free_cuda()

    # the parity's inputs: the longest timed batch, its features, masks,
    # negatives and a dropout seed, fixed
    batch = max((s["batch"] for s in steps), key=lambda b: b.audio.shape[1])
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        spec, flens = log_mel_spectrogram(model.mel, torch.as_tensor(batch.audio).to(dev),
                                          torch.as_tensor(batch.audio_lens).to(dev),
                                          generator=gen, training=True)
        masked, spec_masks = mask_inputs(spec, flens, model.patch_size, model.mask_patches,
                                         mask_generator=gen)
    noise = model.model.loss.draw_noise(spec.shape[0], spec.shape[2], gen, dev)
    enc_lens = encoder_frames(types.SimpleNamespace(encoder=enc, preprocessor=model.mel),
                              batch.audio_lens.tolist())
    t_enc = encoder_frames(types.SimpleNamespace(encoder=enc, preprocessor=model.mel),
                           [batch.audio.shape[1]])[0]
    check(t_enc >= enc.flash_attention_min_t, ("ssl T", t_enc))
    check(bool(torch.isfinite(spec).all()) and int(spec_masks.sum()) > 0,
          ("parity inputs", bool(torch.isfinite(spec).all()), int(spec_masks.sum())))
    inputs = (spec, flens, masked, spec_masks, noise)

    # flash against dense: from the CLI's initial weights (the same seed), then
    # from the weights its steps trained
    initial = SpeechSSLModel(encoder=enc, mel=model.mel, loss=model.loss_cfg,
                             patch_size=model.patch_size, mask_patches=model.mask_patches,
                             seed=model.seed)
    initial.train_state = TrainState(model=initial.model, opt_state={},
                                     generator=torch.Generator())
    initial.train_state.step = model.train_state.step
    parity = [_ssl_flash_vs_dense(initial, inputs, "initial")]
    del initial
    free_cuda()
    # at the trained weights the scores reach millions, past what fp32 can
    # resolve in a softmax: flash and dense (bf16 scores, masked to -10000)
    # are held to finite gradients and their losses; the kernels to the
    # plain version on the first and last layers' own inputs
    captured: list = []
    with _captured_attention(captured, (0, enc.n_layers - 1)):
        parity.append(_ssl_flash_vs_dense(model, inputs, "trained", hold_cosine=False))
    gen_do = torch.Generator(device=dev).manual_seed(SEED + 9)
    # the same inputs through the fp32 kernels, held to the fp32 limits
    captured_rows = [_flash_captured_case(f"ssl_trained_layer{i}{sfx}", *args, gen_do,
                                          dtype=dtype)
                     for dtype, sfx in ((torch.bfloat16, ""), (torch.float32, "_fp32"))
                     for i, args in zip((0, enc.n_layers - 1), captured)]
    check(len(captured_rows) == 4, ("captured attention calls", len(captured)))
    del captured
    free_cuda()

    # one traced step: the contrastive loss's share of its device time
    step = orig(model, constant_adamw(lr, 1e-3))
    with _module_span(model.model.loss, "contrastive_loss"):
        prof = _profile(lambda: step(batch), "profile_ssl", span="contrastive_loss",
                        batch=int(batch.audio.shape[0]), encoder_t=t_enc)
    model.model.eval()
    del step
    bad = [n for n, p in model.model.named_parameters() if not bool(torch.isfinite(p).all())]
    check(not bad, ("non-finite parameters after the traced step", bad[:5]))

    # the pretrained encoder into a ConformerCTC of the same config: one fit step
    ctc = ConformerCTC.from_config_file(
        LONGFORM, overrides={**TRAIN_OVERRIDES, "model.encoder.n_layers": SSL_LAYERS},
        seed=SEED + 4)
    model.transfer_encoder_to(ctc)
    src = model.model.encoder.state_dict()
    moved = sum(torch.equal(v, src[k]) for k, v in ctc.model.encoder.state_dict().items())
    check(moved == len(src), ("transferred encoder tensors", moved, len(src)))
    fine = ctc.fit(train_manifest, max_steps=1)
    check(math.isfinite(fine["last_loss"]), ("fine-tune step after transfer", fine))

    steady = steps[1:]
    emit("ssl", config="configs/conformer_ctc_bpe_longform.yaml", quantized_targets=True,
         n_layers=enc.n_layers, d_model=enc.d_model, remat=enc.remat, lr=lr,
         batch=int(batch.audio.shape[0]), rows_live=int((batch.audio_lens > 0).sum()),
         encoder_t=t_enc, params=sum(p.numel() for p in model.model.parameters()),
         steps=[{k: v for k, v in s.items() if k != "batch"} for s in steps],
         steady_step_s=sum(s["seconds"] for s in steady) / len(steady),
         steady_audio_s_per_s=sum(s["audio_s"] for s in steady) / sum(
             s["seconds"] for s in steady),
         peak_memory_bytes=peak, archive_bytes=os.path.getsize(out_path),
         archive_restore_s=restore_s, archive_tensors_equal=same,
         traced_step_device_busy_s=prof["device_busy_s"],
         traced_step_idle_share=prof["device_idle_share"],
         contrastive_loss_device_s=prof["contrastive_loss_device_s"],
         contrastive_loss_share=prof["contrastive_loss_share"],
         flash_vs_dense={"batch": "the longest timed", "encoder_t": t_enc,
                         "audio_s": float(batch.audio_lens.sum()) / SR, "runs": parity},
         transfer={"tensors_equal": moved, "fine_tune_loss": fine["last_loss"]},
         launches_by_shape={k: {str(sh): n for sh, n in d.items()} for k, d in by_shape.items()},
         phase_s=time.perf_counter() - t_start, gpu=gpu)
    info = {"by_shape": by_shape, "t": t_enc,
            "lens": [n for n in enc_lens for _ in range(enc.n_heads)]}
    del model, ctc
    free_cuda()
    return info


# ---------------------------------------------------------------------------
# labels: classification, speaker and VAD models (cuDNN convolutions, fp32)
# ---------------------------------------------------------------------------


def _label_wavs(tmp: str, name: str, classes: list, n: int, lo_s: float, hi_s: float,
                rng) -> tuple:
    """n WAVs of lo_s..hi_s seconds, class i of `classes` a tone at its own
    pitch over noise (or noise alone for "background"), and their JSONL
    manifest with `label`. -> (manifest, paths)."""
    from conformer_nemo_tpu_torch.data.audio_io import write_wav

    rows = []
    for i in range(n):
        label = classes[i % len(classes)]
        t = np.arange(int(rng.uniform(lo_s, hi_s) * SR)) / SR
        sig = 0.02 * rng.randn(len(t))
        if label != "background":
            f0 = 150.0 * (1.0 + classes.index(label) / 2.0)
            sig += 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 2.7 * f0 * t)
        path = os.path.join(tmp, f"{name}_{i:03d}.wav")
        write_wav(path, sig.astype(np.float32), SR)
        rows.append({"audio_filepath": path, "duration": len(t) / SR, "label": label})
    manifest = os.path.join(tmp, f"{name}.json")
    with open(manifest, "w", encoding="utf-8") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return manifest, [r["audio_filepath"] for r in rows]


def _timed_label_steps(log: list):
    """Wrap `_EncDecLabelModel.make_train_step` on the class: each step's
    seconds (synchronised), rows and loss."""
    from conformer_nemo_tpu_torch.api_label import _EncDecLabelModel

    orig = _EncDecLabelModel.make_train_step

    def make(self, optimizer, augment=False):
        step = orig(self, optimizer, augment)

        def run(audio, lens, labels):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(audio, lens, labels)
            torch.cuda.synchronize()
            log.append({"seconds": time.perf_counter() - t0, "rows": int(len(lens)),
                        "loss": float(metrics["loss"])})
            return metrics

        return run

    return orig, make


def _steady(steps: list) -> dict:
    steady = steps[1:]
    s = sum(x["seconds"] for x in steady)
    return {"step_s": [x["seconds"] for x in steps], "losses": [x["loss"] for x in steps],
            "steady_step_s": s / len(steady), "rows_per_s": sum(x["rows"] for x in steady) / s}


def phase_labels(tmp: str, gpu: str) -> None:
    """The label models at their default widths through their CLIs, each
    against a CPU copy of the same weights: MatchboxNet 3x1x64 on 64 mel
    features (speech_classification: LABEL_STEPS fit steps at batch 32 x
    4 s, then predict), ECAPA 512 x 4 + 1536 with a 192-wide embedding
    (speaker_tasks train, verify and embed; LABEL_STEPS steps at batch 32 x
    3 s), and the classification model's VAD over a 60 s file (0.63 s
    windows every 0.01 s, batch 256) into postprocess_frame_predictions."""
    from conformer_nemo_tpu_torch.api_label import (
        ClassificationModel,
        SpeakerLabelModel,
        _EncDecLabelModel,
    )
    from conformer_nemo_tpu_torch.data.audio_io import load_audio
    from conformer_nemo_tpu_torch.decode.vad import postprocess_frame_predictions
    from conformer_nemo_tpu_torch.ops.build import launch_counts, reset_launch_counts
    from conformer_nemo_tpu_torch.scripts import speaker_tasks, speech_classification

    t_start = time.perf_counter()
    rng = np.random.RandomState(SEED + 11)
    cls_m, cls_files = _label_wavs(tmp, "cls", ["background", "speech"], 64, 1.0, 4.0, rng)
    spk_m, spk_files = _label_wavs(tmp, "spk", [f"spk{i}" for i in range(8)], 64, 1.5, 3.0, rng)
    cls_path, spk_path = os.path.join(tmp, "cls.cntpu"), os.path.join(tmp, "spk.cntpu")
    out = {}
    reset_launch_counts()
    steps: list = []
    orig, timed = _timed_label_steps(steps)
    _EncDecLabelModel.make_train_step = timed
    try:
        model, fit, _ = speech_classification.main([
            "--train-manifest", cls_m, "--max-steps", str(LABEL_STEPS), "--batch-size", "32",
            "--fixed-seconds", "4", "--out", cls_path])
        cls_steps = list(steps)
        steps.clear()
        spk_model, spk_fit = speaker_tasks.main([
            "train", "--train-manifest", spk_m, "--max-steps", str(LABEL_STEPS),
            "--batch-size", "32", "--fixed-seconds", "3", "--out", spk_path])
        spk_steps = list(steps)
    finally:
        _EncDecLabelModel.make_train_step = orig
    # no kernel of the port runs here: cuDNN convolves, as XLA does in the JAX package
    check(not any(launch_counts().values()), ("the label models launched", launch_counts()))
    check(len(cls_steps) == len(spk_steps) == LABEL_STEPS, (len(cls_steps), len(spk_steps)))
    for s in cls_steps + spk_steps:
        check(math.isfinite(s["loss"]), ("label step", s))

    # classification: predict through the CLI, the same weights on the CPU
    from conformer_nemo_tpu_torch.data.audio_to_label import repeat_to_length

    files = cls_files[:8]
    _, _, preds = speech_classification.main(["--model", cls_path, "--predict", *files,
                                              "--fixed-seconds", "4"])
    cpu_cls = ClassificationModel.restore_portable(cls_path, device="cpu")
    audio = np.stack([repeat_to_length(load_audio(p, target_sr=SR), 4 * SR) for p in files])
    lens = np.full(len(files), 4 * SR, np.int32)
    card = model._infer_logits(audio, lens).cpu()
    cpu = cpu_cls._infer_logits(audio, lens)
    logit_err = float((card - cpu).abs().max())
    check(logit_err <= LABEL_CARD_CPU_ATOL, ("classification logits card vs CPU", logit_err))
    check(preds == [model.labels[j] for j in card.argmax(-1).tolist()], ("predict", preds))
    # the control: what cuDNN's default TF32 (not used by the port) gives on
    # these inputs must fail the limit that the port's fp32 meets
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True), torch.no_grad():
        tf32 = model.model(*model._features(audio, lens)).cpu()
    tf32_err = float((tf32 - cpu).abs().max())
    check(tf32_err > LABEL_CARD_CPU_ATOL, ("the TF32 control meets the fp32 limit", tf32_err))
    out["classification"] = {"arch": "MatchboxNet 3x1x64", "features": 64, "batch": 32,
                             "fixed_s": 4.0, **_steady(cls_steps),
                             "params": sum(p.numel() for p in model.model.parameters()),
                             "predict": preds, "logits_card_vs_cpu": logit_err,
                             "logits_tf32_vs_cpu": tf32_err,
                             "tol": LABEL_CARD_CPU_ATOL}

    # speaker: verify and embed through the CLI, the same weights on the CPU
    _, same = speaker_tasks.main(["verify", "--model", spk_path, spk_files[0], spk_files[8]])
    _, embs = speaker_tasks.main(["embed", "--model", spk_path, spk_files[1]])
    cpu_spk = SpeakerLabelModel.restore_portable(spk_path, device="cpu")
    emb_cpu = cpu_spk.get_embedding(spk_files[1])
    emb_err = float(np.abs(embs[spk_files[1]] - emb_cpu).max())
    check(emb_cpu.shape == (192,) and emb_err <= LABEL_CARD_CPU_ATOL,
          ("speaker embedding card vs CPU", emb_err))
    out["speaker"] = {"arch": "ECAPA 512x4 + 1536, emb 192, attentive pool, angular",
                      "features": 80, "batch": 32, "fixed_s": 3.0, **_steady(spk_steps),
                      "params": sum(p.numel() for p in spk_model.model.parameters()),
                      "verify_same": bool(same), "embedding_card_vs_cpu": emb_err,
                      "tol": LABEL_CARD_CPU_ATOL}
    del spk_model, cpu_spk
    free_cuda()

    # VAD: 60 s of noise with tone stretches, frame probabilities, segments
    wav = 0.02 * rng.randn(VAD_SECONDS * SR)
    t = np.arange(len(wav)) / SR
    on = ((t % 12.0) > 4.0) & ((t % 12.0) < 9.0)
    wav = (wav + on * 0.3 * np.sin(2 * np.pi * 225.0 * t)).astype(np.float32)
    probs, vad_s = _timed(lambda: model.vad_frame_probs(wav, 0.63, 0.01, batch_size=256))
    segs = postprocess_frame_predictions(probs, {"onset": 0.5, "offset": 0.5})
    n_cpu = VAD_CPU_WINDOWS
    head = wav[: (n_cpu - 1) * int(0.01 * SR) + int(0.63 * SR)]
    cpu_probs = cpu_cls.vad_frame_probs(head, 0.63, 0.01, batch_size=256)
    vad_err = float(np.abs(probs[:n_cpu] - cpu_probs).max())
    check(len(probs) == (len(wav) - int(0.63 * SR)) // int(0.01 * SR) + 1, len(probs))
    check(np.isfinite(probs).all() and vad_err <= VAD_CARD_CPU_ATOL, ("VAD card vs CPU", vad_err))
    out["vad"] = {"seconds_of_audio": VAD_SECONDS, "windows": len(probs), "batch": 256,
                  "seconds": vad_s, "audio_s_per_s": VAD_SECONDS / vad_s,
                  "segments": len(segs), "card_vs_cpu_windows": n_cpu,
                  "probs_card_vs_cpu": vad_err, "tol": VAD_CARD_CPU_ATOL}
    emit("labels", **out, phase_s=time.perf_counter() - t_start, gpu=gpu)
    del model, cpu_cls
    free_cuda()


# ---------------------------------------------------------------------------
# diarization: speaker turns, DER, a speaker-attributed transcript; MFCC and
# the RNN encoder
# ---------------------------------------------------------------------------


def _voice(f0: float, seconds: float, seed: int) -> np.ndarray:
    """A synthetic voice of tests/test_diarization.py: f0 and its second
    harmonic over seeded noise."""
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.15 * np.sin(2 * np.pi * 2 * f0 * t)
            + 0.01 * np.random.RandomState(seed).randn(len(t))).astype(np.float32)


def _diar_inputs(tmp: str) -> tuple:
    """The speaker model's training manifest (DIAR_FILES_PER_VOICE files of
    DIAR_FIXED_S a voice), the session of alternating DIAR_TURN_S turns and
    its true RTTM. -> (manifest, session path, reference RTTM path, the
    true turns)."""
    from conformer_nemo_tpu_torch.data.audio_io import write_wav
    from conformer_nemo_tpu_torch.decode.der import write_rttm

    rows = []
    for i in range(2 * DIAR_FILES_PER_VOICE):
        label = "A" if i % 2 == 0 else "B"
        path = os.path.join(tmp, f"diar_train_{i:02d}.wav")
        write_wav(path, _voice(DIAR_VOICES[label], DIAR_FIXED_S, i), SR)
        rows.append({"audio_filepath": path, "duration": DIAR_FIXED_S, "label": label})
    manifest = os.path.join(tmp, "diar_train.json")
    with open(manifest, "w", encoding="utf-8") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    turns = [(i * DIAR_TURN_S, (i + 1) * DIAR_TURN_S, "A" if i % 2 == 0 else "B")
             for i in range(int(DIAR_SESSION_S / DIAR_TURN_S))]
    session = np.concatenate([_voice(DIAR_VOICES[s], b - a, 100 + i)
                              for i, (a, b, s) in enumerate(turns)])
    path = os.path.join(tmp, "session.wav")
    write_wav(path, session, SR)
    ref = write_rttm(os.path.join(tmp, "session_ref.rttm"), turns, "session")
    return manifest, path, ref, turns


def _window_batch(path: str, segs: list, sr: int, window: float) -> tuple:
    """The diarizer's batch of windows (each repeated to the window's
    length) -> (audio [N, T] float32, lens [N] int32)."""
    from conformer_nemo_tpu_torch.data.audio_io import load_audio
    from conformer_nemo_tpu_torch.data.audio_to_label import repeat_to_length

    wav = load_audio(path, target_sr=sr)
    t_fixed = int(window * sr)
    audio = np.stack([repeat_to_length(wav[int(a * sr): int(b * sr)], t_fixed)
                      for a, b in segs])
    return audio, np.full((len(segs),), t_fixed, np.int32)


def _rnn_encoder_case(gpu: str) -> dict:
    """RNNEncoder at its defaults and an LSTM head on RNN_ROWS x RNN_FRAMES
    seeded features, fp32 and bf16, on the card against the CPU with the
    same weights on the first RNN_CPU_ROWS rows; the forward's time and, for
    bf16 (the default dtype), one traced forward's idle share."""
    from conformer_nemo_tpu_torch.models.rnn_encoder import (
        LSTMDecoder,
        LSTMDecoderConfig,
        RNNEncoder,
        RNNEncoderConfig,
    )
    from conformer_nemo_tpu_torch.ops.build import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(SEED + 17)
    feats = torch.randn(RNN_ROWS, 80, RNN_FRAMES, generator=g)
    lens = torch.tensor([RNN_FRAMES - 100 * i for i in range(RNN_ROWS)], dtype=torch.int32)
    out = {"rows": RNN_ROWS, "cpu_rows": RNN_CPU_ROWS, "frames": RNN_FRAMES,
           "audio_s": RNN_ROWS * RNN_FRAMES / 100.0}
    weights = None
    for name, dtype, rel in (("fp32", torch.float32, RNN_FP32_REL),
                             ("bf16", torch.bfloat16, RNN_BF16_REL)):
        cfg, head_cfg = RNNEncoderConfig(dtype=dtype), LSTMDecoderConfig(feat_in=512, dtype=dtype)
        enc, head = RNNEncoder.create(cfg, seed=SEED), LSTMDecoder.create(head_cfg, seed=SEED)
        enc_cpu = RNNEncoder.create(cfg, device="cpu", seed=SEED)
        head_cpu = LSTMDecoder.create(head_cfg, device="cpu", seed=SEED)
        if weights is None:
            weights = (enc_cpu.state_dict(), head_cpu.state_dict())
        for m in (enc, enc_cpu):
            m.load_state_dict(weights[0])
        for m in (head, head_cpu):
            m.load_state_dict(weights[1])
        x, xl = feats.cuda(), lens.cuda()

        def forward():
            with torch.no_grad():
                y, ylens = enc(x, xl)
                return y, ylens, head(y)

        forward()  # warm
        reset_launch_counts()
        times = []
        for _ in range(2):
            (y, ylens, lp), sec = _timed(forward)
            times.append(sec)
        check(not any(launch_counts().values()), ("the RNN encoder launched", launch_counts()))
        n = RNN_CPU_ROWS
        with torch.no_grad():
            y_cpu, ylens_cpu = enc_cpu(feats[:n], lens[:n])
            lp_cpu = head_cpu(y_cpu)
        errs = {k: float((a[:n].float().cpu() - b).abs().max()) / float(b.abs().max())
                for k, a, b in (("encoder", y, y_cpu), ("head", lp, lp_cpu))}
        check(torch.equal(ylens[:n].cpu(), ylens_cpu) and tuple(y.shape) == (RNN_ROWS, 512,
                                                                              RNN_FRAMES // 4),
              ("RNN encoder lengths or shape", ylens.tolist(), tuple(y.shape)))
        check(all(math.isfinite(e) and e <= rel for e in errs.values()),
              ("RNN encoder card vs CPU", name, errs, rel))
        out[name] = {"forward_s": times, "audio_s_per_s": out["audio_s"] / min(times),
                     "card_vs_cpu_rel": errs, "tol": rel}
        if name == "bf16":
            out[name]["profile"] = _profile(forward, "profile_rnn_encoder", dtype=name,
                                            rows=RNN_ROWS, frames=RNN_FRAMES, gpu=gpu)
        del enc, head, enc_cpu, head_cpu, x
        free_cuda()
    out["params"] = sum(t.numel() for sd in weights for t in sd.values())
    return out


def phase_diarization(tmp: str, ctc_model, gpu: str) -> dict:
    """Diarization and the other modules of the port's last slice, on the card:
    a default-width ECAPA trained through `speaker_tasks train` on two
    synthetic voices; `speaker_tasks diarize --num-speakers 2` of a
    DIAR_SESSION_S session of alternating turns, on the card and with
    --device cpu (the same RTTM text), its window embeddings against a CPU
    copy (LABEL_CARD_CPU_ATOL), `speaker_tasks score` against the true RTTM
    (both speakers found, DER <= DIAR_DER_MAX); the transcribe phase's CTC
    model's `transcribe_with_timestamps` of the session, traced through the
    port's `profile_trace` (the trace names the flash kernel; K2-fwd counted
    for the summary path `diarization`), composed with the turns by
    `transcribe_with_speakers` (every word a speaker, equal on a host copy
    of the words); MFCC of the session card vs CPU; the RNN encoder.
    -> {"by_shape": K2-fwd launches, "flash_calls": [(T, lens)]}."""
    from conformer_nemo_tpu_torch.api_label import SpeakerLabelModel, _EncDecLabelModel
    from conformer_nemo_tpu_torch.audio.mfcc import MFCCConfig, mfcc
    from conformer_nemo_tpu_torch.data.audio_io import load_audio
    from conformer_nemo_tpu_torch.decode.asr_diar import transcribe_with_speakers
    from conformer_nemo_tpu_torch.decode.der import der_score, rttm_to_segments
    from conformer_nemo_tpu_torch.decode.diarization import (
        ClusteringDiarizer,
        merge_labeled_segments,
        nme_spectral_clustering,
        to_rttm,
    )
    from conformer_nemo_tpu_torch.decode.timestamps import WordTimestamp
    from conformer_nemo_tpu_torch.ops import flash_attention as fa
    from conformer_nemo_tpu_torch.ops.build import launch_counts, reset_launch_counts
    from conformer_nemo_tpu_torch.scripts import speaker_tasks
    from conformer_nemo_tpu_torch.utils.profiling import profile_trace

    t_start = time.perf_counter()
    manifest, session, ref_rttm, true_turns = _diar_inputs(tmp)
    spk_path = os.path.join(tmp, "diar_spk.cntpu")
    steps: list = []
    orig, timed = _timed_label_steps(steps)
    _EncDecLabelModel.make_train_step = timed
    try:
        spk, _ = speaker_tasks.main([
            "train", "--train-manifest", manifest, "--max-steps", str(DIAR_STEPS),
            "--batch-size", str(DIAR_BATCH), "--fixed-seconds", str(DIAR_FIXED_S),
            "--lr", str(DIAR_LR), "--out", spk_path])
    finally:
        _EncDecLabelModel.make_train_step = orig
    check(len(steps) == DIAR_STEPS and all(math.isfinite(x["loss"]) for x in steps),
          ("diarization speaker fit", steps[-3:]))
    del spk
    free_cuda()

    # diarize through the CLI on the card; the same pipeline on a CPU copy
    hyp_rttm = os.path.join(tmp, "session_hyp.rttm")
    reset_launch_counts()
    (spk_card, rttm), cli_s = _timed(lambda: speaker_tasks.main([
        "diarize", "--model", spk_path, session, "--num-speakers", "2", "--rttm-out",
        hyp_rttm]))
    check(not any(launch_counts().values()), ("diarization launched", launch_counts()))
    diar = ClusteringDiarizer(spk_card)
    turns, diar_s = _timed(lambda: diar.diarize(session, oracle_num_speakers=2))
    segs, emb = diar.window_embeddings(session)
    cpu_spk = SpeakerLabelModel.restore_portable(spk_path, device="cpu")
    segs_cpu, emb_cpu = ClusteringDiarizer(cpu_spk).window_embeddings(session)
    rttm_cpu = to_rttm(merge_labeled_segments(segs_cpu, nme_spectral_clustering(
        emb_cpu, oracle_num_speakers=2)), "session")
    check(rttm == rttm_cpu, ("RTTM card vs CPU", rttm, rttm_cpu))
    # the trained embeddings are of order 10-100: the limit is held relative to
    # their largest magnitude, and cuDNN's TF32 (not used by the port) must fail it
    scale = float(np.abs(emb_cpu).max())
    emb_rel = float(np.abs(emb - emb_cpu).max()) / scale
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True), torch.no_grad():
        m = spk_card
        feats, flens = m._features(*_window_batch(session, segs, m.sample_rate, diar.window))
        tf32 = m.model(feats, flens)[1].cpu().numpy()
    tf32_rel = float(np.abs(tf32 - emb_cpu).max()) / scale
    check(segs == segs_cpu and emb.shape == (len(segs), 192) and emb_rel <= LABEL_CARD_CPU_ATOL,
          ("diarization window embeddings card vs CPU", emb_rel, emb.shape))
    check(tf32_rel > LABEL_CARD_CPU_ATOL, ("the TF32 control meets the fp32 limit", tf32_rel))
    hyp = rttm_to_segments(hyp_rttm)
    _, score = speaker_tasks.main(["score", "--ref-rttm", ref_rttm, "--hyp-rttm", hyp_rttm,
                                   "--collar", str(DIAR_COLLAR)])
    detail = der_score(true_turns, hyp, DIAR_COLLAR)
    check(len({t[2] for t in turns}) == 2 and sorted(detail["mapping"].values()) == ["A", "B"],
          ("both speakers found", turns, detail["mapping"]))
    check(score["DER"] <= DIAR_DER_MAX, ("DER", score, DIAR_DER_MAX))
    del spk_card, cpu_spk, diar
    free_cuda()

    # the speaker-attributed transcript: the CTC model's words, traced and counted
    enc = ctc_model.cfg.encoder
    wav = load_audio(session, target_sr=SR)
    trace_dir = os.path.join(tmp, "diar_trace")
    reset_launch_counts()
    with profile_trace(trace_dir):
        words, words_s = _timed(
            lambda: ctc_model.transcribe_with_timestamps([session], batch_size=1)[0])
    launches, by_shape = fa.fwd_launches.total, dict(fa.fwd_launches.by_shape)
    t_enc = encoder_frames(ctc_model.cfg, [len(wav)])[0]
    check(t_enc >= enc.flash_attention_min_t and launches == enc.n_layers,
          ("diarization transcript K2-fwd launches", launches, "T", t_enc))
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir) if f.endswith(".json")]
    with open(traces[0], encoding="utf-8") as f:
        trace_text = f.read()
    check(len(traces) == 1 and "flash_fwd_kernel" in trace_text,
          ("the profile_trace trace does not name the flash kernel", traces))
    diar_segments = [(a, b, s) for a, b, s in hyp]
    result = transcribe_with_speakers(words, diar_segments)
    host_words = [WordTimestamp(w.word, w.start_s, w.duration_s, w.probability) for w in words]
    check(result == transcribe_with_speakers(host_words, diar_segments),
          "the composition differs on a host copy of the words")
    speakers = {s for _, _, s in diar_segments}
    check(words and len(result["words"]) == len(words)
          and all(w["speaker_label"] in speakers for w in result["words"]),
          ("speaker-attributed words", len(words), result["words"][:3]))

    # MFCC of the session, card against CPU
    cfg = MFCCConfig()
    lens = np.array([len(wav)], np.int32)
    (m_card, ml_card), mfcc_s = _timed(lambda: mfcc(cfg, wav[None], lens))
    m_cpu, ml_cpu = mfcc(cfg, wav[None], lens, device="cpu")
    mfcc_rel = float((m_card.cpu() - m_cpu).abs().max()) / float(m_cpu.abs().max())
    check(torch.equal(ml_card.cpu(), ml_cpu) and m_card.shape == m_cpu.shape
          and m_card.shape[1] == cfg.n_mfcc and mfcc_rel <= MFCC_CARD_CPU_REL,
          ("MFCC card vs CPU", mfcc_rel, tuple(m_card.shape)))

    rnn = _rnn_encoder_case(gpu)
    steady = _steady(steps)
    emit("diarization", speaker_model="ECAPA 512x4 + 1536, emb 192", fit_steps=DIAR_STEPS,
         batch=DIAR_BATCH, fixed_s=DIAR_FIXED_S, lr=DIAR_LR,
         fit_steady_step_s=steady["steady_step_s"], fit_losses=steady["losses"][::10],
         session_s=DIAR_SESSION_S, windows=len(segs), turns=len(turns),
         diarize_cli_s=cli_s, diarize_s=diar_s, diarize_audio_s_per_s=DIAR_SESSION_S / diar_s,
         embeddings_card_vs_cpu_rel=emb_rel, embeddings_tf32_vs_cpu_rel=tf32_rel,
         embedding_scale=scale, emb_tol=LABEL_CARD_CPU_ATOL, rttm_card_eq_cpu=True,
         score=score, collar=DIAR_COLLAR, der_max=DIAR_DER_MAX, mapping=detail["mapping"],
         transcript={"config": "configs/conformer_ctc_bpe.yaml", "encoder_t": t_enc,
                     "k2_fwd_launches": launches, "seconds_traced": words_s,
                     "words": len(words), "turns": len(result["turns"]),
                     "trace_bytes": len(trace_text), "sample": result["transcript"][:120]},
         mfcc={"shape": list(m_card.shape), "seconds": mfcc_s, "card_vs_cpu_rel": mfcc_rel,
               "tol": MFCC_CARD_CPU_REL},
         rnn_encoder=rnn, phase_s=time.perf_counter() - t_start, gpu=gpu)
    return {"by_shape": by_shape,
            "flash_calls": [(t_enc, [t_enc] * enc.n_heads)]}


# ---------------------------------------------------------------------------
# decode: the beam strategies, an n-gram LM, word timestamps
# ---------------------------------------------------------------------------


def _write_arpa(path: str) -> str:
    """A 3-gram ARPA over the fixture tokenizer's LM_WORDS pieces of two
    letters or more, '▁' stripped (seeded): every unigram, the bigrams and
    trigrams of a seeded word stream."""
    from conformer_nemo_tpu_torch.data.tokenizers import SentencePieceTokenizer

    tok = SentencePieceTokenizer(TOKENIZER)
    words = sorted({p.lstrip("▁") for p, t in zip(tok.pieces, tok.types)
                    if t == 1 and len(p.lstrip("▁")) > 1})[:LM_WORDS]
    rng = np.random.RandomState(SEED + 11)
    stream = ["<s>"] + [words[i] for i in rng.randint(0, len(words), 400)] + ["</s>"]
    bi = sorted(set(zip(stream, stream[1:])))
    tri = sorted(set(zip(stream, stream[1:], stream[2:])))
    uni = ["<unk>", "<s>", "</s>"] + words
    lp = lambda: f"{-rng.uniform(0.2, 2.0):.4f}"
    lines = ["\\data\\", f"ngram 1={len(uni)}", f"ngram 2={len(bi)}", f"ngram 3={len(tri)}", "",
             "\\1-grams:"]
    lines += [f"{lp()}\t{w}" + ("" if w in ("</s>", "<unk>") else f"\t{lp()}") for w in uni]
    lines += ["", "\\2-grams:"] + [f"{lp()}\t{a} {b}\t{lp()}" for a, b in bi]
    lines += ["", "\\3-grams:"] + [f"{lp()}\t{a} {b} {c}" for a, b, c in tri]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines + ["", "\\end\\", ""]))
    return path


def _timed_call(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _check_words(words: list, audio_s: float, time_per_frame: float, transcript: str, what):
    """Word timestamps are non-decreasing, lie within the audio (to one
    encoder frame: the last frame may end past the last sample), and their
    words joined give the greedy transcript (whitespace collapsed: a word
    boundary of the text is a word of its own, or a separator, in the list)."""
    ends = [w.start_s + w.duration_s for w in words]
    starts = [w.start_s for w in words]
    check(all(w.duration_s > 0 for w in words), (what, "a word of no duration"))
    check(all(s0 <= s1 for s0, s1 in zip(starts, starts[1:])), (what, "starts decrease"))
    check(all(e <= s1 + 1e-9 for e, s1 in zip(ends, starts[1:])), (what, "words overlap"))
    check(not words or (starts[0] >= 0 and ends[-1] <= audio_s + time_per_frame + 1e-9),
          (what, "a word outside the audio", starts[:1], ends[-1:], audio_s))
    joined = " ".join(" ".join(w.word for w in words).split())
    check(joined == " ".join(transcript.split()), (what, "words", joined[:80], transcript[:80]))


def phase_decode_ctc(model, groups, tmp: str, gpu: str) -> tuple:
    """CTC beamsearch_ngram through change_decoding_strategy on the
    transcribe phase's model: the short bucket and one 30-50 s file (T >=
    flash_attention_min_t: K2-fwd launches), twice at once beside the port's
    decoder on transcribe(logprobs=True)'s arrays; word timestamps. ->
    (K2-fwd launches by shape, the flash calls)."""
    from conformer_nemo_tpu_torch.data.audio_io import load_audio
    from conformer_nemo_tpu_torch.decode.ctc_beam import BeamSearchDecoderWithLM
    from conformer_nemo_tpu_torch.ops import flash_attention as fa
    from conformer_nemo_tpu_torch.ops.build import reset_launch_counts

    enc = model.cfg.encoder
    # the beam's host C++ is quadratic in T here: the shortest 30-50 s file
    # whose batch reaches the flash path (T >= flash_attention_min_t)
    pad = lambda n: int(math.ceil(n / 1600.0)) * 1600
    longs = sorted((len(load_audio(p, target_sr=SR)), p) for p in groups["flash_batched"])
    long_file = next(p for n, p in longs
                     if encoder_frames(model.cfg, [pad(n)])[0] >= enc.flash_attention_min_t)
    files = groups["dense"] + [long_file]
    samples = [len(load_audio(p, target_sr=SR)) for p in files]
    audio_s = sum(samples) / SR
    arpa = _write_arpa(os.path.join(tmp, "lm3.arpa"))
    greedy, greedy_s = _timed_call(lambda: model.transcribe(files, batch_size=BATCH))
    lps = model.transcribe(files, batch_size=BATCH, logprobs=True)
    vocab = model.tokenizer.ids_to_tokens(list(range(model.tokenizer.vocab_size)))
    dec = BeamSearchDecoderWithLM(vocab, **CTC_BEAM, lm_path=arpa)  # writes the .binlm
    beam_cfg = {"strategy": "beamsearch_ngram", "beam": {**CTC_BEAM, "lm_path": arpa}}
    model.change_decoding_strategy(beam_cfg)
    # two API calls and the decoder on the log-probs, side by side (the
    # native search releases the GIL; each runs the long file on one thread
    # of its own): the same texts from all three
    reset_launch_counts()
    with ThreadPoolExecutor(max_workers=2) as ex:
        again_f = ex.submit(lambda: _timed_call(lambda: model.transcribe(files, batch_size=BATCH)))
        direct_f = ex.submit(lambda: dec(
            np.stack([np.pad(lp, ((0, max(len(x) for x in lps) - len(lp)), (0, 0))) for lp in lps]),
            seq_lens=np.array([len(lp) for lp in lps])))
        texts, beam_s = _timed_call(lambda: model.transcribe(files, batch_size=BATCH))
        again, again_s = again_f.result()
        direct = [cands[0][0].replace("▁", " ").strip() for cands in direct_f.result()]
    launches, by_shape = fa.fwd_launches.total, dict(fa.fwd_launches.by_shape)
    # the long file decodes alone, BATCH rows padded to a multiple of 1600
    # samples, once in each of the two calls
    t_long = encoder_frames(model.cfg, [pad(samples[-1])])[0]
    check(t_long >= enc.flash_attention_min_t and launches == 2 * enc.n_layers,
          ("decode K2-fwd launches", launches, "T", t_long))
    flash_calls = [(t_long, [n for n in encoder_frames(model.cfg, [samples[-1]] + [0] * (BATCH - 1))
                             for _ in range(enc.n_heads)])]
    check(again == texts, ("two beam calls differ", again, texts))
    check(direct == texts, ("the API's beam texts are not the decoder's", direct, texts))
    check(dec.lm_score([], "<unk>") < 0 and os.path.exists(arpa + ".binlm"), "the LM did not load")
    model.change_decoding_strategy({"strategy": "greedy"})
    check(model.transcribe(files, batch_size=BATCH) == greedy, "greedy after the beam differs")
    words, words_s = _timed_call(lambda: model.transcribe_with_timestamps(files, batch_size=BATCH))
    tpf = model.cfg.preprocessor.window_stride * enc.subsampling_factor
    for p, n, w, g in zip(files, samples, words, greedy):
        _check_words(w, n / SR, tpf, g, os.path.basename(p))
    rate = lambda s: {"seconds": s, "s_per_file": s / len(files), "audio_s_per_s": audio_s / s}
    emit("decode_ctc", config="configs/conformer_ctc_bpe.yaml", files=len(files),
         audio_s=audio_s, longest_t=t_long, beam=CTC_BEAM, lm_words=LM_WORDS,
         k2_fwd_launches=launches, greedy=rate(greedy_s), beamsearch_ngram=rate(beam_s),
         beamsearch_ngram_again_beside=rate(again_s), timestamps=rate(words_s),
         words=sum(len(w) for w in words), sample_beam=texts[0][:60],
         sample_words=[(w.word, round(w.start_s, 2)) for w in words[0][:5]], gpu=gpu)
    return by_shape, flash_calls


def _decode_fp32(model_fp32, strategy: str, enc, enc_lens) -> list:
    """The port's decode of `enc` by `strategy` with the JAX script's beam
    options -> per sample (tokens, the score the search ranks by)."""
    from conformer_nemo_tpu_torch.decode.rnnt_beam import BeamRNNTInfer
    from conformer_nemo_tpu_torch.decode.rnnt_beam_batched import rnnt_beam_batched_decode

    m = model_fp32.model
    enc, enc_lens = enc.to(model_fp32.device), enc_lens.to(model_fp32.device)
    if strategy == "beam_batch":
        tok, tl, sc = rnnt_beam_batched_decode(m, enc, enc_lens, beam_size=RNNT_BEAM_SIZE,
                                               max_sym_exp=2)
        return [(tok[i, : int(tl[i])].tolist(), float(sc[i])) for i in range(len(tl))]
    search = "default" if strategy == "beam" else strategy
    hyps = BeamRNNTInfer(m, beam_size=RNNT_BEAM_SIZE, search_type=search,
                         tsd_max_sym_exp=2)(enc, enc_lens)
    return [(h.y_sequence, h.score / max(len(h.y_sequence), 1)) for h in hyps]


def _beam_round_trip(model, beam_cfg: dict, path: str) -> dict:
    """One file's default beam search, traced: its joint calls (each one
    host read of the log-probs), the wall and device time per call."""
    from conformer_nemo_tpu_torch.decode import rnnt_beam

    calls = [0]
    joint = rnnt_beam.BeamRNNTInfer._joint

    def counted(self, e, ps):
        calls[0] += 1
        return joint(self, e, ps)

    model.change_decoding_strategy(beam_cfg)
    rnnt_beam.BeamRNNTInfer._joint = counted
    try:
        prof = _profile(lambda: model.transcribe([path], batch_size=1), "profile_decode_beam")
    finally:
        rnnt_beam.BeamRNNTInfer._joint = joint
    n = calls[0]
    return {"joint_calls": n, "wall_s": prof["traced_wall_s"],
            "device_busy_s": prof["device_busy_s"], "idle_share": prof["device_idle_share"],
            "wall_ms_per_call": prof["traced_wall_s"] / n * 1e3,
            "device_ms_per_call": prof["device_busy_s"] / n * 1e3}


def phase_decode_rnnt(archive: str, manifest: str, tmp: str, gpu: str) -> dict:
    """The transducer's strategies at full width on the rnnt_train phase's
    model (its archive): scripts/evaluate.main once per strategy with the
    JAX script's options on the phase's shortest files, each evaluate's
    texts against a second call; one strategy through
    change_decoding_strategy with the config's own beam block; the card's
    encoder output in fp32 decoded on the card and on the CPU; word
    timestamps."""
    from conformer_nemo_tpu_torch.api import ConformerTransducer
    from conformer_nemo_tpu_torch.decode.wer import word_error_rate
    from conformer_nemo_tpu_torch.scripts import evaluate

    with open(manifest, encoding="utf-8") as f:
        entries = sorted((json.loads(line) for line in f), key=lambda x: x["duration"])
    entries = [{**x, "audio_filepath": _crop_wav(x["audio_filepath"], tmp, DECODE_CLIP_S),
                "duration": min(x["duration"], DECODE_CLIP_S)} for x in entries[:RNNT_DECODE_FILES]]
    files, refs = [x["audio_filepath"] for x in entries], [x["text"] for x in entries]
    audio_s = sum(x["duration"] for x in entries)
    sub = os.path.join(tmp, "decode.json")
    with open(sub, "w", encoding="utf-8") as f:
        f.writelines(json.dumps(x) + "\n" for x in entries)
    restored, restore_s = _timed_call(lambda: ConformerTransducer.restore_portable(archive,
                                                                                   seed=SEED))
    model = restored
    config_decoding = json.loads(json.dumps(model.raw_cfg["model"]["decoding"]))
    seen: list = []
    orig = ConformerTransducer.transcribe

    def recorded(self, *a, **kw):
        out, s = _timed_call(lambda: orig(self, *a, **kw))
        seen.append((out, s))
        return out

    def restore_once(path, **kw):
        """evaluate.main's restore: this archive, restored once above (the
        round trip in rnnt_train held a restore to the saved bits)."""
        check(path == archive and kw.get("device") is None, ("evaluate restored", path, kw))
        return restored

    strategies = {}
    # on the class (the base class's methods, shadowed): evaluate.main's own calls
    ConformerTransducer.transcribe, ConformerTransducer.restore_portable = recorded, restore_once
    try:
        for strategy in RNNT_STRATEGIES:
            seen.clear()
            wer = evaluate.main(["--model", archive, "--model-type", "rnnt", "--manifest", sub,
                                 "--batch-size", str(len(files)), "--decoding-strategy",
                                 strategy, "--beam-size", str(RNNT_BEAM_SIZE)])
            check(len(seen) == 1 and model.decoding.strategy == strategy,
                  ("evaluate transcribed", len(seen), model.decoding.strategy))
            texts, s = seen[0]
            again = model.transcribe(files, batch_size=len(files))
            check(again == texts, (strategy, "two calls differ", again, texts))
            check(word_error_rate(again, refs) == wer, (strategy, "WER", wer))
            strategies[strategy] = {"seconds": s, "again_s": seen[1][1],
                                    "s_per_file": s / len(files), "audio_s_per_s": audio_s / s,
                                    "wer": wer, "tokens_first_file": len(texts[0])}
        # the config's own beam block (beam_size 2, return_best_hypothesis false,
        # alsd_max_target_len 2.0)
        cfg_beam = {**config_decoding, "strategy": "alsd"}
        model.change_decoding_strategy(cfg_beam)
        seen.clear()
        model.transcribe(files, batch_size=len(files))
        strategies["alsd_config_block"] = {"seconds": seen[0][1], "beam": cfg_beam["beam"]}
        greedy_cfg = evaluate.decoding_config(types.SimpleNamespace(
            model_type="rnnt", decoding_strategy="greedy_batch", beam_size=RNNT_BEAM_SIZE))
        beam_cfg = evaluate.decoding_config(types.SimpleNamespace(
            model_type="rnnt", decoding_strategy="beam", beam_size=RNNT_BEAM_SIZE))
    finally:
        del ConformerTransducer.transcribe, ConformerTransducer.restore_portable
    round_trip = _beam_round_trip(model, beam_cfg, files[0])

    # the card against the CPU: the card's encoder output in fp32, the same
    # weights in fp32 on both
    from conformer_nemo_tpu_torch.api import _pad_batch
    from conformer_nemo_tpu_torch.data.audio_io import load_audio

    audio, lens = _pad_batch([load_audio(p, target_sr=SR) for p in files], len(files))
    with torch.inference_mode():
        enc, enc_lens = model._encode(audio, lens)
    enc = enc.float()
    raw = json.loads(json.dumps(model.raw_cfg))
    raw["model"]["encoder"]["use_flash_attention"] = False  # fp32: dense attention and joint
    raw["model"]["joint"]["joint_impl"] = "dense"
    copies = {}
    for dev in ("cuda", "cpu"):
        copies[dev] = ConformerTransducer(raw, model.tokenizer, dtype=torch.float32, device=dev,
                                          seed=SEED)
        copies[dev].load_state_dict({k: v.to(copies[dev].device)
                                     for k, v in model.state_dict().items()})
    threads = torch.get_num_threads()
    torch.set_num_threads(min(4, threads))  # small CPU products: fewer threads, less contention
    near_ties, parity = 0, {}
    try:
        for strategy in RNNT_STRATEGIES[1:]:
            card, card_s = _timed_call(lambda: _decode_fp32(copies["cuda"], strategy, enc,
                                                            enc_lens))
            t0 = time.perf_counter()
            cpu = _decode_fp32(copies["cpu"], strategy, enc.cpu(), enc_lens.cpu())
            cpu_s = time.perf_counter() - t0
            differ = [i for i, (a, b) in enumerate(zip(card, cpu)) if a[0] != b[0]]
            for i in differ:
                check(abs(card[i][1] - cpu[i][1]) <= DECODE_SCORE_ATOL,
                      (strategy, "card and CPU differ beyond a near-tie", i, card[i][1], cpu[i][1]))
            near_ties += len(differ)
            parity[strategy] = {"card_fp32_s": card_s, "cpu_fp32_s": cpu_s, "differ": differ,
                                "max_score_diff": max(abs(a[1] - b[1]) for a, b in zip(card, cpu))}
    finally:
        torch.set_num_threads(threads)
    del copies
    free_cuda()

    model.change_decoding_strategy(greedy_cfg)  # the script's greedy: max_symbols 10
    greedy = model.transcribe(files, batch_size=len(files))
    words, words_s = _timed_call(lambda: model.transcribe_with_timestamps(files,
                                                                          batch_size=len(files)))
    tpf = model.cfg.preprocessor.window_stride * model.cfg.model.encoder.subsampling_factor
    for x, w, g in zip(entries, words, greedy):
        _check_words(w, x["duration"], tpf, g, os.path.basename(x["audio_filepath"]))
    emit("decode_rnnt", config="configs/conformer_transducer_bpe.yaml", files=len(files),
         audio_s=audio_s, encoder_t=int(enc.shape[1]), beam_size=RNNT_BEAM_SIZE,
         archive_restore_s=restore_s, round_trip=round_trip,
         strategies=strategies, card_vs_cpu=parity, near_ties=near_ties,
         score_atol=DECODE_SCORE_ATOL, timestamps_s=words_s,
         words=sum(len(w) for w in words), gpu=gpu)
    del model
    free_cuda()
    return {"near_ties": near_ties}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _crop_wav(path: str, tmp: str, seconds: float) -> str:
    """The first `seconds` of an audio file as a WAV in `tmp` (written once)."""
    from conformer_nemo_tpu_torch.data.audio_io import load_audio, write_wav

    stem = os.path.splitext(os.path.basename(path))[0]
    out = os.path.join(tmp, f"clip{seconds:g}s_{stem}.wav")
    if not os.path.exists(out):
        write_wav(out, load_audio(path, target_sr=SR)[: int(seconds * SR)], SR)
    return out


def _write_manifest(tmp: str, name: str, n: int, lo_s: float, hi_s: float, rng) -> str:
    """n WAVs of lo_s..hi_s seconds, texts drawn from the fixture tokenizer's
    pieces at 2-3 tokens per second, and their JSONL manifest."""
    from conformer_nemo_tpu_torch.data.audio_io import write_wav
    from conformer_nemo_tpu_torch.data.tokenizers import SentencePieceTokenizer

    tok = SentencePieceTokenizer(TOKENIZER)
    pieces = [p for p, t in zip(tok.pieces, tok.types) if t == 1 and p != "▁"]
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            secs = float(np.round(rng.uniform(lo_s, hi_s), 2))
            wav_path = os.path.join(tmp, f"{name}_{i}.wav")
            write_wav(wav_path, _wav(rng, secs), SR)
            words = rng.choice(pieces, size=int(secs * rng.uniform(2.0, 3.0)))
            text = "".join(words).replace("▁", " ").strip()
            f.write(json.dumps({"audio_filepath": wav_path, "duration": secs, "text": text},
                               ensure_ascii=False) + "\n")
    return path


def _counted_steps(model, log: list, orig=None):
    """Wrap `model._make_train_step` (or `orig`, its unwrapped version) so
    that each step records its time, audio, metrics, launches per kernel and
    whether the watched parameters and BatchNorm statistics changed."""
    from conformer_nemo_tpu_torch.ops.build import launch_counts

    orig = orig or model._make_train_step
    watch = watched(model)

    def make(optimizer):
        step = orig(optimizer)

        def run(batch):
            sd = model.model.state_dict()
            snap = {k: sd[k].clone() for k in watch}
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(batch)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            after = launch_counts()
            sd = model.model.state_dict()
            audio_s = float(batch.audio_lens.sum()) / SR
            log.append({
                "seconds": seconds, "audio_s": audio_s, "audio_s_per_s": audio_s / seconds,
                "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                "launches": {k: after[k] - before.get(k, 0) for k in after},
                "changed": {k: not torch.equal(snap[k], sd[k]) for k in watch},
                "batch": batch})
            return metrics

        return run

    return make


def phase_train(tmp: str, gpu: str) -> dict:
    from conformer_nemo_tpu_torch.api import ConformerCTC
    from conformer_nemo_tpu_torch.ops.build import launch_count, reset_launch_counts

    rng = np.random.RandomState(SEED + 1)
    train_m = _write_manifest(tmp, "lf_train", 16, 45.0, 75.0, rng)
    val_m = _write_manifest(tmp, "lf_val", 2, 45.0, 75.0, rng)
    model = ConformerCTC.from_config_file(LONGFORM, overrides=TRAIN_OVERRIDES, seed=SEED)
    enc = model.cfg.encoder
    steps: list = []
    model._make_train_step = _counted_steps(model, steps)
    reset_launch_counts()
    out = model.fit(train_m, val_m, max_steps=TRAIN_STEPS)
    by_shape = {k: dict(launch_count(k).by_shape) for k in PER_STEP_LAUNCHES}
    del model._make_train_step  # the class's own again
    check(len(steps) == TRAIN_STEPS and out["steps"] == TRAIN_STEPS, (len(steps), out))
    check(not model.model.training, "the model is in eval mode after fit")
    for i, s in enumerate(steps):
        got = {k: s["launches"].get(k, 0) for k in PER_STEP_LAUNCHES}
        check(got == PER_STEP_LAUNCHES, ("step", i, "launches", got))
        check(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]), ("step", i, s["loss"]))
        check(all(s["changed"].values()), ("step", i, "unchanged", s["changed"]))
    batch = steps[0]["batch"]
    t_enc = encoder_frames(model.cfg, [batch.audio.shape[1]])[0]
    check(t_enc >= enc.flash_attention_min_t, ("train T", t_enc))
    enc_lens = encoder_frames(model.cfg, batch.audio_lens.tolist())
    text = model.transcribe([json.loads(open(train_m, encoding="utf-8").readline())
                             ["audio_filepath"]])[0]
    steady = steps[1:]
    emit("train", config="configs/conformer_ctc_bpe_longform.yaml", n_layers=enc.n_layers,
         d_model=enc.d_model, remat=enc.remat, batch=int(batch.audio.shape[0]), encoder_t=t_enc,
         params=sum(p.numel() for p in model.model.parameters()), gpu=gpu,
         steps=[{k: v for k, v in s.items() if k != "batch"} for s in steps],
         steady_step_s=sum(s["seconds"] for s in steady) / len(steady),
         steady_audio_s_per_s=sum(s["audio_s"] for s in steady) / sum(
             s["seconds"] for s in steady),
         val=out["val"], launches_by_shape={k: {str(s): n for s, n in v.items()}
                                             for k, v in by_shape.items()},
         transcribe_after_fit=text[:80])
    step = model._make_train_step(model._make_optimizer())
    _profile(lambda: step(batch), "profile_train", config="configs/conformer_ctc_bpe_longform.yaml",
             batch=int(batch.audio.shape[0]), encoder_t=t_enc)
    info = {"by_shape": by_shape, "t": t_enc, "losses": [s["loss"] for s in steps],
            "lens": [n for n in enc_lens for _ in range(enc.n_heads)],
            "ctc": (batch.tokens, enc_lens, batch.token_lens),
            "cfg": model.cfg, "train_manifest": train_m, "val_manifest": val_m}
    del model, step
    free_cuda()
    return info


def _states_equal(a, b) -> dict:
    """Which parts of two CTC models' train states are bitwise equal."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    ta, tb = a.train_state, b.train_state
    moments = lambda t: [x for key in ("mu", "nu") for x in t.opt_state[key]]
    return {"state_dict": sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa),
            "adam_moments": all(torch.equal(x, y) for x, y in zip(moments(ta), moments(tb))),
            "adam_count": ta.opt_state["count"] == tb.opt_state["count"],
            "generator": torch.equal(ta.generator.get_state(), tb.generator.get_state()),
            "step": ta.step == tb.step}


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_lifecycle(tmp: str, train_m: str, val_m: str, gpu: str) -> None:
    """Train from the CLI with an experiment manager, resume bit for bit,
    write and restore the portable archive, serve it from the transcribe
    CLI; the long-form config at full width and LIFECYCLE_LAYERS deep, the
    train phase's manifests."""
    import contextlib
    import io

    from conformer_nemo_tpu_torch.api import ConformerCTC
    from conformer_nemo_tpu_torch.ops.build import launch_counts, reset_launch_counts
    from conformer_nemo_tpu_torch.scripts import speech_to_text_ctc, transcribe_speech
    from conformer_nemo_tpu_torch.train import checkpoint as ckpt
    from conformer_nemo_tpu_torch.train.exp_manager import ExpManagerConfig, ExperimentManager

    exp_dir = os.path.join(tmp, "lifecycle")
    argv = ["--config", LONGFORM, *(f"{k}={v}" for k, v in LIFECYCLE_OVERRIDES.items()),
            f"model.train_ds.manifest_filepath={train_m}",
            f"model.validation_ds.manifest_filepath={val_m}",
            f"trainer.max_steps={LIFECYCLE_STEPS}", "trainer.log_every_n_steps=1",
            f"exp_manager.exp_dir={exp_dir}", "exp_manager.name=lifecycle",
            "exp_manager.checkpoint_callback_params.save_top_k=1",
            # the archive is written and timed below, with the tokenizer inside
            "exp_manager.checkpoint_callback_params.always_save_portable=false"]

    # 1. train from the CLI, each step counted
    steps: list = []
    unwrapped = ConformerCTC._make_train_step
    ConformerCTC._make_train_step = lambda self, opt: _counted_steps(
        self, steps, unwrapped.__get__(self))(opt)
    reset_launch_counts()
    try:
        (model, result), fit_s = _timed(lambda: speech_to_text_ctc.main(argv))
    finally:
        ConformerCTC._make_train_step = unwrapped
    path_launches = launch_counts()
    check(result["steps"] == LIFECYCLE_STEPS and len(steps) == LIFECYCLE_STEPS, result)
    want = per_step_launches(LIFECYCLE_LAYERS)
    for i, s in enumerate(steps):
        got = {k: s["launches"].get(k, 0) for k in want}
        check(got == want, ("lifecycle step", i, "launches", got))
        check(math.isfinite(s["loss"]) and all(s["changed"].values()), ("lifecycle step", i))
    run_dir = os.path.join(exp_dir, "lifecycle", "version_0")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    logged = {r["step"]: r for r in rows if "train_loss" in r}
    check(sorted(logged) == [1, 2] and all({"grad_norm", "train_step_timing"} <= set(r)
                                           for r in logged.values()), rows)
    check(any("val_wer" in r for r in rows), ("no validation logged", rows))
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    with open(os.path.join(ckpt_dir, "last")) as f:
        check(f.read() == f"step_{LIFECYCLE_STEPS}", "last")
    with open(os.path.join(ckpt_dir, f"step_{LIFECYCLE_STEPS}", "meta.json")) as f:
        check(json.load(f)["step"] == LIFECYCLE_STEPS, "meta.json step")
    ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, f"step_{LIFECYCLE_STEPS}",
                                              ckpt.STATE_FILE))

    # 2. resume: a fresh model from the experiment's last checkpoint
    fresh = ConformerCTC.from_config_file(LONGFORM, overrides=LIFECYCLE_OVERRIDES, seed=SEED + 7)
    em = ExperimentManager(ExpManagerConfig(exp_dir=exp_dir, name="lifecycle",
                                            resume_if_exists=True))
    meta, resume_s = _timed(lambda: fresh.maybe_resume(em))
    check(meta["step"] == LIFECYCLE_STEPS, meta)
    same = _states_equal(model, fresh)
    check(all(same.values()), ("resumed state differs", same))
    batch = steps[0]["batch"]

    def next_step(m):
        metrics = m._make_train_step(m._make_optimizer())(batch)
        m.model.eval()
        return float(metrics["loss"])

    loss_saved, loss_resumed = next_step(model), next_step(fresh)
    sa, sb = model.state_dict(), fresh.state_dict()
    param_rel = max(((sa[k].float() - sb[k].float()).abs().max()
                     / sa[k].float().abs().max().clamp(min=1e-30)).item() for k in sa)
    next_bitwise = all(_states_equal(model, fresh).values())
    loss_rel = abs(loss_saved - loss_resumed) / abs(loss_saved)
    check(math.isfinite(loss_saved) and loss_rel <= NEXT_LOSS_REL,
          ("next-step loss", loss_saved, loss_resumed))
    del fresh, sb
    free_cuda()

    # the async save's halves, timed: the host copy on this thread, the write on the worker
    async_dir = os.path.join(tmp, "lifecycle_async")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fut = ckpt.save_train_state_async(async_dir, model.train_state, model.train_state.step, {})
    copy_s = time.perf_counter() - t0
    fut.result()
    write_s = time.perf_counter() - t0 - copy_s
    shutil.rmtree(async_dir)

    # 3. the portable archive: saved, restored, the same bits, texts and log-probs
    archive = os.path.join(tmp, "lifecycle.cntpu")
    _, save_s = _timed(lambda: model.save_portable(archive,
                                                   artifacts={"tokenizer_model": TOKENIZER}))
    with tarfile.open(archive, "r:gz") as tar:
        weights_bytes = tar.getmember("model_weights.msgpack").size
    restored, restore_s = _timed(lambda: ConformerCTC.restore_portable(archive, seed=SEED + 9))
    sa, sr = model.state_dict(), restored.state_dict()
    check(sa.keys() == sr.keys() and all(torch.equal(sa[k], sr[k]) for k in sa),
          "the restored archive's weights differ")
    with open(train_m, encoding="utf-8") as f:
        entries = sorted((json.loads(line) for line in f), key=lambda x: x["duration"])
    files = [x["audio_filepath"] for x in entries[:2] + entries[-1:]]
    check(entries[-1]["duration"] > 60.0, "the served files hold a whole-utterance long file")
    texts = model.transcribe(files)
    check(restored.transcribe(files) == texts, "the restored archive transcribes otherwise")
    lp_err = max(float(np.abs(a - b).max()) for a, b in zip(
        model.transcribe(files, logprobs=True), restored.transcribe(files, logprobs=True)))
    check(lp_err <= LOGPROB_ATOL, ("log-probs", lp_err))
    del restored, sr
    free_cuda()

    # 4. served from the archive by the transcribe CLI
    out = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        served = transcribe_speech.main(["--model", archive, "--audio", *files])
    serve_launches = launch_counts()
    print(out.getvalue(), end="", flush=True)
    check(served == texts and out.getvalue().splitlines() == [
        f"{p}\t{t}" for p, t in zip(files, texts)], ("transcribe_speech", served, texts))
    check(serve_launches.get("K2-fwd", 0) >= model.cfg.encoder.n_layers, serve_launches)
    emit("lifecycle", config="configs/conformer_ctc_bpe_longform.yaml",
         n_layers=LIFECYCLE_LAYERS, gpu=gpu,
         params=sum(p.numel() for p in model.model.parameters()),
         cli_fit_s=fit_s, cli_steps=[{k: v for k, v in s.items() if k != "batch"}
                                     for s in steps],
         path_launches=path_launches, metrics_rows=len(rows), resumed_equal=same,
         next_loss_saved=loss_saved, next_loss_resumed=loss_resumed, next_loss_rel=loss_rel,
         next_step_bitwise=next_bitwise, next_step_max_param_rel=param_rel,
         async_save_copy_s=copy_s, async_save_write_s=write_s, checkpoint_bytes=ckpt_bytes,
         resume_restore_s=resume_s, archive_save_s=save_s, archive_restore_s=restore_s,
         archive_bytes=os.path.getsize(archive), archive_weights_bytes=weights_bytes,
         logprob_max_abs_err=lp_err, tol_logprob=LOGPROB_ATOL, served_files=len(files),
         served_seconds=[x["duration"] for x in entries[:2] + entries[-1:]],
         serve_launches=serve_launches, sample_text=texts[-1][:80])
    del model
    shutil.rmtree(exp_dir)
    os.remove(archive)
    free_cuda()


# ---------------------------------------------------------------------------
# streaming: the banded recipe, buffered decode, change_vocabulary, export, .nemo
# ---------------------------------------------------------------------------


def _k2_keys_banded(by_shape: dict) -> bool:
    """Every K2 launch of `by_shape` ({kernel: {shape: n}}) with the band."""
    return all(tuple(sh[-2:]) == STREAMING_BAND for k, d in by_shape.items()
               if k.startswith("K2") for sh in d)


def _exported_greedy(fns: dict, audio, lens, blank: int, max_symbols: int, layers: int,
                     hidden: int) -> list:
    """Batched greedy decoding through an exported transducer's `encoder` and
    `decoder_joint` alone, the rule of decode/rnnt_greedy.py: per frame up to
    max_symbols steps; a sample whose argmax is blank is done with the frame,
    and keeps its LSTM state and last label; tokens past 2T are dropped.
    -> tokens per sample."""
    enc, enc_lens = fns["encoder"](audio, lens)
    b, t_max, _ = enc.shape
    cap = 2 * t_max
    dev = enc.device
    h = torch.zeros((layers, b, hidden), device=dev)
    c = torch.zeros_like(h)
    last = torch.full((b,), blank, dtype=torch.int32, device=dev)
    out = [[] for _ in range(b)]
    for t in range(t_max):
        done = t >= enc_lens
        for _ in range(max_symbols):
            if bool(done.all()):
                break
            logits, nh, nc = fns["decoder_joint"](enc[:, t].contiguous(), last, h, c)
            k = logits.argmax(dim=-1)
            advance = ~done & (k != blank)
            for row in advance.nonzero().flatten().tolist():
                if len(out[row]) < cap:
                    out[row].append(int(k[row]))
            last = torch.where(advance, k.to(torch.int32), last)
            h = torch.where(advance[None, :, None], nh, h)
            c = torch.where(advance[None, :, None], nc, c)
            done = done | (k == blank)
    return out


def _write_nemo(path: str, model, tokenizer_file: str) -> str:
    """A NeMo archive of `model` as NeMo writes one: model_config.yaml (the
    model section, manifests dropped, the tokenizer as `model_path:
    nemo:<md5>_tokenizer.model`), torch.save(state_dict) as
    model_weights.ckpt with BatchNorm's num_batches_tracked, and the
    tokenizer under its md5-mangled name (an uncompressed tar)."""
    import hashlib

    import yaml

    m = {k: v for k, v in json.loads(json.dumps(model.raw_cfg["model"])).items()
         if k not in ("train_ds", "validation_ds", "test_ds")}
    with open(tokenizer_file, "rb") as f:
        member = hashlib.md5(f.read()).hexdigest() + "_tokenizer.model"
    m["tokenizer"] = {"dir": "/nemo/run/tokenizer", "type": "bpe",
                      "model_path": f"nemo:{member}"}
    sd = {}
    for k, v in model.state_dict().items():
        sd[k] = v.detach().cpu()
        if k.endswith("batch_norm.running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(1000)
    work = path + ".d"
    os.makedirs(work)
    with open(os.path.join(work, "model_config.yaml"), "w") as f:
        yaml.safe_dump(m, f)
    torch.save(sd, os.path.join(work, "model_weights.ckpt"))
    shutil.copy(tokenizer_file, os.path.join(work, member))
    with tarfile.open(path, "w") as tar:
        for name in os.listdir(work):
            tar.add(os.path.join(work, name), arcname=name)
    shutil.rmtree(work)
    return path


def _nemo_round_trip(cls, model, nemo: str, cntpu: str, files: list) -> dict:
    """scripts/convert_nemo.main on `nemo`, restore_portable of its `.cntpu`:
    the source model's tensors (the LSTM forget chunk within one ulp) and
    texts; for CTC its log-probs within LOGPROB_ATOL."""
    import contextlib
    import io

    from conformer_nemo_tpu_torch.scripts import convert_nemo

    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        kind, convert_s = _timed(lambda: convert_nemo.main([nemo, cntpu]))
    print(said.getvalue(), end="", flush=True)
    check(kind == ("ctc" if cls.__name__ == "ConformerCTC" else "rnnt"), kind)
    restored, restore_s = _timed(lambda: cls.restore_portable(cntpu, seed=SEED + 13))
    if kind == "ctc":
        sa, sb = model.state_dict(), restored.state_dict()
        differ, ulps = [k for k in sa if sb.get(k) is None or not torch.equal(sa[k], sb[k])], 0.0
    else:
        _, differ, ulps = _same_but_forget_chunk(model, restored)
    check(not differ and ulps <= 1.0, ("the converted model's tensors differ", differ[:5], ulps))
    texts = model.transcribe(files, batch_size=len(files))
    check(restored.transcribe(files, batch_size=len(files)) == texts,
          "the converted model transcribes otherwise")
    out = {"nemo_bytes": os.path.getsize(nemo), "cntpu_bytes": os.path.getsize(cntpu),
           "convert_s": convert_s, "restore_s": restore_s, "files": len(files),
           "forget_chunk_max_ulps": ulps,
           "dropped_line": said.getvalue().splitlines()[0][:160]}
    if kind == "ctc":
        out["logprob_max_abs_err"] = max(float(np.abs(a - b).max()) for a, b in zip(
            model.transcribe(files, logprobs=True), restored.transcribe(files, logprobs=True)))
        check(out["logprob_max_abs_err"] <= LOGPROB_ATOL, out)
    del restored
    free_cuda()
    return out


def _shares(profile: dict) -> dict:
    """A traced run's wall, device busy time and idle share."""
    return {k: profile[k] for k in ("traced_wall_s", "device_busy_s", "device_idle_share")}


def _depth_cut(cls, config: str, overrides: dict, full):
    """A model of `config` at STREAMING_SERVE_LAYERS layers holding `full`'s
    first layers, the rest of its encoder and its head."""
    cut = cls.from_config_file(config, overrides={
        **overrides, "model.encoder.n_layers": STREAMING_SERVE_LAYERS}, seed=SEED)
    want = cut.state_dict()
    cut.load_state_dict({k: v for k, v in full.state_dict().items() if k in want})
    return cut


def phase_streaming(tmp: str, rnnt_archive: str, rnnt_manifest: str, gpu: str) -> dict:
    """The banded streaming recipe on the card, and what it trains a model
    for: buffered decode of both families, change_vocabulary, export through
    torch.export and .nemo loading. -> the counted step's K2 calls."""
    import contextlib
    import io

    from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer, _pad_batch
    from conformer_nemo_tpu_torch.data.audio_io import load_audio
    from conformer_nemo_tpu_torch.data.tokenizers import SentencePieceTokenizer
    from conformer_nemo_tpu_torch.models.ctc_model import ctc_forward
    from conformer_nemo_tpu_torch.ops import flash_attention as fa
    from conformer_nemo_tpu_torch.ops.build import launch_count, reset_launch_counts
    from conformer_nemo_tpu_torch.scripts import transcribe_speech
    from conformer_nemo_tpu_torch.utils.export import load_exported

    t_phase = time.perf_counter()
    out: dict = {"config": "configs/conformer_ctc_bpe_streaming.yaml", "gpu": gpu}

    # 1. the streaming fit: per step K2 with the band, K1
    train_m = _write_manifest(tmp, "st_train", STREAMING_FILES, 60.0, 120.0,
                              np.random.RandomState(SEED + 11))
    model = ConformerCTC.from_config_file(
        STREAMING_CONFIG, overrides=STREAMING_OVERRIDES, seed=SEED)
    enc = model.cfg.encoder
    want_launches = per_step_launches(STREAMING_LAYERS)
    check(tuple(enc.att_context_size) == STREAMING_BAND and enc.n_layers == STREAMING_LAYERS
          and enc.d_model == 512 and enc.remat and enc.flash_attention_min_t == 512,
          ("the streaming recipe", enc))
    steps: list = []
    model._make_train_step = _counted_steps(model, steps)
    reset_launch_counts()
    fit = model.fit(train_m, max_steps=TRAIN_STEPS)
    fit_by_shape = {k: dict(launch_count(k).by_shape) for k in want_launches}
    del model._make_train_step
    check(len(steps) == TRAIN_STEPS and fit["steps"] == TRAIN_STEPS, (len(steps), fit))
    for i, s in enumerate(steps):
        got = {k: s["launches"].get(k, 0) for k in want_launches}
        check(got == want_launches, ("streaming step", i, "launches", got))
        check(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]), ("step", i, s))
        check(all(s["changed"].values()), ("streaming step", i, "unchanged", s["changed"]))
    check(_k2_keys_banded(fit_by_shape), ("K2 launches without the band", fit_by_shape))
    batch = steps[0]["batch"]
    t_enc = encoder_frames(model.cfg, [batch.audio.shape[1]])[0]
    check(t_enc >= enc.flash_attention_min_t, ("streaming T", t_enc))
    enc_lens = encoder_frames(model.cfg, batch.audio_lens.tolist())
    steady = steps[1:]
    out["fit"] = {
        "n_layers": enc.n_layers, "d_model": enc.d_model, "band": list(STREAMING_BAND),
        "remat": enc.remat, "batch": int(batch.audio.shape[0]), "encoder_t": t_enc,
        "params": sum(p.numel() for p in model.model.parameters()),
        "steps": [{k: v for k, v in s.items() if k != "batch"} for s in steps],
        "steady_step_s": sum(s["seconds"] for s in steady) / len(steady),
        "steady_audio_s_per_s": sum(s["audio_s"] for s in steady) / sum(
            s["seconds"] for s in steady),
        "launches_by_shape": {k: {str(sh): n for sh, n in d.items()}
                              for k, d in fit_by_shape.items()}}

    step = model._make_train_step(model._make_optimizer())
    out["fit"]["profile"] = _shares(_profile(
        lambda: step(batch), "profile_streaming", config="configs/conformer_ctc_bpe_streaming.yaml",
        batch=int(batch.audio.shape[0]), encoder_t=t_enc))
    model.model.eval()
    del step

    # 2. whole-utterance transcribe (K2 with the band), flash against dense
    with open(train_m, encoding="utf-8") as f:
        entries = [json.loads(line) for line in f][:STREAMING_TRANSCRIBE_FILES]
    files = [x["audio_filepath"] for x in entries]
    audio_s = sum(x["duration"] for x in entries)
    reset_launch_counts()
    texts, transcribe_s = _timed(lambda: model.transcribe(files, batch_size=BATCH))
    tr_by_shape, tr_total = {"K2-fwd": dict(fa.fwd_launches.by_shape)}, fa.fwd_launches.total
    check(tr_total == enc.n_layers * len(files) and _k2_keys_banded(tr_by_shape),
          ("whole-utterance K2-fwd", tr_by_shape))
    lp_flash = model.transcribe(files, batch_size=BATCH, logprobs=True)
    dense = ConformerCTC.from_config_file(
        STREAMING_CONFIG, overrides={**STREAMING_OVERRIDES,
                                     "model.encoder.use_flash_attention": False})
    dense.load_state_dict(model.state_dict())
    lp_dense = dense.transcribe(files, batch_size=BATCH, logprobs=True)
    del dense
    free_cuda()
    for a, b in zip(lp_flash, lp_dense):
        check(a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all(),
              ("log-probs", a.shape, b.shape))
    agree = lambda x, y: float(np.concatenate([a.argmax(-1) == b.argmax(-1)
                                               for a, b in zip(x, y)]).mean())
    agreement = agree(lp_flash, lp_dense)
    # The same weights in fp32, flash (the fp32 kernels) and dense. At this
    # cut depth a quarter of the random model's frames hold near-tied top
    # tokens (gap < 0.05), whose bf16 argmax either path's rounding flips
    # (on an H100 the bf16 flash and dense paths each agreed with fp32 on
    # 96.7-96.8%, with each other on 98.4%; at 18 layers all read 100%). So
    # the paths are held against each other in fp32, and each bf16 path to
    # the fp32 reference, the flash one no further than the dense one.
    ref = {}
    for name, use_flash in (("flash", "auto"), ("dense", False)):
        m = ConformerCTC.from_config_file(
            STREAMING_CONFIG, overrides={**STREAMING_OVERRIDES,
                                         "model.encoder.use_flash_attention": use_flash},
            seed=SEED + 1, dtype=torch.float32)
        m.load_state_dict(model.state_dict())
        before = fa.counter("fwd", torch.float32).total
        ref[name] = m.transcribe(files, batch_size=BATCH, logprobs=True)
        check((fa.counter("fwd", torch.float32).total > before) == (name == "flash"),
              ("the fp32 copy's path", name))
        del m
    free_cuda()
    agreement_fp32 = agree(ref["flash"], ref["dense"])
    to_ref = {"flash_bf16": agree(lp_flash, ref["dense"]),
              "dense_bf16": agree(lp_dense, ref["dense"])}
    check(agreement_fp32 >= ARGMAX_AGREEMENT_MIN, ("streaming flash vs dense argmax, fp32",
                                                   agreement_fp32))
    check(to_ref["flash_bf16"] >= to_ref["dense_bf16"] - (1.0 - ARGMAX_AGREEMENT_MIN),
          ("streaming bf16 flash further from the fp32 reference than dense", to_ref))
    out["transcribe"] = {
        "files": len(files), "audio_s": audio_s, "seconds": transcribe_s,
        "audio_s_per_s": audio_s / transcribe_s, "k2_fwd_launches": tr_total,
        "launches_by_shape": {str(k): n for k, n in tr_by_shape["K2-fwd"].items()},
        "argmax_agreement_vs_dense": agreement, "agreement_min": ARGMAX_AGREEMENT_MIN,
        "argmax_agreement_vs_dense_fp32": agreement_fp32,
        "argmax_agreement_with_fp32_dense": to_ref,
        "flash_vs_dense_max_abs_logprob": max(float(np.abs(a - b).max())
                                              for a, b in zip(lp_flash, lp_dense)),
        "sample_text": texts[0][:60]}

    # 3. buffered decode: the defaults twice (dense banded, no K2), a 24 s buffer (K2)
    reset_launch_counts()
    buf, buf_s = _timed(lambda: model.transcribe_buffered(files, **BUFFERED_DEFAULT))
    again, again_s = _timed(lambda: model.transcribe_buffered(files, **BUFFERED_DEFAULT))
    check(again == buf and all(isinstance(x, str) for x in buf), ("buffered texts", buf, again))
    check(fa.fwd_launches.total == 0, ("K2 launched at the 4 s buffer", fa.fwd_launches.total))
    reset_launch_counts()
    buf_k2, buf_k2_s = _timed(lambda: model.transcribe_buffered(files, **BUFFERED_FLASH))
    k2_by_shape = {"K2-fwd": dict(fa.fwd_launches.by_shape)}
    total = fa.fwd_launches.total
    check(total > 0 and total % enc.n_layers == 0 and _k2_keys_banded(k2_by_shape)
          and all(sh[1] == 600 for sh in k2_by_shape["K2-fwd"]),
          ("the 24 s buffer's K2-fwd", k2_by_shape))
    rate = lambda sec: {"seconds": sec, "audio_s_per_s": audio_s / sec}
    out["buffered"] = {
        "default": {**BUFFERED_DEFAULT, **rate(buf_s), "again": rate(again_s),
                    "k2_fwd_launches": 0, "sample_text": buf[0][:60]},
        "flash": {**BUFFERED_FLASH, **rate(buf_k2_s), "k2_fwd_launches": total,
                  "launches_by_shape": {str(k): n for k, n in k2_by_shape["K2-fwd"].items()},
                  "sample_text": buf_k2[0][:60]}}
    out["buffered"]["profile"] = _shares(_profile(
        lambda: model.transcribe_buffered(files[:1], **BUFFERED_DEFAULT), "profile_buffered",
        config="configs/conformer_ctc_bpe_streaming.yaml", files=1,
        audio_s=entries[0]["duration"], **BUFFERED_DEFAULT))

    # 4. the transducer's buffered decode, on the rnnt_train phase's archive
    with open(rnnt_manifest, encoding="utf-8") as f:
        r_entries = [json.loads(line) for line in f][:STREAMING_RNNT_FILES]
    r_entries = [{**x, "audio_filepath": _crop_wav(x["audio_filepath"], tmp, STREAMING_CLIP_S),
                  "duration": min(x["duration"], STREAMING_CLIP_S)} for x in r_entries]
    r_files = [x["audio_filepath"] for x in r_entries]
    rm, r_restore_s = _timed(lambda: ConformerTransducer.restore_portable(rnnt_archive,
                                                                          seed=SEED + 9))
    r_buf, r_buf_s = _timed(lambda: rm.transcribe_buffered(r_files, **BUFFERED_DEFAULT))
    r_again, r_again_s = _timed(lambda: rm.transcribe_buffered(r_files, **BUFFERED_DEFAULT))
    check(r_again == r_buf, ("transducer buffered texts", r_buf, r_again))
    r_audio_s = sum(x["duration"] for x in r_entries)
    out["buffered"]["transducer"] = {
        **BUFFERED_DEFAULT, "files": len(r_files), "audio_s": r_audio_s,
        "archive_restore_s": r_restore_s, "seconds": r_buf_s, "again_s": r_again_s,
        "audio_s_per_s": r_audio_s / r_buf_s, "max_symbols": rm.decoding.max_symbols,
        "tokens": [len(rm.tokenizer.text_to_ids(x)) for x in r_buf]}

    # 5. export: the streaming CTC model (banded K2-fwd inside), the transducer's two;
    # both cut to STREAMING_SERVE_LAYERS layers for this and the .nemo round trips
    serve = _depth_cut(ConformerCTC, STREAMING_CONFIG, STREAMING_OVERRIDES, model)
    r_serve = _depth_cut(ConformerTransducer, RNNT_CONFIG, RNNT_OVERRIDES, rm)
    n_serve = STREAMING_SERVE_LAYERS
    path = os.path.join(tmp, "streaming_export.tar.gz")
    _, export_s = _timed(lambda: serve.export(path, batch_size=EXPORT_BATCH,
                                              seconds=EXPORT_SECONDS))
    fns, load_s = _timed(lambda: load_exported(path))
    n = int(EXPORT_SECONDS * SR)
    wavs = [load_audio(p, target_sr=SR)[:n] for p in files[:EXPORT_BATCH]]
    wavs[-1] = wavs[-1][: n * 5 // 6]  # a padded row
    audio, lens = _pad_batch(wavs, EXPORT_BATCH)
    audio_t, lens_t = torch.from_numpy(audio).to(serve.device), torch.from_numpy(lens).to(
        serve.device)
    reset_launch_counts()
    lp_e, el_e = fns["forward"](audio_t, lens_t)
    torch.cuda.synchronize()
    e_by_shape, e_total = {"K2-fwd": dict(fa.fwd_launches.by_shape)}, fa.fwd_launches.total
    t_export = encoder_frames(model.cfg, [n])[0]
    check(e_total == n_serve and _k2_keys_banded(e_by_shape)
          and all(sh[:2] == (EXPORT_BATCH * enc.n_heads, t_export)
                  for sh in e_by_shape["K2-fwd"]),
          ("the exported program's K2-fwd", e_by_shape))
    lp_live, el_live = ctc_forward(serve.model, audio_t, lens_t)
    check(torch.equal(el_e, el_live), ("exported lengths", el_e, el_live))
    err, argmax_equal = 0.0, True
    for row, m_ in enumerate(el_live.tolist()):
        err = max(err, float((lp_e[row, :m_] - lp_live[row, :m_]).abs().max()))
        argmax_equal &= torch.equal(lp_e[row, :m_].argmax(-1), lp_live[row, :m_].argmax(-1))
    check(err <= EXPORT_LOGPROB_ATOL and argmax_equal, ("exported log-probs", err, argmax_equal))
    out["export"] = {"layers": n_serve,
                     "ctc": {"batch": EXPORT_BATCH, "seconds_of_audio": EXPORT_SECONDS,
                             "encoder_t": t_export, "archive_bytes": os.path.getsize(path),
                             "export_s": export_s, "load_s": load_s,
                             "k2_fwd_launches": e_total,
                             "launches_by_shape": {str(k): v for k, v in
                                                   e_by_shape["K2-fwd"].items()},
                             "logprob_max_abs_err": err, "tol": EXPORT_LOGPROB_ATOL,
                             "argmax_equal": argmax_equal}}
    del fns, lp_e, lp_live
    os.remove(path)
    r_audio, r_lens = _pad_batch([load_audio(p, target_sr=SR) for p in r_files], len(r_files))
    hyps = r_serve.transcribe(r_files, batch_size=len(r_files), return_hypotheses=True)
    r_path = os.path.join(tmp, "rnnt_export.tar.gz")
    _, r_export_s = _timed(lambda: r_serve.export(r_path, batch_size=len(r_files),
                                                  seconds=r_audio.shape[1] / SR))
    r_fns, r_load_s = _timed(lambda: load_exported(r_path))
    dcfg = r_serve.cfg.model.decoder
    tokens, greedy_s = _timed(lambda: _exported_greedy(
        r_fns, torch.from_numpy(r_audio).to(r_serve.device),
        torch.from_numpy(r_lens).to(r_serve.device), r_serve.cfg.model.blank_id,
        r_serve.decoding.max_symbols, dcfg.pred_rnn_layers, dcfg.pred_hidden))
    check(tokens == [h.y_sequence for h in hyps],
          ("the exported transducer's tokens differ from transcribe's",
           [len(x) for x in tokens], [len(h.y_sequence) for h in hyps]))
    out["export"]["transducer"] = {"files": len(r_files), "samples": int(r_audio.shape[1]),
                                   "archive_bytes": os.path.getsize(r_path),
                                   "export_s": r_export_s, "load_s": r_load_s,
                                   "greedy_s": greedy_s, "tokens": [len(x) for x in tokens]}
    del r_fns
    os.remove(r_path)

    # 6. .nemo loading: the streaming CTC model and a transducer whose joint has dropout
    nemo = _write_nemo(os.path.join(tmp, "streaming.nemo"), serve, TOKENIZER)
    cntpu = os.path.join(tmp, "streaming_from_nemo.cntpu")
    out["nemo"] = {"layers": n_serve,
                   "ctc": _nemo_round_trip(ConformerCTC, serve, nemo, cntpu, files)}
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        served = transcribe_speech.main(["--model", cntpu, "--audio", *files])
    print(said.getvalue(), end="", flush=True)
    check(served == serve.transcribe(files, batch_size=BATCH), ("transcribe_speech", served))
    check(r_serve.raw_cfg["model"]["joint"]["jointnet"]["dropout"] > 0
          and "joint.joint_net.2.weight" in r_serve.state_dict(), "the transducer's joint dropout")
    r_nemo = _write_nemo(os.path.join(tmp, "rnnt.nemo"), r_serve, TOKENIZER)
    r_cntpu = os.path.join(tmp, "rnnt_from_nemo.cntpu")
    out["nemo"]["transducer"] = _nemo_round_trip(ConformerTransducer, r_serve, r_nemo, r_cntpu,
                                                 r_files)
    for p in (nemo, cntpu, r_nemo, r_cntpu):
        os.remove(p)
    del serve, r_serve
    free_cuda()

    # 7. change_vocabulary to the 288-piece unigram model, then one step each
    es = SentencePieceTokenizer(LANG_MODELS["es"])
    before = {k: v.clone() for k, v in model.model.encoder.state_dict().items()}
    model.change_vocabulary(es)
    after = model.model.encoder.state_dict()
    check(all(torch.equal(before[k], after[k]) for k in before), "the encoder moved")
    check(model.model.decoder.decoder_layers[0].weight.shape[0] == es.vocab_size + 1 == 289,
          "the new CTC head")
    del before, after
    cv_steps: list = []
    model._make_train_step = _counted_steps(model, cv_steps)
    reset_launch_counts()
    model.fit(train_m, max_steps=1)
    k1 = {k: dict(launch_count(k).by_shape) for k in ("K1-fwd", "K1-bwd", "K1-bwd-grad")}
    del model._make_train_step
    check(len(cv_steps) == 1 and math.isfinite(cv_steps[0]["loss"])
          and all(sh[-1] == 289 for d in k1.values() for sh in d) and all(k1.values()),
          ("the step on the new vocabulary", cv_steps, k1))
    r_steps: list = []
    rm.change_vocabulary(es)
    rm._make_train_step = _counted_steps(rm, r_steps)
    reset_launch_counts()
    rm.fit(rnnt_manifest, max_steps=1)
    del rm._make_train_step
    k4 = dict(launch_count("K4-fwd").by_shape)
    want = rnnt_step_launches(rm, r_steps[0]["batch"])
    got = {k: r_steps[0]["launches"].get(k, 0) for k in want}
    check(got == want and math.isfinite(r_steps[0]["loss"])
          and all(sh[-1] == 289 for sh in k4), ("the transducer's step", got, want, k4))
    out["change_vocabulary"] = {
        "vocab_with_blank": 289,
        "ctc_step": {k: v for k, v in cv_steps[0].items() if k != "batch"},
        "ctc_k1_by_shape": {k: {str(sh): n for sh, n in d.items()} for k, d in k1.items()},
        "transducer_step": {k: v for k, v in r_steps[0].items() if k != "batch"},
        "transducer_k4_fwd_by_shape": {str(sh): n for sh, n in k4.items()}}
    out["phase_s"] = time.perf_counter() - t_phase
    emit("streaming", **out)
    del model, rm
    free_cuda()
    return {"by_shape": fit_by_shape, "t": t_enc,
            "lens": [n_ for n_ in enc_lens for _ in range(enc.n_heads)]}


def phase_bpe_step(tmp: str) -> None:
    """conformer_ctc_bpe.yaml trains through the dense attention (its
    dropout_att is 0.1) and the K1 kernels."""
    from conformer_nemo_tpu_torch.api import ConformerCTC
    from conformer_nemo_tpu_torch.ops.build import launch_counts, reset_launch_counts

    manifest = _write_manifest(tmp, "bpe_train", 16, 10.0, 16.0, np.random.RandomState(SEED + 2))
    model = ConformerCTC.from_config_file(CONFIG, overrides=TRAIN_OVERRIDES, seed=SEED)
    attn = model.model.encoder.layers[0].self_attn
    model.model.train()
    lens = torch.tensor([3000], device=model.device)
    check(not attn.use_flash(3000, lens), "training with dropout_att > 0 takes the dense path")
    model.model.eval()
    check(attn.use_flash(3000, lens), "eval mode takes the flash path at T >= 1024")
    steps: list = []
    model._make_train_step = _counted_steps(model, steps)
    reset_launch_counts()
    model.fit(manifest, max_steps=1)
    counts = launch_counts()
    check(all(counts.get(k, 0) == 1 for k in ("K1-fwd", "K1-bwd", "K1-bwd-grad")), counts)
    check(all(counts.get(k, 0) == 0 for k in ("K2-fwd", "K2-bwd-dq", "K2-bwd-dkv")), counts)
    s = steps[0]
    check(math.isfinite(s["loss"]) and all(s["changed"].values()), s["changed"])
    emit("bpe_step", config="configs/conformer_ctc_bpe.yaml",
         batch=int(s["batch"].audio.shape[0]),
         encoder_t=encoder_frames(model.cfg, [s["batch"].audio.shape[1]])[0],
         dropout_att=model.cfg.encoder.dropout_att, launches=counts, seconds=s["seconds"],
         audio_s_per_s=s["audio_s_per_s"], loss=s["loss"])
    del model
    free_cuda()


def _probe_step(model, batch, impl: str = "kernel") -> tuple:
    """One train step of `model` on `batch` through an optimizer that only
    captures the gradients (the weights stay). -> (loss, [fp32 gradient of
    each parameter])."""
    from conformer_nemo_tpu_torch.train.optim import Transformation
    from conformer_nemo_tpu_torch.train.trainer import init_ctc_state, make_ctc_train_step

    grads = []

    def capture(g, state, params):
        grads.extend(x.detach().float() for x in g)
        return [torch.zeros_like(x) for x in g], state

    probe = Transformation(lambda params: {}, capture)
    metrics = make_ctc_train_step(model.cfg, probe, ctc_impl=impl)(
        init_ctc_state(model.model, probe, seed=SEED), batch)
    return float(metrics["loss"]), grads


def _grad_cosine(g_a: list, g_b: list) -> tuple:
    """-> (cosine of the two gradients as one vector, |g_a|, |g_b|)."""
    dot = sum((a.double() * b.double()).sum() for a, b in zip(g_a, g_b)).item()
    na = math.sqrt(sum((a.double() ** 2).sum().item() for a in g_a))
    nb = math.sqrt(sum((b.double() ** 2).sum().item() for b in g_b))
    return dot / (na * nb), na, nb


def phase_train_parity(train_manifest: str) -> None:
    """One step through flash + K1 against dense + plain CTC: same weights,
    same batch, no dropout, SpecAugment or dither."""
    from conformer_nemo_tpu_torch.api import ConformerCTC

    quiet = {**TRAIN_OVERRIDES, **QUIET, "model.encoder.dropout_att": 0.0}
    kernel = ConformerCTC.from_config_file(LONGFORM, overrides=quiet, seed=SEED)
    plain = ConformerCTC.from_config_file(
        LONGFORM, overrides={**quiet, "model.encoder.use_flash_attention": False}, seed=SEED + 1)
    plain.load_state_dict(kernel.state_dict())
    batch = next(iter(kernel._loader(train_manifest, kernel.raw_cfg["model"]["train_ds"],
                                     shuffle=True)))
    loss_k, g_k = _probe_step(kernel, batch, "kernel")
    loss_p, g_p = _probe_step(plain, batch, "plain")
    names = [n for n, _ in kernel.model.named_parameters()]
    cosine, nk, np_ = _grad_cosine(g_k, g_p)
    rel = [((a - b).norm() / b.norm().clamp(min=1e-30)).item() for a, b in zip(g_k, g_p)]
    worst = int(np.argmax(rel))
    nonzero = [i for i, n in enumerate(names) if not n.endswith(ZERO_GRAD)]
    worst_nz = max(nonzero, key=lambda i: rel[i])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    check(math.isfinite(loss_k) and loss_rel <= PARITY_LOSS_REL, ("loss", loss_k, loss_p))
    check(cosine >= PARITY_GRAD_COSINE, ("gradient cosine", cosine))
    emit("train_parity", config="configs/conformer_ctc_bpe_longform.yaml",
         loss_kernel=loss_k, loss_plain=loss_p, loss_rel_err=loss_rel,
         tol_loss_rel=PARITY_LOSS_REL, grad_cosine=cosine, min_cosine=PARITY_GRAD_COSINE,
         grad_norm_kernel=nk, grad_norm_plain=np_, max_tensor_rel_err=rel[worst],
         max_tensor=names[worst], max_tensor_rel_err_nonzero_grad=rel[worst_nz],
         max_tensor_nonzero_grad=names[worst_nz], median_tensor_rel_err=float(np.median(rel)))
    del kernel, plain, g_k, g_p
    free_cuda()


# ---------------------------------------------------------------------------
# widths: K2 at Small's and XLarge's heads, and in fp16 and fp32
# ---------------------------------------------------------------------------


def _flash_dense_pair(config: str, overrides: dict, dtype, seed: int = SEED) -> tuple:
    """Two models of `config` with the same weights, in `dtype`, under the
    quiet settings: flash where "auto" takes it (T >= 1024), and the dense
    attention."""
    from conformer_nemo_tpu_torch.api import ConformerCTC

    quiet = {**overrides, **QUIET}
    flash = ConformerCTC.from_config_file(
        config, overrides={**quiet, "model.encoder.use_flash_attention": "auto"}, seed=seed,
        dtype=dtype)
    dense = ConformerCTC.from_config_file(
        config, overrides={**quiet, "model.encoder.use_flash_attention": False}, seed=seed + 1,
        dtype=dtype)
    dense.load_state_dict(flash.state_dict())
    return flash, dense


def _step_parity(flash, dense, batch, what: str) -> dict:
    """One probe step of each model on `batch` (K1 on both): the loss within
    WIDE_LOSS_REL and the gradients' cosine at least WIDE_GRAD_COSINE; the
    flash step launched K2's backward once a layer."""
    from conformer_nemo_tpu_torch.ops import flash_attention as fa

    dq = fa.counter("dq", flash.cfg.encoder.dtype)
    before = dq.total
    loss_f, g_f = _probe_step(flash, batch)
    check(dq.total - before == flash.cfg.encoder.n_layers, (what, "dQ launches", dq.total - before))
    loss_d, g_d = _probe_step(dense, batch)
    cosine, nf, nd = _grad_cosine(g_f, g_d)
    loss_rel = abs(loss_f - loss_d) / abs(loss_d)
    out = {"loss_flash": loss_f, "loss_dense": loss_d, "loss_rel_err": loss_rel,
           "tol_loss_rel": WIDE_LOSS_REL, "grad_cosine": cosine, "min_cosine": WIDE_GRAD_COSINE,
           "grad_norm_flash": nf, "grad_norm_dense": nd,
           "grads_finite": all(bool(torch.isfinite(g).all()) for g in g_f)}
    check(math.isfinite(loss_f) and loss_rel <= WIDE_LOSS_REL and out["grads_finite"],
          (what, "flash against dense: loss", out))
    check(cosine >= WIDE_GRAD_COSINE, (what, "flash against dense: gradient cosine", out))
    return out


def _transcribe_agreement(flash, dense, files: list, what: str, hold: bool = True) -> dict:
    """Log-probs of `files` through both models (one file a batch): finite,
    normalised, the same shapes, and (with `hold`) argmax agreement >=
    ARGMAX_AGREEMENT_MIN."""
    lp_f = flash.transcribe(files, batch_size=1, logprobs=True)
    lp_d = dense.transcribe(files, batch_size=1, logprobs=True)
    for a, b in zip(lp_f, lp_d):
        check(a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all(),
              (what, "log-probs", a.shape, b.shape))
        check(np.abs(np.exp(a.astype(np.float64)).sum(-1) - 1.0).max() < 1e-2,
              (what, "log-probs do not normalise"))
    agreement = float(np.concatenate([a.argmax(-1) == b.argmax(-1)
                                      for a, b in zip(lp_f, lp_d)]).mean())
    check(agreement >= ARGMAX_AGREEMENT_MIN or not hold, (what, "argmax agreement", agreement))
    return {"frames": [int(a.shape[0]) for a in lp_f], "argmax_agreement": agreement,
            "max_abs_logprob_diff": max(float(np.abs(a - b).max()) for a, b in zip(lp_f, lp_d))}


def _widths_fit(model, manifest: str, steps_n: int, want: dict, what: str) -> dict:
    """`model.fit` for steps_n steps, each step's launches as `want`, finite
    losses and gradient norms, changed parameters. -> the steps (their
    batches kept) and the steady step."""
    steps: list = []
    model._make_train_step = _counted_steps(model, steps)
    fit = model.fit(manifest, max_steps=steps_n)
    del model._make_train_step
    check(len(steps) == steps_n and fit["steps"] == steps_n, (what, len(steps), fit))
    for i, st in enumerate(steps):
        got = {k: st["launches"].get(k, 0) for k in want}
        check(got == want, (what, "step", i, "launches", got, "want", want))
        check(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]), (what, i, st["loss"]))
        check(all(st["changed"].values()), (what, "step", i, "unchanged", st["changed"]))
    steady = steps[1:] or steps
    return {"steps": steps, "steady_step_s": sum(x["seconds"] for x in steady) / len(steady),
            "losses": [x["loss"] for x in steps]}


def phase_widths(tmp: str, train_manifest: str, gpu: str) -> dict:
    """K2 at every head width and dtype the JAX package runs, through the
    API at full width: Conformer-CTC Small (d1 220, dv 44, padded on the
    card) transcribes a 60 s file through flash ("auto") against a flash-off
    copy and fits SMALL_STEPS steps with flash forced; the XLarge widths (d1
    1152, dv 128), at WIDE_LAYERS layers: a flash step against a dense one
    at the initial weights, WIDE_STEPS fit steps at batch 4 x 60 s through
    flash ("auto"), a file transcribed against the dense copy; the long-form
    Large model at DTYPE_LAYERS layers in fp16 and in fp32: the same
    comparisons and one fit step on the train phase's batch. -> K2's
    launches by kernel and shape over the phase, and the calls its fits made
    (the kernels phase's `widths` rows)."""
    from conformer_nemo_tpu_torch.api import ConformerCTC
    from conformer_nemo_tpu_torch.ops import flash_attention as fa
    from conformer_nemo_tpu_torch.ops.build import launch_count, reset_launch_counts

    t_phase = time.perf_counter()
    k2 = [fa.counter(k, dt).name for dt in fa.KERNELS for k in ("fwd", "dq", "dkv")]
    by_shape: dict = {k: {} for k in k2}

    def collect():
        for k in k2:
            for sh, n in launch_count(k).by_shape.items():
                by_shape[k][sh] = by_shape[k].get(sh, 0) + n
        reset_launch_counts()

    manifest = _write_manifest(tmp, "widths", WIDTHS_FILES, WIDTHS_SECONDS, WIDTHS_SECONDS,
                               np.random.RandomState(SEED + 21))
    with open(manifest, encoding="utf-8") as f:
        files = [json.loads(line)["audio_filepath"] for line in f]
    out: dict = {"gpu": gpu}
    calls: dict = {}

    def fit_call(name, model, fit, dtype):
        """The first fit step's K2 call: (bh, t, d1, dv, per-head lens, dtype)."""
        enc, batch = model.cfg.encoder, fit["steps"][0]["batch"]
        t = encoder_frames(model.cfg, [batch.audio.shape[1]])[0]
        lens = [n for n in encoder_frames(model.cfg, batch.audio_lens.tolist())
                for _ in range(enc.n_heads)]
        calls[name] = (len(lens), t, enc.d_head + enc.d_model, enc.d_head, lens, dtype)

    # 1. Small: d1 220, dv 44 (not multiples of 8)
    reset_launch_counts()
    small = ConformerCTC.from_config_file(CONFIG, overrides=SMALL_OVERRIDES, seed=SEED)
    enc = small.cfg.encoder
    check((enc.d_model, enc.n_heads, enc.d_head + enc.d_model, enc.d_head) == (176, 4, 220, 44),
          ("Small's widths", enc))
    off = ConformerCTC.from_config_file(
        CONFIG, overrides={**SMALL_OVERRIDES, "model.encoder.use_flash_attention": False},
        seed=SEED + 1)
    off.load_state_dict(small.state_dict())
    t0 = time.perf_counter()
    agree = _transcribe_agreement(small, off, files[:1], "small")
    check(fa.fwd_launches.total == enc.n_layers and agree["frames"][0] >= 1024,
          ("small: K2-fwd at T", agree["frames"], fa.fwd_launches.total))
    collect()
    out["small"] = {"config": "configs/conformer_ctc_bpe.yaml", "d_model": 176, "n_heads": 4,
                    "n_layers": enc.n_layers, "d1": 220, "dv": 44,
                    "params": sum(p.numel() for p in small.model.parameters()),
                    "transcribe": agree, "transcribe_pair_s": time.perf_counter() - t0}
    del small, off
    fit_model = ConformerCTC.from_config_file(
        CONFIG, overrides={**SMALL_OVERRIDES, **SMALL_FIT}, seed=SEED)
    fit = _widths_fit(fit_model, manifest, SMALL_STEPS,
                      per_step_launches(enc.n_layers, remat=False), "small fit")
    fit_call("small", fit_model, fit, torch.bfloat16)
    collect()
    out["small"].update(fit_losses=fit["losses"], fit_steady_step_s=fit["steady_step_s"],
                        fit_batch=int(fit["steps"][0]["batch"].audio.shape[0]))
    del fit_model, fit
    free_cuda()

    # 2. XLarge's widths: d1 1152, dv 128, at WIDE_LAYERS layers
    flash, dense = _flash_dense_pair(CONFIG, WIDE_OVERRIDES, torch.bfloat16)
    enc = flash.cfg.encoder
    check((enc.d_model, enc.n_heads, enc.d_head + enc.d_model, enc.d_head, enc.d_ff,
           enc.conv_kernel_size) == (1024, 8, 1152, 128, 4096, 31), ("XLarge's widths", enc))
    batch = next(iter(flash._loader(manifest, flash.raw_cfg["model"]["train_ds"], shuffle=True)))
    parity = _step_parity(flash, dense, batch, "xlarge")
    # reported, not held: at these widths the dense path's bf16 scores move
    # near-tied argmaxes of the random model (0.975 on an H100, where the
    # same pair's gradients read a cosine of 0.999997)
    agree = _transcribe_agreement(flash, dense, files[:1], "xlarge", hold=False)
    collect()
    del dense
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    fit = _widths_fit(flash, manifest, WIDE_STEPS,
                      per_step_launches(WIDE_LAYERS, remat=False), "xlarge fit")
    fit_call("xlarge", flash, fit, torch.bfloat16)
    collect()
    out["xlarge"] = {"config": "configs/conformer_ctc_bpe.yaml", "d_model": 1024, "n_heads": 8,
                     "n_layers": WIDE_LAYERS, "of_layers": 24, "d1": 1152, "dv": 128,
                     "params": sum(p.numel() for p in flash.model.parameters()),
                     "parity": parity, "transcribe": agree, "fit_losses": fit["losses"],
                     "fit_steady_step_s": fit["steady_step_s"],
                     "fit_audio_s_per_s": [x["audio_s_per_s"] for x in fit["steps"]],
                     "fit_batch": int(fit["steps"][0]["batch"].audio.shape[0]),
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del flash, fit
    free_cuda()

    # 3. the long-form Large model in fp16 and in fp32 (the flagship shapes)
    for dtype in (torch.float16, torch.float32):
        name = str(dtype).split(".")[-1]
        suffix = "-" + fa.KERNELS[dtype][2]
        flash, dense = _flash_dense_pair(
            LONGFORM, {**TRAIN_OVERRIDES, "model.encoder.n_layers": DTYPE_LAYERS}, dtype)
        batch = next(iter(flash._loader(train_manifest, flash.raw_cfg["model"]["train_ds"],
                                        shuffle=True)))
        parity = _step_parity(flash, dense, batch, name)
        agree = _transcribe_agreement(flash, dense, files[:1], name)
        collect()
        del dense
        free_cuda()
        fit = _widths_fit(flash, train_manifest, 1,
                          per_step_launches(DTYPE_LAYERS, remat=True, suffix=suffix), name)
        fit_call(name, flash, fit, dtype)
        collect()
        out[name] = {"config": "configs/conformer_ctc_bpe_longform.yaml", "dtype": str(dtype),
                     "n_layers": DTYPE_LAYERS, "parity": parity, "transcribe": agree,
                     "fit_loss": fit["losses"][0], "fit_step_s": fit["steps"][0]["seconds"],
                     "fit_batch": int(fit["steps"][0]["batch"].audio.shape[0])}
        del flash, fit
        free_cuda()
    check(all(by_shape[k] for k in k2), ("a K2 kernel did not launch in the widths phase",
                                         {k: len(v) for k, v in by_shape.items()}))
    emit("widths", seconds=time.perf_counter() - t_phase,
         launches_by_shape={k: {str(sh): n for sh, n in d.items()} for k, d in by_shape.items()},
         **out)
    return {"by_shape": by_shape, "calls": calls}


# ---------------------------------------------------------------------------
# transducer training
# ---------------------------------------------------------------------------


def _frames(model, samples) -> list:
    """Encoder frames of a transducer model for each sample count."""
    return encoder_frames(types.SimpleNamespace(encoder=model.cfg.model.encoder,
                                                preprocessor=model.cfg.preprocessor), samples)


def rnnt_step_launches(model, batch) -> dict:
    """Launches per kernel of one flash-joint train step on this batch: one
    K4-bwd and one K4-bwd-dw per window of the B * T * U1 cells (K4's names
    in the joint's dtype)."""
    from conformer_nemo_tpu_torch.ops.rnnt_joint import bwd_windows

    from conformer_nemo_tpu_torch.ops.rnnt_joint import counter

    cfg = model.cfg.model
    dt = cfg.joint.dtype
    b, samples = batch.audio.shape
    cells = b * _frames(model, [samples])[0] * (batch.tokens.shape[1] + 1)  # B * T * U1
    _, n_win = bwd_windows(cells, cfg.joint.joint_hidden, cfg.num_classes_with_blank, dtype=dt)
    k4 = {counter(k, dt).name: n for k, n in (("fwd", 1), ("cells", n_win), ("sums", n_win),
                                               ("reduce", 1))}
    return {"K3-alpha": 1, "K3-beta": 1, **k4, **{k: 0 for k in NOT_RNNT}}


def phase_rnnt_train(tmp: str, gpu: str) -> dict:
    from conformer_nemo_tpu_torch.api import ConformerTransducer
    from conformer_nemo_tpu_torch.ops.build import launch_count, reset_launch_counts

    manifest = _write_manifest(tmp, "rnnt_train", 16, 10.0, 16.0,
                               np.random.RandomState(SEED + 3))
    model = ConformerTransducer.from_config_file(RNNT_CONFIG, overrides=RNNT_OVERRIDES,
                                                 seed=SEED)
    cfg = model.cfg.model
    steps: list = []
    model._make_train_step = _counted_steps(model, steps)
    reset_launch_counts()
    out = model.fit(manifest, max_steps=TRAIN_STEPS)
    by_shape = {k: dict(launch_count(k).by_shape) for k in RNNT_KERNELS}
    del model._make_train_step
    check(len(steps) == TRAIN_STEPS and out["steps"] == TRAIN_STEPS, (len(steps), out))
    check(not model.model.training, "the model is in eval mode after fit")
    for i, s in enumerate(steps):
        got = {k: s["launches"].get(k, 0) for k in RNNT_KERNELS + NOT_RNNT}
        want = rnnt_step_launches(model, s["batch"])
        s["windows"] = want["K4-bwd"]
        check(got == want, ("rnnt step", i, "launches", got, "want", want))
        check(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]), ("step", i, s["loss"]))
        check(all(s["changed"].values()), ("rnnt step", i, "unchanged", s["changed"]))
    batch = steps[0]["batch"]
    t_enc = _frames(model, [batch.audio.shape[1]])[0]
    enc_lens = _frames(model, batch.audio_lens.tolist())
    with open(manifest, encoding="utf-8") as f:
        entries = [json.loads(line) for line in f][:RNNT_TRANSCRIBE_FILES]
    entries = [{**x, "audio_filepath": _crop_wav(x["audio_filepath"], tmp, DECODE_CLIP_S),
                "duration": min(x["duration"], DECODE_CLIP_S)} for x in entries]
    wavs = [x["audio_filepath"] for x in entries]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = model.transcribe(wavs, batch_size=RNNT_TRANSCRIBE_FILES)
    torch.cuda.synchronize()
    transcribe_s = time.perf_counter() - t0
    check(len(texts) == len(wavs) and all(isinstance(x, str) for x in texts), texts)
    # the traced step follows the fit and the transcribe; the archive round
    # trip's host work and cache release come after it
    step = model._make_train_step(model._make_optimizer())
    _profile(lambda: step(batch), "profile_rnnt", config="configs/conformer_transducer_bpe.yaml",
             batch=int(batch.audio.shape[0]), encoder_t=t_enc)
    model.model.eval()
    del step
    portable = _rnnt_round_trip(model, os.path.join(tmp, "rnnt.cntpu"), wavs)
    steady = steps[1:]
    emit("rnnt_train", config="configs/conformer_transducer_bpe.yaml",
         overrides={k: v for k, v in RNNT_OVERRIDES.items() if "tokenizer" not in k},
         n_layers=cfg.encoder.n_layers, d_model=cfg.encoder.d_model,
         pred_hidden=cfg.decoder.pred_hidden, joint_hidden=cfg.joint.joint_hidden,
         vocab_with_blank=cfg.num_classes_with_blank, batch=int(batch.audio.shape[0]),
         encoder_t=t_enc, u_cap=int(batch.tokens.shape[1]),
         params=sum(p.numel() for p in model.model.parameters()), gpu=gpu,
         steps=[{k: v for k, v in s.items() if k != "batch"} for s in steps],
         steady_step_s=sum(s["seconds"] for s in steady) / len(steady),
         steady_audio_s_per_s=sum(s["audio_s"] for s in steady) / sum(
             s["seconds"] for s in steady),
         launches_by_shape={k: {str(sh): n for sh, n in v.items()} for k, v in by_shape.items()},
         transcribe_files=len(wavs), transcribe_s=transcribe_s,
         transcribe_audio_s=sum(x["duration"] for x in entries), sample_text=texts[0][:80],
         portable=portable)
    info = {"by_shape": by_shape, "t": t_enc, "enc_lens": enc_lens, "tokens": batch.tokens,
            "token_lens": batch.token_lens.tolist(), "manifest": manifest,
            "h": cfg.joint.joint_hidden, "v": cfg.num_classes_with_blank,
            "archive": os.path.join(tmp, "rnnt.cntpu")}
    del model
    free_cuda()
    return info


def _same_but_forget_chunk(model, restored) -> tuple:
    """A transducer and its restore from an archive: every tensor bit for
    bit but the LSTM forget chunk b, which travels as b - c (c =
    forget_gate_bias). -> (tensors bit for bit, tensors that differ
    otherwise, the forget chunk's largest error in ulps of max(|b|, |b - c|))."""
    dcfg = model.cfg.model.decoder
    h, c = dcfg.pred_hidden, float(dcfg.forget_gate_bias)
    sa, sr = model.state_dict(), restored.state_dict()
    check(sa.keys() == sr.keys(), "the restored transducer's keys differ")
    bitwise, differ, chunk_ulps = 0, [], 0.0
    for k in sa:
        if torch.equal(sa[k], sr[k]):
            bitwise += 1
            continue
        rest = torch.ones_like(sa[k], dtype=torch.bool)
        rest[h: 2 * h] = False
        if ".dec_rnn.lstm.bias_ih_l" not in k or not torch.equal(sa[k][rest], sr[k][rest]):
            differ.append(k)
            continue
        b, back = sa[k][h: 2 * h].float(), sr[k][h: 2 * h].float()
        ulp = torch.finfo(torch.float32).eps * torch.maximum(b.abs(), (b - c).abs())
        chunk_ulps = max(chunk_ulps, float(((back - b).abs() / ulp.clamp(min=1e-45)).max()))
    return bitwise, differ, chunk_ulps


def _rnnt_round_trip(model, archive: str, wavs: list) -> dict:
    """save_portable and restore_portable of the trained transducer: every
    tensor bit for bit but the LSTM forget chunk b, which travels as b - c
    (c = forget_gate_bias) and is held within one ulp of max(|b|, |b - c|);
    the same greedy texts of `wavs`. The archive stays for the decode phase."""
    from conformer_nemo_tpu_torch.api import ConformerTransducer

    texts = model.transcribe(wavs, batch_size=len(wavs))
    _, save_s = _timed(lambda: model.save_portable(archive,
                                                   artifacts={"tokenizer_model": TOKENIZER}))
    restored, restore_s = _timed(lambda: ConformerTransducer.restore_portable(archive,
                                                                             seed=SEED + 9))
    bitwise, differ, chunk_ulps = _same_but_forget_chunk(model, restored)
    check(not differ and chunk_ulps <= 1.0, ("the restored transducer differs", differ,
                                             chunk_ulps))
    texts_r = restored.transcribe(wavs, batch_size=len(wavs))
    check(texts_r == texts, ("the restored transducer transcribes otherwise", texts_r, texts))
    out = {"archive_save_s": save_s, "archive_restore_s": restore_s,
           "archive_bytes": os.path.getsize(archive), "forget_chunk_max_ulps": chunk_ulps,
           "bitwise_tensors": bitwise, "tensors": len(model.state_dict())}
    del restored
    free_cuda()
    return out


def phase_rnnt_dense_step(manifest: str) -> None:
    """joint_impl auto at this batch resolves to the dense joint: K3
    launches, no K4 launch, in each of two steps (the first pays the
    warm-up, the second is the steady step)."""
    from conformer_nemo_tpu_torch.api import ConformerTransducer
    from conformer_nemo_tpu_torch.ops.build import reset_launch_counts

    model = ConformerTransducer.from_config_file(RNNT_CONFIG, overrides={
        **TRAIN_OVERRIDES, "model.encoder.n_layers": RNNT_LAYERS}, seed=SEED)
    steps: list = []
    model._make_train_step = _counted_steps(model, steps)
    reset_launch_counts()
    model.fit(manifest, max_steps=2)
    b, samples = steps[0]["batch"].audio.shape
    t = _frames(model, [samples])[0]
    u1 = steps[0]["batch"].tokens.shape[1] + 1
    resolved = model.cfg.model.resolve_joint_impl(b, t, u1, "cuda")
    check(resolved == "dense", ("auto resolved to", resolved))
    check(len(steps) == 2, len(steps))
    for i, s in enumerate(steps):
        counts = s["launches"]
        check(counts.get("K3-alpha", 0) == 1 and counts.get("K3-beta", 0) == 1, (i, counts))
        check(all(counts.get(k, 0) == 0 for k in ("K4-fwd", "K4-bwd", "K4-bwd-dw", "K4-bwd-reduce",
                                                  "K2-fwd", "K2-bwd-dq", "K2-bwd-dkv")),
              (i, counts))
        check(math.isfinite(s["loss"]) and all(s["changed"].values()), (i, s["changed"]))
    emit("rnnt_dense_step", config="configs/conformer_transducer_bpe.yaml", joint_impl="auto",
         resolved=resolved, dense_bytes_estimate=3 * 2 * b * t * u1 * model.cfg.model.num_classes_with_blank,
         batch=b, encoder_t=t, u1=u1,
         steps=[{k: s[k] for k in ("seconds", "audio_s_per_s", "loss", "launches")} for s in steps],
         seconds=steps[1]["seconds"], audio_s_per_s=steps[1]["audio_s_per_s"])
    del model
    free_cuda()


def phase_rnnt_parity(manifest: str) -> None:
    """One step through K4 + K3 against one through the dense joint and the
    plain lattice: same weights, same batch, no dropout, SpecAugment or dither."""
    from conformer_nemo_tpu_torch.api import ConformerTransducer
    from conformer_nemo_tpu_torch.train.optim import Transformation
    from conformer_nemo_tpu_torch.train.rnnt_trainer import init_rnnt_state, make_rnnt_train_step

    quiet = {**TRAIN_OVERRIDES, "model.encoder.dropout": 0.0, "model.encoder.dropout_att": 0.0,
             "model.encoder.dropout_emb": 0.0, "model.decoder.prednet.dropout": 0.0,
             "model.joint.jointnet.dropout": 0.0, "model.spec_augment.freq_masks": 0,
             "model.spec_augment.time_masks": 0, "model.spec_augment.specshot_ratio": 0.0,
             "model.preprocessor.dither": 0.0, "model.encoder.n_layers": RNNT_LAYERS}
    kernel = ConformerTransducer.from_config_file(
        RNNT_CONFIG, overrides={**quiet, "model.joint.joint_impl": "flash"}, seed=SEED)
    plain = ConformerTransducer.from_config_file(
        RNNT_CONFIG, overrides={**quiet, "model.joint.joint_impl": "dense"}, seed=SEED + 1)
    plain.load_state_dict(kernel.state_dict())
    plain.model.cfg = dataclasses.replace(plain.model.cfg, lattice_impl="plain")
    batch = next(iter(kernel._loader(manifest, kernel.raw_cfg["model"]["train_ds"],
                                     shuffle=True)))

    def run(m):
        grads = []

        def capture(g, state, params):
            grads.extend(x.detach().float() for x in g)
            return [torch.zeros_like(x) for x in g], state

        probe = Transformation(lambda params: {}, capture)
        metrics = make_rnnt_train_step(m.cfg, probe)(init_rnnt_state(m.model, probe, seed=SEED),
                                                     batch)
        return float(metrics["loss"]), grads

    loss_k, g_k = run(kernel)
    loss_p, g_p = run(plain)
    names = [n for n, _ in kernel.model.named_parameters()]
    dot = sum((a.double() * b.double()).sum() for a, b in zip(g_k, g_p)).item()
    nk = math.sqrt(sum((a.double() ** 2).sum().item() for a in g_k))
    np_ = math.sqrt(sum((b.double() ** 2).sum().item() for b in g_p))
    cosine = dot / (nk * np_)
    rel = [((a - b).norm() / b.norm().clamp(min=1e-30)).item() for a, b in zip(g_k, g_p)]
    worst = int(np.argmax(rel))
    nonzero = [i for i, n in enumerate(names) if not n.endswith(ZERO_GRAD)]
    worst_nz = max(nonzero, key=lambda i: rel[i])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    check(math.isfinite(loss_k) and loss_rel <= PARITY_LOSS_REL, ("rnnt loss", loss_k, loss_p))
    check(cosine >= PARITY_GRAD_COSINE, ("rnnt gradient cosine", cosine))
    emit("rnnt_parity", config="configs/conformer_transducer_bpe.yaml",
         batch=int(batch.audio.shape[0]), loss_kernel=loss_k, loss_plain=loss_p,
         loss_rel_err=loss_rel, tol_loss_rel=PARITY_LOSS_REL, grad_cosine=cosine,
         min_cosine=PARITY_GRAD_COSINE, grad_norm_kernel=nk, grad_norm_plain=np_,
         max_tensor_rel_err=rel[worst], max_tensor=names[worst],
         max_tensor_rel_err_nonzero_grad=rel[worst_nz], max_tensor_nonzero_grad=names[worst_nz],
         median_tensor_rel_err=float(np.median(rel)))
    del kernel, plain, g_k, g_p
    free_cuda()


# ---------------------------------------------------------------------------
# joints: K4 in fp16 and fp32, and at joint widths 1024 and 600
# ---------------------------------------------------------------------------


def _rnnt_probe(model, batch) -> tuple:
    """One train step of a transducer on `batch` through an optimizer that
    only captures the gradients (the weights stay). -> (loss, [fp32 gradient
    of each parameter])."""
    from conformer_nemo_tpu_torch.train.optim import Transformation
    from conformer_nemo_tpu_torch.train.rnnt_trainer import init_rnnt_state, make_rnnt_train_step

    grads: list = []

    def capture(g, state, params):
        grads.extend(x.detach().float() for x in g)
        return [torch.zeros_like(x) for x in g], state

    probe = Transformation(lambda params: {}, capture)
    metrics = make_rnnt_train_step(model.cfg, probe)(
        init_rnnt_state(model.model, probe, seed=SEED), batch)
    return float(metrics["loss"]), grads


def _joint_flash_dense(overrides: dict, dtype, impl: str = "flash") -> tuple:
    """Two transducers of RNNT_CONFIG with the same weights in `dtype`, under
    the quiet settings: the joint `impl` ("flash", or "auto" where it
    resolves to flash) and the dense joint."""
    from conformer_nemo_tpu_torch.api import ConformerTransducer

    quiet = {**RNNT_OVERRIDES, **JOINTS_QUIET, **overrides}
    flash = ConformerTransducer.from_config_file(
        RNNT_CONFIG, overrides={**quiet, "model.joint.joint_impl": impl}, seed=SEED, dtype=dtype)
    dense = ConformerTransducer.from_config_file(
        RNNT_CONFIG, overrides={**quiet, "model.joint.joint_impl": "dense"}, seed=SEED + 1,
        dtype=dtype)
    dense.load_state_dict(flash.state_dict())
    return flash, dense


def _joint_step_parity(flash, dense, batch, what: str) -> dict:
    """One probe step of each model on `batch`: the flash one launched
    K4-fwd (in its dtype's name) once, the loss within WIDE_LOSS_REL and the
    gradients' cosine at least WIDE_GRAD_COSINE."""
    from conformer_nemo_tpu_torch.ops import rnnt_joint as jt

    fwd = jt.counter("fwd", flash.cfg.model.joint.dtype)
    before = fwd.total
    loss_f, g_f = _rnnt_probe(flash, batch)
    check(fwd.total - before == 1, (what, fwd.name, "launches", fwd.total - before))
    loss_d, g_d = _rnnt_probe(dense, batch)
    cosine, nf, nd = _grad_cosine(g_f, g_d)
    loss_rel = abs(loss_f - loss_d) / abs(loss_d)
    out = {"loss_flash": loss_f, "loss_dense": loss_d, "loss_rel_err": loss_rel,
           "tol_loss_rel": WIDE_LOSS_REL, "grad_cosine": cosine, "min_cosine": WIDE_GRAD_COSINE,
           "grad_norm_flash": nf, "grad_norm_dense": nd,
           "grads_finite": all(bool(torch.isfinite(g).all()) for g in g_f)}
    check(math.isfinite(loss_f) and loss_rel <= WIDE_LOSS_REL and out["grads_finite"],
          (what, "flash joint against dense: loss", out))
    check(cosine >= WIDE_GRAD_COSINE, (what, "flash joint against dense: gradient cosine", out))
    return out


def _joint_fit_step(model, manifest: str, what: str) -> dict:
    """One `fit` step through the flash joint: the launches of
    `rnnt_step_launches` in the model's dtype, a finite loss and gradient
    norm, changed parameters."""
    steps: list = []
    model._make_train_step = _counted_steps(model, steps)
    fit = model.fit(manifest, max_steps=1)
    del model._make_train_step
    check(len(steps) == 1 and fit["steps"] == 1, (what, len(steps), fit))
    st = steps[0]
    want = rnnt_step_launches(model, st["batch"])
    got = {k: st["launches"].get(k, 0) for k in want}
    check(got == want, (what, "fit step launches", got, "want", want))
    check(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]), (what, st["loss"]))
    check(all(st["changed"].values()), (what, "unchanged", st["changed"]))
    return {"loss": st["loss"], "seconds": st["seconds"], "audio_s_per_s": st["audio_s_per_s"],
            "batch": st["batch"]}


def _serve_first_step(model, audio: np.ndarray, lens: np.ndarray) -> tuple:
    """The serving path's first values: the encoder output [B, T, D] and the
    joint's logits at the first decode step (frame 0, the prediction network
    at its start state), in fp32 on the CPU."""
    from conformer_nemo_tpu_torch.models.conformer import _linear

    m = model.model
    with torch.no_grad():
        enc, _ = model._encode(audio, lens)
        b, dev, dt = enc.shape[0], enc.device, m.joint.cfg.dtype
        g, _ = m.decoder.step(torch.full((b,), m.cfg.blank_id, dtype=torch.int64, device=dev),
                              m.decoder.zero_state(b, dev))
        logits = m.joint.combine(_linear(m.joint.enc, enc[:, 0], dt)
                                 + _linear(m.joint.pred, g, dt))
    return enc.float().cpu(), logits.float().cpu()


def _serve_card_vs_cpu(model, overrides: dict, wavs: list) -> dict:
    """The fp32 model's encoder output and first-step joint logits on the
    card (cuDNN's TF32 off; the matmul's is off by default) against the same
    weights on the CPU, within JOINT_CARD_CPU_REL of the CPU's largest
    entry; with TF32 on in both (cuDNN's default) the encoder output must
    fall outside it (the control; cuDNN's TF32 alone moved it 1.4e-4 of its
    largest entry on an H100, too near the limit to fail it reliably)."""
    from conformer_nemo_tpu_torch.api import ConformerTransducer
    from conformer_nemo_tpu_torch.data.audio_io import load_audio

    cpu = ConformerTransducer.from_config_file(RNNT_CONFIG, overrides={
        **RNNT_OVERRIDES, **JOINTS_QUIET, **overrides}, seed=SEED + 7, device="cpu",
        dtype=torch.float32)
    cpu.load_state_dict(model.state_dict())
    waves = [load_audio(p, target_sr=SR) for p in wavs]
    lens = np.array([len(w) for w in waves], np.int32)
    audio = np.zeros((len(waves), int(lens.max())), np.float32)
    for i, w in enumerate(waves):
        audio[i, : len(w)] = w
    want_enc, want_logits = _serve_first_step(cpu, audio, lens)
    rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        enc, logits = _serve_first_step(model, audio, lens)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            tf32_enc, tf32_logits = _serve_first_step(model, audio, lens)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    out = {"files": len(wavs), "encoder_t": int(enc.shape[1]),
           "encoder_card_vs_cpu_rel": rel(enc, want_enc),
           "logits_card_vs_cpu_rel": rel(logits, want_logits),
           "encoder_tf32_vs_cpu_rel": rel(tf32_enc, want_enc),
           "logits_tf32_vs_cpu_rel": rel(tf32_logits, want_logits), "tol": JOINT_CARD_CPU_REL}
    check(out["encoder_card_vs_cpu_rel"] <= JOINT_CARD_CPU_REL and
          out["logits_card_vs_cpu_rel"] <= JOINT_CARD_CPU_REL, ("fp32 serving card vs CPU", out))
    check(out["encoder_tf32_vs_cpu_rel"] > JOINT_CARD_CPU_REL,
          ("the TF32 control meets the fp32 limit", out))
    del cpu
    return out


def phase_joints(manifest: str, tmp: str, gpu: str) -> dict:
    """K4 in every dtype and at the widths the JAX package runs, through the
    API at full width (d_model 512, LSTM 640, the encoder at RNNT_LAYERS) on
    rnnt_train's manifest: in fp16 and fp32 a flash-joint probe step against
    a dense one at the same weights (quiet settings), one fit step and a
    greedy transcribe of JOINT_SERVE_FILES files, and in fp32 the serving
    path card vs CPU; in bf16 at joint_hidden 1024 the probe pair and a fit
    step; at joint_hidden 600 (padded to 608 on the card) the probe pair
    under joint_impl auto, which must resolve to the flash joint. -> K4's
    launches by kernel and shape over the phase, and each run's shapes (the
    kernels phase's `joints` rows)."""
    from conformer_nemo_tpu_torch.ops import rnnt_joint as jt
    from conformer_nemo_tpu_torch.ops.build import launch_count, reset_launch_counts

    t_phase = time.perf_counter()
    names = [jt.counter(k, dt).name for dt in jt.KERNELS for k in ("fwd", "cells", "sums",
                                                                    "reduce")]
    by_shape: dict = {k: {} for k in names}

    def collect():
        for k in names:
            for sh, n in launch_count(k).by_shape.items():
                by_shape[k][sh] = by_shape[k].get(sh, 0) + n
        reset_launch_counts()

    with open(manifest, encoding="utf-8") as f:
        entries = [json.loads(line) for line in f][:JOINT_SERVE_FILES]
    wavs = [_crop_wav(x["audio_filepath"], tmp, DECODE_CLIP_S) for x in entries]
    out: dict = {"gpu": gpu}
    calls: dict = {}

    def call(name, model, batch, dtype):
        """The step's joint call: (b, t, u, h, v, enc_lens, token_lens, dtype)."""
        cfg = model.cfg.model
        calls[name] = (int(batch.audio.shape[0]), _frames(model, [batch.audio.shape[1]])[0],
                       int(batch.tokens.shape[1]), cfg.joint.joint_hidden,
                       cfg.num_classes_with_blank, _frames(model, batch.audio_lens.tolist()),
                       batch.token_lens.tolist(), dtype)

    reset_launch_counts()
    # 1. fp16 and fp32 at the shipped joint (640)
    for dtype in (torch.float16, torch.float32):
        name = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        flash, dense = _joint_flash_dense({}, dtype)
        batch = next(iter(flash._loader(manifest, flash.raw_cfg["model"]["train_ds"],
                                        shuffle=True)))
        parity = _joint_step_parity(flash, dense, batch, name)
        del dense
        free_cuda()
        step = _joint_fit_step(flash, manifest, name)
        call(name, flash, step.pop("batch"), dtype)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        texts = flash.transcribe(wavs, batch_size=len(wavs))
        torch.cuda.synchronize()
        check(len(texts) == len(wavs) and all(isinstance(x, str) for x in texts), (name, texts))
        out[name] = {"dtype": str(dtype), "joint_hidden": flash.cfg.model.joint.joint_hidden,
                     "parity": parity, "fit_step": step, "transcribe_s": time.perf_counter() - t1,
                     "sample_text": texts[0][:80]}
        if dtype == torch.float32:
            out[name]["serve_card_vs_cpu"] = _serve_card_vs_cpu(flash, {}, wavs)
        out[name]["seconds"] = time.perf_counter() - t0
        collect()
        del flash
        free_cuda()
    # 2. bf16 at joint_hidden 1024 (past the old backward's 640)
    t0 = time.perf_counter()
    wide = {"model.model_defaults.joint_hidden": JOINT_WIDE_H}
    flash, dense = _joint_flash_dense(wide, torch.bfloat16)
    check(flash.cfg.model.joint.joint_hidden == JOINT_WIDE_H, "joint_hidden override")
    batch = next(iter(flash._loader(manifest, flash.raw_cfg["model"]["train_ds"], shuffle=True)))
    parity = _joint_step_parity(flash, dense, batch, "h1024")
    del dense
    free_cuda()
    step = _joint_fit_step(flash, manifest, "h1024")
    call("h1024", flash, step.pop("batch"), torch.bfloat16)
    out["h1024"] = {"joint_hidden": JOINT_WIDE_H, "parity": parity, "fit_step": step,
                    "seconds": time.perf_counter() - t0}
    collect()
    del flash
    free_cuda()
    # 3. bf16 at joint_hidden 600 under auto, its dense estimate's threshold
    # lowered so that auto takes the flash joint at this batch
    t0 = time.perf_counter()
    odd = {"model.model_defaults.joint_hidden": JOINT_ODD_H,
           "model.joint.joint_flash_hbm_threshold": 1.0e6}
    flash, dense = _joint_flash_dense(odd, torch.bfloat16, impl="auto")
    cfg = flash.cfg.model
    batch = next(iter(flash._loader(manifest, flash.raw_cfg["model"]["train_ds"], shuffle=True)))
    b, u1 = int(batch.audio.shape[0]), int(batch.tokens.shape[1]) + 1
    t = _frames(flash, [batch.audio.shape[1]])[0]
    resolved = cfg.resolve_joint_impl(b, t, u1, "cuda")
    check(cfg.joint_impl == "auto" and resolved == "flash", ("h600: auto resolved to", resolved))
    parity = _joint_step_parity(flash, dense, batch, "h600")
    call("h600", flash, batch, torch.bfloat16)
    check(launch_count("K4-fwd").by_shape.get((b, t, u1, JOINT_ODD_H,
                                               cfg.num_classes_with_blank), 0) == 1,
          ("h600: K4-fwd at H 600", dict(launch_count("K4-fwd").by_shape)))
    out["h600"] = {"joint_hidden": JOINT_ODD_H, "padded_to": jt.padded_h(JOINT_ODD_H),
                   "joint_impl": "auto", "resolved": resolved,
                   "dense_bytes_estimate": 3 * 2 * b * t * u1 * cfg.num_classes_with_blank,
                   "threshold": cfg.joint_flash_hbm_threshold, "parity": parity,
                   "seconds": time.perf_counter() - t0}
    collect()
    del flash, dense
    free_cuda()
    for dt in jt.KERNELS:
        check(all(by_shape[jt.counter(k, dt).name] for k in ("fwd", "cells", "sums", "reduce")),
              ("a K4 kernel did not launch in the joints phase", str(dt)))
    emit("joints", config="configs/conformer_transducer_bpe.yaml", n_layers=RNNT_LAYERS,
         seconds=time.perf_counter() - t_phase,
         launches_by_shape={k: {str(sh): n for sh, n in d.items()} for k, d in by_shape.items()},
         **out)
    return {"by_shape": by_shape, "calls": calls}


# ---------------------------------------------------------------------------
# multilang: the data pipeline into both multilang recipes
# ---------------------------------------------------------------------------


def _write_multilang_manifest(tmp: str, rng) -> tuple:
    """MULTILANG_FILES FLAC files of 10-16 s written from int16 with the
    port's encoder, half `en` and half `es`, texts drawn from each
    language's pieces -> (manifest, [(path, int16 source)])."""
    from conformer_nemo_tpu_torch.data.flac_encode import write_flac
    from conformer_nemo_tpu_torch.data.tokenizers import SentencePieceTokenizer

    pieces = {}
    for lang, path in LANG_MODELS.items():
        tok = SentencePieceTokenizer(path)
        pieces[lang] = [p for p, t in zip(tok.pieces, tok.types) if t == 1 and p != "▁"]
    manifest, sources = os.path.join(tmp, "multilang.json"), []
    with open(manifest, "w", encoding="utf-8") as f:
        for i in range(MULTILANG_FILES):
            lang = ("en", "es")[i % 2]
            secs = float(np.round(rng.uniform(10.0, 16.0), 2))
            pcm = np.clip(np.round(_wav(rng, secs) * 32768.0), -32768, 32767).astype(np.int16)
            path = os.path.join(tmp, f"multilang_{i}.flac")
            write_flac(path, pcm)
            sources.append((path, pcm))
            words = rng.choice(pieces[lang], size=int(secs * rng.uniform(2.0, 3.0)))
            text = "".join(words).replace("▁", " ").strip()
            f.write(json.dumps({"audio_filepath": path, "duration": secs, "text": text,
                                "lang": lang}, ensure_ascii=False) + "\n")
    return manifest, sources


def _audio_checks(tmp: str, sources: list) -> dict:
    """FLAC bit for bit, the fixture FLACs' lengths, each codec the card
    box has within CODEC_MIN_SNR_DB of its source (an absent one raises
    naming its library), and host decode rates in audio-seconds per second."""
    from concurrent.futures import ThreadPoolExecutor

    from conformer_nemo_tpu_torch.data import audio_io, codecs
    from conformer_nemo_tpu_torch.ops.build import MissingSystemLibrary

    for path, pcm in sources:
        check(np.array_equal(audio_io.load_audio_pcm16(path), pcm), ("FLAC bits", path))
    for name, n in FIXTURE_FLAC_SAMPLES.items():
        got = audio_io.read_flac(os.path.join(ROOT, "tests", "fixtures", "speech", name))[0]
        check(got.shape == (n,), ("fixture FLAC length", name, got.shape))
    present = {name: codecs.have_codec(name) for name in CODEC_LIBRARIES}
    emit("multilang_codecs", present=present, libraries=CODEC_LIBRARIES)
    paths = [p for p, _ in sources]
    audio_s = sum(len(pcm) for _, pcm in sources) / SR
    rates = {}
    t0 = time.perf_counter()
    for path in paths:
        audio_io.read_flac(path)
    rates["flac_1_thread"] = audio_s / (time.perf_counter() - t0)
    with ThreadPoolExecutor(max_workers=8) as pool:
        t0 = time.perf_counter()
        list(pool.map(audio_io.read_flac, paths))
        rates["flac_8_workers"] = audio_s / (time.perf_counter() - t0)
    snr, encoders = {}, {}
    src = sources[0][1].astype(np.float32) / 32768.0
    for name, write in (("mp3", codecs.write_mp3), ("ogg", codecs.write_ogg),
                        ("opus", codecs.write_opus)):
        copy = os.path.join(tmp, f"multilang_0.{name}")
        if not present[name]:  # an absent codec refuses, naming its library
            head = {"mp3": b"ID3\x03", "ogg": b"OggS", "opus": b"OggS"}[name]
            with open(copy, "wb") as f:
                f.write(head + bytes(256))
            try:
                audio_io.load_audio(copy)
            except MissingSystemLibrary as e:
                check(any(lib in str(e) for lib in CODEC_LIBRARIES[name]), (name, str(e)))
                continue
            check(False, ("an absent codec decoded", name))
        try:
            write(copy, src)
        except MissingSystemLibrary as e:  # a decoder without its encoder: no fixture
            encoders[name] = str(e)
            continue
        audio_io.load_audio(copy)  # warm-up: the first resample imports scipy.signal
        t0 = time.perf_counter()
        decoded = audio_io.load_audio(copy)
        rates[name] = (len(src) / SR) / (time.perf_counter() - t0)
        snr[name] = codecs.snr_db(src, decoded)[0]
        check(snr[name] >= CODEC_MIN_SNR_DB, ("codec SNR", name, snr[name]))
    return {"decode_audio_s_per_s": rates, "codec_snr_db": snr, "min_snr_db": CODEC_MIN_SNR_DB,
            "codecs_present": present, "encoders_absent": encoders}


def _transport_bytes(model, manifest: str) -> dict:
    """H2D bytes of one batch in each wire format (the validation loader's
    batch: no augmentor), the integer batches dequantised on the card
    against the f32 batch (pcm16 from lossless FLAC: the same floats), and
    their features' largest difference."""
    from conformer_nemo_tpu_torch.audio.features import _decode_transport, log_mel_spectrogram

    ds_cfg = model.raw_cfg["model"]["train_ds"]
    out, wav, feats = {}, {}, {}
    for transport in ("f32", "pcm16", "mulaw8"):
        b = next(iter(model._loader(manifest, {**ds_cfg, "transport": transport}, shuffle=False)))
        out[transport] = int(sum(getattr(b, k).nbytes for k in ("audio", "audio_lens", "tokens",
                                                                 "token_lens")))
        audio = torch.from_numpy(b.audio).to(model.device)
        wav[transport] = _decode_transport(audio)
        with torch.no_grad():
            feats[transport] = log_mel_spectrogram(
                model.cfg.preprocessor, audio, torch.from_numpy(b.audio_lens).to(model.device))[0]
    check(torch.equal(wav["pcm16"], wav["f32"]), "pcm16 dequantised != f32 on lossless audio")
    return {"h2d_bytes_per_batch": out,
            "features_max_abs_diff_vs_f32": {t: float((feats[t] - feats["f32"]).abs().max())
                                             for t in ("pcm16", "mulaw8")}}


def _prefetch_turns(model, host_batches: list) -> list:
    """The traced train step's idle share fed by device_prefetch against
    the synchronous copy (the step's own pageable `.to`), in turns."""
    from conformer_nemo_tpu_torch.data.prefetch import device_prefetch

    step = model._make_train_step(model._make_optimizer())
    runs = {"prefetch": lambda: [step(b) for b in device_prefetch(iter(host_batches),
                                                                   model.device)],
            "sync": lambda: [step(b) for b in host_batches]}
    runs["sync"]()  # warm-up of both paths
    runs["prefetch"]()
    turns = []
    for mode in PREFETCH_TURNS:
        r = _profile(runs[mode], "profile_multilang_feed", feed=mode, steps=len(host_batches))
        turns.append({"feed": mode, "traced_wall_s": r["traced_wall_s"],
                      "device_idle_share": r["device_idle_share"]})
    return turns


def phase_multilang(tmp: str, gpu: str) -> dict:
    """Both multilang recipes at full width on FLAC audio through the whole
    data pipeline: CTC (K1 at V + 1 584, dense attention) 3 steps and a
    transcribe of its files and the fixture FLACs; the transducer (flash
    joint: K3, K4 at V 584) 3 steps and a greedy transcribe of 3 files."""
    from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
    from conformer_nemo_tpu_torch.ops.build import launch_count, reset_launch_counts

    t_phase = time.perf_counter()
    timeline = {}  # seconds since the phase began, at the end of each part
    manifest, sources = _write_multilang_manifest(tmp, np.random.RandomState(SEED + 7))
    timeline["write_flac"] = time.perf_counter() - t_phase
    audio = _audio_checks(tmp, sources)
    timeline["audio_checks"] = time.perf_counter() - t_phase

    model = ConformerCTC.from_config_file(MULTILANG_CTC, overrides=MULTILANG_OVERRIDES, seed=SEED)
    check(model.tokenizer.vocab_size + 1 == MULTILANG_V1 and model.cfg.blank_id == 583,
          ("vocabulary", model.tokenizer.vocab_size, model.cfg.blank_id))
    enc = model.cfg.encoder
    loader = model._loader(manifest, model.raw_cfg["model"]["train_ds"], shuffle=True)
    host_batches = [next(iter(loader))]  # one batch an epoch (one bucket); warms the workers
    t0 = time.perf_counter()
    host_batches += [next(iter(loader)) for _ in range(3)]
    loader_s = (time.perf_counter() - t0) / 3
    host_batches = host_batches[:2]
    check(host_batches[0].audio.dtype == np.int16, host_batches[0].audio.dtype)
    timeline["ctc_model_and_loader"] = time.perf_counter() - t_phase
    steps: list = []
    model._make_train_step = _counted_steps(model, steps)
    ctc_kernels = ("K1-fwd", "K1-bwd", "K1-bwd-grad")
    reset_launch_counts()
    model.fit(manifest, max_steps=TRAIN_STEPS)
    ctc_by_shape = {k: dict(launch_count(k).by_shape) for k in ctc_kernels}
    del model._make_train_step
    check(len(steps) == TRAIN_STEPS, len(steps))
    for i, st in enumerate(steps):
        got = {k: st["launches"].get(k, 0) for k in PER_STEP_LAUNCHES}
        want = {k: int(k in ctc_kernels) for k in PER_STEP_LAUNCHES}
        check(got == want, ("multilang ctc step", i, got))
        check(math.isfinite(st["loss"]) and all(st["changed"].values()), ("ctc step", i, st))
    batch = steps[0]["batch"]
    t_enc = encoder_frames(model.cfg, [batch.audio.shape[1]])[0]
    check(t_enc < enc.flash_attention_min_t, ("dense attention expected", t_enc))
    fixtures = [os.path.join(ROOT, "tests", "fixtures", "speech", n) for n in FIXTURE_FLAC_SAMPLES]
    t0 = time.perf_counter()
    texts = model.transcribe([p for p, _ in sources] + fixtures, batch_size=BATCH)
    torch.cuda.synchronize()
    transcribe_s = time.perf_counter() - t0
    check(len(texts) == MULTILANG_FILES + 3 and all(isinstance(x, str) for x in texts), texts)
    timeline["ctc_fit_transcribe"] = time.perf_counter() - t_phase
    transport = _transport_bytes(model, manifest)
    timeline["transports"] = time.perf_counter() - t_phase
    turns = _prefetch_turns(model, host_batches)
    timeline["prefetch_turns"] = time.perf_counter() - t_phase
    steady = steps[1:]
    ctc = {"config": "configs/conformer_ctc_bpe_multilang.yaml", "n_layers": enc.n_layers,
           "d_model": enc.d_model, "batch": int(batch.audio.shape[0]), "encoder_t": t_enc,
           "u_cap": int(batch.tokens.shape[1]), "v1": MULTILANG_V1,
           "steps": [{k: v for k, v in st.items() if k != "batch"} for st in steps],
           "steady_step_s": sum(st["seconds"] for st in steady) / len(steady),
           "loader_s_per_batch": loader_s, "transcribe_files": len(texts),
           "transcribe_s": transcribe_s, "sample_text": texts[0][:60],
           "fixture_texts": [x[:40] for x in texts[-3:]], **transport,
           "prefetch_turns": turns}
    kernels_ctc = {"t": t_enc, "tokens": batch.tokens,
                   "enc_lens": encoder_frames(model.cfg, batch.audio_lens.tolist()),
                   "token_lens": batch.token_lens, "by_shape": ctc_by_shape}
    del model, steps, batch, loader, host_batches
    free_cuda()

    model = ConformerTransducer.from_config_file(
        MULTILANG_RNNT, overrides={**MULTILANG_OVERRIDES, "model.joint.joint_impl": "flash"},
        seed=SEED)
    cfg = model.cfg.model
    check(cfg.num_classes_with_blank == MULTILANG_V1, cfg.num_classes_with_blank)
    steps = []
    model._make_train_step = _counted_steps(model, steps)
    reset_launch_counts()
    model.fit(manifest, max_steps=TRAIN_STEPS)
    rnnt_by_shape = {k: dict(launch_count(k).by_shape) for k in RNNT_KERNELS}
    del model._make_train_step
    check(len(steps) == TRAIN_STEPS, len(steps))
    for i, st in enumerate(steps):
        want = rnnt_step_launches(model, st["batch"])
        st["windows"] = want["K4-bwd"]
        got = {k: st["launches"].get(k, 0) for k in RNNT_KERNELS + NOT_RNNT}
        check(got == want, ("multilang rnnt step", i, got, want))
        check(math.isfinite(st["loss"]) and all(st["changed"].values()), ("rnnt step", i, st))
    batch = steps[0]["batch"]
    t_rnnt = _frames(model, [batch.audio.shape[1]])[0]
    t0 = time.perf_counter()
    rnnt_texts = model.transcribe([_crop_wav(p, tmp, DECODE_CLIP_S)
                                   for p, _ in sources[:RNNT_TRANSCRIBE_FILES]],
                                  batch_size=RNNT_TRANSCRIBE_FILES)
    torch.cuda.synchronize()
    rnnt_transcribe_s = time.perf_counter() - t0
    check(len(rnnt_texts) == RNNT_TRANSCRIBE_FILES, rnnt_texts)
    timeline["rnnt"] = time.perf_counter() - t_phase
    steady = steps[1:]
    rnnt = {"config": "configs/conformer_transducer_bpe_multilang.yaml",
            "n_layers": cfg.encoder.n_layers, "d_model": cfg.encoder.d_model,
            "joint_hidden": cfg.joint.joint_hidden, "vocab_with_blank": cfg.num_classes_with_blank,
            "batch": int(batch.audio.shape[0]), "encoder_t": t_rnnt,
            "u_cap": int(batch.tokens.shape[1]),
            "steps": [{k: v for k, v in st.items() if k != "batch"} for st in steps],
            "steady_step_s": sum(st["seconds"] for st in steady) / len(steady),
            "transcribe_files": len(rnnt_texts), "transcribe_s": rnnt_transcribe_s,
            "sample_text": rnnt_texts[0][:60]}
    kernels_rnnt = {"t": t_rnnt, "enc_lens": _frames(model, batch.audio_lens.tolist()),
                    "tokens": batch.tokens, "token_lens": batch.token_lens.tolist(),
                    "h": cfg.joint.joint_hidden, "v": cfg.num_classes_with_blank,
                    "by_shape": rnnt_by_shape}
    del model, steps, batch
    free_cuda()
    emit("multilang", gpu=gpu, audio=audio, ctc=ctc, rnnt=rnnt,
         phase_s=time.perf_counter() - t_phase, timeline=timeline)
    return {"ctc": kernels_ctc, "rnnt": kernels_rnnt}


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# distributed: NCCL at world 1 in this process, gloo worlds of two ranks
# sharing the card in child processes (`--dist-worker`)
# ---------------------------------------------------------------------------


def _agent_store(world: int):
    """The rendezvous store of a world, held by this process as torchrun's
    agent holds it: bound to a port the system picks (port 0) before any
    rank is told the port, so no other socket can take it in between; the
    ranks join it as clients (TORCHELASTIC_USE_AGENT_STORE, `_launcher_env`).
    Keep it alive until the ranks have finished."""
    import datetime

    import torch.distributed as dist

    return dist.TCPStore("localhost", 0, world, is_master=True, wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))


def _launcher_env(world: int, rank: int, port: int) -> dict:
    """What a launcher sets for one rank; the port is an agent store's."""
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
            "RANK": str(rank), "LOCAL_RANK": "0", "TORCHELASTIC_USE_AGENT_STORE": "True"}


def _digests(state_dict: dict) -> dict:
    import hashlib

    return {k: hashlib.sha1(v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
            .hexdigest() for k, v in state_dict.items()}


def _dist_variant(v: dict, rank: int) -> dict:
    """One variant of a gloo world on this rank: the model of v's config
    with the weights the parent saved, on the mesh (v["data"], v["model"]),
    DIST_STEPS steps on this rank's rows of the saved global batch, each
    timed; the first step's reduced gradients (gathered to full tensors,
    written by rank 0), the gradient all-reduce timed alone, launches per
    kernel and a digest of every local tensor after the steps."""
    from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
    from conformer_nemo_tpu_torch.models import conformer
    from conformer_nemo_tpu_torch.ops.build import launch_count, launch_counts
    from conformer_nemo_tpu_torch.parallel import distributed as pdist
    from conformer_nemo_tpu_torch.parallel.mesh import make_mesh
    from conformer_nemo_tpu_torch.parallel.sharding import (
        gather_tensor,
        param_spec,
        set_sync_batchnorm,
        tp_of,
    )
    from conformer_nemo_tpu_torch.train.optim import Transformation
    from conformer_nemo_tpu_torch.train.trainer import distribute_state

    cls = ConformerCTC if v["family"] == "ctc" else ConformerTransducer
    model = cls.from_config_file(v["config"], overrides=v["overrides"], seed=SEED)
    model.load_state_dict(torch.load(v["weights"], weights_only=True))
    mesh = make_mesh(v["data"], v["model"])
    opt = model._make_optimizer(mesh)
    first: list = []

    def update(grads, state, params):
        if not first:
            first.extend(g.detach().clone() for g in grads)
        return opt.update(grads, state, params)

    wrapped = Transformation(opt.init, update)
    model.train_state = model._init_state(wrapped)
    distribute_state(model.train_state, mesh)
    if v.get("control") == "unsynced_bn":  # each rank's BatchNorm on its own rows' statistics
        set_sync_batchnorm(model.model, None)
    local_ln = v.get("control") == "local_layer_norm"
    if local_ln:  # each rank's LayerNorm on its own channels' statistics
        real_ln = conformer._tp_layer_norm
        conformer._tp_layer_norm = lambda norm, x, tp: torch.nn.functional.layer_norm(
            x.float(), x.shape[-1:], norm.weight, norm.bias, norm.eps)
    step = model._make_train_step(wrapped)
    data = dict(np.load(v["batch"]))
    rows = data["audio"].shape[0] // mesh.data
    batch = {k: a[mesh.data_index * rows: (mesh.data_index + 1) * rows] for k, a in data.items()}
    kernels = ("K2-fwd", "K2-bwd-dq", "K2-bwd-dkv", "K1-fwd", "K1-bwd", "K3-alpha", "K4-fwd")
    out = {"steps": [], "mesh": [mesh.data, mesh.model, mesh.data_index, mesh.model_index]}
    before_all = {k: dict(launch_count(k).by_shape) for k in kernels}
    for _ in range(DIST_STEPS):
        pdist.GRAD_ALL_REDUCE.update(bytes=0, calls=0)
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = launch_counts()
        out["steps"].append({"loss": float(metrics["loss"]),
                             "grad_norm": float(metrics["grad_norm"]), "seconds": seconds,
                             "all_reduce_bytes": pdist.GRAD_ALL_REDUCE["bytes"],
                             "all_reduce_calls": pdist.GRAD_ALL_REDUCE["calls"],
                             "launches": {k: after[k] - before.get(k, 0) for k in after
                                          if after[k] - before.get(k, 0)}})
    out["by_shape"] = {k: {sh: n - before_all[k].get(sh, 0)
                           for sh, n in launch_count(k).by_shape.items()
                           if n - before_all[k].get(sh, 0)} for k in kernels}
    # the gradient all-reduce alone, on the first step's gradients, 3 calls
    params = model.train_state.params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        model.train_state.mesh_or_single.reduce_grads(list(first), params)
    torch.cuda.synchronize()
    out["all_reduce_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    tp = tp_of(model.model)
    names = [n for n, _ in model.model.named_parameters()]
    full = [gather_tensor(g, *param_spec(n), tp) if tp is not None and param_spec(n) else g
            for n, g in zip(names, first)]
    if rank == 0:
        torch.save([g.float().cpu() for g in full], v["grads_out"])
    out["digests"] = _digests(model.model.state_dict())
    out["sharded"] = sorted(k for k in out["digests"] if tp is not None and param_spec(k))
    if local_ln:
        conformer._tp_layer_norm = real_ln
    del model, step, first, full
    free_cuda()
    return out


def dist_worker(spec_path: str, rank: int) -> int:
    """A rank of the distributed phase's gloo world (or its NCCL probe),
    on cuda:0 with the other ranks."""
    import torch.distributed as dist

    from conformer_nemo_tpu_torch.parallel import distributed as pdist

    with open(spec_path) as f:
        spec = json.load(f)
    os.environ.update(_launcher_env(spec["world"], rank, spec["port"]))
    pdist.initialize_distributed(backend=spec["backend"], timeout_s=spec["timeout_s"])
    if spec.get("probe"):
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        print(json.dumps({"rank": rank, "sum": float(x)}), flush=True)
    else:
        results = {v["name"]: _dist_variant(v, rank) for v in spec["variants"]}
        torch.save(results, spec["out"].format(rank=rank))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _spawn_world(tmp: str, name: str, world: int, timeout_s: float, **spec) -> list:
    """Start `world` ranks of `--dist-worker` on this card and wait (each at
    most timeout_s, then every rank is killed) -> [(returncode, stdout,
    stderr)]."""
    store = _agent_store(world)
    spec = {**spec, "world": world, "port": store.port, "timeout_s": timeout_s / 2,
            "out": os.path.join(tmp, f"{name}_rank{{rank}}.pt")}
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-worker", path,
                               str(rank)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in range(world)]
    t_end = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            try:
                outs.append((*p.communicate(timeout=max(1.0, t_end - time.monotonic())),))
            except subprocess.TimeoutExpired:
                outs.append(("", "timed out"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        del store
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _reference_step(cls, config: str, overrides: dict, weights: str, batch: dict) -> tuple:
    """One process's first step on the whole global batch: (loss, gradients)."""
    from conformer_nemo_tpu_torch.train.optim import Transformation

    model = cls.from_config_file(config, overrides=overrides, seed=SEED)
    model.load_state_dict(torch.load(weights, weights_only=True))
    grads: list = []

    def capture(g, state, params):
        grads.extend(x.detach().float().cpu() for x in g)
        return [torch.zeros_like(x) for x in g], state

    probe = Transformation(lambda params: {}, capture)
    model.train_state = model._init_state(probe)
    loss = float(model._make_train_step(probe)(batch)["loss"])
    del model
    free_cuda()
    return loss, grads


def _cosine(a: list, b: list) -> float:
    dot = sum((x.double() * y.double()).sum() for x, y in zip(a, b)).item()
    na = math.sqrt(sum((x.double() ** 2).sum().item() for x in a))
    nb = math.sqrt(sum((y.double() ** 2).sum().item() for y in b))
    return dot / (na * nb)


def _save_variant_inputs(tmp: str, name: str, cls, config: str, overrides: dict,
                         manifest: str) -> tuple:
    """The variant's weights (a seeded model's) and one global batch of its
    loader, written for the ranks; -> (weights path, batch path, batch)."""
    model = cls.from_config_file(config, overrides=overrides, seed=SEED)
    batch = next(iter(model._loader(manifest, model.raw_cfg["model"]["train_ds"],
                                    shuffle=True)))
    arrays = {k: np.asarray(getattr(batch, k)) for k in ("audio", "audio_lens", "tokens",
                                                           "token_lens")}
    weights, path = os.path.join(tmp, f"{name}_w.pt"), os.path.join(tmp, f"{name}_batch.npz")
    torch.save(model.state_dict(), weights)
    np.savez(path, **arrays)
    del model
    free_cuda()
    return weights, path, arrays


def phase_distributed(tmp: str, train: dict, rnnt: dict, gpu: str) -> dict:
    """NCCL at world 1: the train phase's 3-step fit through the distributed
    path (the same losses bit for bit); NCCL refusing two ranks on one card
    (reported); a gloo world of two ranks on the card: CTC at dp2 and at
    dp1 x tp2 (K2 at half the heads) and the transducer at dp2 with the
    flash joint, each against one process's step on the whole global batch."""
    import torch.distributed as dist

    from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
    from conformer_nemo_tpu_torch.ops.build import launch_count, reset_launch_counts
    from conformer_nemo_tpu_torch.parallel import distributed as pdist
    from conformer_nemo_tpu_torch.parallel.mesh import make_mesh
    from conformer_nemo_tpu_torch.parallel.sharding import set_sync_batchnorm

    t_phase = time.perf_counter()
    # -- NCCL, world 1, this process ------------------------------------------
    store = _agent_store(1)
    env = _launcher_env(1, 0, store.port)
    os.environ.update(env)
    try:
        check(pdist.initialize_distributed(timeout_s=DIST_TIMEOUT_S) == (0, 1), "world 1")
        check(dist.get_backend() == "nccl", ("backend", dist.get_backend()))
        model = ConformerCTC.from_config_file(LONGFORM, overrides=TRAIN_OVERRIDES, seed=SEED)
        steps: list = []
        model._make_train_step = _counted_steps(model, steps)
        reset_launch_counts()
        pdist.GRAD_ALL_REDUCE.update(bytes=0, calls=0)
        out = model.fit(train["train_manifest"], train["val_manifest"], max_steps=TRAIN_STEPS)
        nccl_by_shape = {k: dict(launch_count(k).by_shape) for k in PER_STEP_LAUNCHES}
        del model._make_train_step
        reduced = dict(pdist.GRAD_ALL_REDUCE)
        losses = [s["loss"] for s in steps]
        check(out["steps"] == TRAIN_STEPS and losses == train["losses"],
              ("NCCL world-1 losses", losses, "train phase", train["losses"]))
        for i, s in enumerate(steps):
            got = {k: s["launches"].get(k, 0) for k in PER_STEP_LAUNCHES}
            check(got == PER_STEP_LAUNCHES, ("NCCL step", i, "launches", got))
        check(reduced["bytes"] > 0, "the gradients went through the all-reduce")
        grads = [torch.ones_like(p) for p in model.model.parameters()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            pdist.all_reduce_coalesced(grads, None)
        torch.cuda.synchronize()
        nccl_ms = (time.perf_counter() - t0) / 3 * 1e3
        # the fit's first batch in turns: one process's step, the step on the
        # NCCL mesh (the same optimizer, the collectives on or off)
        mesh = make_mesh()
        batch = steps[0]["batch"]
        step = model._make_train_step(model._make_optimizer(mesh))

        def turn(on: bool) -> float:
            model.train_state.mesh = mesh if on else None
            set_sync_batchnorm(model.model, mesh.data_group if on else None)
            torch.cuda.synchronize()
            t_step = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            return time.perf_counter() - t_step

        turns = [(name, turn(name == "nccl")) for name in ("plain", "nccl", "nccl", "plain")]
        turn(True)  # warm
        _profile(lambda: step(batch), "profile_distributed_nccl", batch=int(batch.audio.shape[0]),
                 config="configs/conformer_ctc_bpe_longform.yaml", world=1, backend="nccl")
        model.train_state.mesh = None
        set_sync_batchnorm(model.model, None)
        steady = steps[1:]
        emit("distributed_nccl_world1", config="configs/conformer_ctc_bpe_longform.yaml",
             backend="nccl", world=1, losses=losses, train_phase_losses=train["losses"],
             all_reduce_bytes_per_step=reduced["bytes"] // TRAIN_STEPS,
             all_reduce_calls_per_step=reduced["calls"] // TRAIN_STEPS,
             all_reduce_ms=nccl_ms, steady_step_s=sum(s["seconds"] for s in steady) / len(steady),
             turns_s=turns,
             launches_per_step=PER_STEP_LAUNCHES, val=out["val"], gpu=gpu)
        del model, grads, step
        free_cuda()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
        del store

    # -- NCCL, two ranks on the one card: reported, not used ---------------------
    probe = _spawn_world(tmp, "nccl_probe", 2, 120, backend="nccl", probe=True)
    said = lambda err: [line[-400:] for line in err.splitlines()
                        if "rror" in line or "uplicate" in line][-3:]
    emit("distributed_nccl_two_ranks_one_card", returncodes=[p[0] for p in probe],
         stdout=[p[1].strip()[-300:] for p in probe], errors=[said(p[2]) for p in probe])

    # -- gloo, two ranks sharing the card ------------------------------------------
    ctc_over = {**TRAIN_OVERRIDES, **DIST_QUIET}
    # the prediction network's dropout off too; the joint's stays on: each
    # rank hashes its rows at their offset in the global batch (K4)
    rnnt_over = {**RNNT_OVERRIDES, **DIST_QUIET, "model.decoder.prednet.dropout": 0.0,
                 "model.spec_augment.specshot_ratio": 0.0}
    ln_over = {**ctc_over, "model.encoder.conv_norm_type": "layer_norm"}
    w_ctc, b_ctc, arr_ctc = _save_variant_inputs(tmp, "ctc", ConformerCTC, LONGFORM, ctc_over,
                                                 train["train_manifest"])
    w_ln, b_ln, arr_ln = _save_variant_inputs(tmp, "ctc_ln", ConformerCTC, LONGFORM, ln_over,
                                              train["train_manifest"])
    w_rnnt, b_rnnt, arr_rnnt = _save_variant_inputs(tmp, "rnnt", ConformerTransducer,
                                                    RNNT_CONFIG, rnnt_over, rnnt["manifest"])
    refs = {"ctc": _reference_step(ConformerCTC, LONGFORM, ctc_over, w_ctc, arr_ctc),
            "ctc_ln": _reference_step(ConformerCTC, LONGFORM, ln_over, w_ln, arr_ln),
            "rnnt": _reference_step(ConformerTransducer, RNNT_CONFIG, rnnt_over, w_rnnt,
                                    arr_rnnt)}
    ctc = {"family": "ctc", "config": LONGFORM, "overrides": ctc_over, "weights": w_ctc,
           "batch": b_ctc}
    variants = [
        {**ctc, "name": "ctc_dp2", "data": 2, "model": 1},
        {**ctc, "name": "ctc_dp2_unsynced_bn", "data": 2, "model": 1, "control": "unsynced_bn"},
        {**ctc, "name": "ctc_dp1_tp2", "data": 1, "model": 2},
        # the conv module's LayerNorm: each rank its half of the channels, the
        # statistics all-reduced over the model group
        {**ctc, "name": "ctc_dp1_tp2_layer_norm", "ref": "ctc_ln", "overrides": ln_over,
         "weights": w_ln, "batch": b_ln, "data": 1, "model": 2, "loss_rel": DIST_LN_LOSS_REL},
        {**ctc, "name": "ctc_dp1_tp2_layer_norm_local", "ref": "ctc_ln", "overrides": ln_over,
         "weights": w_ln, "batch": b_ln, "data": 1, "model": 2, "loss_rel": DIST_LN_LOSS_REL,
         "control": "local_layer_norm"},
        {"name": "rnnt_dp2", "family": "rnnt", "config": RNNT_CONFIG, "overrides": rnnt_over,
         "weights": w_rnnt, "batch": b_rnnt, "data": 2, "model": 1},
    ]
    for v in variants:
        v["grads_out"] = os.path.join(tmp, f"{v['name']}_grads.pt")
    t_world = time.perf_counter()
    ranks = _spawn_world(tmp, "gloo", 2, DIST_TIMEOUT_S, backend="gloo", variants=variants)
    world_s = time.perf_counter() - t_world
    for rank, (rc, o, e) in enumerate(ranks):
        check(rc == 0, (f"gloo rank {rank} failed", o[-2000:], e[-3000:]))
    results = [torch.load(os.path.join(tmp, f"gloo_rank{r}.pt"), weights_only=False)
               for r in range(2)]
    summary = {}
    for v in variants:
        name = v["name"]
        r0, r1 = results[0][name], results[1][name]
        ref_loss, ref_grads = refs[v.get("ref", v["family"])]
        grads = torch.load(v["grads_out"], weights_only=True)
        loss_rel = abs(r0["steps"][0]["loss"] - ref_loss) / abs(ref_loss)
        cosine = _cosine(grads, ref_grads)
        check([s["loss"] for s in r0["steps"]] == [s["loss"] for s in r1["steps"]],
              (name, "the ranks' losses differ", r0["steps"], r1["steps"]))
        loss_tol = v.get("loss_rel", DIST_LOSS_REL)
        if v.get("control"):
            check(loss_rel > loss_tol or cosine < DIST_GRAD_COSINE,
                  (name, "the control passes the limits", loss_rel, cosine))
            summary[name] = {"loss_rel_err": loss_rel, "tol_loss_rel": loss_tol,
                             "grad_cosine": cosine,
                             "losses": [s["loss"] for s in r0["steps"]],
                             "reference_loss": ref_loss}
            continue
        same = [k for k in r0["digests"] if k not in r0["sharded"]]
        check(loss_rel <= loss_tol, (name, "loss", r0["steps"][0]["loss"], ref_loss, loss_tol))
        check(cosine >= DIST_GRAD_COSINE, (name, "gradient cosine", cosine))
        check(all(r0["digests"][k] == r1["digests"][k] for k in same),
              (name, "parameters differ across ranks",
               [k for k in same if r0["digests"][k] != r1["digests"][k]][:5]))
        want = ("K2-fwd", "K1-fwd") if v["family"] == "ctc" else ("K4-fwd", "K3-alpha")
        check(all(r0["steps"][0]["launches"].get(k, 0) > 0 for k in want),
              (name, "kernels", r0["steps"][0]["launches"]))
        steady = r0["steps"][1:]
        rows = (arr_ctc if v["family"] == "ctc" else arr_rnnt)["audio"].shape[0] // v["data"]
        summary[name] = {
            "mesh": r0["mesh"][:2], "rows_per_rank": int(rows),
            "losses": [s["loss"] for s in r0["steps"]], "reference_loss": ref_loss,
            "loss_rel_err": loss_rel, "tol_loss_rel": loss_tol, "grad_cosine": cosine,
            "steady_step_s": sum(s["seconds"] for s in steady) / len(steady),
            "step_s": [s["seconds"] for s in r0["steps"]],
            "all_reduce_bytes_per_step": r0["steps"][-1]["all_reduce_bytes"],
            "all_reduce_calls_per_step": r0["steps"][-1]["all_reduce_calls"],
            "all_reduce_ms": r0["all_reduce_ms"],
            "launches_first_step": r0["steps"][0]["launches"],
            "by_shape": {k: {str(sh): n for sh, n in d.items()} for k, d in r0["by_shape"].items()
                         if d},
            "params_identical_across_ranks": len(same), "sharded_tensors": len(r0["sharded"])}
    emit("distributed", backend="gloo", world=2, card="shared by both ranks",
         layers=DIST_LAYERS, steps=DIST_STEPS, tol_loss_rel=DIST_LOSS_REL,
         min_cosine=DIST_GRAD_COSINE, variants=summary, world_s=world_s,
         phase_s=time.perf_counter() - t_phase, gpu=gpu)
    # K2 of the dp1 x tp2 variant: every row, half the heads a rank
    cfg = train["cfg"]
    enc_lens = encoder_frames(cfg, arr_ctc["audio_lens"].tolist())
    return {"nccl_by_shape": nccl_by_shape,
            "tp_by_shape": {k: d for k, d in results[0]["ctc_dp1_tp2"]["by_shape"].items()
                            if k.startswith("K2")},
            "tp_t": encoder_frames(cfg, [arr_ctc["audio"].shape[1]])[0],
            "tp_lens": [n for n in enc_lens for _ in range(cfg.encoder.n_heads // 2)]}


def _frontends_rows(fr: dict, d1: int, dv: int, gen, dev, chain) -> list:
    """The frontends phase's calls, as its runs made them: K2-fwd of the
    resnet serve, K1 of the resnet fit, K3 and K4 of the subencoder
    transducer's fit (T 390: its own length rule) with its lengths."""
    as_i32 = lambda x: torch.as_tensor(x).to(dev, torch.int32)
    rows = [_flash_case(f"frontends_bh{len(lens)}_t{t}", len(lens), t, d1, dv, lens, (-1, -1),
                        gen, dev) for t, lens in fr["flash_calls"]]
    tokens, enc_lens, token_lens = fr["ctc"]
    b, t = len(enc_lens), fr["ctc_t"]
    lp = torch.log_softmax(torch.randn(b, t, fr["v1"], generator=gen, device=dev) * 3, dim=-1)
    rows += _ctc_case(f"frontends_resnet_b{b}_t{t}_u{tokens.shape[1]}", lp, as_i32(tokens),
                      as_i32(enc_lens), as_i32(token_lens), fr["blank"])
    r = fr["rnnt"]
    b, u = r["tokens"].shape
    name = f"frontends_subencoder_b{b}_t{r['t']}_u1{u + 1}"
    rows += _lattice_case(name, r["t"], u + 1, r["enc_lens"], r["token_lens"], gen, dev, chain)
    rows += _joint_case(name, b, r["t"], u, r["h"], r["v"], r["enc_lens"], r["token_lens"], gen,
                        dev, drop_t=26)
    free_cuda()
    return rows


def phase_kernels(dev, cfg, flash_calls, train: dict, rnnt: dict, multilang: dict,
                  decode_calls: list, dist: dict, streaming: dict, frontends: dict,
                  ssl: dict, diar: dict, widths: dict, joints: dict) -> dict:
    """Each main-path call as the counted runs made it, then edge cases off
    the main path. -> {kernel name: [rows]} for the main-path rows."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d1, dv = cfg.encoder.d_head + cfg.encoder.d_model, cfg.encoder.d_head
    rows = {"transcribe": [_flash_case(f"main_bh{len(lens)}_t{t}", len(lens), t, d1, dv, lens,
                                       (-1, -1), gen, dev, compare_rows=True)
                           for t, lens in flash_calls]}
    # the decode phase's CTC beam transcribe: its 30-50 s file alone in a batch
    rows["decode"] = [_flash_case(f"decode_bh{len(lens)}_t{t}", len(lens), t, d1, dv, lens,
                                  (-1, -1), gen, dev) for t, lens in decode_calls]
    # the diarization phase's transcript: the session alone in a batch of one
    rows["diarization"] = [_flash_case(f"diarization_bh{len(lens)}_t{t}", len(lens), t, d1, dv,
                                       lens, (-1, -1), gen, dev)
                           for t, lens in diar["flash_calls"]]
    t, lens = train["t"], train["lens"]
    rows["train"] = [_flash_case(f"train_bh{len(lens)}_t{t}", len(lens), t, d1, dv, lens,
                                 (-1, -1), gen, dev, compare_rows=True)]
    rows["train"] += _flash_bwd_case(f"train_bh{len(lens)}_t{t}", len(lens), t, d1, dv, lens,
                                     (-1, -1), gen, dev)
    # the streaming step's banded calls (band 128/32, BH 64 at the step's T)
    t_st, lens_st = streaming["t"], streaming["lens"]
    rows["streaming"] = [_flash_case(f"streaming_bh{len(lens_st)}_t{t_st}", len(lens_st), t_st,
                                     d1, dv, lens_st, STREAMING_BAND, gen, dev)]
    rows["streaming"] += _flash_bwd_case(f"streaming_bh{len(lens_st)}_t{t_st}", len(lens_st),
                                         t_st, d1, dv, lens_st, STREAMING_BAND, gen, dev)
    # the SSL step's calls (BH 64 at its longest batch's T)
    t_ss, lens_ss = ssl["t"], ssl["lens"]
    rows["ssl"] = [_flash_case(f"ssl_bh{len(lens_ss)}_t{t_ss}", len(lens_ss), t_ss, d1, dv,
                               lens_ss, (-1, -1), gen, dev)]
    rows["ssl"] += _flash_bwd_case(f"ssl_bh{len(lens_ss)}_t{t_ss}", len(lens_ss), t_ss, d1, dv,
                                   lens_ss, (-1, -1), gen, dev)
    # the widths phase's fits: Small's heads (d1 220, dv 44: padded to 224 and
    # 48), XLarge's (d1 1152, dv 128), the flagship shapes in fp16 and fp32
    rows["widths"] = []
    for name, (bh, t_w, d1_w, dv_w, lens_w, dtype) in widths["calls"].items():
        case = f"widths_{name}_bh{bh}_t{t_w}"
        rows["widths"].append(_flash_case(case, bh, t_w, d1_w, dv_w, lens_w, (-1, -1), gen,
                                          dev, dtype=dtype))
        rows["widths"] += _flash_bwd_case(case, bh, t_w, d1_w, dv_w, lens_w, (-1, -1), gen, dev,
                                          dtype=dtype)
        free_cuda()
    # the same shapes at scores past fp32's integer range, where the SSL CLI's
    # own rate takes the encoder
    for dtype, sfx in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        _flash_extreme_case(f"ssl_extreme{sfx}_bh{len(lens_ss)}_t{t_ss}", len(lens_ss), t_ss, d1,
                            dv, lens_ss, gen, dev, dtype=dtype)
        free_cuda()
    # tiny depths, empty rows, a two-sided band, the top of the forward's range
    # (d1 1152, dv 128), dQ in two passes of columns
    _flash_case("tiny", 4, 200, 80, 16, [200, 100, 1, 0], (-1, -1), gen, dev)
    _flash_case("band_128_32", 8, 3001, d1, dv, [3001, 2500, 1876, 1200, 700, 64, 1, 0],
                (128, 32), gen, dev)
    _flash_case("wide_d1152_dv128", 4, 333, 1152, 128, [333, 200, 1, 0], (-1, -1), gen, dev)
    _flash_bwd_case("bwd_tiny_lens0", 4, 200, 80, 16, [200, 100, 1, 0], (-1, -1), gen, dev)
    _flash_bwd_case("bwd_band_128_32", 8, 1876, d1, dv, [1876, 1500, 1126, 700, 300, 64, 1, 0],
                    (128, 32), gen, dev)
    _flash_dq_wide_case("dq_wide_d656", 3, 301, 656, 64, [301, 256, 0], gen, dev)
    # the distributed phase's dp1 x tp2 step: every row at half the heads
    t_tp, lens_tp = dist["tp_t"], dist["tp_lens"]
    rows["distributed"] = [_flash_case(f"tp2_bh{len(lens_tp)}_t{t_tp}", len(lens_tp), t_tp, d1,
                                       dv, lens_tp, (-1, -1), gen, dev)]
    rows["distributed"] += _flash_bwd_case(f"tp2_bh{len(lens_tp)}_t{t_tp}", len(lens_tp), t_tp,
                                           d1, dv, lens_tp, (-1, -1), gen, dev)

    tokens, enc_lens, token_lens = train["ctc"]
    v1, blank = cfg.num_classes + 1, cfg.blank_id
    b = len(enc_lens)
    lp = torch.log_softmax(torch.randn(b, t, v1, generator=gen, device=dev) * 3, dim=-1)
    as_i32 = lambda x: torch.as_tensor(x).to(dev, torch.int32)
    rows["train"] += _ctc_case(f"train_b{b}_t{t}_u{tokens.shape[1]}", lp, as_i32(tokens),
                               as_i32(enc_lens), as_i32(token_lens), blank)
    # a U = 0 row, an infeasible row (25 labels in 17 frames), a 1-frame zero row
    u = 30
    lp_e = torch.log_softmax(torch.randn(4, 300, v1, generator=gen, device=dev) * 3, dim=-1)
    tg_e = torch.randint(0, v1 - 1, (4, u), generator=gen, device=dev).to(torch.int32)
    _ctc_case("edges_u0_infeasible", lp_e, tg_e, as_i32([300, 300, 17, 1]),
              as_i32([30, 0, 25, 0]), blank)
    # 8401 states: more than the beta kernel's 8 per thread at 1024 threads
    lp_l = torch.log_softmax(torch.randn(2, 4400, v1, generator=gen, device=dev) * 3, dim=-1)
    tg_l = torch.randint(0, v1 - 1, (2, 4200), generator=gen, device=dev).to(torch.int32)
    _ctc_case("edges_u4200", lp_l, tg_l, as_i32([4400, 4300]), as_i32([4200, 3000]), blank,
              timed=False)

    # the counted transducer step's lattice and joint, then edge cases: U+1 >
    # 1024 with a u_len = 0 row and a 1-frame row, T not a multiple of 16;
    # tanh, FastEmit 0.1 and clamp 2 on the joint; the joint at U+1 1100 and
    # at V 401; the dropout mask probe
    t, enc_lens = rnnt["t"], rnnt["enc_lens"]
    b, u = rnnt["tokens"].shape
    name = f"rnnt_b{b}_t{t}_u1{u + 1}"
    chain = _chain_probe(dev)
    emit("kernels", case="k3_chain_probe", **{k: v for k, v in chain.items()})
    rows["rnnt_train"] = _lattice_case(name, t, u + 1, enc_lens, rnnt["token_lens"], gen, dev,
                                       chain)
    rows["rnnt_train"] += _joint_case(name, b, t, u, rnnt["h"], rnnt["v"], enc_lens,
                                      rnnt["token_lens"], gen, dev, drop_t=26)
    _lattice_case("lattice_edges_u1_1100", 301, 1100, [301, 150, 1, 77], [1099, 500, 0, 0],
                  gen, dev, chain)
    # K3 at the step's T and U+1: widths 63-66 about the warp path's 64 (66
    # with one frame); 200 samples, more blocks than SMs, at loader-like
    # lengths; rows at the full width U+1 beside a u_len = 0 and a t_len = 1 row
    _lattice_case("lattice_warp_block_boundary", t, u + 1, [t, t, t - 90, 1, t],
                  [63, 64, 62, 65, 0], gen, dev, chain)
    rng = np.random.RandomState(SEED + 5)
    _lattice_case("lattice_b200", t, u + 1, rng.randint(int(0.6 * t), t + 1, 200).tolist(),
                  rng.randint(20, 51, 200).tolist(), gen, dev, chain)
    _lattice_case("lattice_full_width_rows", t, u + 1, [t, t, 1, t, t // 2],
                  [u, u, u, 0, u], gen, dev, chain)
    _joint_case("joint_edges_tanh_fastemit_clamp", 3, 37, 8, rnnt["h"], rnnt["v"], [37, 20, 1],
                [8, 3, 0], gen, dev, activation="tanh", drop_t=26, fastemit=0.1, clamp=2.0)
    # a long lattice: U+1 > 1024, three windows of cells at the flagship widths
    _joint_case("joint_edges_long_u1_1100", 2, 301, 1099, rnnt["h"], rnnt["v"], [301, 150],
                [1099, 500], gen, dev, activation="relu", drop_t=26)
    # V - 1 = 400: the backward takes the label block in two passes of columns
    _joint_case("joint_edges_v401", 3, 37, 8, rnnt["h"], 401, [37, 20, 1], [8, 3, 0], gen, dev,
                activation="relu", drop_t=26)
    # the counted step's shapes and lengths at the JAX kernel's flagship
    # vocabulary: 1024 pieces and the blank (the backward: four label passes)
    _joint_case("joint_v1025", b, t, u, rnnt["h"], JOINT_FLAGSHIP_V, enc_lens,
                rnnt["token_lens"], gen, dev, drop_t=26)
    # the forward's 64-cell tiles at the widest H they take; V 41 leaves the last
    # column group of each 64-column box nothing but pad columns
    _joint_fwd_wide_case("joint_fwd_wide_h1376", 3, 37, 8, 1376, 41, [37, 20, 1], [8, 3, 0], gen,
                         dev)
    rows["frontends"] = _frontends_rows(frontends, d1, dv, gen, dev, chain)
    _dropout_mask_probe(b, t, u, rnnt["h"], gen, dev)
    # a data-parallel rank's rows far into a global batch: the hash base wraps
    _dropout_mask_probe(b, t, u, rnnt["h"], gen, dev, row_offset=1000 * b + 3)
    _joint_case("joint_row_offset", 3, 37, 8, rnnt["h"], rnnt["v"], [37, 20, 1], [8, 3, 0], gen,
                dev, drop_t=26, row_offset=4099)
    free_cuda()
    # the joints phase's calls: K4 in fp16 and fp32 (TF32 off) at the step's
    # shapes, and in bf16 at joint widths 1024 and 600 (padded to 608), dropout on
    torch.backends.cuda.matmul.allow_tf32 = False
    rows["joints"] = []
    for name, (b_j, t_j, u_j, h_j, v_j, el_j, tl_j, dt_j) in joints["calls"].items():
        rows["joints"] += _joint_case(f"joints_{name}_b{b_j}_t{t_j}_u1{u_j + 1}_h{h_j}", b_j, t_j,
                                      u_j, h_j, v_j, el_j, tl_j, gen, dev, drop_t=26, dtype=dt_j)
        free_cuda()
    # the step's shapes at the widest H the forward takes (64-cell tiles; the
    # cells kernel's two-stage ring) and at H 100 (padded to 112); no shipped
    # configuration runs either, so they stay out of the summary line
    for h_e in (1376, 100):
        _joint_case(f"joint_h{h_e}", b, t, u, h_e, rnnt["v"], enc_lens, rnnt["token_lens"], gen,
                    dev, drop_t=26)
        free_cuda()

    # the multilang steps' K1 (V + 1 584, blank 583) and K4 (V 584) calls
    ml = multilang["ctc"]
    t, b = ml["t"], len(ml["enc_lens"])
    lp = torch.log_softmax(torch.randn(b, t, MULTILANG_V1, generator=gen, device=dev) * 3, dim=-1)
    rows["multilang"] = _ctc_case(f"multilang_b{b}_t{t}_u{ml['tokens'].shape[1]}", lp,
                                  as_i32(ml["tokens"]), as_i32(ml["enc_lens"]),
                                  as_i32(ml["token_lens"]), MULTILANG_V1 - 1)
    ml = multilang["rnnt"]
    b, u = ml["tokens"].shape
    rows["multilang"] += _joint_case(f"multilang_rnnt_b{b}_t{ml['t']}_u1{u + 1}", b, ml["t"], u,
                                     ml["h"], ml["v"], ml["enc_lens"], ml["token_lens"], gen,
                                     dev, drop_t=26)
    return rows


# a whole backward runs once per call; its last kernel counts the calls
WHOLE_COUNTED_BY = {"K1-bwd-whole": "K1-bwd-grad",
                    **{f"K4-bwd-whole{x}": f"K4-bwd-reduce{x}" for x in ("", "-f16", "-f32")}}


def kernel_summary(rows: dict, launches: dict) -> list:
    """The summary line's entries: every main-path kernel row, and each
    whole backward as one function, with the launches its path made at its
    shape."""
    sources = {"K2-fwd": FLASH_FWD, "K2-bwd-dq": FLASH_DQ, "K2-bwd-dkv": FLASH_DKV,
               "K2-fwd-f16": FLASH_FWD, "K2-bwd-dq-f16": FLASH_DQ, "K2-bwd-dkv-f16": FLASH_DKV,
               "K2-fwd-f32": FLASH_F32_FWD, "K2-bwd-dq-f32": FLASH_F32_DQ,
               "K2-bwd-dkv-f32": FLASH_F32_DKV,
               "K1-fwd": CTC_FWD, "K1-bwd": CTC_BWD, "K1-bwd-grad": CTC_BWD,
               "K1-bwd-whole": CTC_BWD, "K3-alpha": RNNT_ALPHA, "K3-beta": RNNT_BETA,
               **{f"K4-{k}{x}": (src, (JOINT_FWD if k == "fwd" else JOINT_BWD)[1])
                  for x, src in (("", JOINT_FWD[0]), ("-f16", JOINT_FWD[0]),
                                 ("-f32", JOINT_F32))
                  for k in ("fwd", "bwd", "bwd-dw", "bwd-reduce", "bwd-whole")}}
    kernels = []
    for path, path_rows in rows.items():
        for r in path_rows:
            k = r["kernel"]
            if "shape" in r:
                shape = tuple(r["shape"])
            elif k.startswith("K2"):
                shape = (r["bh"], r["t"], r["d1"], r["dv"], *r["band"])
            else:
                shape = (r["b"], r["t"], r["u"], r["v1"])
            source, replaces = sources[k]
            kernels.append({
                "name": f"{k}[{path}:{','.join(map(str, shape))}]", "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": launches[path].get(WHOLE_COUNTED_BY.get(k, k), {}).get(shape, 0),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]})
    check(all(k["launches"] > 0 for k in kernels), kernels)
    check({k["name"].split("[")[0] for k in kernels} == set(sources), kernels)
    return kernels


def joint_bench(root: str) -> int:
    """K4 alone, with the package imported from the checkout at `root` (so
    that two versions can be timed in turns on one card): `_joint_case` at
    the transducer step's shapes, its lengths from the same generated
    manifest through the loader (no fit), at the config's V and at V 1025."""
    from conformer_nemo_tpu_torch.api import ConformerTransducer

    dev = torch.device("cuda")
    env = phase_env()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        manifest = _write_manifest(tmp, "rnnt_train", 16, 10.0, 16.0,
                                   np.random.RandomState(SEED + 3))
        model = ConformerTransducer.from_config_file(RNNT_CONFIG, overrides=RNNT_OVERRIDES,
                                                     seed=SEED)
        batch = next(iter(model._loader(manifest, model.raw_cfg["model"]["train_ds"],
                                        shuffle=True)))
        cfg = model.cfg.model
        t = _frames(model, [batch.audio.shape[1]])[0]
        enc_lens = _frames(model, batch.audio_lens.tolist())
        h, v = cfg.joint.joint_hidden, cfg.num_classes_with_blank
        del model
    free_cuda()
    b, u = batch.tokens.shape
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for vv in (v, JOINT_FLAGSHIP_V):
        _joint_case(f"bench_b{b}_t{t}_u1{u + 1}_v{vv}", b, t, u, h, vv, enc_lens,
                    batch.token_lens.tolist(), gen, dev, drop_t=26)
        free_cuda()
    emit("joint_bench", root=os.path.abspath(root), nvidia_smi=env["nvidia_smi"])
    return 0


def flash_bench(root: str) -> int:
    """K2 alone, with the package imported from the checkout at `root` (so
    that two versions can be timed in turns on one card): `_flash_case` and
    `_flash_bwd_case` in bf16, fp16 and fp32 at the train step's shapes (the
    long-form Large model: d1 576, dv 64) and at the widths phase's (Small:
    d1 220, dv 44; XLarge: d1 1152, dv 128), each batch's lengths from the
    same generated manifests through the loader (no fit), and at the train
    step's shapes with every row at its full length. Each case's times sit
    beside SDPA's forward and backward on the same inputs (`library_fwd`,
    `library_bwd`), so "no slower than SDPA" reads from one run."""
    from conformer_nemo_tpu_torch.api import ConformerCTC

    dev = torch.device("cuda")
    env = phase_env()
    phase_build()
    shapes = {}
    with tempfile.TemporaryDirectory() as tmp:
        lf = _write_manifest(tmp, "lf_train", 16, 45.0, 75.0, np.random.RandomState(SEED + 1))
        wd = _write_manifest(tmp, "widths", WIDTHS_FILES, WIDTHS_SECONDS, WIDTHS_SECONDS,
                             np.random.RandomState(SEED + 21))
        for name, config, overrides, manifest in (
                ("flagship", LONGFORM, TRAIN_OVERRIDES, lf),
                ("small", CONFIG, {**SMALL_OVERRIDES, **SMALL_FIT}, wd),
                ("xlarge", CONFIG, WIDE_OVERRIDES, wd)):
            model = ConformerCTC.from_config_file(config, overrides=overrides, seed=SEED)
            batch = next(iter(model._loader(manifest, model.raw_cfg["model"]["train_ds"],
                                            shuffle=True)))
            enc = model.cfg.encoder
            t = encoder_frames(model.cfg, [batch.audio.shape[1]])[0]
            lens = [n for n in encoder_frames(model.cfg, batch.audio_lens.tolist())
                    for _ in range(enc.n_heads)]
            shapes[name] = (len(lens), t, enc.d_head + enc.d_model, enc.d_head, lens)
            del model
            free_cuda()
    bh, t, d1, dv, _ = shapes["flagship"]
    shapes["flagship_full"] = (bh, t, d1, dv, [t] * bh)  # every row at T: the most pairs
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ms = {}
    for name, (bh, t, d1, dv, lens) in shapes.items():
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            case = f"bench_{name}_{str(dtype).split('.')[-1]}_bh{bh}_t{t}"
            rows = [_flash_case(case, bh, t, d1, dv, lens, (-1, -1), gen, dev, dtype=dtype),
                    *_flash_bwd_case(case, bh, t, d1, dv, lens, (-1, -1), gen, dev, dtype=dtype)]
            ms[case] = {r["kernel"]: r["ms"] for r in rows}
            ms[case]["library_fwd"] = rows[0]["library_ms"]
            ms[case]["library_bwd"] = rows[1]["library_ms"]
            free_cuda()
    emit("flash_bench", root=os.path.abspath(root), nvidia_smi=env["nvidia_smi"], ms=ms)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dist-worker"]:
        return dist_worker(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--joint-bench"]:
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        return joint_bench(sys.argv[2])
    if sys.argv[1:2] == ["--flash-bench"]:
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        return flash_bench(sys.argv[2])
    from conformer_nemo_tpu_torch.api import ConformerCTC

    dev = torch.device("cuda")
    env = phase_env()
    phase_build()
    model = ConformerCTC.from_config_file(CONFIG, overrides=OVERRIDES, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        groups = _write_inputs(tmp)
        fwd_by_shape, flash_calls = phase_transcribe(model, groups, env["nvidia_smi"])
        decode_by_shape, decode_calls = phase_decode_ctc(model, groups, tmp, env["nvidia_smi"])
        cfg = model.cfg
        # the model stays on the card for the diarization phase's transcript
        free_cuda()
        train = phase_train(tmp, env["nvidia_smi"])
        phase_bpe_step(tmp)
        phase_train_parity(train["train_manifest"])
        widths = phase_widths(tmp, train["train_manifest"], env["nvidia_smi"])
        rnnt = phase_rnnt_train(tmp, env["nvidia_smi"])
        phase_decode_rnnt(rnnt["archive"], rnnt["manifest"], tmp, env["nvidia_smi"])
        phase_rnnt_dense_step(rnnt["manifest"])
        phase_rnnt_parity(rnnt["manifest"])
        joints = phase_joints(rnnt["manifest"], tmp, env["nvidia_smi"])
        multilang = phase_multilang(tmp, env["nvidia_smi"])
        dist = phase_distributed(tmp, train, rnnt, env["nvidia_smi"])
        # last of the fits, so that its host buffers and save thread precede no timed step
        phase_lifecycle(tmp, train["train_manifest"], train["val_manifest"], env["nvidia_smi"])
        streaming = phase_streaming(tmp, rnnt["archive"], rnnt["manifest"], env["nvidia_smi"])
        os.remove(rnnt["archive"])
        frontends = phase_frontends(tmp, groups, rnnt["manifest"], env["nvidia_smi"])
        ssl = phase_ssl(tmp, env["nvidia_smi"])
        phase_labels(tmp, env["nvidia_smi"])
        diar = phase_diarization(tmp, model, env["nvidia_smi"])
        del model
        free_cuda()
    rows = phase_kernels(dev, cfg, flash_calls, train, rnnt, multilang, decode_calls, dist,
                         streaming, frontends, ssl, diar, widths, joints)

    # the NCCL world-1 fit ran the train phase's calls again
    train_launches = {k: {sh: n + dist["nccl_by_shape"].get(k, {}).get(sh, 0)
                          for sh, n in d.items()} for k, d in train["by_shape"].items()}
    kernels = kernel_summary(rows, {"transcribe": {"K2-fwd": fwd_by_shape},
                                    "decode": {"K2-fwd": decode_by_shape},
                                    "distributed": dist["tp_by_shape"],
                                    "train": train_launches, "rnnt_train": rnnt["by_shape"],
                                    "streaming": streaming["by_shape"],
                                    "frontends": frontends["by_shape"],
                                    "ssl": ssl["by_shape"],
                                    "diarization": {"K2-fwd": diar["by_shape"]},
                                    "widths": widths["by_shape"],
                                    "joints": joints["by_shape"],
                                    "multilang": {**multilang["ctc"]["by_shape"],
                                                  **multilang["rnnt"]["by_shape"]}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(env["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
