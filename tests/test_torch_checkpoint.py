"""Checkpoints and the experiment manager of the port, on the CPU.

- the flax msgpack codec (convert/flax_msgpack.py) against
  flax.serialization in both directions: the same bytes, the same leaves
  (bf16 and chunked leaves included);
- an async save holds the values of the moment it returned, whatever the
  train step does to the live tensors afterwards;
- pruning and `last` leave the same checkpoints as the JAX module's on the
  same metric sequence;
- `ExperimentManager` versioning, `resume_if_exists` and
  `resume_ignore_no_checkpoint`;
- resume is exact: a tiny `fit` (2 layers, d_model 64) stopped at step 2
  and resumed to step 4 from its checkpoint by a fresh model equals, bit
  for bit, one model fitting to 2 and then to 4 in memory (parameters,
  BatchNorm statistics, Adam moments and count, generator state, step);
- `trainer.resume_from_checkpoint`, `max_time_s`;
- one tiny `fit` of each package with an experiment manager leaves the same
  checkpoint names, `meta.json` keys and `metrics.jsonl` keys.
"""

import json
import os
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from conformer_nemo_tpu.train import checkpoint as jax_ckpt
from conformer_nemo_tpu_torch.api import ConformerCTC
from conformer_nemo_tpu_torch.convert import flax_msgpack
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.train import checkpoint as ckpt
from conformer_nemo_tpu_torch.train.exp_manager import ExpManagerConfig, ExperimentManager

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "conformer_ctc_bpe.yaml")
TINY = {
    "model.tokenizer.model_file": os.path.join(ROOT, "tests", "fixtures",
                                               "sp_bpe_bytefallback.model"),
    "model.encoder.n_layers": 2, "model.encoder.d_model": 64, "model.encoder.n_heads": 4,
    "model.train_ds.batch_size": 2, "model.validation_ds.batch_size": 2,
}


def _tiny(**overrides):
    return ConformerCTC.from_config_file(CONFIG, overrides={**TINY, **overrides}, device="cpu",
                                         dtype=torch.float32)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_fit")
    rng = np.random.RandomState(0)
    with open(d / "train.json", "w", encoding="utf-8") as f:
        for i, text in enumerate(["hello world", "the quick brown fox", "speech", "a test"]):
            n = int(rng.uniform(1.0, 2.0) * 16000)
            write_wav(str(d / f"{i}.wav"), (0.1 * rng.randn(n)).astype(np.float32))
            f.write(json.dumps({"audio_filepath": f"{i}.wav", "duration": n / 16000,
                                "text": text}) + "\n")
    return str(d / "train.json")


# ---------------------------------------------------------------------------
# the msgpack codec
# ---------------------------------------------------------------------------


def _tree(rng):
    return {"params": {"enc": {"kernel": rng.randn(3, 4).astype(np.float32),
                               "bias": rng.randn(70000).astype(np.float32)},
                       "idx": np.arange(5, dtype=np.int32), "flag": np.array([True, False])},
            "step": 12345, "neg": -200, "rate": 1.5, "name": "x" * 40, "none": None,
            "scalar": np.float32(2.5), "seq": [1, 2, np.int64(-7)],
            "empty": np.zeros((0, 3), np.float32), "u8": np.arange(256, dtype=np.uint8)}


def _assert_same_tree(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("case", ["mixed", "bfloat16", "chunked"])
def test_msgpack_codec_matches_flax(case, monkeypatch):
    """dumps(tree) == flax.serialization.to_bytes(tree), and each side's
    reader returns the other's leaves, exactly."""
    rng = np.random.RandomState(0)
    if case == "mixed":
        tree = _tree(rng)
    elif case == "bfloat16":
        tree = {"w": np.asarray(jnp.asarray(rng.randn(5, 3), jnp.bfloat16)),
                "b": np.asarray(jnp.asarray(rng.randn(7), jnp.bfloat16))}
    else:  # leaves over the chunk limit, lowered in both modules
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
        tree = {"x": rng.randn(50).astype(np.float32),
                "y": {"z": rng.randn(3, 7).astype(np.float32), "s": np.float32(1.0)}}
    flax_bytes = serialization.to_bytes(tree)
    assert flax_msgpack.dumps(tree) == flax_bytes
    mine = flax_msgpack.loads(flax_bytes)
    theirs = serialization.msgpack_restore(flax_bytes)
    if case == "bfloat16":  # numpy has no bfloat16 here: torch.bfloat16 by name
        for k in tree:
            assert mine[k].dtype == torch.bfloat16
            assert np.array_equal(mine[k].float().numpy(), theirs[k].astype(np.float32))
        mine = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
                for k, v in theirs.items()}
        assert flax_msgpack.dumps(mine) == flax_bytes  # torch bf16 leaves write flax's bytes
    else:
        _assert_same_tree(theirs, mine)
    # and flax reads what the port writes
    _assert_same_tree(serialization.msgpack_restore(flax_msgpack.dumps(tree)),
                      serialization.msgpack_restore(flax_bytes))


def test_msgpack_codec_rejects_truncated_data():
    blob = flax_msgpack.dumps({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(blob[:-2])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.loads(blob + b"\x00")


# ---------------------------------------------------------------------------
# resumable checkpoints
# ---------------------------------------------------------------------------


def _toy_state(seed=0):
    """A train state of the port's shape around a small module."""
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    torch.manual_seed(seed)
    for p in model.parameters():
        p.data.normal_()
    opt = {"count": 3, "mu": [torch.randn_like(p) for p in model.parameters()],
           "nu": [torch.rand_like(p) for p in model.parameters()]}
    return types.SimpleNamespace(model=model, opt_state=opt,
                                 generator=torch.Generator().manual_seed(seed + 11), step=7)


def _state_equal(a, b) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
            and a.opt_state["count"] == b.opt_state["count"]
            and all(torch.equal(x, y) for key in ("mu", "nu")
                    for x, y in zip(a.opt_state[key], b.opt_state[key]))
            and torch.equal(a.generator.get_state(), b.generator.get_state())
            and a.step == b.step)


def test_async_save_holds_the_values_of_its_return(tmp_path):
    """The write waits behind a blocked worker while the live parameters,
    BatchNorm statistics, Adam moments and generator move on; the restore
    gives the values of the moment `save_train_state_async` returned."""
    state = _toy_state()
    snapshot = _toy_state()  # the same values, untouched
    gate = threading.Event()
    blocker = ckpt._save_pool().submit(gate.wait)
    fut = ckpt.save_train_state_async(str(tmp_path), state, 7, {"val_wer": 0.5})
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        state.model[1].running_mean.add_(1.0)
        for m in state.opt_state["mu"]:
            m.mul_(2.0)
    torch.randint(0, 10, (5,), generator=state.generator)
    state.step += 1
    assert not fut.done()
    gate.set()
    blocker.result()
    assert fut.result() == os.path.join(str(tmp_path), "step_7")
    fresh = _toy_state(seed=5)
    restored, meta = ckpt.restore_train_state(str(tmp_path), fresh)
    assert restored is fresh and meta == {"step": 7, "metrics": {"val_wer": 0.5}}
    assert _state_equal(fresh, snapshot)


def test_restore_without_a_checkpoint_returns_none(tmp_path):
    assert ckpt.restore_train_state(str(tmp_path), _toy_state()) == (None, None)


def test_prune_and_last_match_the_jax_module(tmp_path):
    """The same save sequence and metrics: the same checkpoints survive
    pruning, `last` included, in both packages' layouts."""
    seq = [(1, 0.9), (2, 0.5), (3, None), (4, 0.4), (5, 0.8), (6, 0.95)]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    state = _toy_state()
    for step, wer in seq:
        ckpt.save_train_state(port_dir, state, step, {"val_wer": wer})
        jax_ckpt.save_train_state(jax_dir, {"w": np.zeros(2, np.float32)}, step,
                                  {"val_wer": wer})
        for d, prune in ((port_dir, ckpt.prune_checkpoints),
                         (jax_dir, jax_ckpt.prune_checkpoints)):
            prune(d, save_top_k=2, monitor="val_wer", mode="min")
        assert ckpt.list_checkpoints(port_dir) == jax_ckpt.list_checkpoints(jax_dir)
        for name in ("last",):
            with open(os.path.join(port_dir, name)) as a, open(os.path.join(jax_dir, name)) as b:
                assert a.read() == b.read()
    assert [n for n, _ in ckpt.list_checkpoints(port_dir)] == ["step_2", "step_4", "step_6"]
    for mode in ("min", "max"):
        ckpt.prune_checkpoints(port_dir, 1, "val_wer", mode)
        jax_ckpt.prune_checkpoints(jax_dir, 1, "val_wer", mode)
        assert ckpt.list_checkpoints(port_dir) == jax_ckpt.list_checkpoints(jax_dir)


def test_exp_manager_versions_and_resume(tmp_path):
    cfg = dict(exp_dir=str(tmp_path), name="run", create_tensorboard_logger=False)
    first = ExperimentManager(ExpManagerConfig(**cfg))
    second = ExperimentManager(ExpManagerConfig(**cfg))
    assert first.run_dir.endswith(os.path.join("run", "version_0"))
    assert second.run_dir.endswith(os.path.join("run", "version_1"))
    assert os.path.exists(os.path.join(second.run_dir, "run-info.json"))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ExperimentManager(ExpManagerConfig(**cfg, resume_if_exists=True)).maybe_resume(
            _toy_state())
    ignore = ExperimentManager(ExpManagerConfig(**cfg, resume_if_exists=True,
                                                resume_ignore_no_checkpoint=True))
    assert ignore.run_dir == second.run_dir  # resumes the newest version
    assert ignore.maybe_resume(_toy_state()) == (None, None)
    assert second.maybe_resume(_toy_state()) == (None, None)  # resume_if_exists is off
    state = _toy_state()
    second.save(state, 3, {"val_wer": 0.25})
    second.wait_for_saves()
    again = ExperimentManager(ExpManagerConfig(**cfg, resume_if_exists=True))
    fresh = _toy_state(seed=9)
    restored, meta = again.maybe_resume(fresh)
    assert meta["step"] == 3 and _state_equal(restored, state)
    again.logger.log(3, val_wer=0.25)
    with open(os.path.join(again.run_dir, "metrics.jsonl")) as f:
        assert json.loads(f.readline())["val_wer"] == 0.25


# ---------------------------------------------------------------------------
# fit with checkpoints
# ---------------------------------------------------------------------------


def _train_state_equal(a, b) -> bool:
    def flat(opt):
        return [t for key in ("mu", "nu") for t in opt[key]]

    sa, sb = a.state_dict(), b.state_dict()
    ta, tb = a.train_state, b.train_state
    return (sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
            and ta.opt_state["count"] == tb.opt_state["count"]
            and all(torch.equal(x, y) for x, y in zip(flat(ta.opt_state), flat(tb.opt_state)))
            and torch.equal(ta.generator.get_state(), tb.generator.get_state())
            and ta.step == tb.step)


def test_resume_equals_the_uninterrupted_run(manifest, tmp_path):
    em_cfg = dict(exp_dir=str(tmp_path), name="resume", create_tensorboard_logger=False)
    stopped = _tiny()
    stopped.fit(manifest, manifest, max_steps=2, exp_manager=ExperimentManager(
        ExpManagerConfig(**em_cfg)))
    resumed = _tiny()
    out = resumed.fit(manifest, manifest, max_steps=4, exp_manager=ExperimentManager(
        ExpManagerConfig(**em_cfg, resume_if_exists=True)))
    assert out["steps"] == 4
    memory = _tiny()
    memory.fit(manifest, manifest, max_steps=2)
    assert _train_state_equal(memory, stopped)
    memory.fit(manifest, manifest, max_steps=4)
    assert memory.train_state.step == 4
    assert _train_state_equal(resumed, memory)
    bn = "encoder.layers.0.conv.batch_norm.running_var"
    assert not torch.equal(resumed.state_dict()[bn], stopped.state_dict()[bn])


def test_resume_from_checkpoint_and_max_time(manifest, tmp_path):
    em = ExperimentManager(ExpManagerConfig(exp_dir=str(tmp_path), name="timed",
                                            create_tensorboard_logger=False))
    timed = _tiny()
    out = timed.fit(manifest, max_steps=4, max_time_s=1e-9, exp_manager=em)
    assert out["stopped"] == "max_time" and out["steps"] == 1
    assert not timed.model.training
    names = [n for n, meta in ckpt.list_checkpoints(em.ckpt_dir)]
    assert names == ["step_1"]
    follow = _tiny(**{"trainer.resume_from_checkpoint": em.ckpt_dir})
    assert follow.fit(manifest, max_steps=2)["steps"] == 2  # one step from the restored 1
    timed.fit(manifest, max_steps=2)
    assert _train_state_equal(follow, timed)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _tiny(**{"trainer.resume_from_checkpoint": str(tmp_path / "nowhere")}).fit(
            manifest, max_steps=1)


def _layout(run_dir: str) -> dict:
    ckpts = os.path.join(run_dir, "checkpoints")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [sorted(json.loads(line)) for line in f]
    return {"checkpoints": sorted(os.listdir(ckpts)),
            "meta": [sorted(meta) + sorted(meta["metrics"])
                     for _, meta in ckpt.list_checkpoints(ckpts)],
            "metrics": lines, "run": sorted(os.listdir(run_dir))}


def test_fit_layout_matches_the_jax_package(manifest, tmp_path):
    """One tiny fit of each package, 2 steps, log every step, validation at
    the epoch's end: the same checkpoint names, meta.json keys and
    metrics.jsonl keys line by line."""
    from conformer_nemo_tpu.api import ConformerCTC as JaxConformerCTC
    from conformer_nemo_tpu.train.exp_manager import (
        ExpManagerConfig as JaxExpManagerConfig,
        ExperimentManager as JaxExperimentManager,
    )

    kw = dict(name="layout", create_tensorboard_logger=False)
    port = ExperimentManager(ExpManagerConfig(exp_dir=str(tmp_path / "port"), **kw))
    _tiny().fit(manifest, manifest, max_steps=2, log_every_n_steps=1, exp_manager=port)
    jax_em = JaxExperimentManager(JaxExpManagerConfig(exp_dir=str(tmp_path / "jax"), **kw))
    jm = JaxConformerCTC.from_config_file(CONFIG, overrides=TINY, dtype=jnp.float32)
    jm.fit(manifest, manifest, max_steps=2, log_every_n_steps=1, exp_manager=jax_em)
    got, want = _layout(port.run_dir), _layout(jax_em.run_dir)
    assert got["checkpoints"] == want["checkpoints"] == ["last", "step_2"]
    assert got["meta"] == want["meta"]
    assert got["metrics"] == want["metrics"]
    assert got["run"] == want["run"]
    # the state file is each package's own
    assert sorted(os.listdir(os.path.join(port.ckpt_dir, "step_2"))) == ["meta.json", "state.pt"]
