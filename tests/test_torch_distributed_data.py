"""What each rank reads and draws, against the JAX package, and a two-rank
`fit` through the API.

- The bucketed loader's rank slice (every process_count-th sample of the
  shuffled order, before the bucket fill) and the tar shards' `scatter` /
  `replicate` partitions equal the JAX package's index for index.
- The flash joint's dropout mask: the JAX package's data-sharded joint
  (Pallas in interpret mode, its batch sharded over two devices) gives the
  unsharded run's outputs, so its hash indexes the global row; the port's
  rank r, passed its first row's offset (`joint_seed`), draws the JAX
  mask's rows of that rank bit for bit, and its plain forward on its rows
  gives the JAX outputs' rows (fp32, 1e-5 relative).
- Two gloo ranks (`torch_dist_worker.run_world`) fit a tiny CTC config with
  `trainer.mesh: {data: -1}`, the white-noise augmentor and an experiment
  manager for two epochs on a manifest whose rank plans differ in length:
  both ranks take the same number of steps each epoch (the least of the
  two plans; the longer rank logs what it drops), and each step takes the
  batch of the JAX package's `_loader` at that rank's process index, in
  that epoch, bit for bit (the augmentation follows the epoch). The ranks
  end with equal parameters, log the world, mesh and global batch, share
  one run directory that only rank 0 writes, and refuse a mesh that does
  not fit the world before a step. The same on tar shards of five and
  three members (a stream of unknown length): both ranks stop after two
  steps. One process, outside a launcher, likewise takes the JAX
  loader's batches of epochs 0 and 1.
- The CTC training script under two ranks: rank 0 alone prints and writes
  the archive. Outside a launcher, fit trains on one device and says so.
"""

import json
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.api import ConformerCTC as JaxConformerCTC
from conformer_nemo_tpu.data import dataset as jds
from conformer_nemo_tpu.data import manifest as jman
from conformer_nemo_tpu.data import tarred as jtar
from conformer_nemo_tpu.data import tokenizers as jtok
from conformer_nemo_tpu.ops.pallas import rnnt_joint_kernel as jk
from conformer_nemo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from conformer_nemo_tpu_torch.data import dataset as pds
from conformer_nemo_tpu_torch.data import manifest as pman
from conformer_nemo_tpu_torch.data import tarred as ptar
from conformer_nemo_tpu_torch.data import tokenizers as ptok
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.ops import rnnt_joint as pj
from torch_dist_worker import BATCH_ARRAYS, record_batches, run_world

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = list(" abcdefghijklmnopqrstuvwxyz'")
CHAR_CONFIG = os.path.join(ROOT, "configs", "conformer_ctc_char.yaml")
FIT_OVERRIDES = {
    "model.labels": LABELS, "model.encoder.n_layers": 1, "model.encoder.d_model": 32,
    "model.encoder.n_heads": 2, "model.train_ds.batch_size": 2,
    "model.validation_ds.batch_size": 2, "model.train_ds.num_buckets": 8,
    "model.train_ds.augmentor": {"white_noise": {"prob": 1.0}},
    "trainer.mesh": {"data": -1, "model": 1}, "trainer.log_every_n_steps": 1,
}


def _manifest(d, n: int, rng, lo: float = 0.4, hi: float = 1.6, audio: bool = False) -> str:
    path = os.path.join(d, "m.json")
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            secs = float(np.round(rng.uniform(lo, hi), 2))
            if audio:
                write_wav(os.path.join(d, f"{i}.wav"),
                          (0.1 * rng.randn(int(secs * 16000))).astype(np.float32))
            f.write(json.dumps({"audio_filepath": f"{i}.wav", "duration": secs,
                                "text": "abc def"[: 1 + i % 7]}) + "\n")
    return path


@pytest.mark.parametrize("count,strategy", [(2, "synced_randomized"), (3, "synced_randomized"),
                                            (2, "fully_randomized")])
def test_loader_rank_slices_match_jax(tmp_path, count, strategy):
    path = _manifest(str(tmp_path), 23, np.random.RandomState(0))

    def plans(ds_mod, man_mod, tok_mod, shuffle):
        ds = ds_mod.BucketedAudioTextDataset(man_mod.read_manifest(path),
                                             tok_mod.build_tokenizer({"labels": LABELS}),
                                             n_buckets=4)
        out = []
        for rank in range(count):
            loader = ds_mod.BucketedLoader(ds, 3, shuffle=shuffle, seed=5, process_index=rank,
                                           process_count=count, bucketing_strategy=strategy)
            loader.epoch = 1
            out.append(loader._plan())
        return out

    for shuffle in (True, False):
        got = plans(pds, pman, ptok, shuffle)
        want = plans(jds, jman, jtok, shuffle)
        assert got == want
        seen = sorted(i for plan in got for _, idxs in plan for i in idxs)
        assert seen == list(range(23))  # the ranks share the samples out


@pytest.mark.parametrize("world", [1, 2, 4])
def test_tar_shard_partitions_match_jax(world):
    paths = ["a/audio_{0..7}.tar", "b/audio__OP_0..3_CL_.tar,c/x.tar"]
    for p in paths:
        for strategy in ("scatter", "replicate"):
            for rank in range(world):
                try:
                    want = jtar.expand_sharded_filepaths(p, strategy, world, rank)
                except ValueError as e:
                    with pytest.raises(ValueError, match="divisible by world_size"):
                        ptar.expand_sharded_filepaths(p, strategy, world, rank)
                    assert "divisible by world_size" in str(e)
                    continue
                assert ptar.expand_sharded_filepaths(p, strategy, world, rank) == want


def _joint_inputs(b=4, t=9, u=3, h=16, v=6, seed=0):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return (rng.randn(b, t, h).astype(f32), rng.randn(b, u + 1, h).astype(f32),
            (0.3 * rng.randn(h, v)).astype(f32), (0.1 * rng.randn(v)).astype(f32),
            rng.randint(0, v - 1, (b, u)).astype(np.int32))


def test_joint_dropout_mask_under_data_parallelism_matches_jax():
    seed, drop_t, bt, ranks = 1234567, 64, 4, 2
    e, p, w, bias, targets = _joint_inputs()
    b, t, h = e.shape
    u1, v = p.shape[1], w.shape[1]
    kw = dict(blank_id=v - 1, activation="relu", drop_t=drop_t, bt=bt)
    jseed = jnp.asarray([seed], jnp.int32)

    fwd = jax.jit(lambda *a: jk.joint_flash_fwd(*a, jseed, interpret=True, **kw))
    args = tuple(jnp.asarray(x) for x in (e, p, w, bias, targets))
    whole = fwd(*args)
    mesh = jax_make_mesh(data=ranks, model=1, devices=jax.devices()[:ranks])
    rows = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    sharded = fwd(*(jax.device_put(x, rows if x.shape[0] == b and x.ndim > 1 else rep)
                    for x in args))
    for a, c in zip(whole, sharded):  # the data-sharded joint hashes the global row
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))

    tp = pj.padded_t(t, bt)
    want_mask = np.asarray(jk.hash_keep_mask_reference((b, tp, u1, h), jseed, drop_t))
    bl = b // ranks
    for r in range(ranks):
        rows_r = slice(r * bl, (r + 1) * bl)
        rseed = pj.joint_seed(seed, r * bl, t, u1, h, bt)
        mask = pj.hash_keep_mask_reference((bl, tp, u1, h), rseed, drop_t).numpy()
        np.testing.assert_array_equal(mask, want_mask[rows_r])
        if r:  # without the offset the rank would draw rank 0's mask
            assert not np.array_equal(pj.hash_keep_mask_reference(
                (bl, tp, u1, h), torch.tensor([seed], dtype=torch.int32), drop_t).numpy(),
                want_mask[rows_r])
        got = pj.joint_flash_fwd_reference(
            *(torch.from_numpy(x[rows_r]) for x in (e, p)), torch.from_numpy(w),
            torch.from_numpy(bias), torch.from_numpy(targets[rows_r]), rseed,
            t_lens=torch.full((bl,), t, dtype=torch.int32),
            u_lens=torch.full((bl,), u1 - 1, dtype=torch.int32), **kw)
        for g, c in zip(got, whole):
            np.testing.assert_allclose(g.numpy(), np.asarray(c)[rows_r], rtol=1e-5, atol=1e-5)


def jax_loader_epochs(manifest: str, count: int, epochs: int = 2) -> list:
    """The JAX package's `_loader` for the fit config at each of `count`
    process indices (as a launch of `count` processes sets them): per
    rank, per epoch, its batches, cut to the least of the ranks' counts."""
    jm = JaxConformerCTC.from_config_file(CHAR_CONFIG, overrides=FIT_OVERRIDES)
    loaders = []
    for rank in range(count):
        loader = jm._loader(manifest, jm.raw_cfg["model"]["train_ds"], True)
        loader.process_index, loader.process_count = rank, count
        loaders.append(loader)
    out: list = [[] for _ in range(count)]
    for _ in range(epochs):
        n = min(len(loader) for loader in loaders)
        for rank, loader in enumerate(loaders):
            out[rank].append(list(loader)[:n])
    return out


def assert_steps_took(seen: list, epochs: list) -> None:
    """The batches of a fit's steps are the epochs' batches, in order, bit
    for bit; the augmentation differs between the epochs."""
    want = [b for epoch in epochs for b in epoch]
    assert len(seen) == len(want)
    for i, (got, ref) in enumerate(zip(seen, want)):
        for k in BATCH_ARRAYS:
            np.testing.assert_array_equal(got[k], getattr(ref, k), err_msg=f"step {i} {k}")
    assert not np.array_equal(epochs[0][0].audio, epochs[1][0].audio)


def test_two_epoch_fit_takes_the_jax_loaders_epochs(tmp_path):
    """One process, no launcher: fit's two epochs take the JAX `_loader`'s
    epoch 0 and epoch 1 batches, each augmented in its own epoch."""
    from conformer_nemo_tpu_torch.api import ConformerCTC

    manifest = _manifest(str(tmp_path), 5, np.random.RandomState(3), 0.5, 1.5, audio=True)
    model = ConformerCTC.from_config_file(CHAR_CONFIG, overrides=FIT_OVERRIDES, device="cpu",
                                          dtype=torch.float32)
    seen = record_batches(model)
    epochs = jax_loader_epochs(manifest, 1)[0]
    assert model.fit(manifest, max_epochs=2)["steps"] == len(seen) == 2 * len(epochs[0])
    assert_steps_took(seen, epochs)


def test_two_rank_fit_with_unequal_plans(tmp_path):
    """Nine utterances, batch 2, eight buckets: rank 0 gets five (three
    batches at least), rank 1 four, in other buckets; fit runs two epochs."""
    d = str(tmp_path)
    manifest = _manifest(d, 9, np.random.RandomState(3), 0.5, 1.5, audio=True)
    # two tar shards of five and three members: scatter gives each rank one
    for shard, members in enumerate((range(5), range(5, 8))):
        with tarfile.open(os.path.join(d, f"audio_{shard}.tar"), "w") as tar:
            for i in members:
                tar.add(os.path.join(d, f"{i}.wav"), arcname=f"{i}.wav")
    tar_overrides = {"model.train_ds.is_tarred": True, "model.train_ds.tarred_audio_filepaths":
                     os.path.join(d, "audio_{0..1}.tar"), "model.train_ds.max_duration": 1.6}
    results = run_world(d, "fit", 2, config=CHAR_CONFIG, overrides=FIT_OVERRIDES,
                        manifest=manifest, exp_dir=os.path.join(d, "exp"),
                        tar_overrides=tar_overrides, epochs=2)
    assert [r["tar_steps"] for r in results] == [2, 2]  # rank 1's stream has two batches
    assert any("ends its stream early" in m for m in results[0]["log"])
    lens = [r["local_len"] for r in results]
    assert lens[0] != lens[1]
    steps = min(lens)
    for r, epochs in zip(results, jax_loader_epochs(manifest, 2)):
        assert r["result"]["steps"] == 2 * steps
        assert_steps_took(r["batches"], epochs)
        assert any("world 2" in m and "data 2 x model 1" in m and "global batch" in m
                   for m in r["log"]), r["log"]
        assert "needs a world of 3 processes" in r["refused"]
    longer = int(np.argmax(lens))
    for epoch in (0, 1):
        assert any(f"drops {lens[longer] - steps} of its {lens[longer]} batches in epoch "
                   f"{epoch}" in m for m in results[longer]["log"])
    for k, v in results[0]["state"].items():
        assert torch.equal(results[1]["state"][k], v), k
    assert results[0]["run_dir"] == results[1]["run_dir"]
    val = [{k: v for k, v in r["result"]["val"].items() if k != "example"} for r in results]
    assert val[0] == val[1] and val[0]["words"] > 0  # summed over both ranks' slices
    with open(os.path.join(results[0]["run_dir"], "metrics.jsonl")) as f:
        assert len([json.loads(line) for line in f if "train_loss" in line]) == 2 * steps
    assert os.path.exists(os.path.join(results[0]["run_dir"], "checkpoints",
                                       f"step_{2 * steps}", "state.pt"))


def test_training_script_under_two_ranks(tmp_path):
    """speech_to_text_ctc under a launcher's environment (two gloo ranks):
    both ranks train the same steps, rank 0 alone prints the result and
    writes the archive, which restores."""
    from conformer_nemo_tpu_torch.api import ConformerCTC

    d = str(tmp_path)
    manifest = _manifest(d, 4, np.random.RandomState(4), 0.5, 1.0, audio=True)
    argv = ["--config", os.path.join(ROOT, "configs", "conformer_ctc_char.yaml"),
            "--device", "cpu", f"model.train_ds.manifest_filepath={manifest}",
            "model.encoder.n_layers=1", "model.encoder.d_model=32", "model.encoder.n_heads=2",
            "model.train_ds.batch_size=1", "trainer.max_steps=2", f"exp_manager.exp_dir={d}",
            "exp_manager.name=cli", "exp_manager.create_tensorboard_logger=false"]
    results = run_world(d, "cli", 2, argv=argv)
    assert [r["result"]["steps"] for r in results] == [2, 2]
    assert results[0]["result"]["last_loss"] == results[1]["result"]["last_loss"]
    printed = results[0]["stdout"]
    assert "done:" in printed and "portable:" in printed and results[1]["stdout"] == ""
    archive = printed.split("portable:")[1].split()[0]
    model = ConformerCTC.restore_portable(archive, device="cpu", dtype=torch.float32)
    assert model.cfg.encoder.n_layers == 1


def test_fit_outside_a_launcher_trains_on_one_device_and_says_so(tmp_path, caplog):
    """No launcher environment: `trainer.mesh: {data: -1}` is a world of
    one, no process group is made, and fit logs that it trains on one
    device."""
    import logging

    import torch.distributed as dist

    from conformer_nemo_tpu_torch.api import ConformerCTC

    d = str(tmp_path)
    manifest = _manifest(d, 2, np.random.RandomState(5), 0.5, 1.0, audio=True)
    model = ConformerCTC.from_config_file(
        os.path.join(ROOT, "configs", "conformer_ctc_char.yaml"), device="cpu",
        dtype=torch.float32, overrides={"model.encoder.n_layers": 1, "model.encoder.d_model": 32,
                                        "model.encoder.n_heads": 2,
                                        "trainer.mesh": {"data": -1, "model": 1}})
    with caplog.at_level(logging.INFO, logger="conformer_nemo_tpu_torch"):
        assert model.fit(manifest, max_steps=1)["steps"] == 1
    assert any("one process, one device" in r.getMessage() for r in caplog.records)
    assert not dist.is_initialized() and model.train_state.mesh is None
