"""The port's utilities against the JAX package's, on the CPU.

- utils/typecheck.py: the JAX package's contract cases (rank, axis letters
  bound across arguments and outputs, fixed extents, dtype kinds, the
  imperative form) on torch tensors and numpy arrays; the port's three
  decorated entry points (`log_mel_spectrogram`, `ctc_loss`, `rnnt_loss`)
  raise TypecheckError where the JAX package's do and run where they run.
- utils/timers.py, utils/profiling.py (a torch.profiler Chrome trace with
  the annotated range), `AppState` outside and inside a process group.
- The native edit distance (data/csrc/edit_distance.cpp through
  ops/build.py) equal to its Python twin and to the JAX package's
  decode/wer.py on random token lists; the WER equal to the JAX one.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.decode import wer as jwer
from conformer_nemo_tpu.utils import typecheck as jtc
from conformer_nemo_tpu_torch.decode import wer as pwer
from conformer_nemo_tpu_torch.utils import typecheck as ptc
from conformer_nemo_tpu_torch.utils.profiling import annotate, profile_trace
from conformer_nemo_tpu_torch.utils.timers import NamedTimer, StepTimingHook

torch.set_num_threads(2)


@pytest.mark.parametrize("make", [torch.ones, np.ones], ids=["torch", "numpy"])
def test_typecheck_contracts_as_jax(make):
    """The JAX package's test_typecheck_contracts cases, on the port's."""
    for tc in (ptc, jtc):
        @tc.typecheck(x=("B", "T"), lens=("B",), outputs=(("B", "T"),))
        def f(x, lens):
            return x * 2

        assert f(make((2, 5)), make((2,))).shape == (2, 5)
        with pytest.raises(tc.TypecheckError):  # rank
            f(make((2, 5, 1)), make((2,)))
        with pytest.raises(tc.TypecheckError):  # 'B' bound to 2 by x
            f(make((2, 5)), make((3,)))

        @tc.typecheck(x=("B", "T"), outputs=(("B", "T"),))
        def g(x):
            return x[:, :1].reshape(1, -1)

        with pytest.raises(tc.TypecheckError, match="output"):  # an output breaks 'B'
            g(make((2, 5)))

        @tc.typecheck(x=(2, None))
        def h(x):
            return x

        h(make((2, 9)))
        with pytest.raises(tc.TypecheckError, match="fixed extent"):
            h(make((3, 9)))
        with pytest.raises(tc.TypecheckError, match="expected an array"):
            h([1, 2])
    env = ptc.check_shapes(x=(make((4, 3)), ptc.Spec(("B", "D"), dtype=np.floating)))
    with pytest.raises(ptc.TypecheckError):
        ptc.check_shapes(env, y=(make((5,)), ("B",)))  # B already 4
    ptc.check_shapes(env, y=(make((4,)), ("B",)))


def test_dtype_kinds():
    spec = ptc.Spec(("B",), dtype=np.floating)
    for ok in (torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16), np.zeros(2, np.float32)):
        ptc.check_shapes(x=(ok, spec))
    for bad in (torch.zeros(2, dtype=torch.int32), np.zeros(2, np.int32)):
        with pytest.raises(ptc.TypecheckError, match="dtype"):
            ptc.check_shapes(z=(bad, spec))
    ptc.check_shapes(i=(torch.zeros(2, dtype=torch.int64), ptc.Spec(("B",), dtype=np.integer)))
    ptc.check_shapes(f=(torch.zeros(2), ptc.Spec(("B",), dtype=torch.float32)))
    with pytest.raises(ptc.TypecheckError):
        ptc.check_shapes(f=(torch.zeros(2, dtype=torch.float16),
                            ptc.Spec(("B",), dtype=torch.float32)))
    with pytest.raises(jtc.TypecheckError):  # the JAX package's check on the same array
        jtc.check_shapes(z=(np.zeros(2, np.int32), jtc.Spec(("B",), dtype=np.floating)))


def test_decorated_entry_points_raise_where_jax_does():
    from conformer_nemo_tpu.audio.features import MelFeatureConfig as JaxMel
    from conformer_nemo_tpu.audio.features import log_mel_spectrogram as jax_mel
    from conformer_nemo_tpu.ops.ctc_loss import ctc_loss as jax_ctc
    from conformer_nemo_tpu.ops.rnnt_loss import rnnt_loss as jax_rnnt
    from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig, log_mel_spectrogram
    from conformer_nemo_tpu_torch.ops.ctc_loss import ctc_loss
    from conformer_nemo_tpu_torch.ops.rnnt_loss import rnnt_loss

    wav = np.random.RandomState(0).randn(2, 1600).astype(np.float32)
    for lens in (np.array([1600, 1200], np.int32), np.array([1600, 1200, 800], np.int32)):
        bad = len(lens) != 2
        for run in (lambda: jax_mel(JaxMel(features=16), jnp.asarray(wav), jnp.asarray(lens)),
                    lambda: log_mel_spectrogram(MelFeatureConfig(features=16),
                                                torch.from_numpy(wav), torch.from_numpy(lens))):
            if bad:
                with pytest.raises(TypeError, match="'B'"):
                    run()
            else:
                run()
    lp = np.log(np.full((2, 6, 5), 0.2, np.float32))
    for targets in (np.zeros((2, 3), np.int32), np.zeros((3, 3), np.int32)):
        bad = targets.shape[0] != 2
        args = (np.array([6, 6], np.int32), np.array([3, 3], np.int32))
        runs = (lambda: jax_ctc(jnp.asarray(lp), jnp.asarray(targets), *map(jnp.asarray, args),
                                blank_id=4),
                lambda: ctc_loss(torch.from_numpy(lp), torch.from_numpy(targets),
                                 *map(torch.from_numpy, args), blank_id=4))
        for tc, run in zip((jtc, ptc), runs):
            if bad:
                with pytest.raises(tc.TypecheckError):
                    run()
            else:
                assert np.isfinite(float(run()))
    logits = np.random.RandomState(1).randn(2, 4, 3, 5).astype(np.float32)
    for t_lens in (np.array([4, 3], np.int32), np.array([4], np.int32)):
        bad = len(t_lens) != 2
        tg, ul = np.array([[1, 2], [3, 0]], np.int32), np.array([2, 1], np.int32)
        runs = (lambda: jax_rnnt(jnp.asarray(logits), jnp.asarray(tg), jnp.asarray(t_lens),
                                 jnp.asarray(ul), blank_id=4),
                lambda: rnnt_loss(torch.from_numpy(logits), torch.from_numpy(tg),
                                  torch.from_numpy(t_lens), torch.from_numpy(ul), blank_id=4))
        for tc, run in zip((jtc, ptc), runs):
            if bad:
                with pytest.raises(tc.TypecheckError):
                    run()
            else:
                assert np.isfinite(float(run()))


def test_named_timer_and_step_hook():
    calls = []
    t = NamedTimer(sync_fn=lambda: calls.append(1))
    t.start("a")
    assert t.active_timers == ["a"]
    assert t.stop("a") >= 0.0 and calls == [1]
    assert t.stop("never") is None
    t.start("a")
    t.stop("a")
    assert t.get("a") >= 0.0 and t.get("b") is None
    assert NamedTimer(reduction="max").get("a") is None
    t.reset("a")
    assert t.get("a") is None
    t.start("x")
    t.reset()
    assert t.active_timers == []

    class Log:
        rows = []

        def log(self, step, **kw):
            self.rows.append((step, kw))

    log = Log()
    hook = StepTimingHook(log, log_every=2, buffer_size=3)
    for step in range(1, 6):
        hook.before_step()
        hook.after_step(step)
    assert [s for s, _ in log.rows] == [2, 4]
    assert all(kw["train_step_timing"] >= 0.0 for _, kw in log.rows)
    assert len(hook.timer._records["train_step"]) == 3


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "prof")
    x = torch.randn(64, 64)
    with profile_trace(log_dir):
        with annotate("port_region"):
            (x @ x).sum()
    traces = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "port_region" in names and any("mm" in str(n) for n in names)
    with profile_trace(log_dir, enabled=False):
        (x @ x).sum()
    assert len(glob.glob(os.path.join(log_dir, "*.json"))) == 1


def test_app_state(tmp_path):
    import torch.distributed as dist

    from conformer_nemo_tpu_torch.parallel.distributed import AppState

    st = AppState.current()
    assert (st.process_index, st.process_count, st.is_main_process) == (0, 1, True)
    assert st.local_device_count == max(torch.cuda.device_count(), 1)
    assert st.global_device_count == st.local_device_count
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        st = AppState.current()
        assert (st.process_index, st.process_count, st.global_device_count) == (0, 1, 1)
    finally:
        dist.destroy_process_group()


def _token_lists(rs, n: int) -> list:
    vocab = [f"t{i}" for i in range(6)]
    return [[vocab[j] for j in rs.randint(0, 6, rs.randint(0, 25))] for _ in range(n)]


def test_native_edit_distance_equals_python_and_jax():
    rs = np.random.RandomState(0)
    a, b = _token_lists(rs, 60), _token_lists(rs, 60)
    for x, y in zip(a, b):
        d = pwer.edit_distance(x, y)
        assert d == pwer.edit_distance_reference(x, y) == jwer.edit_distance(x, y)
    assert pwer.edit_distance("kitten", "sitting") == 3
    assert pwer.edit_distance([], ["a", "b"]) == 2 and pwer.edit_distance([], []) == 0
    hyps = [" ".join(x) for x in a]
    refs = [" ".join(y) or "t0" for y in b]
    for cer in (False, True):
        assert pwer.word_error_rate(hyps, refs, cer) == jwer.word_error_rate(hyps, refs, cer)
        assert pwer.wer_num_denom(hyps, refs, cer) == jwer.wer_num_denom(hyps, refs, cer)
    with pytest.raises(ValueError, match="same number"):
        pwer.word_error_rate(["a"], [])
    lib = pwer._lib()
    assert lib._name.endswith(os.path.join("ops", "_build", "libedit_distance.so"))
