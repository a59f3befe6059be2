"""The port's training launcher (``repro_torch.launch.train``) and its pieces
against the reference package's on the CPU: the straggler monitor's flags
on one seeded series of step times, the prefetch iterator's order and end,
the launcher's per-step losses on ``tiny`` from one converted state (within
1e-4 relative of the reference launcher's, read from both JSONL metric
files) and its printed lines, auto-resume bit for bit against an unbroken
run, and the refusal of a data mesh the card does not have."""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.data import prefetch_iterator as jprefetch  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.obs import read_jsonl as jread_jsonl  # noqa: E402
from repro.train import straggler as jstraggler  # noqa: E402
from repro_torch.data import prefetch_iterator  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.obs import read_jsonl  # noqa: E402
from repro_torch.train import checkpoint, straggler, trainer  # noqa: E402

import ssm_pairs as sp  # noqa: E402

FLAGS = ["--arch", "tiny", "--rank", "8", "--batch", "4", "--seq", "32",
         "--lr", "1e-2", "--log-every", "1"]


def _times(seed=0, n=200):
    """Step times around 1 s with jitter, a slow warm-up, a few planted
    stragglers and a slow stretch the window adapts to."""
    rng = np.random.default_rng(seed)
    t = 1.0 + 0.02 * rng.standard_normal(n)
    t[:3] = 5.0
    t[[20, 57, 58, 120]] *= [1.5, 3.0, 1.2, 8.0]
    t[150:] *= 2.0
    return [float(x) for x in t]


def test_step_time_monitor_flags_the_reference_steps():
    for kw in ({}, dict(window=10, zscore_threshold=3.0, warmup_steps=2)):
        heard = []
        mon = straggler.StepTimeMonitor(
            on_anomaly=lambda s, t, m: heard.append((s, t, m)), **kw)
        jmon = jstraggler.StepTimeMonitor(**kw)
        flags = [mon.record(t) for t in _times()]
        jflags = [jmon.record(t) for t in _times()]
        assert flags == jflags
        assert mon.anomalies == jmon.anomalies == [
            i + 1 for i, f in enumerate(flags) if f]
        assert [s for s, _, _ in heard] == mon.anomalies
        assert 121 in mon.anomalies


def test_stopwatch_times_its_block():
    with straggler.Stopwatch() as sw:
        x = straggler.block_until_ready(torch.ones(3) * 2)
    assert float(x.sum()) == 6.0 and 0 <= sw.seconds < 5


def test_prefetch_iterator_keeps_order_and_ends():
    items = [{"i": i} for i in range(25)]
    assert list(prefetch_iterator(iter(items), depth=3)) == items
    assert list(prefetch_iterator(iter([]))) == []
    assert [x["i"] for x in prefetch_iterator(iter(items))] == \
        [x["i"] for x in jprefetch(iter(items))]


@pytest.fixture(scope="module")
def ref_state():
    """A train state of the launcher's ``tiny`` (fp32, PSOFT r 8) in the
    reference's structure, numpy, the trainables off their init."""
    jcfg, _ = sp.configs("tiny")
    return sp.train_state(jcfg, sp.numpy_params(jcfg, 0))


def _from(np_state):
    def init(cfg, tc, seed=0, device="cpu"):
        assert seed == 0 and str(device) == "cpu"
        return trainer.train_state_from_numpy(np_state, device="cpu")
    return init


def _losses(records):
    return [(r["step"], r["data"]["train/loss"]) for r in records
            if r["kind"] == "scalars" and "train/loss" in r["data"]]


def test_main_matches_the_reference_main(ref_state, tmp_path,
                                             monkeypatch, capsys):
    """4 steps of the port's ``main`` and the reference's from one state:
    per-step losses within 1e-4 relative (the JSONL files of both), the
    same params line, one step line a step, and the last loss returned."""
    jit = jax.jit
    monkeypatch.setattr(jax, "jit", functools.partial(
        jit, compiler_options=sp.XLA_FAST))
    monkeypatch.setattr(jtrain.trainer, "init_train_state",
                        lambda key, cfg, tc: jax.tree.map(jax.numpy.asarray,
                                                          ref_state))
    jpath, path = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    jloss = jtrain.main(FLAGS + ["--steps", "4", "--metrics-jsonl",
                                 str(jpath)])
    jout = capsys.readouterr().out
    monkeypatch.setattr(trainer, "init_train_state", _from(ref_state))
    loss = train.main(FLAGS + ["--steps", "4", "--metrics-jsonl", str(path),
                               "--device", "cpu"])
    out = capsys.readouterr().out
    want = _losses(jread_jsonl(str(jpath)))
    got = _losses(read_jsonl(str(path)))
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4)
    assert loss == pytest.approx(jloss, rel=1e-4)
    assert loss == pytest.approx(got[-1][1], rel=1e-6)

    def lines(text, head):
        return [ln for ln in text.splitlines() if ln.startswith(head)]
    assert lines(out, "params:") == lines(jout, "params:")
    assert len(lines(out, "step ")) == len(lines(jout, "step ")) == 4
    for ln, jln in zip(lines(out, "step "), lines(jout, "step ")):
        assert ln.split()[:2] == jln.split()[:2]
    assert lines(out, "done: 4 steps") and \
        "straggler flags: 0" in lines(out, "done:")[0]


def _ckpt_arrays(d, step):
    with np.load(os.path.join(d, f"step_{step:08d}", "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_resumed_run_equals_an_unbroken_one(tmp_path, capsys,
                                            monkeypatch):
    """A 6-step run interrupted after 3 steps (its fourth step raises;
    the step-3 checkpoint is committed), then a call to 6 that resumes
    from step 3, against one unbroken 6-step run: the same last loss and
    every array of the step-6 checkpoint (trainables, frozen leaves, AdamW
    state) bit for bit."""
    flags = FLAGS + ["--device", "cpu", "--ckpt-every", "3", "--steps", "6"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    unbroken = train.main(flags + ["--ckpt", one])
    make = trainer.make_train_step

    def failing_at_4(*args, **kw):
        step, calls = make(*args, **kw), []

        def run(state, batch):
            calls.append(1)
            if len(calls) == 4:
                raise RuntimeError("interrupted")
            return step(state, batch)
        return run
    monkeypatch.setattr(trainer, "make_train_step", failing_at_4)
    with pytest.raises(RuntimeError, match="interrupted"):
        train.main(flags + ["--ckpt", two])
    monkeypatch.setattr(trainer, "make_train_step", make)
    assert checkpoint.all_steps(two) == [3]
    capsys.readouterr()
    resumed = train.main(flags + ["--ckpt", two])
    assert "resumed from step 3" in capsys.readouterr().out
    assert resumed == unbroken
    assert checkpoint.all_steps(one) == checkpoint.all_steps(two) == [3, 6]
    want, got = _ckpt_arrays(one, 6), _ckpt_arrays(two, 6)
    assert set(got) == set(want) and any("trainable" in k for k in got)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_data_mesh_beyond_one_device_raises():
    """One process is one rank: a larger data axis needs the ranks
    started by ``torch.distributed.run`` (tests/test_torch_distributed.py
    runs two)."""
    with pytest.raises(ValueError, match="torch.distributed.run "
                                         "--nproc-per-node 2"):
        train.main(FLAGS + ["--data-mesh", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="torch.distributed.run "
                                         "--nproc-per-node 4"):
        train.main(FLAGS + ["--data-mesh", "4", "--device", "cpu"])
