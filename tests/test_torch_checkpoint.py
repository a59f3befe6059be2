"""The port's checkpoints against the reference package's format: a ``tiny``
train state saved by either package restores in the other bit for bit
(the same ``\\x1f``-joined keys, NamedTuple fields and ``None`` leaves
absent), bf16 leaves cross as their bit patterns, and the commit protocol
(atomic rename, GC, async save with a publish hook, meta) holds."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import checkpoint as jcheckpoint  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint, trainer  # noqa: E402


@pytest.fixture(scope="module")
def state():
    """A tiny port train state one step in (moments and step non-zero)."""
    cfg, tc = get_config("tiny"), TrainConfig(steps=5, learning_rate=1e-2,
                                              warmup_ratio=0.0)
    st = trainer.init_train_state(cfg, tc, seed=0, device="cpu")
    st, _ = trainer.make_train_step(cfg, tc)(
        st, SyntheticLMDataset(cfg, 2, 16).batch_at(0))
    return st


def _as_reference(np_state):
    """The same numpy leaves in the reference's own NamedTuples."""
    return jtrainer.TrainState(np_state.step, np_state.trainable,
                               np_state.frozen,
                               jadamw.AdamWState(*np_state.opt))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _bitwise_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def test_port_checkpoint_restores_in_the_reference(state, tmp_path):
    checkpoint.save(state, str(tmp_path), 3, extra_meta={"arch": "tiny"})
    want = _as_reference(interop.params_to_numpy(state))
    got = jcheckpoint.restore(want, str(tmp_path))
    assert jcheckpoint.load_meta(str(tmp_path), 3) == {"step": 3,
                                                       "arch": "tiny"}
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(_leaves(got), _leaves(want)):
        _bitwise_equal(a, b)


def test_reference_checkpoint_restores_in_the_port(state, tmp_path):
    ref_state = jax.tree.map(jnp.asarray,
                             _as_reference(interop.params_to_numpy(state)))
    jcheckpoint.save(ref_state, str(tmp_path / "ref"), 4)
    checkpoint.save(state, str(tmp_path / "port"), 4)
    keys = {}
    for who in ("ref", "port"):
        with np.load(tmp_path / who / "step_00000004" / "arrays.npz") as z:
            keys[who] = set(z.files)
    assert keys["ref"] == keys["port"]
    assert "opt\x1fmu\x1flayers\x1fattn\x1fq\x1fq" in keys["port"]
    assert not any("w_res" in k and k.startswith("opt") for k in keys["port"])
    template = jax.tree.map(torch.zeros_like, state)
    got = checkpoint.restore(template, str(tmp_path / "ref"))
    assert type(got) is trainer.TrainState
    assert type(got.opt) is adamw.AdamWState
    assert got.frozen["layers"]["attn"]["q"]["q"] is None
    for a, b in zip(tree.tree_leaves(got), tree.tree_leaves(state)):
        assert a.dtype == b.dtype
        _bitwise_equal(a.numpy(), b.numpy())


def test_bfloat16_leaves_cross_as_bit_patterns(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    s = rng.standard_normal(4).astype(np.float32)
    # reference writes -> port reads
    jcheckpoint.save({"w": jnp.asarray(w), "s": jnp.asarray(s)},
                     str(tmp_path / "ref"), 1)
    template = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
                "s": torch.zeros(4)}
    got = checkpoint.restore(template, str(tmp_path / "ref"))
    assert got["w"].dtype == torch.bfloat16
    _bitwise_equal(got["w"].view(torch.int16).numpy().view(np.uint16),
                   w.view(np.uint16))
    _bitwise_equal(got["s"].numpy(), s)
    # port writes -> the same arrays as the reference's file
    checkpoint.save(got, str(tmp_path / "port"), 1)
    with np.load(tmp_path / "ref" / "step_00000001" / "arrays.npz") as zr, \
            np.load(tmp_path / "port" / "step_00000001" /
                    "arrays.npz") as zp:
        assert set(zr.files) == set(zp.files)
        for k in zr.files:
            assert zr[k].dtype.itemsize == zp[k].dtype.itemsize
            assert zr[k].tobytes() == zp[k].tobytes(), k
    again = checkpoint.restore(template, str(tmp_path / "port"))
    assert torch.equal(again["w"].view(torch.int16),
                       got["w"].view(torch.int16))


def test_latest_step_and_gc(state, tmp_path):
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(state, str(tmp_path), s, keep=2)
    assert checkpoint.latest_step(str(tmp_path)) == 5
    assert checkpoint.all_steps(str(tmp_path)) == [4, 5]
    assert jcheckpoint.all_steps(str(tmp_path)) == [4, 5]


def test_atomic_commit_leaves_no_tmp(state, tmp_path):
    checkpoint.save(state, str(tmp_path), 7)
    names = os.listdir(tmp_path)
    assert not any(n.startswith("tmp.") for n in names)
    assert "step_00000007" in names


def test_async_save_publishes_after_commit(state, tmp_path):
    heard = []

    def publish(step):
        heard.append((step, checkpoint.latest_step(str(tmp_path))))
    t = checkpoint.save(state, str(tmp_path), 9, async_save=True,
                        publish=publish)
    t.join(timeout=30)
    assert heard == [(9, 9)]
    got = checkpoint.restore(state, str(tmp_path), 9)
    assert int(got.step) == int(state.step)


def test_restore_rejects_what_does_not_fit(state, tmp_path):
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(state, str(tmp_path / "nope"))
    checkpoint.save(state, str(tmp_path), 1)
    bad = tree.tree_map(lambda t: torch.zeros(t.shape + (1,), dtype=t.dtype)
                         if t.ndim > 0 else t, state)
    with pytest.raises(ValueError):
        checkpoint.restore(bad, str(tmp_path), 1)
    extra = state._replace(frozen={**state.frozen,
                                   "extra": torch.zeros(2)})
    with pytest.raises(KeyError, match="extra"):
        checkpoint.restore(extra, str(tmp_path), 1)
