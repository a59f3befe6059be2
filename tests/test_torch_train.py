"""The port's PEFT-masked training path against the reference package on
``tiny`` (fp32 throughout): AdamW, partition/combine, schedules, clipping,
gradient compression, the data pipeline, the trainability mask, and 5 train
steps from one converted state, step by step; then merge-after-train.

Tolerances: losses and grad norms 1e-4 relative (fp32, sums in another
order in each package).  Trainable leaves after a step: 1e-4 relative
plus an absolute 1e-3 * lr per step taken (a thousandth of one Adam step):
Adam's early updates are ~lr * sign(g), so an element whose gradient sits
near zero may move by up to ~2 * lr differently in the two packages, and
this bound states how rarely that may be allowed to happen (never, here).
The reference's train step is jitted once, for the module's fixture."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    DataConfig, PEFTConfig, TrainConfig, get_config,
)
from repro_torch.core import peft  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

STEPS = 5
TC = dict(steps=10, learning_rate=1e-2, warmup_ratio=0.2)
BATCH, SEQ = 4, 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pairs(jtree, ttree):
    """(path, reference leaf, port leaf) over the reference's leaves."""
    for kp, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        node = ttree
        for k in kp:
            node = node[getattr(k, "key", getattr(k, "idx", None))] \
                if not hasattr(k, "name") else getattr(node, k.name)
        yield jax.tree_util.keystr(kp), np.asarray(leaf), node


def _run_reference(tc_kw, n_steps):
    jcfg = jget_config("tiny")
    jtc = JTrainConfig(**tc_kw)
    state = jax.jit(lambda k: jtrainer.init_train_state(k, jcfg, jtc))(
        jax.random.PRNGKey(0))
    step = jax.jit(jtrainer.make_train_step(jcfg, jtc, moe_impl="dense"))
    ds = JDataset(jcfg, batch=BATCH, seq_len=SEQ)
    states, metrics = [_np_tree(state)], []
    for i in range(n_steps):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in ds.batch_at(i).items()})
        states.append(_np_tree(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


@pytest.fixture(scope="module")
def ref_run():
    """The reference's 5-step trajectory on tiny: numpy states after every
    step (index 0: the initial state) and the metrics of each step."""
    return _run_reference(TC, STEPS)


def _port_state(np_state):
    return trainer.train_state_from_numpy(np_state, device="cpu")


def _batch(i):
    return SyntheticLMDataset(get_config("tiny"), BATCH, SEQ).batch_at(i)


def _assert_trainables(jstate, tstate, steps_taken, lr):
    atol = 1e-3 * lr * max(steps_taken, 1)
    n = 0
    for path, want, got in _pairs(jstate.trainable, tstate.trainable):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=atol, err_msg=path)
        n += 1
    assert n > 0


# ------------------------------------------------------------ optimizer

def test_adamw_step_matches_reference():
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "n": {"b": rng.standard_normal(5).astype(np.float32)}}
    g = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "n": {"b": rng.standard_normal(5).astype(np.float32)}}
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              grad_clip_norm=1.5)
    jst = jadamw.adamw_init(jax.tree.map(jnp.asarray, p))
    tst = adamw.adamw_init(jax.tree.map(torch.from_numpy, p))
    for _ in range(3):
        jp, jst, jm = jadamw.adamw_update(jax.tree.map(jnp.asarray, g), jst,
                                          jax.tree.map(jnp.asarray, p),
                                          lr=0.1, **kw)
        tp, tst, tm = adamw.adamw_update(jax.tree.map(torch.from_numpy, g),
                                         tst, jax.tree.map(torch.from_numpy,
                                                           p), lr=0.1, **kw)
        for path, want, got in _pairs(jp, tp):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-7, err_msg=path)
        for path, want, got in _pairs(jst, tst):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       err_msg=path)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        p = jax.tree.map(np.array, jp)


def test_partition_combine_roundtrip_matches_reference():
    params = {"a": np.ones(3, np.float32),
              "nest": {"b": np.zeros(2, np.float32),
                       "c": np.ones(1, np.float32)}}
    mask = {"a": True, "nest": {"b": False, "c": True}}
    tparams = jax.tree.map(torch.from_numpy, params)
    tr, fr = adamw.partition(tparams, mask)
    jtr, jfr = jadamw.partition(params, mask)
    assert tr["nest"]["b"] is None and fr["a"] is None
    assert jtr["nest"]["b"] is None and jfr["a"] is None
    assert (tr["a"], fr["nest"]["b"]) == (tparams["a"],
                                         tparams["nest"]["b"])
    back = adamw.combine(tr, fr)
    assert jax.tree_util.tree_structure(
        jax.tree.map(lambda t: 0, back)) == \
        jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, params))
    assert all(back["nest"][k] is tparams["nest"][k] for k in "bc")


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedules_match_reference(kind):
    jfn = jadamw.make_schedule(kind, 1.0, 100, warmup_ratio=0.1)
    tfn = adamw.make_schedule(kind, 1.0, 100, warmup_ratio=0.1)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert float(tfn(s)) == pytest.approx(float(jfn(s)), rel=1e-6,
                                               abs=1e-7)
    assert float(tfn(torch.tensor(10, dtype=torch.int32))) == \
        pytest.approx(1.0)


def test_grad_clip_matches_reference():
    p = {"w": np.ones(4, np.float32)}
    g = {"w": np.full(4, 100.0, np.float32)}
    tp, _, tm = adamw.adamw_update(
        jax.tree.map(torch.from_numpy, g),
        adamw.adamw_init(jax.tree.map(torch.from_numpy, p)),
        jax.tree.map(torch.from_numpy, p), lr=0.5, grad_clip_norm=1.0)
    jp, _, jm = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, g),
        jadamw.adamw_init(jax.tree.map(jnp.asarray, p)),
        jax.tree.map(jnp.asarray, p), lr=0.5, grad_clip_norm=1.0)
    assert float(tm["grad_norm"]) == pytest.approx(200.0)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_grad_compression_matches_reference(dtype):
    rng = np.random.default_rng(1)
    g = {"a": (rng.standard_normal((6, 7)) * 1e-3).astype(np.float32),
         "b": {"c": (rng.standard_normal(9) * 3).astype(np.float32)},
         "d": None}
    got = trainer._compress(jax.tree.map(torch.from_numpy, g), dtype)
    want = jtrainer._compress(jax.tree.map(jnp.asarray, g), dtype)
    assert got["d"] is None
    for path, w, t in _pairs(want, got):
        np.testing.assert_allclose(t.numpy(), w, rtol=1e-6, atol=0,
                                   err_msg=path)


# ------------------------------------------------------------ data, mask

def test_synthetic_batches_match_reference():
    for dc, jdc in ((None, None),
                    (DataConfig(seed=3, branching=5, num_hosts=2, host_id=1),
                     JDataConfig(seed=3, branching=5, num_hosts=2,
                                 host_id=1))):
        ds = SyntheticLMDataset(get_config("tiny"), 4, 16, dc)
        jds = JDataset(jget_config("tiny"), 4, 16, jdc)
        for i in (0, 1, 7):
            got, want = ds.batch_at(i), jds.batch_at(i)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_trainable_names_and_counts_match_reference():
    from repro.configs import PEFTConfig as JPEFTConfig
    for kw in (dict(rank=8), dict(rank=8, relax_vectors=False),
               dict(method="lora", rank=4)):
        cfg, jcfg = PEFTConfig(**kw), JPEFTConfig(**kw)
        for method in ("none", "psoft", "lora"):
            assert peft.trainable_names(method, cfg) == \
                jpeft.trainable_names(method, jcfg)
        for module in (None, "q", "down"):
            assert peft.count_trainable_params(
                128, 512, cfg, module=module) == \
                jpeft.count_trainable_params(128, 512, jcfg, module=module)


@pytest.mark.parametrize("full", [False, True])
def test_trainable_mask_matches_reference(ref_run, full):
    jcfg, cfg = jget_config("tiny"), get_config("tiny")
    tp = adamw.combine(*(_port_state(ref_run[0][0])[1:3]))
    jp = interop.params_to_numpy(tp)
    want = jmodel.trainable_mask(jcfg, jp, full)
    got = model.trainable_mask(cfg, tp, full)
    for path, w, g in _pairs(want, got):
        assert bool(w) == g, path
    if not full:
        assert {k for k, v in got["layers"]["attn"]["q"].items() if v} == \
            {"q", "alpha", "beta"}


# ------------------------------------------------------------ train steps

def test_five_train_steps_match_reference(ref_run):
    """From one converted state, the port's train step follows the
    reference's: loss, grad norm and lr at every step, and every trainable
    leaf after every step."""
    jstates, jmetrics = ref_run
    cfg = get_config("tiny")
    state = _port_state(jstates[0])
    step = trainer.make_train_step(cfg, TrainConfig(**TC))
    for i in range(STEPS):
        state, m = step(state, _batch(i))
        want = jmetrics[i]
        for key in ("loss", "grad_norm"):
            assert float(m[key]) == pytest.approx(want[key], rel=1e-4), \
                (i, key)
        assert float(m["lr"]) == pytest.approx(want["lr"], rel=1e-6,
                                               abs=1e-9)
        assert int(state.step) == i + 1
        _assert_trainables(jstates[i + 1], state, i + 1,
                           TC["learning_rate"])
    for path, want, got in _pairs(jstates[-1].opt, state.opt):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-9,
                                   err_msg=path)
    assert jmetrics[-1]["loss"] < jmetrics[0]["loss"]


def test_frozen_params_never_change(ref_run):
    cfg = get_config("tiny")
    state = _port_state(ref_run[0][0])
    before = jax.tree.map(lambda t: t.clone(), state.frozen)
    step = trainer.make_train_step(cfg, TrainConfig(**TC))
    for i in range(3):
        state, _ = step(state, _batch(i))
    for path, want, got in _pairs(interop.params_to_numpy(before),
                                  state.frozen):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


def test_microbatches_give_the_full_batch_update(ref_run):
    """Two microbatches of 2 give the reference's one-batch-of-4 update
    (the mean of the microbatch grads is the full-batch grad: equal token
    counts)."""
    jstates, jmetrics = ref_run
    cfg = get_config("tiny")
    step = trainer.make_train_step(cfg, TrainConfig(**TC, microbatches=2))
    state, m = step(_port_state(jstates[1]), _batch(1))
    assert float(m["loss"]) == pytest.approx(jmetrics[1]["loss"], rel=1e-4)
    _assert_trainables(jstates[2], state, 2, TC["learning_rate"])


def test_remat_none_gives_the_same_step(ref_run):
    jstates, jmetrics = ref_run
    cfg = get_config("tiny", remat_policy="none")
    state, m = trainer.make_train_step(cfg, TrainConfig(**TC))(
        _port_state(jstates[1]), _batch(1))
    assert float(m["loss"]) == pytest.approx(jmetrics[1]["loss"], rel=1e-4)
    _assert_trainables(jstates[2], state, 2, TC["learning_rate"])
    state, m = trainer.make_train_step(
        get_config("tiny", remat_policy="minimal"), TrainConfig(**TC))(
        _port_state(jstates[1]), _batch(1))
    assert float(m["loss"]) == pytest.approx(jmetrics[1]["loss"], rel=1e-4)
    _assert_trainables(jstates[2], state, 2, TC["learning_rate"])


def _loss_and_grads(np_state, policy, forward_calls):
    """Loss and trainable grads of one batch under ``policy``, with the
    PSOFT forward calls counted apart in the forward and in the
    backward."""
    cfg = get_config("tiny", remat_policy=policy)
    state = _port_state(np_state)
    leaves = []

    def leaf(p):
        t = p.detach().requires_grad_(True)
        leaves.append(t)
        return t
    params = adamw.combine(tree.tree_map(leaf, state.trainable),
                           state.frozen)
    batch = {k: torch.as_tensor(v) for k, v in _batch(2).items()}
    forward_calls.clear()
    loss, _ = model.loss_fn(params, batch, cfg)
    in_forward = len(forward_calls)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, in_forward, len(forward_calls) - in_forward


def test_remat_minimal_keeps_every_linear_output(ref_run, monkeypatch):
    """``"minimal"`` keeps each linear's output (the reference's
    dots-without-batch-dims policy): its loss and grads equal ``"full"``'s
    within 1e-6, and its backward makes no PSOFT forward call, where
    ``"full"`` recomputes one per linear."""
    from repro_torch.kernels import ref
    calls = []
    parts = ref.psoft_matmul_parts

    def counted(*args, **kw):
        if not kw.get("transpose", args[7] if len(args) > 7 else False):
            calls.append(1)
        return parts(*args, **kw)
    monkeypatch.setattr(ref, "psoft_matmul_parts", counted)
    np_state = ref_run[0][1]
    linears = 7 * get_config("tiny").num_layers
    full = _loss_and_grads(np_state, "full", calls)
    minimal = _loss_and_grads(np_state, "minimal", calls)
    assert full[2:] == (linears, linears)
    assert minimal[2:] == (linears, 0)
    np.testing.assert_allclose(float(minimal[0]), float(full[0]), rtol=1e-6)
    for g, w in zip(minimal[1], full[1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()))


def test_full_finetune_grads_match_the_unfused_apply(ref_run, monkeypatch):
    """Every leaf trains: a full-finetune step through the fused wrapper
    (W_res, A and B take its frozen-factor grads) equals the same step
    with every PSOFT linear on the port's mirror of the reference's unfused
    apply, which autograd differentiates."""
    from repro_torch.core import psoft, registry
    cfg = get_config("tiny")
    tc = TrainConfig(**TC, full_finetune=True)
    step = trainer.make_train_step(cfg, tc)

    def start():
        return trainer.train_state_from_params(trainer.adapter_params(
            _port_state(ref_run[0][1])), cfg, tc)
    fused, mf = step(start(), _batch(1))
    assert tree.tree_leaves(fused.frozen) == []
    monkeypatch.setattr(
        registry.get_method("psoft"), "apply",
        lambda params, x, cfg, cdt: psoft.psoft_apply(
            params, x, cfg.neumann_terms, cfg.exact_cayley, cdt))
    unfused, mu = step(start(), _batch(1))
    assert float(mf["loss"]) == pytest.approx(float(mu["loss"]), rel=1e-5)
    assert float(mf["grad_norm"]) == pytest.approx(float(mu["grad_norm"]),
                                                   rel=1e-4)
    lin = fused.opt.mu["layers"]["mlp"]["up"]
    assert all(float(lin[k].abs().max()) > 0 for k in ("w_res", "A", "B"))
    for a, b in zip(tree.tree_leaves(fused.opt.mu),
                    tree.tree_leaves(unfused.opt.mu)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-6 * float(b.abs().max()))


def test_merge_after_training_keeps_the_logits(ref_run):
    """Quickstart step 3: the tuned tree's logits equal its merged tree's."""
    jstates, _ = ref_run
    cfg = get_config("tiny")
    state = _port_state(jstates[0])
    step = trainer.make_train_step(cfg, TrainConfig(**TC))
    for i in range(STEPS):
        state, _ = step(state, _batch(i))
    tuned = trainer.adapter_params(state)
    merged = peft.merge_tree(tuned, cfg.peft)
    assert "w_res" not in merged["layers"]["attn"]["q"]
    batch = {k: torch.as_tensor(v) for k, v in _batch(9).items()}
    with torch.no_grad():
        got = model.forward_logits(merged, batch, cfg)
        want = model.forward_logits(tuned, batch, cfg)
    assert got.shape == (BATCH, SEQ, cfg.padded_vocab_size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    moved = [float((t - torch.from_numpy(w)).abs().max())
             for _, w, t in _pairs(jstates[0].trainable, state.trainable)]
    assert min(moved) > 0


def test_rewrap_peft_matches_reference(ref_run):
    """Wrapping a merged tree with PSOFT again: the SVD split reproduces the
    weight (A and B agree with the reference's only up to column signs, so
    compare A·B and W_res)."""
    cfg, jcfg = get_config("tiny"), jget_config("tiny")
    tp = adamw.combine(*(_port_state(ref_run[0][0])[1:3]))
    merged = peft.merge_tree(tp, cfg.peft)
    got = model.rewrap_peft(merged, cfg)
    want = jmodel.rewrap_peft(
        jax.tree.map(jnp.asarray, interop.params_to_numpy(merged)), jcfg)
    for name in ("q", "o"):
        g, w = got["layers"]["attn"][name], want["layers"]["attn"][name]
        assert set(g) == set(w)
        np.testing.assert_allclose(g["w_res"].numpy(), np.asarray(w["w_res"]),
                                   atol=1e-5)
        np.testing.assert_allclose((g["A"] @ g["B"]).numpy(),
                                   np.asarray(w["A"] @ w["B"]), atol=1e-5)
    assert set(got["embed"]) == {"w"}


def test_train_state_crosses_interop_both_ways(ref_run):
    np_state = ref_run[0][1]
    state = _port_state(np_state)
    assert type(state) is trainer.TrainState
    assert type(state.opt) is adamw.AdamWState
    assert state.frozen["layers"]["attn"]["q"]["q"] is None
    assert state.opt.mu["layers"]["attn"]["q"]["w_res"] is None
    back = interop.params_to_numpy(state)
    for path, want, got in _pairs(np_state, back):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
