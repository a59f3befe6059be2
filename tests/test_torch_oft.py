"""The port's OFT family against the reference package, fp32 on the CPU:
the plain ``blockdiag_rotate`` against the reference's Pallas kernel in
interpret mode (and, transposed, against its oracle on R^T), the autograd
wrapper's backward against autograd of the plain version, the butterfly
permutations, layer-stacked OFT and BOFT trees (merge and trainability
mask; the structure matchers must not take one for the other), and 3 train
steps from one converted state for oft, boft and goft (one per block size
on the kernel's path: 32, 8, 2).

Tolerances: the rotate 1e-5 (fp32 sums of b products in another order);
merged weights 1e-5 relative to the largest entry; train steps as in
tests/test_torch_train.py (losses 1e-4 relative, trainables 1e-4 relative
plus 1e-3 * lr per step).  The reference's train steps are jitted once per
method, in a module fixture."""
from concurrent.futures import ThreadPoolExecutor

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
from repro.core import oft as joft  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core import registry as jregistry  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.blockdiag_rotate import blockdiag_rotate_pallas  # noqa
from repro.models import model as jmodel  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
import ssm_pairs as sp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import oft, peft, registry  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

TRAIN_METHODS = ("oft", "boft", "goft")
STEPS = 3
TC = dict(steps=10, learning_rate=1e-2, warmup_ratio=0.2)
BATCH, SEQ = 4, 32


def _cfgs(method):
    jcfg = jget_config("tiny")
    cfg = get_config("tiny")
    return (jcfg.replace(peft=jcfg.peft.replace(method=method)),
            cfg.replace(peft=cfg.peft.replace(method=method)))


def _rots(rng, nb, b, scale=0.3):
    """Orthogonal-ish blocks: I plus noise (the kernel takes any matrix)."""
    return (np.eye(b) + rng.standard_normal((nb, b, b)) * scale).astype(
        np.float32)


# ------------------------------------------------------------ the kernel

@pytest.mark.parametrize("m,d,b", [(64, 128, 16), (128, 256, 32),
                                   (256, 128, 8), (64, 512, 256)])
def test_plain_blockdiag_rotate_matches_pallas_interpret(m, d, b):
    """The shapes of tests/test_kernels.py::test_blockdiag_rotate_vs_ref,
    and blocks of 256 (above the port's 128-column slices); transposed
    against the reference's oracle on the transposed blocks."""
    rng = np.random.default_rng(m + d + b)
    x = rng.standard_normal((m, d)).astype(np.float32)
    rots = _rots(rng, d // b, b)
    want = blockdiag_rotate_pallas(jnp.asarray(x), jnp.asarray(rots),
                                   interpret=True)
    got = ref.blockdiag_rotate(torch.from_numpy(x), torch.from_numpy(rots))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    want_t = jref.blockdiag_rotate_ref(
        jnp.asarray(x), jnp.asarray(rots.transpose(0, 2, 1)))
    got_t = ops.blockdiag_rotate(torch.from_numpy(x), torch.from_numpy(rots),
                                 transpose=True)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-5,
                               rtol=1e-5)


def test_oft_apply_at_block_256_matches_reference():
    """OFT with ``oft_block_size=256`` (two blocks of a 512-wide input):
    the port's CPU apply against the reference's ``oft_apply`` on the same
    weights (converted by ``interop``), compute dtype fp32 in both, within
    1e-5 of the largest output."""
    rng = np.random.default_rng(256)
    d_in, d_out, b = 512, 96, 256
    params = {"w": (rng.standard_normal((d_in, d_out)) / d_in ** 0.5
                    ).astype(np.float32),
              "q": (rng.standard_normal((d_in // b, b * (b - 1) // 2))
                    * 0.01).astype(np.float32),
              "out_scale": (1 + 0.1 * rng.standard_normal(d_out)
                            ).astype(np.float32)}
    x = rng.standard_normal((3, 7, d_in)).astype(np.float32)
    want = np.asarray(joft.oft_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), b,
        compute_dtype=jnp.float32))
    got = oft.oft_apply(interop.params_from_numpy(params, device="cpu"),
                        torch.from_numpy(x), b, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("b", [2, 8, 32])
def test_blockdiag_wrapper_grads_match_autograd_of_plain(b, transpose):
    """The autograd function's backward (dx by the other orientation's
    rotate, dR by a batched product) against autograd through the plain
    einsum, both orientations."""
    rng = np.random.default_rng(b)
    x = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    rots = torch.from_numpy(_rots(rng, 64 // b, b))
    dy = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    x1, r1 = x.clone().requires_grad_(True), rots.clone().requires_grad_(True)
    x2, r2 = x.clone().requires_grad_(True), rots.clone().requires_grad_(True)
    got = torch.autograd.grad(
        ops.blockdiag_rotate(x1, r1, transpose=transpose), [x1, r1], dy)
    want = torch.autograd.grad(ref.blockdiag_rotate(x2, r2, transpose),
                               [x2, r2], dy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)
    # only the grads asked for are computed
    frozen_x = ops.blockdiag_rotate(x, r1, transpose=transpose)
    g_r, = torch.autograd.grad(frozen_x, [r1], dy)
    np.testing.assert_allclose(g_r.numpy(), want[1].numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("d", [128, 512, 3072, 8192])
def test_butterfly_perms_match_reference(d):
    """Exact: the identity at strides 0 and 1, every GOFT level (block 1,
    int(log2 d) levels: 11 at 3072, 13 at 8192) and BOFT's factors."""
    levels = int(np.log2(d))
    assert oft._num_levels(d) == levels
    cases = [(1, lvl) for lvl in range(levels)] + \
        [(b, lvl) for b in (8, 32) for lvl in range(3)] + [(d, 0)]
    for block, lvl in cases:
        got = oft._butterfly_perm(d, block, lvl).numpy()
        want = np.asarray(joft._butterfly_perm(d, block, lvl))
        np.testing.assert_array_equal(got, want, err_msg=f"{block} {lvl}")
    assert oft.goft_num_params(d, False) == joft.goft_num_params(d, False)
    with pytest.raises(ValueError, match="does not divide"):
        oft._butterfly_perm(3072, 1, 11)


# ------------------------------------------------- layer-stacked trees

def _nudged(tree, rng, method):
    """Every trainable leaf of every linear moved off init by seeded
    noise (numpy, so both packages see the same values)."""
    names = jregistry.get_method(method).trainable_names()

    def rec(node):
        if isinstance(node, dict) and jregistry.is_peft_param_dict(node):
            return {k: (v + rng.standard_normal(v.shape).astype(v.dtype)
                        * 0.05) if k in names else v
                    for k, v in node.items()}
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return node
    return rec(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("method", ["oft", "boft"])
def test_stacked_tree_merges_and_masks_as_the_reference(method):
    jcfg, cfg = _cfgs(method)
    jp = jax.jit(lambda k: jmodel.init_params(k, jcfg))(jax.random.PRNGKey(0))
    jp = _nudged(jp, np.random.default_rng(1), method)
    tp = interop.params_from_numpy(jp, device="cpu")
    q = tp["layers"]["attn"]["q"]
    assert q["q"].ndim == (3 if method == "oft" else 4)
    # the dispatch trap: a stacked OFT q has BOFT's unstacked rank
    assert registry.resolve(q, cfg.peft, module="q").name == method
    assert registry.infer_method(q).name == method
    assert registry.get_method("boft" if method == "oft" else "oft"
                               ).matches(q) is False
    want = jax.jit(lambda p: jpeft.merge_tree(p, jcfg.peft))(jp)
    got = peft.merge_tree(tp, cfg.peft)
    n = 0
    for kp, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for k in kp:
            node = node[k.key]
        w = np.asarray(w)
        np.testing.assert_allclose(node.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(kp))
        n += 1
    assert n > 0 and set(got["layers"]["mlp"]["down"]) == {"w"}
    want_mask = jmodel.trainable_mask(jcfg, jp)
    got_mask = model.trainable_mask(cfg, tp)
    for kp, w in jax.tree_util.tree_flatten_with_path(want_mask)[0]:
        node = got_mask
        for k in kp:
            node = node[k.key]
        assert node == bool(w), jax.tree_util.keystr(kp)
    assert {k for k, v in got_mask["layers"]["attn"]["q"].items() if v} == \
        {"q", "out_scale"}


# ------------------------------------------------------------ train steps

@pytest.fixture(scope="module")
def ref_runs():
    """Per method: the reference's numpy states after each of 3 steps on
    tiny (index 0: the initial state) and each step's metrics.  Every
    method's init and step are traced in turn and then compiled together
    on a thread pool (XLA compiles without holding the interpreter lock),
    at XLA's lowest optimisation level (``ssm_pairs.XLA_FAST``): compiling
    is what costs at these sizes, not running."""
    key = jax.random.PRNGKey(0)
    lowered = {}
    for method in TRAIN_METHODS:
        jcfg, _ = _cfgs(method)
        jtc = JTrainConfig(**TC)

        def init(k, jcfg=jcfg, jtc=jtc):
            return jtrainer.init_train_state(k, jcfg, jtc)
        ds = JDataset(jcfg, batch=BATCH, seq_len=SEQ)
        step = jax.jit(jtrainer.make_train_step(jcfg, jtc, moe_impl="dense"))
        lowered[method] = (jax.jit(init).lower(key), step.lower(
            jax.eval_shape(init, key),
            {k: jnp.asarray(v) for k, v in ds.batch_at(0).items()}), ds)
    with ThreadPoolExecutor(2 * len(lowered)) as pool:
        jobs = {m: (pool.submit(i.compile, sp.XLA_FAST),
                    pool.submit(s.compile, sp.XLA_FAST))
                for m, (i, s, _) in lowered.items()}
        compiled = {m: (i.result(), s.result()) for m, (i, s) in jobs.items()}
    out = {}
    for method, (init, step) in compiled.items():
        ds = lowered[method][2]
        state = init(key)
        states, metrics = [jax.tree.map(np.asarray, state)], []
        for i in range(STEPS):
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in ds.batch_at(i).items()})
            states.append(jax.tree.map(np.asarray, state))
            metrics.append({k: float(v) for k, v in m.items()})
        out[method] = (states, metrics)
    return out


def _pairs(jtree, ttree):
    for kp, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        node = ttree
        for k in kp:
            node = node[k.key]
        yield jax.tree_util.keystr(kp), np.asarray(leaf), node


@pytest.mark.parametrize("method", TRAIN_METHODS)
def test_three_train_steps_match_reference(ref_runs, method):
    jstates, jmetrics = ref_runs[method]
    _, cfg = _cfgs(method)
    state = trainer.train_state_from_numpy(jstates[0], device="cpu")
    step = trainer.make_train_step(cfg, TrainConfig(**TC))
    ds = SyntheticLMDataset(cfg, BATCH, SEQ)
    for i in range(STEPS):
        state, m = step(state, ds.batch_at(i))
        for key in ("loss", "grad_norm"):
            assert float(m[key]) == pytest.approx(jmetrics[i][key],
                                                  rel=1e-4), (i, key)
        atol = 1e-3 * TC["learning_rate"] * (i + 1)
        n = 0
        for path, want, got in _pairs(jstates[i + 1].trainable,
                                      state.trainable):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=atol, err_msg=path)
            n += 1
        assert n > 0
    moved = [float((got - torch.from_numpy(want)).abs().max())
             for _, want, got in _pairs(jstates[0].trainable,
                                        state.trainable)]
    assert min(moved) > 0
