"""The port's MoE family against the reference package on the CPU (fp32),
one set of params made with numpy in the reference's tree structure and
handed to both: the MoE layer (dense and capacity dispatch; ample
capacity, capacity_factor 0.25 with drops, a zero router whose ties must
resolve as ``lax.top_k`` resolves them) at reduced ``deepseek-moe-16b``
(shared expert, with grads) and ``dbrx-132b`` (no shared expert); the
grouped ``psoft_matmul`` plain version against the reference's oracle
vmapped over the expert axis; the model's trainable mask; and 3 train
steps of both dispatches from one state.

The reference's functions are jitted at XLA's lowest optimisation level
(:func:`_compiled`): at these sizes compiling is what costs, not running.

Tolerances: the layer's outputs 1e-5 and its aux loss 1e-6 (fp32, sums in
another order: the combine's scatter-add and the einsum); grads 1e-4
relative (fp32 sums of a few hundred products); train-step losses, grad
norms and trainables as in ``test_torch_train.py`` (1e-4 relative, plus
1e-3 * lr per step for the trainables)."""
import dataclasses
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
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model, moe  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ARCHS = ("deepseek-moe-16b", "dbrx-132b")
#: capacity_factor per case ("zero_router" also zeroes the router; it
#: shares the ample case's compiled reference)
CASES = {"ample": 8.0, "drops": 0.25, "zero_router": 8.0}
#: XLA options of every compiled reference function
XLA_FAST = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(XLA_FAST)


def _numpy_params(shapes, seed):
    """A tree of numpy params in the structure of ``shapes`` (the
    reference's ``jax.eval_shape`` of an init): norms at their init, every
    PSOFT trainable off it (q ~ 0.05, alpha and beta ~ 1 +- 0.05), every
    weight ~ N(0, 1 / fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(kp, s):
        name = kp[-1].key
        if name == "scale":
            return np.ones(s.shape, np.float32)
        if name == "bias":
            return np.zeros(s.shape, np.float32)
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name == "q":
            return 0.05 * z
        if name in ("alpha", "beta"):
            return 1 + 0.05 * z
        return (z / np.sqrt(s.shape[-2] if len(s.shape) >= 2 else 1)
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _cfgs(arch, cap):
    jcfg = jget_config(arch).reduced()
    jcfg = dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cap))
    cfg = get_config(arch).reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    return jcfg, cfg


@pytest.fixture(scope="module")
def layers():
    """One MoE layer per arch in the reference's structure (PSOFT on every
    expert stack and the shared expert) and an input batch, and a cache of
    the compiled reference functions."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jget_config(arch).reduced()
        shapes = jax.eval_shape(lambda k: jmoe.moe_init(
            k, jcfg, jnp.float32, jnp.float32, jcfg.peft.target_modules),
            jax.random.PRNGKey(0))
        x = np.random.default_rng(10 + i).standard_normal(
            (2, 24, jcfg.d_model)).astype(np.float32)
        out[arch] = (_numpy_params(shapes, i), x)
    return out, {}


def test_port_configs_equal_reference():
    for arch in ARCHS:
        want, got = jget_config(arch), get_config(arch)
        assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
        for f in ("family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "mlp_type", "norm_type"):
            assert getattr(got, f) == getattr(want, f), (arch, f)
        assert got.peft.rank == want.peft.rank
        r_want, r_got = want.reduced(), got.reduced()
        assert dataclasses.asdict(r_got.moe) == dataclasses.asdict(r_want.moe)
        assert (r_got.d_ff, r_got.num_layers, r_got.peft.rank) == \
            (r_want.d_ff, r_want.num_layers, r_want.peft.rank)


def test_top_k_breaks_ties_like_lax():
    """Ties resolve toward the lower index, as ``jax.lax.top_k``: a zero
    router ties every expert, and quantised rows tie some."""
    rng = np.random.default_rng(0)
    probs = np.concatenate([
        np.full((3, 8), 0.125, np.float32),
        (rng.integers(0, 3, (29, 8)) / 4).astype(np.float32)])
    for k in (1, 2, 6):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def _routing_drops(jcfg, p, x):
    """Reference routing of x: how many (token, choice) slots overflow."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt @ p["router"]["w"], axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.moe.top_k)
    cap = max(4, min(int(xt.shape[0] * jcfg.moe.top_k
                         * jcfg.moe.capacity_factor / jcfg.moe.num_experts),
                     xt.shape[0]))
    counts = np.bincount(np.asarray(idx).reshape(-1),
                         minlength=jcfg.moe.num_experts)
    return int(np.maximum(counts - cap, 0).sum())


def _grad_leaves(p):
    """(path, leaf) of every leaf the grads are compared on: the router
    and every q / alpha / beta."""
    out = [(("router", "w"), p["router"]["w"])]

    def rec(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                rec(v, path + (k,))
            elif k in ("q", "alpha", "beta"):
                out.append((path + (k,), v))
    rec({k: v for k, v in p.items() if k != "router"}, ())
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


#: the arch whose layer grads are compared (dbrx's layer differs from it
#: only by the missing shared expert, whose forward is compared)
GRAD_ARCH = ARCHS[0]


@pytest.mark.parametrize("impl", ["dense", "capacity"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(layers, arch, case, impl):
    """Outputs within 1e-5 and aux within 1e-6 of the reference's; at
    deepseek-moe-16b also the grads of x, the router and every q, alpha
    and beta within 1e-4 of ``jax.grad``'s.  The drop case really drops
    and the zero router really ties."""
    (params, cache) = layers
    p, x = params[arch]
    if case == "zero_router":
        p = {**p, "router": {"w": np.zeros_like(p["router"]["w"])}}
    jcfg, cfg = _cfgs(arch, CASES[case])
    if case == "drops" and impl == "capacity":
        assert _routing_drops(jcfg, p, x) > 0
    rng = np.random.default_rng(7)
    w_out = rng.standard_normal(x.shape).astype(np.float32)
    with_grads = arch == GRAD_ARCH

    def jloss(jp, jx):
        y, aux = jmoe.moe_apply(jp, jx, jcfg, jnp.float32, impl)
        return jnp.sum(y * w_out) + 0.5 * aux, (y, aux)
    # the dense dispatch reads no capacity: one compile serves every case
    key = (arch, CASES[case] if impl == "capacity" else None, impl)
    if key not in cache:
        fn = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True) \
            if with_grads else jloss
        cache[key] = _compiled(fn, p, x)
    if with_grads:
        (_, (jy, jaux)), (jgp, jgx) = cache[key](p, x)
    else:
        _, (jy, jaux) = cache[key](p, x)

    tp = interop.params_from_numpy(p, device="cpu")
    leaves = _grad_leaves(tp)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = moe.moe_apply(tp, tx, cfg, torch.float32, impl)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    assert abs(taux.item() - float(jaux)) <= 1e-6
    if not with_grads:
        return
    loss = (ty * torch.from_numpy(w_out)).sum() + 0.5 * taux
    grads = torch.autograd.grad(loss, [tx] + [lf for _, lf in leaves])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx),
                               atol=1e-4, rtol=1e-4, err_msg="dx")
    for (path, _), g in zip(leaves, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(_get(jgp, path)),
                                   atol=1e-4, rtol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("transpose", [False, True])
def test_grouped_psoft_plain_matches_reference_oracle(transpose):
    """The grouped wrapper's plain version (the CPU path of
    ``ops.psoft_matmul`` and ``ops._psoft_mm`` on an expert stack) against
    the reference's ``psoft_matmul_ref`` vmapped over the expert axis, in
    fp32, forward and transposed (the dx of each expert's linear)."""
    rng = np.random.default_rng(3)
    g, m, k, n, r = 3, 10, 24, 16, 8
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, w, a, b = f(g, m, n if transpose else k), f(g, k, n), f(g, k, r), \
        f(g, r, n)
    rot = (np.eye(r, dtype=np.float32) + 0.1 * f(g, r, r))
    al, be = 1 + 0.1 * f(g, r), 1 + 0.1 * f(g, r)
    if transpose:
        # dx = dy (W_res + A diag(al) R diag(be) B)^T
        want = jax.vmap(lambda xx, ww, aa, rr, bb, s1, s2: jref.psoft_matmul_ref(
            xx, ww.T, bb.T, rr.T, aa.T, s2, s1))(x, w, a, rot, b, al, be)
    else:
        want = jax.vmap(jref.psoft_matmul_ref)(x, w, a, rot, b, al, be)
    t = [torch.from_numpy(v) for v in (x, w, a, rot, b, al, be)]
    got = ops._psoft_mm(*t[:5], *((t[6], t[5]) if transpose
                                  else (t[5], t[6])), transpose)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if not transpose:
        np.testing.assert_allclose(ops.psoft_matmul(*t).numpy(),
                                   np.asarray(want), atol=1e-5, rtol=1e-5)
        # group g is the 2-D function on its own slices
        for i in range(g):
            one = ref.psoft_matmul(*(v[i] for v in t))
            np.testing.assert_array_equal(one.numpy(), got[i].numpy())


# -------------------------------------------------------------- the model

STEPS = 3
TC = dict(steps=10, learning_rate=1e-2, warmup_ratio=0.2)
BATCH, SEQ = 2, 16


@pytest.fixture(scope="module")
def model_pair():
    """Reduced deepseek-moe-16b params (numpy, the reference's tree
    structure, PSOFT on every default target) and their train state."""
    jcfg = jget_config("deepseek-moe-16b").reduced()
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    params = _numpy_params(shapes, 5)
    tr, fr = jadamw.partition(params, jmodel.trainable_mask(jcfg, params))
    state = jtrainer.TrainState(step=np.zeros((), np.int32), trainable=tr,
                                frozen=fr, opt=_np(jadamw.adamw_init(tr)))
    return jcfg, params, state


def test_trainable_mask_equals_reference(model_pair):
    jcfg, params, _ = model_pair
    want = jmodel.trainable_mask(jcfg, params)
    got = model.trainable_mask(get_config("deepseek-moe-16b").reduced(),
                               params)
    assert got == jax.tree.map(bool, want)
    assert got["layers"]["moe"]["router"]["w"] is False
    assert got["layers"]["moe"]["up"]["q"] is True
    assert got["layers"]["moe"]["shared"]["down"]["alpha"] is True


@pytest.fixture(scope="module")
def ref_steps(model_pair):
    """The reference's train step of each dispatch, traced in turn and
    compiled together on two threads (XLA compiles without holding the
    interpreter lock): :func:`_compiled`'s executables."""
    jcfg, _, jstate = model_pair
    batch = JDataset(jcfg, batch=BATCH, seq_len=SEQ).batch_at(0)
    lowered = {impl: jax.jit(jtrainer.make_train_step(
        jcfg, JTrainConfig(**TC), moe_impl=impl)).lower(jstate, batch)
        for impl in ("capacity", "dense")}
    with ThreadPoolExecutor(len(lowered)) as pool:
        jobs = {impl: pool.submit(lo.compile, XLA_FAST)
                for impl, lo in lowered.items()}
        return {impl: job.result() for impl, job in jobs.items()}


@pytest.mark.parametrize("impl", ["capacity", "dense"])
def test_moe_train_steps_match_reference(model_pair, ref_steps, impl):
    """3 steps of each dispatch from one converted state: losses, aux and
    grad norms 1e-4 relative, and every trainable leaf after every step."""
    jcfg, _, jstate = model_pair
    cfg = get_config("deepseek-moe-16b").reduced()
    ds = JDataset(jcfg, batch=BATCH, seq_len=SEQ)
    jstep = ref_steps[impl]
    tstate = trainer.train_state_from_numpy(jstate, device="cpu")
    tstep = trainer.make_train_step(cfg, TrainConfig(**TC), moe_impl=impl)
    for i in range(STEPS):
        batch = ds.batch_at(i)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        for key in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} step {i}")
        atol = 1e-3 * TC["learning_rate"] * (i + 1)
        want = jax.tree_util.tree_flatten_with_path(jstate.trainable)[0]
        for kp, leaf in want:
            node = tstate.trainable
            for k in kp:
                node = node[k.key]
            np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                       rtol=1e-4, atol=atol,
                                       err_msg=jax.tree_util.keystr(kp))


def test_moe_state_crosses_interop_and_checkpoints(model_pair, tmp_path):
    """The (L, E, ...) expert leaves and the fp32 router cross unchanged:
    numpy -> port -> numpy, and a port checkpoint of the MoE train state
    restored in the reference bit for bit (and the reverse)."""
    from repro.train import checkpoint as jcheckpoint
    from repro_torch import tree
    from repro_torch.train import checkpoint
    jcfg, params, jstate = model_pair
    back = interop.params_to_numpy(interop.params_from_numpy(params, "cpu"))
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = back
        for k in kp:
            node = node[k.key]
        assert node.dtype == leaf.dtype and node.tobytes() == leaf.tobytes()
    up = params["layers"]["moe"]["up"]["w_res"]
    assert up.shape[:2] == (jcfg.num_layers, jcfg.moe.num_experts)
    state = trainer.train_state_from_numpy(jstate, device="cpu")
    assert state.frozen["layers"]["moe"]["router"]["w"].dtype == \
        torch.float32
    checkpoint.save(state, str(tmp_path / "port"), 2)
    got = jcheckpoint.restore(jax.tree.map(jnp.asarray, jstate),
                              str(tmp_path / "port"))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    jcheckpoint.save(jax.tree.map(jnp.asarray, jstate), str(tmp_path / "ref"),
                     2)
    again = checkpoint.restore(tree.tree_map(torch.zeros_like, state),
                               str(tmp_path / "ref"))
    for a, b in zip(tree.tree_leaves(again), tree.tree_leaves(state)):
        assert torch.equal(a, b)


def _merged_numpy(jcfg, seed):
    """A merged (plain ``{"w"}``) numpy tree of ``jcfg``'s structure."""
    plain = jcfg.replace(peft=jcfg.peft.replace(method="none",
                                                target_modules=()))
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, plain),
                            jax.random.PRNGKey(0))
    return _numpy_params(shapes, seed)


def test_rewrap_casts_the_router_like_reference():
    """Reduced deepseek-moe-16b at bf16 ``param_dtype``, PSOFT on the
    default targets: each package's ``rewrap_peft`` of one merged tree
    casts the router to bf16 (the ``"none"`` method), bit for bit, and the
    two rewrapped models pick the same greedy tokens; a router named in
    ``target_modules`` makes the port's ``rewrap_peft`` raise."""
    jcfg = jget_config("deepseek-moe-16b").reduced(param_dtype="bfloat16")
    cfg = get_config("deepseek-moe-16b").reduced(param_dtype="bfloat16")
    merged = _merged_numpy(jcfg, 6)
    want = jmodel.rewrap_peft(jax.tree.map(jnp.asarray, merged), jcfg)
    got = model.rewrap_peft(interop.params_from_numpy(merged, "cpu"), cfg)
    wr = np.asarray(want["layers"]["moe"]["router"]["w"])
    gr = got["layers"]["moe"]["router"]["w"]
    assert wr.dtype.name == "bfloat16" and gr.dtype == torch.bfloat16
    assert interop.params_to_numpy(gr).tobytes() == wr.tobytes()
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    jl = _compiled(lambda p, t: jmodel.forward_logits(p, {"tokens": t},
                                                      jcfg), want, toks)(
        want, toks)
    tl = model.forward_logits(got, {"tokens": torch.as_tensor(toks)}, cfg)
    np.testing.assert_array_equal(
        tl[..., :cfg.vocab_size].argmax(-1).numpy(),
        np.asarray(jl)[..., :cfg.vocab_size].argmax(-1))
    with pytest.raises(ValueError, match="'router'"):
        model.rewrap_peft(interop.params_from_numpy(merged, "cpu"), cfg.replace(
            peft=cfg.peft.replace(target_modules=("q", "router"))))


def test_prefill_defaults_to_capacity_like_reference(model_pair):
    """``prefill`` with default arguments dispatches the MoE layers with
    capacity, as the reference's does (its ``moe_impl="capacity"``):
    reduced deepseek-moe-16b on a batch whose capacity drops tokens (the
    dense dispatch gives other logits there), both packages' logits within
    1e-5; ``decode_step`` defaults to the dense dispatch in both."""
    jcfg, params, _ = model_pair
    cfg = get_config("deepseek-moe-16b").reduced()
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                              (2, 16)).astype(np.int32)
    step = toks[:, :1]
    jp = jax.tree.map(jnp.asarray, params)

    def ref_fn(p, t, s):
        logits, cache = jmodel.prefill(p, {"tokens": t}, jcfg, 32)
        nxt, _ = jmodel.decode_step(p, {"tokens": s}, cache, 16, jcfg)
        return logits, nxt
    want, want_next = _compiled(ref_fn, jp, toks, step)(jp, toks, step)
    tp = interop.params_from_numpy(params, "cpu")
    got, cache = model.prefill(tp, {"tokens": torch.as_tensor(toks)}, cfg, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    dense, _ = model.prefill(tp, {"tokens": torch.as_tensor(toks)}, cfg, 32,
                             moe_impl="dense")
    assert float((dense - got).abs().max()) > 1e-3
    nxt, _ = model.decode_step(tp, {"tokens": torch.as_tensor(step)}, cache,
                               16, cfg)
    np.testing.assert_allclose(nxt.numpy(), np.asarray(want_next), rtol=0,
                               atol=1e-5)
