"""The seven baseline PEFT methods of the port (pissa, dora, lora_xs, oft,
boft, goft, qgoft) against the reference package on one fp32 linear: init,
apply, merge, the grads of apply in every trainable, Table 8 counts and
trainable names; and the port's adapter bank for each (the dense-delta
fallback for DoRA, PiSSA and the OFT family, the low-rank bank for
LoRA-XS), mirroring tests/test_registry.py.

Parity comes from shared values: the reference's params, moved off init
by numpy noise, are converted into the port, never re-drawn with torch's
RNG (DoRA's ``a`` is random).  PiSSA's and LoRA-XS's inits take an SVD,
whose singular vectors agree only up to sign, so their inits compare
through the products and the residual.  Tolerance: 1e-5 relative to the
largest entry of each compared tensor (fp32, sums in another order); the
banks 1e-4, as the reference's own bank tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import PEFTConfig as JPEFTConfig  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core import registry as jregistry  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import PEFT_METHODS, PEFTConfig  # noqa: E402
from repro_torch.core import peft, registry  # noqa: E402
import ssm_pairs as sp  # noqa: E402

D_IN, D_OUT = 64, 48
NEW_METHODS = ["pissa", "dora", "lora_xs", "oft", "boft", "goft", "qgoft"]
#: the reference's tests/test_registry.py split
DENSE_METHODS = ["pissa", "dora", "oft", "boft", "goft", "qgoft"]
F32 = jnp.float32


@pytest.fixture(scope="module", autouse=True)
def _compiled_rotations():
    with sp.compiled_reference_rotations():
        yield


def _kw(method):
    return dict(method=method, rank=8, oft_block_size=16, boft_blocks=8,
                boft_factors=2)


def _close(got, want, tol=1e-5, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    atol = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=what)


def _reference_linear(method, seed=0, scale=0.05):
    """(w, reference params at init, the same moved off init) as numpy."""
    jcfg = JPEFTConfig(**_kw(method))
    key = jax.random.PRNGKey(seed)
    w = np.array(jax.random.normal(key, (D_IN, D_OUT)) * 0.2)
    jm = jregistry.get_method(method)
    p0 = jax.tree.map(np.asarray, jax.jit(
        lambda w: jm.init(key, w, jcfg, F32, F32))(jnp.asarray(w)))
    rng = np.random.default_rng(seed + 1)
    moved = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * scale
                 if k in jm.trainable_names(jcfg) else v)
             for k, v in p0.items()}
    return jcfg, w, p0, moved


def _port(tree):
    return interop.params_from_numpy(tree, device="cpu")


def test_registry_holds_every_reference_method_in_order():
    assert PEFT_METHODS == tuple(jregistry._METHODS)
    assert list(registry._METHODS) == list(jregistry._METHODS)
    assert registry.available_methods() == jregistry.available_methods()
    assert registry.linear_markers() == jregistry.linear_markers()
    for name in PEFT_METHODS:
        assert registry.get_method(name).supports_batched_delta == \
            jregistry.get_method(name).supports_batched_delta, name


@pytest.mark.parametrize("method", NEW_METHODS)
def test_method_matches_reference(method):
    jcfg, w, p0, pj = _reference_linear(method)
    cfg = PEFTConfig(**_kw(method))
    jm, tm = jregistry.get_method(method), registry.get_method(method)

    # init: exact for the OFT family; the SVD methods through products
    got0 = tm.init(None, torch.from_numpy(w), cfg, torch.float32,
                   torch.float32)
    assert set(got0) == set(p0)
    for k, v in p0.items():
        assert tuple(got0[k].shape) == v.shape, k
    if method in ("pissa", "lora_xs"):
        _close(got0["a"] @ got0["b"], p0["a"] @ p0["b"], what="a @ b")
        _close(got0["w"], p0["w"], what="w")
        if method == "lora_xs":
            assert not got0["s"].any()
    elif method == "dora":           # a is random: only its shape is shared
        for k in ("w", "b", "m"):
            _close(got0[k], p0[k], what=k)
    else:
        for k, v in p0.items():
            _close(got0[k], v, what=k)
    # a port-initialised linear starts at W_pre (the SVD methods in fp32)
    x = np.random.default_rng(2).standard_normal((12, D_IN)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    _close(tm.apply(got0, xt, cfg, torch.float32), x @ w, tol=1e-4,
           what="apply at init")

    # apply and merge off init, on the reference's converted params
    pt = _port(pj)
    want = jax.jit(lambda p, x: jm.apply(p, x, jcfg, F32))(pj, x)
    _close(tm.apply(pt, xt, cfg, torch.float32), want, what="apply")
    want_w = jax.jit(lambda p: jm.merge(p, jcfg))(pj)
    _close(tm.merge(pt, cfg), want_w, what="merge")
    assert tm.matches(pt) and registry.resolve(pt, cfg).name == method

    # grads of apply in every trainable
    names = tm.trainable_names(cfg)
    assert names == jm.trainable_names(jcfg)
    dy = np.random.default_rng(3).standard_normal((12, D_OUT)).astype(
        np.float32)

    def jloss(tr):
        return jnp.sum(jm.apply({**pj, **tr}, x, jcfg, F32) * dy)
    jgrads = jax.jit(jax.grad(jloss))({k: pj[k] for k in names})
    leaves = {k: pt[k].clone().requires_grad_(True) for k in names}
    y = tm.apply({**pt, **leaves}, xt, cfg, torch.float32)
    grads = torch.autograd.grad(y, [leaves[k] for k in names],
                                torch.from_numpy(dy))
    for k, g in zip(names, grads):
        _close(g, jgrads[k], what=f"grad {k}")

    # Table 8 counts, per linear and through the dispatchers
    for d_in, d_out in ((D_IN, D_OUT), (128, 512), (3072, 8192)):
        assert tm.num_params(d_in, d_out, cfg) == \
            jm.num_params(d_in, d_out, jcfg), (d_in, d_out)
        assert peft.count_trainable_params(d_in, d_out, cfg, module="q") == \
            jpeft.count_trainable_params(d_in, d_out, jcfg, module="q")
    assert peft.trainable_names(method, cfg) == \
        jpeft.trainable_names(method, jcfg)


# ---------------------------------------------------------------------------
# adapter banks (tests/test_registry.py's stack_deltas cases, on the port)
# ---------------------------------------------------------------------------

def _bank_entries(method, n_adapters=2):
    """The base (an adapter at init) and n fine-tunes of one weight, moved
    off init by growing noise; the reference's merges of each as want."""
    jcfg, _, p0, _ = _reference_linear(method)
    cfg = PEFTConfig(**_kw(method))
    entries, wants = [(_port(p0), cfg, None)], [p0]
    for i in range(n_adapters):
        _, _, _, moved = _reference_linear(method, scale=0.05 * (i + 1))
        entries.append((_port(moved), cfg, None))
        wants.append(moved)
    jm = jregistry.get_method(method)
    merges = [np.asarray(jax.jit(lambda p: jm.merge(p, jcfg))(p))
              for p in wants]
    return entries, merges


@pytest.mark.parametrize("method", DENSE_METHODS)
def test_stack_deltas_dense_fallback_exact(method):
    entries, merges = _bank_entries(method)
    base_w = torch.from_numpy(merges[0])
    bank = registry.stack_deltas(base_w, entries)
    assert bank is not None and set(bank) == {"delta"}
    for i, want in enumerate(merges):
        _close(base_w + bank["delta"][i], want, tol=1e-4, what=f"adapter {i}")


def test_stack_deltas_low_rank_exact_lora_xs():
    entries, merges = _bank_entries("lora_xs")
    base_w = torch.from_numpy(merges[0])
    bank = registry.stack_deltas(base_w, entries)
    assert bank is not None and set(bank) == {"left", "right"}
    for i, want in enumerate(merges):
        _close(base_w + bank["left"][i] @ bank["right"][i], want, tol=1e-4,
               what=f"adapter {i}")
