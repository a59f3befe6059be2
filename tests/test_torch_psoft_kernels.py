"""The port's training-path kernel wrappers (``psoft_matmul`` and
``cayley_neumann``) against the reference package, on CPU tensors, where
each wrapper runs its plain version inside its ``torch.autograd.Function``.
Forward values are held against the interpret-mode Pallas kernels, and the
port's hand-written backwards against ``jax.grad`` of the reference's paths.

Tolerances in fp32: values 1e-4 (1e-5 for the rotation), as the
reference's own kernel tests; gradients rtol 1e-4 with an absolute part of
1e-4 of the gradient's largest element, since sums over 64-512 products run
in another order in each package.  One bf16 case holds the wrapper against
the reference's oracle at chip_smoke.py's bf16 limit (see BF16_TOL).  The CUDA launches are tested on the card
by test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cayley as jcayley, psoft as jpsoft  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels.cayley_kernel import cayley_neumann_pallas  # noqa: E402
from repro_torch.configs import PEFTConfig  # noqa: E402
from repro_torch.core import cayley, peft, psoft  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

f32 = jnp.float32


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.requires_grad_(True) if grad else t


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got.detach()) if
                               isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=rtol, atol=atol)


def _grad_close(got, want):
    want = np.asarray(want)
    _close(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def _psoft_case(seed, m, k, n, r):
    """Reference PSOFT params of a random W (the SVD split done once, in
    the reference) with trainables off identity, and an input."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    p = jpsoft.psoft_init(jnp.asarray(w), r, True, f32, f32)
    p = {key: np.asarray(v) for key, v in p.items()}
    p["q"] = (rng.standard_normal(p["q"].shape) * 0.02).astype(np.float32)
    p["alpha"] = (1 + 0.05 * rng.standard_normal(r)).astype(np.float32)
    p["beta"] = (1 + 0.05 * rng.standard_normal(r)).astype(np.float32)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    return p, x


def _port_rot(p, r):
    return cayley.cayley_neumann(_t(p["q"]), r, 5)


# ----------------------------------------------------------- psoft_matmul

@pytest.mark.parametrize("m,k,n,r", [
    (64, 128, 128, 8), (128, 256, 512, 64), (256, 512, 256, 32),
    (96, 128, 128, 16),
    (37, 128, 128, 16),   # ragged m: no multiple of 8
])
def test_psoft_matmul_matches_the_interpret_mode_kernel(m, k, n, r):
    p, x = _psoft_case(m + r, m, k, n, r)
    want = jops.psoft_matmul(jnp.asarray(x), {kk: jnp.asarray(v)
                                             for kk, v in p.items()},
                             compute_dtype=f32)
    got = ops.psoft_matmul(_t(x), _t(p["w_res"]), _t(p["A"]),
                           _port_rot(p, r), _t(p["B"]), _t(p["alpha"]),
                           _t(p["beta"]))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close(got, want)
    # and the reference's oracle on the same rotation
    rot = jcayley.cayley_neumann(jnp.asarray(p["q"]), r, 5)
    _close(got, jref.psoft_matmul_ref(jnp.asarray(x), p["w_res"], p["A"],
                                      rot, p["B"], p["alpha"], p["beta"]))


#: bf16 limit, as chip_smoke.py's: |got - want| <= BF16_TOL * (rms(want)
#: + |want|) elementwise; the output's own bf16 rounding reaches 2**-8 of
#: |want|, and summing in another order flips it by one unit
BF16_TOL = 2e-2


@pytest.mark.parametrize("m,k,n,r", [
    (128, 256, 512, 64),
    (37, 128, 128, 16),   # ragged m
])
def test_bf16_psoft_matmul_against_the_reference_oracle(m, k, n, r):
    """The wrapper rounds the rank-r operand v to bf16 (the kernel's
    rounding); psoft_matmul_ref keeps it in fp32.  Both outputs stay within
    the bf16 limit of each other, and the rounding itself costs under half
    the limit (about 0.5% of rms(y) on these shapes)."""
    p, x = _psoft_case(m + r, m, k, n, r)
    bf = torch.bfloat16
    rot = np.asarray(jcayley.cayley_neumann(jnp.asarray(p["q"]), r, 5))
    xb, wb, ab, bb = (_t(v).to(bf) for v in (x, p["w_res"], p["A"], p["B"]))
    al, be = _t(p["alpha"]), _t(p["beta"])
    got = ops.psoft_matmul(xb, wb, ab, _t(rot), bb, al, be)
    assert got.dtype == bf and got.shape == (m, n)

    def jbf(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jref.psoft_matmul_ref(
        jbf(xb), jbf(wb), jbf(ab), rot, jbf(bb), p["alpha"], p["beta"]
    ).astype(f32))
    rms = float(np.sqrt(np.mean(want ** 2)))
    err = np.abs(got.float().numpy() - want)
    assert (err <= BF16_TOL * (rms + np.abs(want))).all(), err.max()
    t = ((xb.float() @ ab.float()) * al) @ _t(rot) * be
    cost = ((t.to(bf).float() - t) @ bb.float()).abs().max()
    assert float(cost) <= BF16_TOL / 2 * rms, float(cost) / rms


def test_psoft_apply_of_any_leading_shape_goes_through_the_wrapper(
        monkeypatch):
    p, x = _psoft_case(5, 24, 64, 48, 8)
    tp = {k: _t(v) for k, v in p.items()}
    x3 = x.reshape(2, 12, 64)
    calls = []
    real = ops.psoft_matmul

    def spy(xx, *args, **kw):
        calls.append(tuple(xx.shape))
        return real(xx, *args, **kw)
    monkeypatch.setattr(ops, "psoft_matmul", spy)
    got = peft.apply_linear(tp, _t(x3), PEFTConfig(rank=8), torch.float32,
                            module="q")
    assert calls == [(24, 64)]
    assert got.shape == (2, 12, 48)
    _close(got, jpsoft.psoft_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x3), compute_dtype=f32))


def test_psoft_matmul_grads_match_the_reference_custom_vjp():
    """x, q, alpha and beta: the port's autograd functions (psoft_matmul's
    transposed launch, the Cayley reverse Horner) against jax.grad of the
    reference's custom-VJP kernel path."""
    r, m, k, n = 8, 64, 128, 128
    p, x = _psoft_case(11, m, k, n, r)
    jp = {kk: jnp.asarray(v) for kk, v in p.items()}

    def f_ref(x, q, alpha, beta):
        pp = {**jp, "q": q, "alpha": alpha, "beta": beta}
        return (jops.psoft_matmul(x, pp, compute_dtype=f32) ** 2).sum()

    want = jax.grad(f_ref, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jp["q"], jp["alpha"], jp["beta"])
    tx, tq, ta, tb = (_t(v, grad=True) for v in (x, p["q"], p["alpha"],
                                                 p["beta"]))
    y = ops.psoft_matmul(tx, _t(p["w_res"]), _t(p["A"]),
                         cayley.cayley_neumann(tq, r, 5), _t(p["B"]), ta, tb)
    (y ** 2).sum().backward()
    for got, w in zip((tx.grad, tq.grad, ta.grad, tb.grad), want):
        _grad_close(got, w)


def test_full_finetune_grads_of_the_frozen_factors():
    """W_res, A and B grads where asked for (the JAX fused path returns
    zeros there), against jax.grad of the reference's unfused apply."""
    r, m, k, n = 8, 48, 64, 80
    p, x = _psoft_case(12, m, k, n, r)
    jp = {kk: jnp.asarray(v) for kk, v in p.items()}

    def f_ref(w_res, a, b):
        pp = {**jp, "w_res": w_res, "A": a, "B": b}
        return (jpsoft.psoft_apply(pp, jnp.asarray(x), compute_dtype=f32)
                ** 3).sum()

    want = jax.grad(f_ref, argnums=(0, 1, 2))(jp["w_res"], jp["A"], jp["B"])
    tw, ta, tb = (_t(p[kk], grad=True) for kk in ("w_res", "A", "B"))
    y = ops.psoft_matmul(_t(x), tw, ta, _port_rot(p, r), tb,
                         _t(p["alpha"]), _t(p["beta"]))
    (y ** 3).sum().backward()
    for got, w in zip((tw.grad, ta.grad, tb.grad), want):
        _grad_close(got, w)


def test_frozen_factors_get_no_grad_when_nothing_asks():
    r, m, k, n = 8, 16, 32, 24
    p, x = _psoft_case(13, m, k, n, r)
    tw, ta, tb = (_t(p[kk]) for kk in ("w_res", "A", "B"))
    tx = _t(x, grad=True)
    ops.psoft_matmul(tx, tw, ta, _port_rot(p, r), tb, _t(p["alpha"]),
                     _t(p["beta"])).sum().backward()
    assert tx.grad is not None
    assert tw.grad is None and ta.grad is None and tb.grad is None


def test_transposed_launch_reproduces_the_reference_backward():
    """The backward's one launch reads W_res, A, B and R transposed: its y
    is _psoft_mm_bwd's dx, and the grads built from its u and t are
    _psoft_mm_bwd's d_rot, d_alpha and d_beta, term by term."""
    r, m, k, n = 16, 40, 96, 72
    p, x = _psoft_case(14, m, k, n, r)
    rng = np.random.default_rng(15)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    rot = np.asarray(jcayley.cayley_neumann(jnp.asarray(p["q"]), r, 5))
    res = tuple(jnp.asarray(v) for v in (x, p["w_res"], p["A"], rot, p["B"],
                                         p["alpha"], p["beta"]))
    jdx, _, _, jdrot, _, jdal, jdbe = jops._psoft_mm_bwd(f32, True, res,
                                                         jnp.asarray(dy))
    dx, du4, du2 = ops._psoft_mm(_t(dy), _t(p["w_res"]), _t(p["A"]),
                                 _t(rot), _t(p["B"]), _t(p["beta"]),
                                 _t(p["alpha"]), True)
    assert dx.shape == (m, k)
    _close(dx, jdx)
    _close(du4, _t(dy) @ _t(p["B"]).T)
    _close(du2, (du4 * _t(p["beta"])) @ _t(rot).T)
    targs = [_t(v, grad=True) for v in (x, p["w_res"], p["A"], rot, p["B"],
                                        p["alpha"], p["beta"])]
    for t in targs[1:3] + targs[4:5]:
        t.requires_grad_(False)
    y = ops._PSoftMatmul.apply(*targs)
    gx, grot, gal, gbe = torch.autograd.grad(
        y, [targs[0], targs[3], targs[5], targs[6]], _t(dy))
    _close(gx, jdx)
    for got, w in ((grot, jdrot), (gal, jdal), (gbe, jdbe)):
        _grad_close(got, w)


# ----------------------------------------------------------- cayley

@pytest.mark.parametrize("r", [4, 16, 46, 64, 128])
@pytest.mark.parametrize("terms", [1, 5, 8])
def test_cayley_wrapper_matches_the_interpret_mode_kernel(r, terms):
    rng = np.random.default_rng(r + terms)
    q = (rng.standard_normal(cayley.num_skew_params(r)) * 0.03).astype(
        np.float32)
    qd = np.asarray(jcayley.skew_from_flat(jnp.asarray(q), r))
    want = cayley_neumann_pallas(jnp.asarray(qd), terms=terms,
                                 interpret=True)
    _close(ops.cayley_neumann(_t(qd), terms), want, atol=1e-5)
    _close(cayley.cayley_neumann(_t(q), r, terms), want, atol=1e-5)


def test_cayley_with_no_terms_is_i_minus_q():
    rng = np.random.default_rng(0)
    qd = rng.standard_normal((6, 6)).astype(np.float32)
    _close(ops.cayley_neumann(_t(qd), 0), np.eye(6) - qd, atol=1e-6)
    _close(ref.cayley_neumann(_t(qd), 0),
           jref.cayley_neumann_ref(jnp.asarray(qd), 0), atol=1e-6)


@pytest.mark.parametrize("r", [8, 32])
@pytest.mark.parametrize("terms", [1, 5])
def test_cayley_backward_matches_jax_grad(r, terms):
    """The reverse Horner recursion against jax.grad of the reference's
    cayley_neumann (which differentiates its jnp series)."""
    rng = np.random.default_rng(r * 10 + terms)
    q = (rng.standard_normal(cayley.num_skew_params(r)) * 0.1).astype(
        np.float32)
    wt = rng.standard_normal((r, r)).astype(np.float32)
    want = jax.grad(lambda q: (jcayley.cayley_neumann(q, r, terms)
                               * jnp.asarray(wt)).sum())(jnp.asarray(q))
    tq = _t(q, grad=True)
    (cayley.cayley_neumann(tq, r, terms) * _t(wt)).sum().backward()
    _grad_close(tq.grad, want)


def test_batched_cayley_over_a_layer_stack():
    """q (L, r(r-1)/2): one wrapper call for the stack, equal to the
    reference per layer, values and grads."""
    r, n_layers, terms = 12, 3, 5
    rng = np.random.default_rng(7)
    q = (rng.standard_normal((n_layers, cayley.num_skew_params(r)))
         * 0.05).astype(np.float32)
    wt = rng.standard_normal((n_layers, r, r)).astype(np.float32)
    tq = _t(q, grad=True)
    got = cayley.cayley_neumann(tq, r, terms)
    assert got.shape == (n_layers, r, r)
    (got * _t(wt)).sum().backward()

    def one(q, w):
        return (jcayley.cayley_neumann(q, r, terms) * w).sum()
    want = jax.vmap(lambda q: jcayley.cayley_neumann(q, r, terms))(
        jnp.asarray(q))
    want_grad = jax.vmap(jax.grad(one))(jnp.asarray(q), jnp.asarray(wt))
    _close(got, want, atol=1e-5)
    for i in range(n_layers):
        _grad_close(tq.grad[i], want_grad[i])
