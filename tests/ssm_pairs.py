"""Shared by the port's SSM and hybrid test files: numpy params in the
reference's tree structure, the reference's functions compiled at XLA's
lowest optimisation level, a NaN-safe copy of the reference's SSD scan for
training, and the train-step comparison.

The reference's ``ssd_chunked`` masks the intra-chunk decay
``exp(cum_i - cum_j)`` after the ``exp``; its masked-out entries overflow to
``inf`` over a chunk of realistic decays, and ``where``'s gradient then
multiplies ``0 * inf``: every training gradient through the reference's
scan is NaN (:func:`test_torch_ssm.test_reference_scan_gradients_are_nan`
pins it).  :func:`safe_ssd_chunked` is the reference's function with that
one exponent masked before the ``exp``, as the port does; its forward
values are the reference's, which the tests check before training with it.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.core import cayley as jcayley
from repro.data import SyntheticLMDataset as JDataset
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro.serve import sampling as jsampling
from repro.train import trainer as jtrainer
import repro_torch.serve as tserve
from repro_torch import interop
from repro_torch.configs import TrainConfig, get_config
from repro_torch.models import model as tmodel
from repro_torch.train import trainer

#: XLA options of every compiled reference function: at these sizes
#: compiling is what costs, not running
XLA_FAST = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
#: model-level agreement (fp32, sums in another order over a few layers)
MODEL_TOL = 1e-4
STEPS = 3
TC = dict(steps=10, learning_rate=1e-2, warmup_ratio=0.2)
BATCH, SEQ = 2, 16


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(XLA_FAST)


def fast_jit(fn, **kw):
    return jax.jit(fn, compiler_options=XLA_FAST, **kw)


@contextlib.contextmanager
def compiled_reference_rotations():
    """The reference's Cayley-Neumann rotation jitted once per shape while
    the context lasts: called eagerly, its ``lax.scan`` traces and
    compiles a new closure at every call (~0.1 s here), and the
    reference engine's merges and bank builds call it for every PSOFT
    linear of every adapter."""
    fn = jax.jit(jcayley.cayley_neumann, static_argnums=(1, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcayley, "cayley_neumann", fn)
        yield


#: the reference's sampler at the lowest optimisation level, shared by
#: every reference engine of the process (it compiles once per batch size)
_FAST_SAMPLE = fast_jit(jsampling._sample_impl,
                        static_argnames=("want_logprobs",))


def share_fast_jits(eng):
    """Re-jit a reference engine's dense-path step functions and its
    sampler at the lowest optimisation level (the step functions compile
    once per prompt length and group size)."""
    for f in ("_decode", "_prefill"):
        setattr(eng, f, fast_jit(getattr(eng, f).__wrapped__))
    eng._sample_fn = _FAST_SAMPLE


def configs(arch, method="psoft"):
    """(reference config, port config) of the reduced ``arch`` (``tiny``
    as it is)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    if arch != "tiny":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    return (jcfg.replace(peft=jcfg.peft.replace(method=method)),
            cfg.replace(peft=cfg.peft.replace(method=method)))


def numpy_params(jcfg, seed, at_init=False):
    """Numpy params in the reference's tree structure (``jax.eval_shape``
    of its init; lists of per-layer dicts for the hybrid): norms at their
    init, every PSOFT trainable off it (q ~ 0.05, alpha and beta ~ 1 +-
    0.05) or, ``at_init``, at it (a served base whose adapters then bank
    low-rank), the SSD decays at init (``a_log``), every other leaf ~ N(0,
    1 / fan_in)."""
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(kp, s):
        name = kp[-1].key if hasattr(kp[-1], "key") else ""
        if name == "scale":
            return np.ones(s.shape, np.float32)
        if name in ("bias", "marker"):
            return np.zeros(s.shape, np.float32)
        if name == "a_log":
            return np.broadcast_to(np.log(np.linspace(
                1.0, 16.0, s.shape[-1], dtype=np.float32)), s.shape).copy()
        z = rng.standard_normal(s.shape).astype(np.float32)
        if at_init and name in ("q", "alpha", "beta"):
            return (np.zeros if name == "q" else np.ones)(s.shape, np.float32)
        if name == "q":
            return 0.05 * z
        if name in ("alpha", "beta"):
            return 1 + 0.05 * z
        return (z / np.sqrt(s.shape[-2] if len(s.shape) >= 2 else 1)
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def nudged(tree, eps=0.05):
    """``tree`` with every PSOFT trainable moved by ``eps`` (the frozen
    leaves shared): an adapter that banks low-rank."""
    def rec(node):
        if isinstance(node, dict):
            return {k: (v + eps if k in ("q", "alpha", "beta")
                        and not isinstance(v, dict) else rec(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v) for v in node]
        return node
    return rec(tree)


def safe_ssd_chunked(x, dt, a_log, bmat, cmat, d_skip, dt_bias, chunk,
                     initial_state=None):
    """The reference's ``ssd_chunked`` (src/repro/models/ssm.py) with the
    intra-chunk exponent masked before the ``exp``: the same forward
    values, finite gradients."""
    bsz, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    rep = h // g
    chunk = min(chunk, s)
    assert s % chunk == 0
    nc = s // chunk
    dt = jax.nn.softplus(dt.astype(jnp.float32)
                         + dt_bias.astype(jnp.float32))
    a = -jnp.exp(a_log.astype(jnp.float32))
    da = dt * a
    xbar = x.astype(jnp.float32) * dt[..., None]
    da_c = jnp.moveaxis(da.reshape(bsz, nc, chunk, h), 1, 0)
    xb_c = jnp.moveaxis(xbar.reshape(bsz, nc, chunk, h, p), 1, 0)
    b_c = jnp.moveaxis(bmat.reshape(bsz, nc, chunk, g, n), 1, 0).astype(
        jnp.float32)
    c_c = jnp.moveaxis(cmat.reshape(bsz, nc, chunk, g, n), 1, 0).astype(
        jnp.float32)
    iq = jnp.arange(chunk)
    causal = iq[:, None] >= iq[None, :]
    h0 = (jnp.zeros((bsz, h, n, p), jnp.float32) if initial_state is None
          else initial_state.astype(jnp.float32))

    def chunk_step(hprev, inp):
        da_q, xb_q, b_q, c_q = inp
        cum = jnp.cumsum(da_q, axis=1)
        total = cum[:, -1]
        lmat = jnp.exp(jnp.where(causal[None, :, :, None],
                                 cum[:, :, None, :] - cum[:, None, :, :],
                                 -jnp.inf))
        cb = jnp.einsum("bqgn,bkgn->bqkg", c_q, b_q)
        cb = jnp.repeat(cb, rep, axis=-1)
        y_intra = jnp.einsum("bqkh,bqkh,bkhp->bqhp", cb, lmat, xb_q)
        c_h = jnp.repeat(c_q, rep, axis=2)
        y_inter = jnp.einsum("bqhn,bhnp->bqhp",
                             c_h * jnp.exp(cum)[..., None], hprev)
        decay_r = jnp.exp(total[:, None, :] - cum)
        b_h = jnp.repeat(b_q, rep, axis=2)
        st = jnp.einsum("bqhn,bqhp->bhnp", b_h * decay_r[..., None], xb_q)
        hnew = hprev * jnp.exp(total)[..., None, None] + st
        return hnew, y_intra + y_inter

    hfinal, y_c = jax.lax.scan(chunk_step, h0, (da_c, xb_c, b_c, c_c))
    y = jnp.moveaxis(y_c, 0, 1).reshape(bsz, s, h, p)
    y = y + x.astype(jnp.float32) * d_skip.astype(jnp.float32)[None, None, :,
                                                               None]
    return y.astype(x.dtype), hfinal.astype(jnp.float32)


def train_state(jcfg, params):
    tr, fr = jadamw.partition(params, jmodel.trainable_mask(jcfg, params))
    return jtrainer.TrainState(
        step=np.zeros((), np.int32), trainable=tr, frozen=fr,
        opt=jax.tree.map(np.asarray, jadamw.adamw_init(tr)))


def check_train_steps(monkeypatch, arch, params):
    """3 PSOFT steps from one converted state, the reference on
    :func:`safe_ssd_chunked`: losses and grad norms within 1e-4
    relative."""
    jcfg, cfg = configs(arch)
    jstate = train_state(jcfg, params)
    ds = JDataset(jcfg, batch=BATCH, seq_len=SEQ)
    monkeypatch.setattr(jssm, "ssd_chunked", safe_ssd_chunked)
    jstep = compiled(jtrainer.make_train_step(jcfg, JTrainConfig(**TC)),
                     jstate, ds.batch_at(0))
    tstate = trainer.train_state_from_numpy(jstate, device="cpu")
    tstep = trainer.make_train_step(cfg, TrainConfig(**TC))
    for i in range(STEPS):
        batch = ds.batch_at(i)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        for key in ("loss", "grad_norm"):
            assert np.isfinite(float(jm[key])), (key, i)
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} step {i}")
    return jstate, tstate


def host(tree):
    return interop.params_from_numpy(tree, device="cpu")


#: prompt lengths shorter than the conv's K - 1 = 3 past inputs, beside
#: one longer, through two slots
SHORT_PROMPTS = (1, 2, 1, 5)


def check_short_prompts(arch, params):
    """The port's engine on prompts shorter than the conv history: prefill
    leads the conv state with the zeros ``causal_conv`` pads with, so
    every greedy token equals the argmax of the port's ``forward_logits``
    over prompt + generated (which the model tests hold against the
    reference; the reference's own prefill leaves a short conv state that
    its decode cannot take)."""
    _jcfg, cfg = configs(arch)
    tp = host(params)
    rng = np.random.default_rng(6)
    reqs = [tserve.Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=6)
        for i, n in enumerate(SHORT_PROMPTS)]
    eng = tserve.ServeEngine(tp, cfg, max_len=48, slots=2, device="cpu")
    got = eng.run(reqs)
    assert eng.cache_mode == "dense"
    for r in got:
        assert r.done and len(r.generated) == 6
        seq = np.concatenate([r.prompt, np.asarray(r.generated[:-1],
                                                   np.int32)])
        logits = tmodel.forward_logits(
            tp, {"tokens": torch.as_tensor(seq[None])}, cfg)
        want = logits[0, len(r.prompt) - 1:, :cfg.vocab_size].argmax(-1)
        assert r.generated == want.tolist(), r.uid


def fast_reference_engine(monkeypatch, jcfg, params, **kw):
    """A paged reference engine over ``params`` whose eager work runs as
    a few executables at XLA's lowest level: its base merge
    (``merge_tree``, op by op otherwise) and the Cayley rotations its bank
    build takes per adapter (63 eager primitive compiles at the reduced
    sizes), plus its decode, paged prefill and sampler."""
    from repro.core import cayley as jcayley
    from repro.core import peft as jpeft
    import repro.serve as jserve
    import repro.serve.engine as jengine

    merge = jpeft.merge_tree
    monkeypatch.setattr(jengine.peft_lib, "merge_tree", lambda p, c: fast_jit(
        lambda t: merge(t, c))(p))
    # plain jit: it nests inside the merge's executable
    monkeypatch.setattr(jcayley, "make_rotation", jax.jit(
        jcayley.make_rotation, static_argnums=(1, 2, 3)))
    eng = jserve.ServeEngine(params, jcfg, **kw)
    for f in ("_decode", "_prefill_paged"):
        setattr(eng, f, fast_jit(getattr(eng, f).__wrapped__))
    eng._sample_fn = _FAST_SAMPLE
    return eng
