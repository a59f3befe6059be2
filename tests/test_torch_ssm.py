"""The port's Mamba2 SSD block, SSM model and dense-cache engine against the
reference package on the CPU (fp32), inputs and params made with numpy and
handed to both.

Tolerances: the SSD pieces 1e-5 abs + 1e-5 rel (fp32, sums in another
order); model logits, prefill and decode 1e-4 (:data:`ssm_pairs
.MODEL_TOL`: fp32 through two layers and a 256-wide vocab); engine tokens
and admission events identical; train-step losses and grad norms 1e-4
relative, the reference on :func:`ssm_pairs.safe_ssd_chunked` (its own
scan's gradients are NaN, which
:func:`test_reference_scan_gradients_are_nan` pins)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.models import model, ssm  # noqa: E402
from repro_torch.serve import SpecConfig  # noqa: E402

import ssm_pairs as sp  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "mamba2-1.3b"
ENGINE = dict(max_len=48, slots=2)


@pytest.fixture(scope="module", autouse=True)
def _compiled_rotations():
    with sp.compiled_reference_rotations():
        yield


def _ssd_inputs(seed, s, g, h=4, p=8, n=16, b=2):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((b, s, h, p)).astype(f),
        dt=rng.standard_normal((b, s, h)).astype(f),
        a_log=np.log(np.linspace(1.0, 16.0, h)).astype(f),
        bmat=rng.standard_normal((b, s, g, n)).astype(f),
        cmat=rng.standard_normal((b, s, g, n)).astype(f),
        d_skip=rng.standard_normal(h).astype(f),
        dt_bias=rng.standard_normal(h).astype(f))


def _port(a):
    return {k: torch.as_tensor(v) for k, v in a.items()}


#: the reference's SSD pieces compiled at XLA's lowest optimisation level
#: (op by op they compile every primitive at every shape)
_J_SSD = sp.fast_jit(jssm.ssd_chunked, static_argnames=("chunk",))
_J_STEP = sp.fast_jit(jssm.ssd_step)
_J_CONV = sp.fast_jit(jssm.causal_conv)
_J_CONV_STEP = sp.fast_jit(jssm.conv_step)


@pytest.mark.parametrize("s,chunk,g", [(32, 8, 1), (64, 16, 1), (64, 16, 2)])
def test_ssd_chunked_matches_reference(s, chunk, g):
    a = _ssd_inputs(s + g, s, g)
    wy, ws = _J_SSD(**a, chunk=chunk)
    ty, ts = ssm.ssd_chunked(**_port(a), chunk=chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), **TOL)


def test_ssd_step_continues_a_chunk():
    """The final state of a chunked pass over 31 tokens, then one step:
    the port's step against the reference's from the same state, and
    against the chunked pass over all 32 tokens."""
    a = _ssd_inputs(7, 32, 2)
    head = {k: (v[:, :31] if k in ("x", "dt", "bmat", "cmat") else v)
            for k, v in a.items()}
    _, ws = _J_SSD(**head, chunk=31)
    _, ts = ssm.ssd_chunked(**_port(head), chunk=31)
    last = {k: a[k][:, 31] for k in ("x", "dt", "bmat", "cmat")}
    rest = {k: a[k] for k in ("a_log", "d_skip", "dt_bias")}
    wy, wst = _J_STEP(last["x"], last["dt"], rest["a_log"],
                            last["bmat"], last["cmat"], rest["d_skip"],
                            rest["dt_bias"], ws)
    t = _port({**last, **rest})
    ty, tst = ssm.ssd_step(t["x"], t["dt"], t["a_log"], t["bmat"], t["cmat"],
                           t["d_skip"], t["dt_bias"], ts)
    np.testing.assert_allclose(ty.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(wst), **TOL)
    full_y, full_s = ssm.ssd_chunked(**_port(a), chunk=32)
    np.testing.assert_allclose(ty.numpy(), full_y[:, 31].numpy(), **TOL)
    np.testing.assert_allclose(tst.numpy(), full_s.numpy(), **TOL)


def test_conv_step_matches_causal_conv():
    """Stepping the conv token by token from a zero state gives the
    reference's causal conv, and the port's step the reference's step."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = np.asarray(_J_CONV(x, w, b))
    np.testing.assert_allclose(
        ssm.causal_conv(*map(torch.as_tensor, (x, w, b))).numpy(), want,
        **TOL)
    state = torch.zeros((2, 3, 12))
    jstate = np.zeros((2, 3, 12), np.float32)
    for t in range(9):
        y, state = ssm.conv_step(torch.as_tensor(x[:, t]), state,
                                 torch.as_tensor(w), torch.as_tensor(b))
        jy, jstate = _J_CONV_STEP(x[:, t], jstate, w, b)
        np.testing.assert_allclose(y.numpy(), want[:, t], **TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)


def test_reference_scan_gradients_are_nan():
    """The reference's scan has NaN gradients (here in ``dt``) once a
    chunk's decays overflow its masked-out ``exp`` entries; the safe copy
    the train-step tests use gives the same forward values and finite
    gradients, as the port's scan does."""
    a = _ssd_inputs(11, 32, 1)
    a["dt_bias"] = np.full_like(a["dt_bias"], 2.0)
    rest = {k: v for k, v in a.items() if k != "dt"}

    def loss(fn):
        return lambda dt: fn(dt=dt, **rest, chunk=32)[0].sum()
    want = np.asarray(_J_SSD(**a, chunk=32)[0])
    np.testing.assert_array_equal(
        np.asarray(sp.fast_jit(sp.safe_ssd_chunked, static_argnames=(
            "chunk",))(**a, chunk=32)[0]), want)
    assert np.isnan(np.asarray(sp.fast_jit(jax.grad(loss(
        jssm.ssd_chunked)))(a["dt"]))).any()
    safe = np.asarray(sp.fast_jit(jax.grad(loss(sp.safe_ssd_chunked)))(
        a["dt"]))
    dt = torch.as_tensor(a["dt"]).requires_grad_(True)
    ssm.ssd_chunked(dt=dt, **_port(rest), chunk=32)[0].sum().backward()
    assert np.isfinite(safe).all() and torch.isfinite(dt.grad).all()
    np.testing.assert_allclose(dt.grad.numpy(), safe, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def params():
    return sp.numpy_params(sp.configs(ARCH)[0], 0)


@pytest.mark.parametrize("method", ["none", "psoft"])
def test_model_matches_reference(params, method):
    """Reduced mamba2: ``forward_logits``, ``prefill`` (logits and both
    states) and one ``decode_step`` after it, and the trainable mask leaf
    for leaf."""
    jcfg, cfg = sp.configs(ARCH, method)
    if method == "none":
        params = sp.numpy_params(jcfg, 1)
    tp = sp.host(params)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                             (2, 32)).astype(np.int32)
    step = np.array([[5], [9]], np.int32)
    pos = np.array([32, 32], np.int32)

    def ref(p, t, s, q):
        logits = jmodel.forward_logits(p, {"tokens": t}, jcfg)
        last, cache = jmodel.prefill(p, {"tokens": t}, jcfg, 48)
        nxt, cache = jmodel.decode_step(p, {"tokens": s}, cache, q, jcfg)
        return logits, last, nxt, cache
    want = sp.compiled(ref, params, toks, step, pos)(params, toks, step, pos)
    got_logits = model.forward_logits(tp, {"tokens": torch.as_tensor(toks)},
                                      cfg)
    got_last, cache = model.prefill(tp, {"tokens": torch.as_tensor(toks)},
                                    cfg, 48)
    got_next, cache = model.decode_step(tp, {"tokens": torch.as_tensor(step)},
                                        cache, torch.as_tensor(pos), cfg)
    tol = dict(atol=sp.MODEL_TOL, rtol=sp.MODEL_TOL)
    for got, w in zip((got_logits, got_last, got_next), want[:3]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), **tol)
    for k in ("conv_state", "ssm_state"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(want[3][k]),
                                   **tol)
    assert model.trainable_mask(cfg, tp) == jax.tree.map(
        bool, jmodel.trainable_mask(jcfg, params))


def _requests(ns, vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [ns.Request(uid=i, prompt=rng.integers(0, vocab, n).astype(
        np.int32), max_new_tokens=m, adapter=a)
        for i, (n, m, a) in enumerate(lengths)]


#: (prompt length, new tokens, adapter): the first pass admits two
#: same-length prompts in one prefill call, the later one alone
TRAFFIC = [(7, 5, "base"), (7, 9, "tuned"), (12, 4, "tuned")]


def _lifecycle_hook(ns, convert, late):
    """Mid-run adapter mutations (the lifecycle over a dense-cache engine,
    as far as the reference's goes): register "late" at step 2 and submit
    a request on it, update "tuned" to the same weights at step 5."""
    def hook(eng, step):
        if step == 2:
            eng.register_adapter("late", convert(late))
            eng.submit(ns.Request(uid=9, prompt=np.arange(3, 10,
                                                          dtype=np.int32),
                                  max_new_tokens=6, adapter="late"))
        if step == 5:
            eng.update_adapter("tuned", convert(late))
    return hook


@pytest.mark.parametrize("arch", ["tiny", ARCH])
def test_dense_engine_matches_reference(arch):
    """The port's dense-cache engine against the reference's on ``tiny``
    (``cache_mode="dense"``, plain linears) and reduced mamba2 (``"auto"``
    resolving to dense; the base and one PSOFT adapter, banked low-rank,
    with a register and an update landing mid-run): identical tokens,
    admission events and lifecycle events."""
    jcfg, cfg = sp.configs(arch, "none" if arch == "tiny" else "psoft")
    mode = "dense" if arch == "tiny" else "auto"
    params = sp.numpy_params(jcfg, 4, at_init=True)
    jeng = jserve.ServeEngine(params, jcfg, cache_mode=mode, **ENGINE)
    sp.share_fast_jits(jeng)
    teng = tserve.ServeEngine(sp.host(params), cfg, cache_mode=mode,
                              device="cpu", **ENGINE)
    traffic = TRAFFIC
    if arch != "tiny":
        tuned, late = sp.nudged(params), sp.nudged(params, 0.1)
        jeng.register_adapter("tuned", tuned, jcfg.peft)
        teng.register_adapter("tuned", sp.host(tuned), cfg.peft)
        jeng.add_step_hook(_lifecycle_hook(jserve, lambda t: t, late))
        teng.add_step_hook(_lifecycle_hook(tserve, sp.host, late))
    else:
        traffic = [(n, m, "base") for n, m, _a in TRAFFIC]
    want = jeng.run(_requests(jserve, jcfg.vocab_size, traffic, 5))
    got = teng.run(_requests(tserve, cfg.vocab_size, traffic, 5))
    assert teng.cache_mode == jeng.cache_mode == "dense"
    assert teng.kv is None and all(r.done for r in got)
    assert {r.uid: r.generated for r in got} == \
        {r.uid: r.generated for r in want}
    for attr in ("admission_events", "lifecycle"):
        if attr == "lifecycle":
            w, g = jeng.lifecycle.events, teng.lifecycle.events
        else:
            w, g = getattr(jeng, attr), getattr(teng, attr)
        assert [dataclasses.astuple(e) for e in g] == \
            [dataclasses.astuple(e) for e in w]
    if arch != "tiny":
        assert [e.op for e in teng.lifecycle.events].count("update") == 1


def test_train_steps_match_reference(params, monkeypatch):
    sp.check_train_steps(monkeypatch, ARCH, params)


def test_engine_serves_prompts_shorter_than_the_conv(params):
    sp.check_short_prompts(ARCH, params)


def _message(fn):
    with pytest.raises((ValueError, AssertionError)) as err:
        fn()
    return str(err.value)


def test_refusals_match_reference(params):
    """The paged cache for a recurrent family (engine and ``init_cache``),
    spec decode and chunked prefill on a dense cache, each with the
    reference's message; a prompt the SSD chunk does not divide raises
    with its length and the chunk, in ``prefill`` and at the engine's
    submit (before it could fail mid-run with other requests in flight)."""
    jcfg, cfg = sp.configs(ARCH)
    tp = sp.host(params)
    for kw in (dict(cache_mode="paged"), dict(spec=jserve.SpecConfig(k=2)),
               dict(cache_mode="dense", prefill_chunk_tokens=8)):
        tkw = dict(kw, spec=SpecConfig(k=2)) if "spec" in kw else kw
        want = _message(lambda: jserve.ServeEngine(params, jcfg, **kw))
        got = _message(lambda: tserve.ServeEngine(tp, cfg, device="cpu",
                                                  **tkw))
        assert got == want
    want = _message(lambda: jmodel.init_cache(jcfg, 2, 48, page_size=8))
    assert _message(lambda: model.init_cache(cfg, 2, 48, page_size=8,
                                             device="cpu")) == want
    teng = tserve.ServeEngine(tp, cfg, device="cpu", **ENGINE)
    req = tserve.Request(uid=0, prompt=np.zeros(4, np.int32),
                         spec=SpecConfig(k=2))
    assert "speculative decoding needs the paged KV cache" in _message(
        lambda: teng.run([req]))
    toks = torch.zeros((1, 40), dtype=torch.long)
    assert _message(lambda: model.prefill(tp, {"tokens": toks}, cfg, 48)) == \
        "ssd_chunked: sequence length 40 is not a multiple of the chunk 32"
    long = tserve.Request(uid=1, prompt=np.zeros(40, np.int32))
    for submit in (teng.submit, lambda r: teng.run([r])):
        assert _message(lambda: submit(long)).startswith(
            "request 1: prompt length 40 is not a multiple of the SSD "
            "chunk 32")
    assert not teng.scheduler.has_work()
