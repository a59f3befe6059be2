"""The port's paged ServeEngine on the MoE family against the reference's,
at reduced ``deepseek-moe-16b`` (fp32), one set of numpy params in the
reference's tree structure handed to both (PSOFT on every default target,
at init): greedy requests on the base and on an attention-only PSOFT
adapter arriving mid-run through ``run_stream`` with chunked prefill give
identical tokens, admissions and kv stats, every MoE call on the dense
dispatch; and an adapter that changes an expert linear is refused with the
reference's message, both when the bank is built and as a mid-run
register that rolls back while the in-flight request serves on."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
import ssm_pairs as sp  # noqa: E402

ARCH = "deepseek-moe-16b"
ENGINE = dict(max_len=40, slots=3, page_size=8, prefill_chunk_tokens=8)
ATTN = ("q", "k", "v", "o")


@pytest.fixture(scope="module", autouse=True)
def _compiled_rotations():
    with sp.compiled_reference_rotations():
        yield


def _params(shapes, seed):
    """Numpy params in the structure of ``shapes``: PSOFT factors and
    weights ~ N(0, 1 / fan_in), every PSOFT trainable at init (q 0, alpha
    and beta 1), norms at init."""
    rng = np.random.default_rng(seed)

    def leaf(kp, s):
        name = kp[-1].key
        if name in ("scale", "alpha", "beta"):
            return np.ones(s.shape, np.float32)
        if name in ("bias", "q"):
            return np.zeros(s.shape, np.float32)
        z = rng.standard_normal(s.shape).astype(np.float32)
        return (z / np.sqrt(s.shape[-2] if len(s.shape) >= 2 else 1)
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _nudged(tree, modules, eps=0.05):
    """``tree`` with the PSOFT trainables of ``modules`` moved by ``eps``
    (everything else shared)."""
    def rec(node, module):
        if isinstance(node, dict):
            return {k: (v + eps if k in ("q", "alpha", "beta")
                        and module in modules else rec(v, k))
                    for k, v in node.items()}
        return node
    return rec(tree, None)


@pytest.fixture(scope="module")
def setup():
    """The numpy params, the attention-only and the expert adapters, and
    one reference engine (serving "attn") with its run of the trace."""
    jcfg = jget_config(ARCH).reduced()
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    params = _params(shapes, 0)
    attn = _nudged(params, ATTN)
    jeng = jserve.ServeEngine(params, jcfg, **ENGINE)
    jeng.register_adapter("attn", attn, jcfg.peft)
    want = jeng.run_stream(_trace(jserve, jcfg.vocab_size), max_steps=200)
    return dict(cfg=jcfg, params=params, attn=attn,
                expert=_nudged(params, ATTN + moe.EXPERT_LINEARS),
                engine=jeng, want=_summary(jeng, want))


def _trace(ns, vocab):
    """(arrival step, request): prompts of 5-19 tokens (chunked into 8s),
    on the base and on "attn", arriving mid-run one prefill apart (each
    prefill call one row, so the reference compiles two prefill shapes)
    while earlier requests decode."""
    rng = np.random.default_rng(3)
    out = []
    for uid, (step, n, adapter) in enumerate([
            (0, 19, "base"), (3, 6, "attn"), (4, 13, "attn"),
            (6, 5, "base"), (7, 17, "attn")]):
        prompt = rng.integers(0, vocab, n).astype(np.int32)
        out.append((step, ns.Request(uid=uid, prompt=prompt,
                                     max_new_tokens=6, adapter=adapter)))
    return out


def _summary(eng, done):
    return dict(tokens={r.uid: list(r.generated) for r in done},
                admissions=[dataclasses.astuple(e)
                            for e in eng.admission_events],
                kv=dict(eng.kv.stats))


def test_moe_engine_matches_reference(setup, monkeypatch):
    """Base and attention-adapter requests through ``run_stream`` with
    chunked prefill: identical tokens, admissions and kv stats; the port's
    MoE layers run the dense dispatch only, and the merged base shares
    every expert stack's storage with the source tree."""
    params, attn = setup["params"], setup["attn"]
    cfg = get_config(ARCH).reduced()

    impls = []
    real = moe.moe_apply

    def spy(params, x, cfg, cdt, impl="capacity", tp=None):
        impls.append(impl)
        return real(params, x, cfg, cdt, impl, tp)
    monkeypatch.setattr(moe, "moe_apply", spy)
    # plain expert stacks: the served base reads the source tree's storage
    plain = {**params, "layers": {**params["layers"], "moe": {
        k: ({"w": v["w_res"]} if k in moe.EXPERT_LINEARS else v)
        for k, v in params["layers"]["moe"].items()}}}
    src = interop.params_from_numpy(plain, device="cpu")
    probe = tserve.ServeEngine(src, cfg, device="cpu", **ENGINE)
    for k in moe.EXPERT_LINEARS:
        assert probe._merged_base["layers"]["moe"][k]["w"].data_ptr() == \
            src["layers"]["moe"][k]["w"].data_ptr()

    teng = tserve.ServeEngine(interop.params_from_numpy(params, device="cpu"),
                              cfg, device="cpu", **ENGINE)
    teng.register_adapter("attn", interop.params_from_numpy(
        attn, device="cpu"), cfg.peft)
    got = teng.run_stream(_trace(tserve, cfg.vocab_size), max_steps=200)
    assert all(r.done for r in got)
    assert teng.kv.pages_in_use() == 0
    assert _summary(teng, got) == setup["want"]
    assert impls and set(impls) == {"dense"}


def _reference_refusal(setup):
    """The reference's message for an expert adapter, from the bank
    extension of its next run (which fails before any step)."""
    jeng = setup["engine"]
    jeng.register_adapter("experts", setup["expert"], setup["cfg"].peft)
    with pytest.raises(ValueError) as err:
        jeng.run([jserve.Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                                 max_new_tokens=2, adapter="experts")])
    return str(err.value)


def test_expert_adapter_refused_like_reference(setup):
    """At the bank build the port raises the reference's message; as a
    mid-run register it rolls back with that message, and the in-flight
    request's tokens equal a run without it."""
    want = _reference_refusal(setup)
    assert "MoE expert" in want
    cfg = get_config(ARCH).reduced()
    base = interop.params_from_numpy(setup["params"], device="cpu")
    tex = interop.params_from_numpy(setup["expert"], device="cpu")
    req = lambda: tserve.Request(  # noqa: E731
        uid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=6)

    eng = tserve.ServeEngine(base, cfg, device="cpu", **ENGINE)
    eng.register_adapter("experts", tex, cfg.peft)
    with pytest.raises(ValueError) as err:
        eng.run([tserve.Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                                max_new_tokens=2, adapter="experts")])
    assert str(err.value) == want

    eng = tserve.ServeEngine(base, cfg, device="cpu",
                             tracker=tserve.InMemoryTracker(), **ENGINE)
    fired = []

    def hook(e, step):
        if step == 2 and not fired:
            fired.append(step)
            e.register_adapter("experts", tex, cfg.peft)
    eng.add_step_hook(hook)
    with pytest.warns(UserWarning, match="rolled back"):
        done = eng.run_stream([(0, req())], max_steps=64)
    assert fired and "experts" not in eng.list_adapters()
    errors = [e["error"] for e in
              eng.tracker.events_named("engine/bank/swap_failed")]
    assert errors == [want]
    plain = tserve.ServeEngine(base, cfg, device="cpu", **ENGINE).run_stream(
        [(0, req())], max_steps=64)
    assert done[0].generated == plain[0].generated
