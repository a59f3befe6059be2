"""The port's hybrid family (Mamba2 layers and one shared attention block,
reduced ``zamba2-1.2b``) against the reference package on the CPU (fp32),
params made with numpy in the reference's tree structure (a list of
per-layer dicts, attention positions holding a 0-d ``"marker"``).

The reference's own engine cannot serve the hybrid (its dense-cache
install slices axis 1 of every leaf, and a hybrid's per-layer leaves lead
with the batch), so the port's engine is held against a per-request greedy
loop over the reference's model-level ``prefill`` and ``decode_step``.

Tolerances: model logits, prefill and decode 1e-4 (:data:`ssm_pairs
.MODEL_TOL`); engine tokens identical; train-step losses and grad norms
1e-4 relative, the reference on :func:`ssm_pairs.safe_ssd_chunked`;
interop and checkpoints bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import peft as jpeft  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jcheckpoint  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch import interop, tree  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402

import ssm_pairs as sp  # noqa: E402

ARCH = "zamba2-1.2b"
MAX_LEN = 48


@pytest.fixture(scope="module", autouse=True)
def _compiled_rotations():
    with sp.compiled_reference_rotations():
        yield


@pytest.fixture(scope="module")
def params():
    return sp.numpy_params(sp.configs(ARCH)[0], 0)


@pytest.mark.parametrize("method", ["none", "psoft"])
def test_model_matches_reference(params, method):
    """``forward_logits``, ``prefill`` (logits, every Mamba state and
    attention buffer) and one ``decode_step`` after it, and the trainable
    mask leaf for leaf, lists included."""
    jcfg, cfg = sp.configs(ARCH, method)
    if method == "none":
        params = sp.numpy_params(jcfg, 1)
    tp = sp.host(params)
    assert cfg.layer_pattern() == jcfg.layer_pattern() == "MAMA"
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                             (2, 32)).astype(np.int32)
    step = np.array([[5], [9]], np.int32)
    pos = np.array([32, 32], np.int32)

    def ref(p, t, s, q):
        logits = jmodel.forward_logits(p, {"tokens": t}, jcfg)
        last, cache = jmodel.prefill(p, {"tokens": t}, jcfg, MAX_LEN)
        nxt, cache = jmodel.decode_step(p, {"tokens": s}, cache, q, jcfg)
        return logits, last, nxt, cache
    want = sp.compiled(ref, params, toks, step, pos)(params, toks, step, pos)
    got_logits = model.forward_logits(tp, {"tokens": torch.as_tensor(toks)},
                                      cfg)
    got_last, cache = model.prefill(tp, {"tokens": torch.as_tensor(toks)},
                                    cfg, MAX_LEN)
    got_next, cache = model.decode_step(tp, {"tokens": torch.as_tensor(step)},
                                        cache, torch.as_tensor(pos), cfg)
    tol = dict(atol=sp.MODEL_TOL, rtol=sp.MODEL_TOL)
    for got, w in zip((got_logits, got_last, got_next), want[:3]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), **tol)
    assert isinstance(cache, list) and len(cache) == 4
    for got, w in zip(cache, want[3]):
        assert set(got) == set(w)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(w[k]), **tol)
    assert model.trainable_mask(cfg, tp) == jax.tree.map(
        bool, jmodel.trainable_mask(jcfg, params))


#: (prompt length, new tokens, adapter) through two slots
TRAFFIC = [(7, 6, "base"), (12, 4, "tuned"), (7, 5, "tuned"),
           (12, 7, "base")]


def _greedy_loop(jcfg, trees, prompts):
    """Per request: the reference's prefill, then greedy decode steps at
    batch 1, on the merged tree of its adapter."""
    scfg = jcfg.replace(peft=jcfg.peft.replace(method="none",
                                               target_modules=()))
    prefill = sp.fast_jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, scfg,
                                                      MAX_LEN))
    decode = sp.fast_jit(lambda p, t, c, q: jmodel.decode_step(
        p, {"tokens": t}, c, q, scfg))
    out = []
    for (n, m, adapter), prompt in zip(TRAFFIC, prompts):
        p = trees[adapter]
        logits, cache = prefill(p, jnp.asarray(prompt[None]))
        toks = [int(np.argmax(np.asarray(logits)[0, -1, :jcfg.vocab_size]))]
        while len(toks) < m:
            logits, cache = decode(p, jnp.asarray([[toks[-1]]], jnp.int32),
                                   cache, jnp.asarray([n + len(toks) - 1]))
            toks.append(int(np.argmax(np.asarray(logits)[0, -1,
                                                         :jcfg.vocab_size])))
        out.append(toks)
    return out


def test_engine_matches_reference_greedy_loop():
    """The port's engine (``cache_mode`` "auto" resolving to dense, two
    slots, ``run_stream`` with requests arriving mid-run) serving the base
    and one PSOFT adapter: the same tokens as the
    reference's prefill + decode on each request's merged tree, one request
    at a time; the bank is low-rank, so every decode-step linear goes
    through the gather-delta wrapper."""
    jcfg, cfg = sp.configs(ARCH)
    base = sp.numpy_params(jcfg, 4, at_init=True)
    tuned = sp.nudged(base)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n, _m, _a in TRAFFIC]
    merge = sp.fast_jit(lambda t: jpeft.merge_tree(t, jcfg.peft))
    trees = {name: merge(t) for name, t in (("base", base),
                                            ("tuned", tuned))}
    want = _greedy_loop(jcfg, trees, prompts)
    eng = tserve.ServeEngine(sp.host(base), cfg, max_len=MAX_LEN, slots=2,
                             device="cpu")
    eng.register_adapter("tuned", sp.host(tuned), cfg.peft)
    arrivals = [(step, tserve.Request(uid=i, prompt=p, max_new_tokens=m,
                                      adapter=a))
                for i, (step, p, (_n, m, a)) in enumerate(zip(
                    (0, 0, 2, 5), prompts, TRAFFIC))]
    got = eng.run_stream(arrivals)
    assert eng.last_run_preemptions == 0
    assert eng.cache_mode == "dense" and all(r.done for r in got)
    tree_ = eng.lifecycle.tree()
    assert "left" in tree_["layers"][0]["ssm"]["in_proj"]["bank"]
    assert "bank" not in tree_["shared_attn"]["fuse"]
    assert "left" in tree_["shared_attn"]["block"]["attn"]["q"]["bank"]
    assert {r.uid: r.generated for r in got} == dict(enumerate(want))


def test_train_steps_match_reference(params, monkeypatch):
    sp.check_train_steps(monkeypatch, ARCH, params)


def test_engine_serves_prompts_shorter_than_the_conv(params):
    sp.check_short_prompts(ARCH, params)


def test_hybrid_tree_crosses_interop_and_checkpoints(params, tmp_path):
    """The list of per-layer dicts and its 0-d markers cross bit for bit:
    numpy -> port -> numpy, and a port checkpoint of the hybrid train state
    restored in the reference and in the port (and the reverse)."""
    back = interop.params_to_numpy(sp.host(params))
    assert isinstance(back["layers"], list)
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = back
        for k in kp:
            node = node[k.idx if hasattr(k, "idx") else k.key]
        assert node.dtype == leaf.dtype and node.shape == leaf.shape
        assert node.tobytes() == leaf.tobytes()
    assert back["layers"][1]["marker"].shape == ()
    jstate = sp.train_state(sp.configs(ARCH)[0], params)
    state = tree.tree_map(torch.as_tensor, interop.params_from_numpy(
        jstate, device="cpu"))
    checkpoint.save(state, str(tmp_path / "port"), 1)
    again = checkpoint.restore(tree.tree_map(torch.zeros_like, state),
                               str(tmp_path / "port"))
    for a, b in zip(tree.tree_leaves(again), tree.tree_leaves(state)):
        assert torch.equal(a, b)
    got = jcheckpoint.restore(jax.tree.map(jnp.asarray, jstate),
                              str(tmp_path / "port"))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    jcheckpoint.save(jax.tree.map(jnp.asarray, jstate), str(tmp_path / "ref"),
                     1)
    again = checkpoint.restore(tree.tree_map(torch.zeros_like, state),
                               str(tmp_path / "ref"))
    for a, b in zip(tree.tree_leaves(again), tree.tree_leaves(state)):
        assert torch.equal(a, b)
