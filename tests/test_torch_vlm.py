"""The port's VLM family (reduced ``internvl2-26b``: 8 patch embeddings in
front of the tokens) against the reference package on the CPU (fp32),
params made with numpy in the reference's tree structure.

Tolerances: model logits, losses, prefill and decode 1e-4
(:data:`ssm_pairs.MODEL_TOL`); train-step losses and grad norms 1e-4
relative; engine tokens and admissions identical; configs, batches and
interop bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.models import model  # noqa: E402

import ssm_pairs as sp  # noqa: E402

ARCH = "internvl2-26b"
MAX_LEN = 48
TOL = dict(atol=sp.MODEL_TOL, rtol=sp.MODEL_TOL)


@pytest.fixture(scope="module", autouse=True)
def _compiled_rotations():
    with sp.compiled_reference_rotations():
        yield


def assert_config_matches(arch):
    """Every field the port's config keeps equals the reference's, the
    nested PEFT, MoE and SSM configs field by field, full and reduced."""
    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (get_config(arch).reduced(),
                       jget_config(arch).reduced())):
        for f in dataclasses.fields(cfg):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(got):
                for g in dataclasses.fields(got):
                    assert getattr(got, g.name) == getattr(want, g.name), \
                        (arch, f.name, g.name)
            else:
                assert got == want, (arch, f.name)


def assert_batches_match(arch, keys):
    """``batch_at`` of the reduced config equals the reference's bit for
    bit, the stub frontend's inputs included."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    for step in (0, 3):
        got = SyntheticLMDataset(cfg, 2, 16).batch_at(step)
        want = JDataset(jcfg, 2, 16).batch_at(step)
        assert set(got) == set(want) == {"tokens", "labels", *keys}
        for k in got:
            assert got[k].dtype == want[k].dtype and \
                got[k].tobytes() == want[k].tobytes(), (k, step)


def test_config_matches_reference():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.num_patch_tokens) == ("vlm", 256)
    assert cfg.reduced().num_patch_tokens == 8
    assert_config_matches(ARCH)


def test_batches_match_reference():
    assert_batches_match(ARCH, ("patch_embeds",))


@pytest.fixture(scope="module")
def params():
    return sp.numpy_params(sp.configs(ARCH)[0], 0)


def _batch(cfg, b=2, s=12, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "patch_embeds": rng.standard_normal(
                (b, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)}


def _logits_and_loss(params, batch, jcfg):
    """The reference's logits and loss from ONE forward (half the graph
    of ``forward_logits`` beside ``loss_fn``): ``loss_fn``'s steps, a
    VLM's labels padded with -1 over the patches; ``loss_fn`` itself is
    held by the train-step test."""
    h, _, _ = jmodel.forward_hidden(params, batch, jcfg)
    labels = batch["labels"]
    if "patch_embeds" in batch:
        pad = jnp.full((labels.shape[0], batch["patch_embeds"].shape[1]),
                       -1, labels.dtype)
        labels = jnp.concatenate([pad, labels], axis=1)
    loss, n_tok = jmodel.chunked_ce_loss(params, h, labels, jcfg)
    return jmodel.lm_logits(params, h, jcfg), loss, n_tok


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_logits_and_loss_match_reference(params):
    """``forward_logits`` over patches + text and ``loss_fn`` with the
    labels padded by -1 over the patches, PSOFT on every target; the
    trainable mask leaf for leaf."""
    jcfg, cfg = sp.configs(ARCH)
    tp = sp.host(params)
    batch = _batch(cfg)
    want = sp.compiled(lambda p, b: _logits_and_loss(p, b, jcfg), params,
                       batch)(params, batch)
    got = model.forward_logits(tp, _tensors(batch), cfg)
    assert got.shape[1] == cfg.num_patch_tokens + 12
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want[0]),
                               **TOL)
    loss, metrics = model.loss_fn(tp, _tensors(batch), cfg)
    np.testing.assert_allclose(float(loss), float(want[1]), **TOL)
    assert int(metrics["tokens"]) == int(want[2]) == 2 * 12
    assert model.trainable_mask(cfg, tp) == jax.tree.map(
        bool, jmodel.trainable_mask(jcfg, params))


def test_train_steps_match_reference(params, monkeypatch):
    """3 PSOFT steps on ``batch_at`` (2 x (8 patches + 16 tokens))."""
    sp.check_train_steps(monkeypatch, ARCH, params)


def test_prefill_and_decode_match_reference(params):
    """Model-level ``prefill`` with the patches in front (right-padded
    prompts read at ``lengths``, which count the patches), then 4
    ``decode_step``s at positions past P + S: logits and the dense cache."""
    jcfg, cfg = sp.configs(ARCH)
    tp = sp.host(params)
    batch = _batch(cfg, s=10, seed=2)
    del batch["labels"]
    p = cfg.num_patch_tokens
    lengths = np.array([p + 10, p + 7], np.int32)
    steps = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 2, 1)
                                              ).astype(np.int32)

    prefill = sp.fast_jit(lambda p, b, ln: jmodel.prefill(
        p, b, jcfg, MAX_LEN, lengths=ln))
    decode = sp.fast_jit(lambda p, t, c, q: jmodel.decode_step(
        p, {"tokens": t}, c, q, jcfg))
    last, wcache = prefill(params, batch, lengths)
    want = [last]
    for i in range(4):
        nxt, wcache = decode(params, steps[i], wcache, lengths + i)
        want.append(nxt)
    got, cache = model.prefill(tp, _tensors(batch), cfg, MAX_LEN,
                               torch.as_tensor(lengths))
    outs = [got]
    for i in range(4):
        nxt, cache = model.decode_step(
            tp, {"tokens": torch.as_tensor(steps[i])}, cache,
            torch.as_tensor(lengths + i), cfg)
        outs.append(nxt)
    for g, w in zip(outs, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(wcache[k]),
                                   **TOL)


#: (prompt length, new tokens, adapter): the first three fill the slots in
#: one prefill call; request 3 takes request 0's slot and shares its first
#: 10 tokens (a full page of 8 aliased).  Two prefill shapes in all, so the
#: reference compiles two prefill executables.
TRAFFIC = [(12, 3, "base"), (13, 8, "tuned"), (14, 8, "tuned"),
           (12, 5, "base")]
ENGINE = dict(max_len=MAX_LEN, slots=3, page_size=8)


def _requests(ns, vocab):
    rng = np.random.default_rng(7)
    out = []
    for uid, (n, m, adapter) in enumerate(TRAFFIC):
        prompt = rng.integers(0, vocab, n).astype(np.int32)
        if uid == 3:
            prompt[:10] = out[0].prompt[:10]
        out.append(ns.Request(uid=uid, prompt=prompt, max_new_tokens=m,
                              adapter=adapter))
    return out


def _summary(eng, done):
    return ({r.uid: list(r.generated) for r in done},
            [dataclasses.astuple(e) for e in eng.admission_events],
            dict(eng.kv.stats))


def test_paged_engine_matches_reference(monkeypatch):
    """Text prompts on the paged engine (``cache_mode`` "auto" resolving
    to "paged", as the reference's does), the base and one PSOFT adapter:
    tokens, admissions and kv stats identical; a shared prefix aliased."""
    jcfg, cfg = sp.configs(ARCH)
    base = sp.numpy_params(jcfg, 4, at_init=True)
    tuned = sp.nudged(base)
    jeng = sp.fast_reference_engine(monkeypatch, jcfg, base, **ENGINE)
    jeng.register_adapter("tuned", tuned, jcfg.peft)
    want = _summary(jeng, jeng.run(_requests(jserve, jcfg.vocab_size)))
    teng = tserve.ServeEngine(sp.host(base), cfg, device="cpu", **ENGINE)
    teng.register_adapter("tuned", sp.host(tuned), cfg.peft)
    done = teng.run(_requests(tserve, cfg.vocab_size))
    assert jeng.cache_mode == teng.cache_mode == "paged"
    assert all(r.done for r in done)
    assert _summary(teng, done) == want
    assert want[2]["prefix_hits"] > 0 and teng.kv.pages_in_use() == 0


def test_vlm_tree_crosses_interop(params):
    """numpy -> port -> numpy bit for bit, leaf for leaf."""
    back = interop.params_to_numpy(sp.host(params))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(jax.tree.leaves(back))
    for kp, leaf in flat:
        node = back
        for k in kp:
            node = node[k.key]
        assert node.dtype == leaf.dtype and node.tobytes() == leaf.tobytes()
