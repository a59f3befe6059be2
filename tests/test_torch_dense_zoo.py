"""The rest of the dense model zoo on the port (``starcoder2-15b``,
``granite-8b``, ``internlm2-1.8b``, ``nemotron-4-15b``) against the
reference package on the CPU (fp32): the configs field by field, full and
reduced; on each reduced config, from numpy params in the reference's tree
structure, the logits, the loss and every trainable grad; train steps of
reduced ``nemotron-4-15b`` (squared-ReLU, LayerNorm, no gate); and reduced
``starcoder2-15b`` served with a PSOFT adapter on the paged engine.

Tolerances: logits, loss and grads 1e-4 (:data:`ssm_pairs.MODEL_TOL`;
grads also 1e-4 of the leaf's largest grad absolute); train-step losses and
grad norms 1e-4 relative; engine tokens, admissions and kv stats
identical.  The reduced granite and internlm2 share one structure, so the
reference compiles three forward-and-grad functions for the four."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_map_with_path  # noqa: E402

import ssm_pairs as sp  # noqa: E402
from test_torch_vlm import assert_config_matches  # noqa: E402

ZOO = ("starcoder2-15b", "granite-8b", "internlm2-1.8b", "nemotron-4-15b")
TOL = dict(atol=sp.MODEL_TOL, rtol=sp.MODEL_TOL)
#: the published shapes each config must keep
SHAPES = {"starcoder2-15b": (40, 6144, 48, 4, 24576, 49152, "gelu",
                             "layernorm", 128),
          "granite-8b": (36, 4096, 32, 8, 14336, 49152, "swiglu", "rmsnorm",
                         128),
          "internlm2-1.8b": (24, 2048, 16, 8, 8192, 92544, "swiglu",
                             "rmsnorm", 64),
          "nemotron-4-15b": (32, 6144, 48, 8, 24576, 256000, "relu2",
                             "layernorm", 128)}


@pytest.fixture(scope="module", autouse=True)
def _compiled_rotations():
    with sp.compiled_reference_rotations():
        yield


@pytest.mark.parametrize("arch", ZOO)
def test_config_matches_reference(arch):
    cfg = get_config(arch)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.mlp_type, cfg.norm_type,
            cfg.peft.rank) == SHAPES[arch]
    assert cfg.peft.is_target("gate") == (cfg.mlp_type == "swiglu")
    assert_config_matches(arch)


_REF_FNS = {}


def _reference_fn(jcfg):
    """(logits, loss, trainable grads) of the reference, compiled once per
    distinct reduced structure (the config's name aside)."""
    key = repr(dataclasses.replace(jcfg, name=""))
    if key not in _REF_FNS:
        def loss_and_logits(tr, fr, batch):
            # ``loss_fn``'s steps on one forward, its logits kept
            p = jadamw.combine(tr, fr)
            h, _, _ = jmodel.forward_hidden(p, batch, jcfg)
            loss, _ = jmodel.chunked_ce_loss(p, h, batch["labels"], jcfg)
            return loss, jmodel.lm_logits(p, h, jcfg)

        def fn(params, batch):
            tr, fr = jadamw.partition(params,
                                      jmodel.trainable_mask(jcfg, params))
            (loss, logits), grads = jax.value_and_grad(
                loss_and_logits, has_aux=True)(tr, fr, batch)
            return logits, loss, grads
        _REF_FNS[key] = sp.fast_jit(fn)
    return _REF_FNS[key]


def _batch(cfg, b=2, s=12, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


@pytest.mark.parametrize("arch", ZOO)
def test_logits_loss_and_grads_match_reference(arch):
    """PSOFT on each config's own targets (six for starcoder2 and
    nemotron, whose MLPs have no gate): logits, loss and every trainable
    grad from one forward and backward."""
    jcfg, cfg = sp.configs(arch)
    params = sp.numpy_params(jcfg, 0)
    batch = _batch(cfg)
    want_logits, want_loss, want_grads = _reference_fn(jcfg)(params, batch)
    tp = sp.host(params)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    got = model.forward_logits(tp, tbatch, cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_logits),
                               **TOL)
    tr, fr = adamw.partition(tp, model.trainable_mask(cfg, tp))
    leaves = {}

    def leaf(path, p):
        leaves[path] = p.detach().requires_grad_(True)
        return leaves[path]
    tr = tree_map_with_path(leaf, tr)
    loss, _ = model.loss_fn(adamw.combine(tr, fr), tbatch, cfg)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    flat = {tuple(k.key for k in kp): np.asarray(w) for kp, w in
            jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    n_linears = 7 if cfg.mlp_type == "swiglu" else 6
    assert set(flat) == set(grads) and len(grads) == 3 * n_linears
    for path, w in flat.items():
        np.testing.assert_allclose(
            grads[path].numpy(), w, rtol=sp.MODEL_TOL,
            atol=sp.MODEL_TOL * max(float(np.abs(w).max()), 1e-3),
            err_msg="/".join(path))


def test_nemotron_train_steps_match_reference(monkeypatch):
    """Train steps of reduced nemotron-4-15b (relu2, LayerNorm, no gate)
    from one converted state: losses and grad norms within 1e-4
    relative at each of the first :data:`ssm_pairs.STEPS`."""
    jcfg, _ = sp.configs("nemotron-4-15b")
    sp.check_train_steps(monkeypatch, "nemotron-4-15b",
                         sp.numpy_params(jcfg, 2))


#: (prompt length, new tokens, adapter), reduced starcoder2's engine
#: traffic: request 3 takes request 0's slot and shares its first 10 tokens
TRAFFIC = [(12, 3, "base"), (13, 8, "tuned"), (14, 8, "tuned"),
           (12, 5, "base")]
ENGINE = dict(max_len=48, slots=3, page_size=8)


def _requests(ns, vocab):
    rng = np.random.default_rng(11)
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


def test_starcoder2_engine_matches_reference(monkeypatch):
    """Reduced starcoder2-15b (GQA, gelu, LayerNorm, six targets) on the
    paged engine with the base and one PSOFT adapter: tokens, admissions
    and kv stats identical to the reference engine's, a prefix aliased."""
    jcfg, cfg = sp.configs("starcoder2-15b")
    base = sp.numpy_params(jcfg, 4, at_init=True)
    tuned = sp.nudged(base)
    jeng = sp.fast_reference_engine(monkeypatch, jcfg, base, **ENGINE)
    jeng.register_adapter("tuned", tuned, jcfg.peft)
    want = _summary(jeng, jeng.run(_requests(jserve, jcfg.vocab_size)))
    teng = tserve.ServeEngine(sp.host(base), cfg, device="cpu", **ENGINE)
    teng.register_adapter("tuned", sp.host(tuned), cfg.peft)
    done = teng.run(_requests(tserve, cfg.vocab_size))
    assert teng.cache_mode == "paged"
    assert all(r.done for r in done)
    assert _summary(teng, done) == want
    assert want[2]["prefix_hits"] > 0 and teng.kv.pages_in_use() == 0
