"""The port's audio encoder-decoder family (reduced
``seamless-m4t-medium``: 2 encoder and 2 decoder layers over precomputed
source frames) against the reference package on the CPU (fp32), params
made with numpy in the reference's tree structure.

The reference's engine cannot serve the family (it builds no
``src_embeds`` and its first prefill raises ``KeyError``), so the port's
engine refuses it at construction, and generation is held at model level:
``prefill`` and ``decode_step``.  The port pads the cross K/V to a multiple
of 16 rows and keeps one length per row; the reference keeps the source's
rows and one scalar length.

Tolerances: model logits, losses, prefill caches and decode 1e-4
(:data:`ssm_pairs.MODEL_TOL`); train-step losses and grad norms 1e-4
relative; greedy tokens identical; configs, batches and interop bit for
bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model  # noqa: E402

import ssm_pairs as sp  # noqa: E402
from test_torch_vlm import _logits_and_loss  # noqa: E402
from test_torch_vlm import assert_batches_match  # noqa: E402
from test_torch_vlm import assert_config_matches  # noqa: E402

ARCH = "seamless-m4t-medium"
MAX_LEN = 48
TOL = dict(atol=sp.MODEL_TOL, rtol=sp.MODEL_TOL)
#: source frames of the model-level checks: not a multiple of 16
SRC = 10
#: right-padded prompts: row lengths, and the greedy loop's new tokens
LENGTHS = np.array([12, 7], np.int32)
DECODES, GREEDY = 4, 6


def test_config_matches_reference():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.is_encoder_decoder, cfg.num_encoder_layers) == \
        ("audio", True, 12)
    assert cfg.reduced().num_encoder_layers == 2
    assert_config_matches(ARCH)


def test_batches_match_reference():
    assert_batches_match(ARCH, ("src_embeds",))


@pytest.fixture(scope="module")
def params():
    return sp.numpy_params(sp.configs(ARCH)[0], 0)


def _inputs(cfg, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    return {"tokens": toks,
            "src_embeds": rng.standard_normal((2, SRC, cfg.d_model)
                                              ).astype(np.float32)}


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_logits_and_loss_match_reference(params):
    """``forward_logits`` and ``loss_fn`` (encoder, cross-attention, PSOFT
    on every target of both stacks); the trainable mask leaf for leaf,
    the cross and encoder linears' PSOFT factors included."""
    jcfg, cfg = sp.configs(ARCH)
    tp = sp.host(params)
    batch = _inputs(cfg, 12, 1)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    want = sp.compiled(lambda p, b: _logits_and_loss(p, b, jcfg), params,
                       batch)(params, batch)
    got = model.forward_logits(tp, _tensors(batch), cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want[0]),
                               **TOL)
    loss, _ = model.loss_fn(tp, _tensors(batch), cfg)
    np.testing.assert_allclose(float(loss), float(want[1]), **TOL)
    mask = model.trainable_mask(cfg, tp)
    assert mask == jax.tree.map(bool, jmodel.trainable_mask(jcfg, params))
    assert mask["layers"]["cross"]["k"]["q"] and \
        mask["enc_layers"]["attn"]["v"]["beta"]
    assert not mask["layers"]["cross"]["k"]["w_res"]


def test_train_steps_match_reference(params, monkeypatch):
    """3 PSOFT steps on ``batch_at`` (2 x (16 source frames + 16
    tokens))."""
    sp.check_train_steps(monkeypatch, ARCH, params)


@pytest.fixture(scope="module")
def generation(params):
    """The reference's model-level generation through one compiled
    ``prefill`` and one compiled ``decode_step``: the prefill at a 10-frame
    source with right-padded prompts read at ``LENGTHS``, then ``DECODES``
    steps on given tokens (logits and caches), and a greedy loop of
    ``GREEDY`` tokens over the same prefill."""
    jcfg, cfg = sp.configs(ARCH)
    batch = _inputs(cfg, int(LENGTHS.max()), 2)
    steps = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (DECODES, 2, 1)).astype(np.int32)
    prefill = sp.fast_jit(lambda p, b, ln: jmodel.prefill(
        p, b, jcfg, MAX_LEN, lengths=ln))
    decode = sp.fast_jit(lambda p, t, c, q: jmodel.decode_step(
        p, {"tokens": t}, c, q, jcfg))
    last, cache = prefill(params, batch, LENGTHS)
    outs, c = [last], cache
    for i in range(DECODES):
        nxt, c = decode(params, steps[i], c, LENGTHS + i)
        outs.append(nxt)
    greedy, c = [], cache
    tok = np.asarray(last)[:, -1, :jcfg.vocab_size].argmax(-1)
    for i in range(GREEDY):
        greedy.append(tok.tolist())
        nxt, c = decode(params, tok[:, None].astype(np.int32), c,
                        LENGTHS + i)
        tok = np.asarray(nxt)[:, -1, :jcfg.vocab_size].argmax(-1)
    return batch, steps, (cache, outs, greedy)


def test_prefill_and_decode_match_reference(params, generation):
    """Prefill logits, the self cache and the cross cache (its source rows,
    zeros in the padding, one length per row), then ``DECODES`` decode
    steps."""
    _jcfg, cfg = sp.configs(ARCH)
    tp = sp.host(params)
    batch, steps, (wcache, want, _greedy) = generation
    got, cache = model.prefill(tp, _tensors(batch), cfg, MAX_LEN,
                               torch.as_tensor(LENGTHS))
    assert set(cache) == {"self", "cross"}
    for k in ("k", "v"):
        np.testing.assert_allclose(cache["self"][k].numpy(),
                                   np.asarray(wcache["self"][k]), **TOL)
        cross = cache["cross"][k].numpy()
        assert cross.shape[2] == 16
        np.testing.assert_allclose(cross[:, :, :SRC],
                                   np.asarray(wcache["cross"][k]), **TOL)
        assert not cross[:, :, SRC:].any()
    assert cache["cross"]["len"].tolist() == [int(wcache["cross"]["len"])] * 2
    outs = [got]
    for i in range(DECODES):
        nxt, cache = model.decode_step(
            tp, {"tokens": torch.as_tensor(steps[i])}, cache,
            torch.as_tensor(LENGTHS + i), cfg)
        outs.append(nxt)
    for g, w in zip(outs, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_greedy_loop_matches_reference(params, generation):
    """The same greedy loop over the port's ``prefill`` and
    ``decode_step``: identical tokens."""
    _jcfg, cfg = sp.configs(ARCH)
    tp = sp.host(params)
    batch, _steps, (_c, _outs, greedy) = generation
    logits, cache = model.prefill(tp, _tensors(batch), cfg, MAX_LEN,
                                  torch.as_tensor(LENGTHS))
    toks = []
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
    for i in range(GREEDY):
        toks.append(tok.tolist())
        logits, cache = model.decode_step(
            tp, {"tokens": tok[:, None]}, cache,
            torch.as_tensor(LENGTHS + i), cfg)
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
    assert toks == greedy


def test_engine_refuses_audio_like_reference(monkeypatch):
    """The reference's engine takes the family and fails at its first
    prefill (``KeyError: 'src_embeds'``); the port's refuses it at
    construction and names that reason."""
    jcfg, cfg = sp.configs(ARCH, "none")
    plain = sp.numpy_params(jcfg, 1)
    jeng = sp.fast_reference_engine(monkeypatch, jcfg, plain, max_len=MAX_LEN,
                                    slots=2)
    assert jeng.cache_mode == "dense"
    prompt = np.arange(5, dtype=np.int32)
    with pytest.raises(KeyError, match="src_embeds"):
        jeng.run([jserve.Request(uid=0, prompt=prompt, max_new_tokens=2)])
    for mode in ("auto", "dense", "paged"):
        with pytest.raises(ValueError, match="not 'audio'.*src_embeds"):
            tserve.ServeEngine(sp.host(plain), cfg, max_len=MAX_LEN, slots=2,
                               device="cpu", cache_mode=mode)


def test_audio_tree_crosses_interop(params):
    """numpy -> port -> numpy bit for bit, the encoder stack, the cross
    blocks and the encoder's final norm included."""
    back = interop.params_to_numpy(sp.host(params))
    assert {"enc_layers", "enc_final_norm"} <= set(back)
    assert {"ln_cross", "cross"} <= set(back["layers"])
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(jax.tree.leaves(back))
    for kp, leaf in flat:
        node = back
        for k in kp:
            node = node[k.key]
        assert node.dtype == leaf.dtype and node.tobytes() == leaf.tobytes()
