"""The port's checkpoint feeds into a live engine against the reference's
on ``tiny`` (fp32): checkpoint round trips into serving (PSOFT and LoRA),
serve-while-train (a step hook trains and checkpoints with
``publish=feed.notify``, the attached ``AdapterFeed`` swaps each
checkpoint into the live bank), and a cross-package feed (checkpoints the
reference's trainer wrote, streamed by each package's feed), each with
identical outcomes on both engines (:mod:`lifecycle_pairs`)."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lifecycle_pairs as lp  # noqa: E402
import ssm_pairs as sp  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import checkpoint as jcheckpoint  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.train import checkpoint, trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _compiled_rotations():
    with sp.compiled_reference_rotations():
        yield


@pytest.fixture(scope="module")
def setup():
    return lp.make_sides()


# -- checkpoints into serving ------------------------------------------------

def _as_reference(np_state):
    return jtrainer.TrainState(np_state.step, np_state.trainable,
                               np_state.frozen,
                               jadamw.AdamWState(*np_state.opt))


@pytest.mark.parametrize("method", ["psoft", "lora"])
def test_checkpoint_roundtrip_into_serving(setup, method, tmp_path):
    """Port trainer steps -> port checkpoint -> restore into the state's
    template -> register on a live engine: the tokens of the unsaved
    in-memory state, moved off base, and the reference engine serving the
    same checkpoint (restored by the reference) gives the same tokens."""
    cfg = get_config("tiny")
    if method != cfg.peft.method:
        cfg = cfg.replace(peft=cfg.peft.replace(method=method))
    tc = TrainConfig(steps=4, learning_rate=5e-2, schedule="constant",
                     warmup_ratio=0.0)
    state0 = trainer.init_train_state(cfg, tc, seed=1, device="cpu")
    step = trainer.make_train_step(cfg, tc)
    ds = JDataset(jget_config("tiny"), batch=2, seq_len=16)
    state = state0
    for i in range(3):
        state, _ = step(state, ds.batch_at(i))
    checkpoint.save(state, str(tmp_path), int(state.step))
    restored = checkpoint.restore(state, str(tmp_path))
    base = trainer.adapter_params(state0)
    prompt = lp.prompt(6, 0, cfg.vocab_size)

    def serve(ns, engine_base, tuned, engine_cfg, **kw):
        eng = ns.ServeEngine(engine_base, engine_cfg, max_len=48, slots=2,
                             **kw)
        eng.register_adapter("tuned", tuned, engine_cfg.peft)
        return [eng.run([ns.Request(uid=u, prompt=prompt.copy(),
                                    max_new_tokens=5, adapter=a)],
                        max_steps=64)[0].generated
                for u, a in ((0, "tuned"), (1, "base"))]

    got, off = serve(tserve, base, trainer.adapter_params(restored), cfg,
                     device="cpu")
    assert got == serve(tserve, base, trainer.adapter_params(state), cfg,
                        device="cpu")[0]
    assert got != off, f"{method}: the fine-tune did not move off base"
    jcfg = jget_config("tiny")
    jcfg = jcfg.replace(peft=jcfg.peft.replace(method=method))
    jtemplate = jax.tree.map(jnp.asarray,
                             _as_reference(interop.params_to_numpy(state)))
    jrestored = jcheckpoint.restore(jtemplate, str(tmp_path))
    jbase = jax.tree.map(jnp.asarray, interop.params_to_numpy(base))
    want, want_off = serve(jserve, jbase, jtrainer.adapter_params(jrestored),
                           jcfg)
    assert (got, off) == (want, want_off)


@pytest.fixture(scope="module")
def jtrain():
    """The reference's training: tiny, a jitted step, the initial state,
    and the states after steps 1..3 (shared by the feed scenarios)."""
    cfg = jget_config("tiny")
    tc = JTrainConfig(steps=8, learning_rate=5e-3)
    key = jax.random.PRNGKey(1)

    def init(k):
        return jtrainer.init_train_state(k, cfg, tc)
    ds = JDataset(cfg, batch=2, seq_len=16)
    # the init and the step traced in turn and compiled together (XLA
    # compiles without holding the interpreter lock)
    lowered = (jax.jit(init).lower(key), jax.jit(jtrainer.make_train_step(
        cfg, tc, moe_impl="dense")).lower(
            jax.eval_shape(init, key),
            {k: jnp.asarray(v) for k, v in ds.batch_at(0).items()}))
    with ThreadPoolExecutor(2) as pool:
        init, step = pool.map(lambda lo: lo.compile(), lowered)
    state0 = init(key)
    states = [state0]
    for i in range(3):
        states.append(step(states[-1], {k: jnp.asarray(v) for k, v in
                                        ds.batch_at(i).items()})[0])
    return cfg, tc, state0, step, ds, states


def _feed_engine(side, jstate0):
    base = jtrainer.adapter_params(jstate0)
    eng = side.engine(base=side.adapter(base), tracker=side.tracker())
    if side.is_port:
        template = trainer.train_state_from_numpy(
            jax.tree.map(np.asarray, jstate0), device="cpu")
    else:
        template = jax.eval_shape(lambda: jstate0)
    return eng, template


def _feed_run(side, eng, feed, final_prompt):
    done = eng.run_stream(
        [(1, side.request(0, lp.prompt(6, 0, side.cfg.vocab_size), 16))],
        max_steps=128)
    assert done[0].done and len(feed.applied) >= 2
    assert feed.applied == sorted(feed.applied)
    swap_ops = [e["op"] for e in eng.tracker.events_named("engine/bank/swap")
                if e["adapter"] == "live"]
    assert swap_ops[0] == "register" and "update" in swap_ops[1:]
    assert eng.tracker.gauges["engine/bank/epoch"] >= 2
    return done + eng.run([side.request(9, final_prompt, 5, "live")],
                          max_steps=64)


def test_serve_while_train_matches_reference(setup, jtrain, tmp_path):
    """One process trains and serves, on each package with its own
    trainer: a step hook trains a step and checkpoints it with
    ``publish=feed.notify``; the attached feed streams each checkpoint into
    the live bank (register, then updates) while a request is in flight;
    the newest state then serves as a fresh engine would serve it."""
    jcfg, tc, jstate0, jstep, ds, _ = jtrain
    applied = {}

    def scenario(side):
        eng, template = _feed_engine(side, jstate0)
        ckpt = str(tmp_path / ("port" if side.is_port else "ref"))
        feed = side.ns.AdapterFeed(eng, ckpt, "live", template).attach()
        if side.is_port:
            box = {"state": template, "i": 0}
            step = trainer.make_train_step(
                get_config("tiny"), TrainConfig(steps=8, learning_rate=5e-3))
        else:
            box = {"state": jstate0, "i": 0}
            step = jstep

        def train_hook(engine, s):
            if s % 3 == 0 and box["i"] < 3:
                batch = ds.batch_at(box["i"])
                if not side.is_port:
                    batch = {k: jnp.asarray(v) for k, v in batch.items()}
                box["state"], _ = step(box["state"], batch)
                box["i"] += 1
                save = checkpoint.save if side.is_port \
                    else jcheckpoint.save
                save(box["state"], ckpt, int(box["state"].step),
                     publish=feed.notify)
        eng.add_step_hook(train_hook)
        done = _feed_run(side, eng, feed, lp.prompt(6, 0, jcfg.vocab_size))
        applied[side.is_port] = list(feed.applied)
        if side.is_port:
            fresh = side.engine(base=lp.host(jtrainer.adapter_params(
                jstate0)))
            fresh.register_adapter("live",
                                   trainer.adapter_params(box["state"]))
            assert fresh.run([side.request(9, lp.prompt(6, 0, jcfg.vocab_size),
                                           5, "live")], max_steps=64
                             )[0].generated == done[-1].generated
        return eng, done

    lp.both(setup, scenario)
    assert applied[True] == applied[False]


def test_cross_package_feed(setup, jtrain, tmp_path):
    """Checkpoints the reference's trainer wrote (tiny, fp32), published
    mid-run into each package's feed: the port's AdapterFeed restores the
    reference's files and serves the same tokens, swap events and gauges
    as the reference's feed; the restored adapter shares no storage with
    the template it was restored into."""
    jcfg, _tc, jstate0, _step, _ds, states = jtrain
    feeds = {}

    def scenario(side):
        eng, template = _feed_engine(side, jstate0)
        ckpt = str(tmp_path / ("port" if side.is_port else "ref"))
        feed = side.ns.AdapterFeed(eng, ckpt, "live", template).attach()
        box = {"i": 1}

        def publish_hook(engine, s):
            if s % 3 == 0 and box["i"] < len(states):
                st = states[box["i"]]
                jcheckpoint.save(st, ckpt, int(st.step), publish=feed.notify)
                box["i"] += 1
        eng.add_step_hook(publish_hook)
        feeds[side.is_port] = (feed, template)
        return eng, _feed_run(side, eng, feed,
                              lp.prompt(6, 3, jcfg.vocab_size))

    eng, _ = lp.both(setup, scenario)
    feed, template = feeds[True]
    assert feed.applied == feeds[False][0].applied
    live = eng._sources["live"][0]
    held = {t.untyped_storage().data_ptr()
            for t in tree_leaves(template.trainable)}
    q = live["layers"]["attn"]["q"]["q"]
    assert q.untyped_storage().data_ptr() not in held
