"""The port's distributed training on gloo process groups on the CPU,
against the reference package and the port's unsharded step.

One module fixture starts every group of ranks at once (each rank a
process running tests/torch_dist_ranks.py, which imports no JAX) and, while
they run, computes the reference's side in this process:

(a) 3 sharded steps of ``tiny`` on (2, 2), (4, 1), (1, 4) and (1, 2)
    meshes from the reference's ``init_train_state(PRNGKey(0))``: losses,
    step-1 gradients, grad norms and trainable leaves within 1e-5 of the
    port's unsharded step, the last loss within 1e-5 of the reference's
    sharded step (:data:`REF_LOSS`), and at one rank (the card's
    in-memory store) bit for bit the unsharded step's, with 2
    microbatches too; where ``model`` has several ranks the compute splits
    over it (no all-gather over ``model``, the all-reduces that
    ``tensor_parallel.step_collectives`` predicts), also under its kv and
    vocab fallbacks (reduced seamless-m4t-medium's kv fallback included),
    every PEFT method, every remat policy and every family; each method,
    remat policy and family case and seamless's fallback also has its
    first step within 1e-5 (loss) and ``ssm_pairs.MODEL_TOL`` (step-1
    gradients' digests) of the reference's unsharded step from the same
    state, pinned by tests/torch_dist_refs.py, one case recomputed live;
(b) ``grad_allreduce_dtype="bfloat16"``: bf16 all-reduces on the wire
    exactly when compression is on, losses within 1e-4 relative and
    trainables within lr a step of the unsharded compressed step (4 ranks
    round 4 partial sums to bf16 where one step rounds one; Adam's early
    steps are ~lr * sign(g)); ``"int8"``: int8 on the wire after one fp32
    max, losses within 1e-3; bit for bit at one rank (both dtypes);
(c) a checkpoint saved on (2, 2) restores onto (4, 1) and in one process
    bit for bit;
(d) GPipe over 4 stages, 8 microbatches, forward and grad against the
    reference's sequential loop and ``jax.grad`` (1e-5 / 1e-4, the
    reference test's);
(e) reduced deepseek-moe-16b's capacity layer on a (2, 1) mesh, each rank
    one dispatch group, against the reference's grouped dispatch with 2
    groups (one JAX process under a mesh context that reports data = 2;
    1e-5, aux 1e-6), and its sharded train steps against the port's
    in-process 2-group step (1e-5); every family's step on (2, 1) and
    (1, 2) against the unsharded step;
(f) the launcher under ``torch.distributed.run`` with 2 gloo ranks ends on
    the loss of one process (1e-5);
(g) split serving: every family's ``prefill`` and 4 ``decode_step``s on
    (1, 2), and reduced llama32-3b's on (1, 4), whose 2 kv heads put the
    decode cache on its sequence, and reduced mamba2-1.3b's there, against
    the unsharded port (1e-5, fp32) and the reference's logits (digests
    pinned by tests/torch_dist_refs.py, one case recomputed live), each
    rank's cache its block (the Mamba2 states its SSM heads and its
    ``[x_r, B_g, C_g]`` conv channels, gathered within 1e-5 relative of
    the unsharded run's and of the reference's pinned digests), the
    collectives over ``model`` those ``tensor_parallel.serve_collectives``
    predicts; and the MoE expert split's train step, whose expert stacks
    are never gathered over ``model``.
"""
import json
import os
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.sharding import mesh_context as jmesh_context  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.distributed import tensor_parallel  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import rules_for  # noqa: E402
from repro_torch.sharding import mesh_context  # noqa: E402
from repro_torch.train import checkpoint, trainer  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import ssm_pairs as sp  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
import torch_dist_refs as refs  # noqa: E402
#: the reference's sharded step on tiny after 3 steps (TrainConfig(steps=
#: 3), SyntheticLMDataset(cfg, 8, 32), moe_impl "dense", init_train_state(
#: PRNGKey(0))), on a (4, 2) ("data", "model") mesh built with
#: repro.launch.mesh._make_mesh (Auto axes) under 8 forced host devices;
#: its (1, 1) mesh gives the same value
REF_LOSS = 7.291981220245361
STEPS, BATCH, SEQ = 3, 8, 32
LAUNCH = ["--device", "cpu", "--reduced", "--rank", "8", "--steps", "3",
          "--batch", "4", "--seq", "32", "--log-every", "1"]
GROUPS = {"four": 4, "moe2": 2}
#: the split case whose reference the fixture recomputes (the others are
#: pinned: ``torch_dist_refs.PINS``)
LIVE_CASE = "psoft"
#: the split serving case whose reference the fixture recomputes
LIVE_SERVE = "llama32-3b"
#: the serving cases: the rank group and its result key, by case
SERVE = {**{arch: ("moe2", "serve", arch) for arch in ranks.SERVE_ARCHS},
         f"seq {ranks.SERVE_SEQ_ARCH}": ("four", "serve seq",
                                         ranks.SERVE_SEQ_ARCH),
         "four mamba2-1.3b": ("four", "serve seq", "mamba2-1.3b")}
#: the serving cases with Mamba2 decode states
STATE_CASES = ("mamba2-1.3b", "zamba2-1.2b", "four mamba2-1.3b")
#: the tiny meshes of (a): the group of ranks that runs each, its shape
MESHES = {"2x2": ("four", (2, 2)), "4x1": ("four", (4, 1)),
          "1x4": ("four", (1, 4)), "1x2": ("moe2", (1, 2))}


class Sizes:
    size = 1

    def __init__(self, shape):
        self.shape = dict(shape)


def _flat(tree):
    return {"/".join(p): t.detach().cpu().numpy()
            for p, t in tree_leaves_with_path(tree)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _moe_inputs():
    jcfg = jget_config("deepseek-moe-16b").reduced()
    shapes = jax.eval_shape(lambda k: jmoe.moe_init(
        k, jcfg, jnp.float32, jnp.float32, jcfg.peft.target_modules),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)

    def leaf(kp, s):
        z = rng.standard_normal(s.shape).astype(np.float32)
        name = kp[-1].key
        if name == "q":
            return 0.05 * z
        if name in ("alpha", "beta"):
            return 1 + 0.05 * z
        return z / np.sqrt(s.shape[-2] if len(s.shape) >= 2 else 1)
    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    return jcfg, params, x


def _start(args, env, log):
    return subprocess.Popen(args, env=env, stdout=log,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}

    def start(group):
        procs[group] = [_start([sys.executable,
                                str(ROOT / "tests" / "torch_dist_ranks.py"),
                                group, str(r), str(GROUPS[group]), str(work)],
                               env, open(work / f"{group}.{r}.log", "w"))
                        for r in range(GROUPS[group])]

    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((4, 32, 32)) * 0.1).astype(np.float32)
    xg = rng.standard_normal((8, 2, 32)).astype(np.float32)
    np.savez(work / "gpipe.npz", ws=ws, x=xg)
    jmcfg, mparams, mx = _moe_inputs()
    np.savez(work / "moe.npz", x=mx, **{
        "/".join(str(k.key) for k in kp): v for kp, v in
        jax.tree_util.tree_flatten_with_path(mparams)[0]})
    start("moe2")
    start("four")   # its ranks wait for the initial state saved below
    launch_jsonl = work / "launch2.jsonl"
    procs["launch"] = [_start(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train"] + LAUNCH
        + ["--data-mesh", "2", "--metrics-jsonl", str(launch_jsonl)],
        env, open(work / "launch.log", "w"))]

    # the reference's initial state, for every tiny scenario
    jcfg = jget_config("tiny")
    jstate = _np(jax.jit(lambda k: jtrainer.init_train_state(
        k, jcfg, JTrainConfig(steps=STEPS)))(jax.random.PRNGKey(0)))
    init = trainer.train_state_from_numpy(jstate, device="cpu")
    checkpoint.save(init, str(work / "init"), 0)

    out = {"init": init, "work": work}
    cfg = get_config("tiny")
    ds = SyntheticLMDataset(cfg, BATCH, SEQ)
    for dtype in ("", "bfloat16"):
        step = trainer.make_train_step(
            cfg, TrainConfig(steps=STEPS, grad_allreduce_dtype=dtype),
            "dense")
        state, losses, norms, grads = ranks.run_steps(
            step, init, [ds.batch_at(i) for i in range(STEPS)])
        out[f"unsharded {dtype or 'float32'}"] = (
            losses, _flat(state.trainable), norms, grads)

    # (d) the reference's sequential stages and their grad
    def seq(w):
        h = jnp.asarray(xg)
        for i in range(4):
            h = jnp.tanh(h @ w[i])
        return h
    out["gpipe"] = (np.asarray(seq(ws)),
                    np.asarray(jax.grad(lambda w: seq(w).sum())(ws)))

    # (e) the reference's grouped dispatch, 2 groups; the port's step
    # dispatching 2 groups in one process
    sizes = Sizes({"data": 2, "model": 1})
    with jmesh_context(sizes, jmesh.rules_for(jmcfg, sizes)):
        y, aux = jax.jit(lambda p, xx: jmoe.moe_apply(
            p, xx, jmcfg, jnp.float32, "capacity"))(mparams, mx)
    out["moe ref"] = (np.asarray(y), float(aux))
    mcfg = get_config("deepseek-moe-16b").reduced()
    tc = TrainConfig(steps=2, learning_rate=1e-2)
    step = trainer.make_train_step(mcfg, tc, "capacity")
    state, losses = trainer.init_train_state(mcfg, tc, device="cpu"), []
    mds = SyntheticLMDataset(mcfg, 4, 16)
    grouped = {"data": 2, "model": 1}
    with mesh_context(grouped, rules_for(mcfg, grouped)):
        for i in range(2):
            state, m = step(state, mds.batch_at(i))
            losses.append(float(m["loss"]))
    out["moe steps"] = (losses, _flat(state.trainable))

    # (a, b) at one rank, in this process: the card's path (a group of
    # one rank on an in-memory store)
    try:
        out["one"] = ([0], "", ranks.one(0, str(work)))
    finally:
        torch.distributed.destroy_process_group()

    # (f) one process
    one_jsonl = work / "launch1.jsonl"
    launch_train.main(LAUNCH + ["--metrics-jsonl", str(one_jsonl)])
    out["launch one"] = one_jsonl

    # the reference's side of the split cases: pinned digests, and one
    # case recomputed while the ranks run
    out["split references"] = json.loads(refs.PINS.read_text())
    # the two live references traced in turn and compiled at once (XLA
    # compiles without holding the interpreter lock)
    with ThreadPoolExecutor(2) as pool:
        train_ref = pool.submit(refs.case_reference, LIVE_CASE)
        serve_ref = pool.submit(refs.serve_reference, LIVE_SERVE)
        out["live reference"] = train_ref.result()
        out["live serve reference"] = serve_ref.result()

    for group, ps in procs.items():
        for p in ps:
            try:
                p.wait(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    for group, ps in procs.items():
        logs = [(work / f"{group}.{r}.log") for r in range(len(ps))] \
            if group != "launch" else [work / "launch.log"]
        rcs = [p.returncode for p in ps]
        text = "\n".join(f.read_text()[-3000:] for f in logs)
        res = None
        if group in GROUPS and all(rc == 0 for rc in rcs):
            res = torch.load(work / f"{group}.0.pt", weights_only=False)
        out[group] = (rcs, text, res)
    out["launch jsonl"] = launch_jsonl
    return out


def _group(runs, group):
    rcs, text, res = runs[group]
    assert all(rc == 0 for rc in rcs), text
    return res


def _losses(path):
    return [r["data"]["train/loss"] for r in obs.read_jsonl(str(path))
            if r["kind"] == "scalars" and "train/loss" in r["data"]]


@pytest.mark.parametrize("mesh", ("2x2", "4x1", "1x4", "1x2"))
def test_sharded_steps_match_unsharded_and_reference(runs, mesh):
    group, (data, model) = MESHES[mesh]
    got = _group(runs, group)[mesh]
    want_losses, want, want_norms, want_grads = runs["unsharded float32"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=0, atol=1e-5)
    assert got["losses"][-1] == pytest.approx(REF_LOSS, abs=1e-5)
    np.testing.assert_allclose(got["grad_norms"], want_norms, rtol=0,
                               atol=1e-5)
    assert sorted(got["grads"]) == sorted(want_grads)
    for k, v in want_grads.items():
        np.testing.assert_allclose(got["grads"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)
    assert sorted(got["trainable"]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["trainable"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)
    assert _group(runs, "four")["mesh_from_config"] == (("data", "model"),
                                                        (2, 2))
    kinds = {(kind, group) for kind, _, _, group, _ in got["records"]}
    if model == 1:
        # frozen leaves gather over both axes (fsdp on data, vocab on
        # model), even where an axis has one rank; gradients reduce over
        # data only
        assert kinds == {("all_gather", "data"), ("all_gather", "model"),
                         ("all_reduce", "data")}
        return
    # the split: no leaf is gathered over model (the embedding and the
    # head keep their vocabulary rows, the linears are whole on every
    # rank), and over model go the split's all-reduces and the sum of the
    # gradients it leaves partial (every PSOFT leaf's)
    assert kinds == {("all_gather", "data"), ("all_reduce", "data"),
                     ("all_reduce", "model")}
    cfg = get_config("tiny")
    sizes = {"data": data, "model": model}
    kinds, vocab = tensor_parallel.plan_linears(cfg, sizes,
                                                rules_for(cfg, sizes))
    assert kinds == {"q": "col", "k": "col", "v": "col", "o": "row",
                     "gate": "col", "up": "col", "down": "row"} and vocab
    want_split = tensor_parallel.step_collectives(
        cfg, kinds, vocab, model, BATCH // data, SEQ) * STEPS
    on_model = [(tag, elements) for _, _, elements, group, tag
                in got["records"] if group == "model"]
    assert Counter(t for t in on_model if t[0] != "grads") == \
        Counter(want_split)
    n_train = sum(v.size for v in want.values())
    assert [t for t in on_model if t[0] == "grads"] == \
        [("grads", n_train)] * STEPS


def _as_reference(loss, grads, pin):
    """A first step's loss within 1e-5 of the reference's pinned one, and
    each step-1 gradient's digest (``torch_dist_refs.digest``) within
    :data:`ssm_pairs.MODEL_TOL` of the reference's relative to the
    gradient's norm (the projection, a sum over a random direction, at 4
    times that: ~4 standard deviations of a difference of that norm)."""
    assert loss == pytest.approx(pin["loss"], abs=1e-5)
    got = refs.digest(grads)
    assert sorted(got) == sorted(pin["grads"])
    for k, (norm, proj) in pin["grads"].items():
        tol = sp.MODEL_TOL * max(norm, 1e-3)
        assert abs(got[k][0] - norm) <= tol, (k, got[k], norm)
        assert abs(got[k][1] - proj) <= 4 * tol, (k, got[k], proj)


def _as_unsharded_and_reference(res, pin, loss_rel=0.0):
    """A split case's steps against the port's unsharded step (losses
    within 1e-5, or ``loss_rel`` relative where larger; step-1
    gradients, grad norms and trainables within 1e-5) and its first step
    against the reference's unsharded step from the same state
    (:func:`_as_reference`)."""
    assert res["losses"] == pytest.approx(res["plain"], rel=loss_rel,
                                          abs=1e-5)
    assert res["grad_diff"] <= 1e-5 and res["norm_diff"] <= 1e-5 \
        and res["diff"] <= 1e-5
    _as_reference(res["losses"][0], res["grads"], pin)


def test_pinned_split_references_are_the_reference(runs):
    """The pinned digests cover every split case, and the case recomputed
    from the reference in this run (:data:`LIVE_CASE`) equals its pin
    (1e-6 relative) and holds the split's gradients elementwise (within
    :data:`ssm_pairs.MODEL_TOL`)."""
    pins = runs["split references"]
    assert sorted(pins) == sorted(refs.CASES)
    loss, grads = runs["live reference"]
    pin = pins[LIVE_CASE]
    assert loss == pytest.approx(pin["loss"], rel=1e-6)
    for k, (norm, proj) in refs.digest(grads).items():
        assert (norm, proj) == pytest.approx(tuple(pin["grads"][k]),
                                             rel=1e-6, abs=1e-9), k
    split = _group(runs, "moe2")["methods"][LIVE_CASE]["grads"]
    for k, w in grads.items():
        np.testing.assert_allclose(
            split[k], w, rtol=sp.MODEL_TOL,
            atol=sp.MODEL_TOL * max(float(np.abs(w).max()), 1e-3),
            err_msg=k)


@pytest.mark.parametrize("case", ranks.FALLBACKS)
def test_split_fallbacks_step_as_unsharded(runs, case):
    """On (1, 4): 2 kv heads leave k and v replicated (each rank's q head
    attends the kv head it maps to), in ``tiny`` and in reduced
    seamless-m4t-medium's encoder, decoder and cross blocks; a vocabulary
    of 1022 rows padded to 2 leaves the embedding and the head
    replicated.  Each steps as the unsharded step, seamless's first step
    also as the reference's (the case the kv fallback's cross block
    reaches).  The plan is the rank's own, at the run's ``model`` size
    and pad multiple, and the test's from sizes agrees; the ``model``
    collectives are the ones ``step_collectives`` predicts."""
    res = _group(runs, "four")["fallbacks"][case]
    if case == "seamless kv":
        _as_unsharded_and_reference(res, runs["split references"][case])
    else:
        np.testing.assert_allclose(res["losses"], res["plain"], rtol=0,
                                   atol=1e-5)
        assert res["grad_diff"] <= 1e-5 and res["norm_diff"] <= 1e-5 \
            and res["diff"] <= 1e-5
    sizes = {"data": 1, "model": 4}
    with ranks.fallback_case(case) as spec:
        cfg = spec[0]
        plan = tensor_parallel.plan_linears(cfg, sizes, rules_for(cfg,
                                                                  sizes))
        padded = cfg.padded_vocab_size
    assert res["plan"] == plan
    kinds, vocab = plan
    b = SyntheticLMDataset(spec[0], spec[3], spec[4]).batch_at(0)
    want = tensor_parallel.step_collectives(
        spec[0], kinds, vocab, 4, spec[3], spec[4],
        src_seq=b["src_embeds"].shape[1] if "src_embeds" in b else 0)
    assert Counter((tag, n) for _, _, n, group, tag in res["records"]
                   if group == "model" and tag != "grads") == Counter(want)
    if case == "vocab":
        assert padded == ranks.FALLBACK_VOCAB and not vocab
        assert kinds["q"] == kinds["up"] == "col"
    else:
        assert (kinds["q"], kinds["k"], kinds["v"], vocab) == \
            ("col", "replicated", "replicated", True)


@pytest.mark.parametrize("case", ranks.METHOD_CASES)
def test_every_method_and_remat_policy_splits_as_unsharded(runs, case):
    """``tiny`` on (1, 2) under every PEFT method (one step; the OFT
    family and DoRA through ``"gathered_row"`` o and down) and every remat
    policy (two steps) against the unsharded step (losses, step-1
    gradients, grad norms and trainables within 1e-5) and the reference's
    first step."""
    _as_unsharded_and_reference(_group(runs, "moe2")["methods"][case],
                                runs["split references"][case])


def test_one_rank_equals_the_unsharded_step(runs):
    res = _group(runs, "one")
    for case in ("float32", "bfloat16", "int8", "float32 x2"):
        assert res[case]["equal"], (case, res[case]["losses"],
                                    res[case]["want"])
    # the gather path runs at one rank too: 14 PSOFT-split leaves a layer
    # twice a step (forward and remat recompute) plus embed and lm_head
    # (no split at one model rank)
    gathers = [r for r in res["float32"]["records"] if r[0] == "all_gather"]
    assert len(gathers) == STEPS * (2 * 2 * 14 + 4)


def _wire(records):
    """(dtype, elements) of every gradient-sized all-reduce."""
    return [(dtype, elements) for kind, dtype, elements, group, _ in records
            if kind == "all_reduce" and group == "data" and elements > 1]


def test_bf16_gradients_cross_the_wire_in_bf16(runs):
    res = _group(runs, "four")
    n_train = sum(v.size for v in res["bfloat16"]["trainable"].values())
    assert _wire(res["bfloat16"]["records"]) == \
        [("torch.bfloat16", n_train)] * STEPS
    assert _wire(res["4x1"]["records"]) == [("torch.float32", n_train)] * STEPS
    want_losses, want, _, _ = runs["unsharded bfloat16"]
    np.testing.assert_allclose(res["bfloat16"]["losses"], want_losses,
                               rtol=1e-4)
    lr = TrainConfig(steps=STEPS).learning_rate
    for k, v in want.items():
        np.testing.assert_allclose(res["bfloat16"]["trainable"][k], v,
                                   rtol=0, atol=STEPS * lr, err_msg=k)
    # int8: every leaf's largest magnitude (fp32, one a leaf), then one
    # int8 tensor a step; 4 ranks quantise to +-31 so the sum stays in
    # range, coarser than one rank's +-127: losses within 1e-3
    wire = _wire(res["int8"]["records"])
    n_leaves = len(res["int8"]["trainable"])
    assert wire == [("torch.float32", n_leaves), ("torch.int8", n_train)] \
        * STEPS
    np.testing.assert_allclose(res["int8"]["losses"], want_losses, rtol=1e-3)


def test_elastic_restore_across_meshes(runs):
    res = _group(runs, "four")["elastic"]
    assert res["equal"]
    # on (4, 1) each rank holds a quarter of embed's fsdp dim
    assert res["block_shapes"]["frozen/embed/w"] == (1024, 32)
    # in one process: no shardings, the full arrays
    got = _flat(checkpoint.restore(runs["init"], str(runs["work"] / "ckpt")))
    saved = res["saved"]
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


def test_gpipe_forward_and_grad_match_reference(runs):
    res = _group(runs, "four")["gpipe"]
    want_y, want_g = runs["gpipe"]
    np.testing.assert_allclose(res["y"], want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res["grad"], want_g, rtol=1e-4, atol=1e-4)


def test_moe_dispatch_groups_match_reference(runs):
    res = _group(runs, "moe2")
    want_y, want_aux = runs["moe ref"]
    np.testing.assert_allclose(res["y"], want_y[:1], rtol=1e-5, atol=1e-5)
    assert res["aux"] == pytest.approx(want_aux, abs=1e-6)
    losses, want = runs["moe steps"]
    np.testing.assert_allclose(res["losses"], losses, rtol=0, atol=1e-5)
    for k, v in want.items():
        np.testing.assert_allclose(res["trainable"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)
    assert any(kind == "all_reduce" and elements == 4 and group == "data"
               for kind, _, elements, group, _ in res["records"])


@pytest.mark.parametrize("arch", ranks.FAMILIES)
def test_every_family_steps_sharded_as_unsharded(runs, arch):
    """A hybrid (its list of layers and shared block), an encoder-decoder
    (its encoder layers) and a VLM (patches in front), reduced, on the
    (2, 1) mesh: each split leaf is found and gathered at its use, and
    the step equals the unsharded one (1e-5; step-1 gradients and the
    grad norm too)."""
    res = _group(runs, "moe2")["families"]["2x1"][arch]
    assert res["losses"] == pytest.approx(res["plain"], rel=1e-5, abs=1e-5)
    assert res["grad_diff"] <= 1e-5 and res["norm_diff"] <= 1e-5 \
        and res["diff"] <= 1e-5


@pytest.mark.parametrize("arch", ranks.FAMILIES + ranks.SPLIT_FAMILIES)
def test_every_family_steps_split_as_unsharded(runs, arch):
    """Every family, reduced, on the (1, 2) mesh: the hybrid's shared
    block, the encoder's layers and the decoder's cross block, the VLM's
    blocks behind its patches split over ``model``; the MoE expert stacks
    and the Mamba2 mixer replicated across its ranks.  The step equals
    the unsharded one (losses, step-1 gradients, the grad norm and the
    trainables within 1e-5) and its first step the reference's."""
    _as_unsharded_and_reference(_group(runs, "moe2")["families"]["1x2"][arch],
                                runs["split references"][arch], 1e-5)


@pytest.mark.parametrize("case", list(SERVE))
def test_split_serving_matches_unsharded_and_reference(runs, case):
    """A split ``prefill`` and 4 ``decode_step``s (fp32) equal the
    unsharded port's within 1e-5 and the reference's logits (each step's
    digest within :data:`ssm_pairs.MODEL_TOL` of its pin); a rank's K/V
    buffers hold KH / n heads (``"kv_heads"``) or max_len / n positions
    (``"cache_seq"``, reduced llama32-3b's 2 kv heads on 4 ranks; its
    Mamba2 states: :func:`test_split_serving_splits_the_mamba2_states`);
    the collectives over ``model`` are exactly the ones
    ``tensor_parallel.serve_collectives`` predicts for the prefill and
    each step (a split Mamba2 layer's norm sum and out_proj sum
    included)."""
    group, key, arch = SERVE[case]
    res = _group(runs, group)[key][arch]
    size = 4 if group == "four" else 2
    assert res["diff"] <= 1e-5
    pin = runs["split references"][f"serve {arch}"]["logits"]
    got = refs.serve_digest(res["logits"])
    assert sorted(got) == sorted(pin)
    for k, (norm, proj) in pin.items():
        tol = sp.MODEL_TOL * max(norm, 1e-3)
        assert abs(got[k][0] - norm) <= tol, (k, got[k], norm)
        assert abs(got[k][1] - proj) <= 4 * tol, (k, got[k], proj)
    want_cache = "cache_seq" if group == "four" else "kv_heads"
    assert res["cache"] == want_cache
    shrunk = []
    for shape in res["whole_shapes"]:
        shape = list(shape)
        shape[-2 if want_cache == "kv_heads" else -3] //= size
        shrunk.append(tuple(shape))
    assert res["shapes"] == sorted(shrunk)
    cfg, _, batch, _, _ = ranks.serve_case(arch)
    kw = dict(src_seq=batch["src_embeds"].shape[1]
              if "src_embeds" in batch else 0,
              patches=batch["patch_embeds"].shape[1]
              if "patch_embeds" in batch else 0)
    want = tensor_parallel.serve_collectives(
        cfg, res["kinds"], res["vocab"], res["cache"], size,
        ranks.SERVE_BATCH, batch["tokens"].shape[1], False, **kw) + \
        tensor_parallel.serve_collectives(
            cfg, res["kinds"], res["vocab"], res["cache"], size,
            ranks.SERVE_BATCH, 1, True) * ranks.SERVE_STEPS
    assert Counter((tag, n) for _, _, n, group_, tag in res["records"]
                   if group_ == "model") == Counter(want)
    assert all(group_ == "model" for *_, group_, _ in res["records"])


@pytest.mark.parametrize("case", STATE_CASES)
def test_split_serving_splits_the_mamba2_states(runs, case):
    """Under the serving plan the mixer splits (in_proj a column set,
    out_proj a row split) and a rank's states are its blocks:
    ``ssm_state`` (..., B, H / n, N, P) and ``conv_state`` (..., B, K-1,
    d_inner / n + 2 g_l N); the blocks gathered in channel order equal
    the unsharded run's final states within 1e-5 relative (fp32) and the
    reference's (digests within :data:`ssm_pairs.MODEL_TOL` of the pins
    ``torch_dist_refs.py`` wrote)."""
    from repro_torch.models import ssm
    group, key, arch = SERVE[case]
    res = _group(runs, group)[key][arch]
    size = 4 if group == "four" else 2
    cfg = ranks.serve_case(arch)[0]
    assert (res["kinds"]["in_proj"], res["kinds"]["out_proj"]) == \
        ("col", "row")
    whole, local = ssm.ssm_dims(cfg), ssm.split_dims(cfg, 0, size)
    assert local["heads"] * size == whole["heads"] == 8
    assert sorted(res["state_shapes"]) == sorted(res["whole_state_shapes"])
    for name, shape in res["whole_state_shapes"].items():
        got = list(res["state_shapes"][name])
        if name.endswith("ssm_state"):
            assert shape[-3:] == (whole["heads"], whole["n"],
                                  cfg.ssm.head_dim)
            assert got == list(shape[:-3]) + [
                whole["heads"] // size, whole["n"], cfg.ssm.head_dim]
        else:
            assert shape[-1] == whole["conv_ch"]
            assert got == list(shape[:-1]) + [
                whole["d_inner"] // size + 2 * whole["n"]]
        assert tuple(res["states"][name].shape) == shape
    assert res["state_diff"] <= 1e-5
    pin = runs["split references"][f"serve {arch}"]["states"]
    got = refs.digest(res["states"])
    assert sorted(got) == sorted(pin)
    for k, (norm, proj) in pin.items():
        tol = sp.MODEL_TOL * max(norm, 1e-3)
        assert abs(got[k][0] - norm) <= tol, (k, got[k], norm)
        assert abs(got[k][1] - proj) <= 4 * tol, (k, got[k], proj)


def test_live_serving_reference_equals_its_pin(runs):
    """The serving case recomputed from the reference in this run
    (:data:`LIVE_SERVE`) equals its pinned digests (1e-6 relative) and
    holds the split's logits elementwise (within
    :data:`ssm_pairs.MODEL_TOL`)."""
    live = runs["live serve reference"]
    pin = runs["split references"][f"serve {LIVE_SERVE}"]["logits"]
    for k, (norm, proj) in refs.serve_digest(live).items():
        assert (norm, proj) == pytest.approx(tuple(pin[k]), rel=1e-6,
                                             abs=1e-9), k
    split = _group(runs, "moe2")["serve"][LIVE_SERVE]["logits"]
    np.testing.assert_allclose(split, live, rtol=sp.MODEL_TOL,
                               atol=sp.MODEL_TOL * float(np.abs(live).max()))


def test_moe_expert_split_keeps_its_stacks_and_predicted_collectives(runs):
    """Reduced deepseek-moe-16b's split step on (1, 2) (4 experts, 2 a
    rank; the shared expert's MLP split like a dense one): no frozen leaf
    is all-gathered over ``model`` (the expert stacks keep their experts,
    the embedding and the head their rows), over ``model`` go exactly
    the split's collectives ``step_collectives`` predicts (the experts'
    output sums, the dispatch input's and the gates' gradient sums
    included), the gradient sum, and the state's gathers of the
    trainable expert leaves and their moments (placed over ``model`` by
    the rules).  The step equals the unsharded one and the reference's
    (:func:`test_every_family_steps_split_as_unsharded`)."""
    res = _group(runs, "moe2")["families"]["1x2"]["deepseek-moe-16b"]
    cfg, _, _, batch, seq, _ = ranks.family_case("deepseek-moe-16b")
    kinds, vocab = res["plan"]
    assert kinds["expert"] == "split" and kinds["shared_up"] == "col"
    on_model = [(kind, tag, n) for kind, _, n, group, tag in res["records"]
                if group == "model"]
    assert not [r for r in on_model if r[1] == "frozen"]
    assert {tag for kind, tag, _ in on_model if kind == "all_gather"} == \
        {"state"}
    want = tensor_parallel.step_collectives(cfg, kinds, vocab, 2, batch, seq)
    assert Counter((tag, n) for kind, tag, n in on_model
                   if tag not in ("grads", "state")) == Counter(want)
    assert sum(tag == "grads" for _, tag, _ in on_model) == 1


def test_launcher_on_two_ranks_ends_on_one_ranks_loss(runs):
    rcs, text, _ = runs["launch"]
    assert rcs == [0], text
    assert "mesh: {'data': 2, 'model': 1}  devices: 2" in text
    two, one = _losses(runs["launch jsonl"]), _losses(runs["launch one"])
    assert len(two) == len(one) == 3
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-5)
