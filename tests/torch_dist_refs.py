"""The reference's side of the split cases of tests/test_torch_distributed.py:
the reference's unsharded loss and step-1 gradients of each named case (a
method or remat case of :func:`torch_dist_ranks.method_case`, a family of
:func:`torch_dist_ranks.family_case`, and ``"seamless kv"``, the fallback
that runs the family case of reduced seamless-m4t-medium at 1x4) from the
port's initial state of the case, converted, on its first batch; and the
reference's logits of each split serving case (``"serve <arch>"``:
:func:`torch_dist_ranks.serve_case`'s prefill and decode steps from the
port's params, converted), with the final Mamba2 decode states of the
SSM and hybrid cases.

Tracing and compiling the reference for every case takes ~80 s, so the
test holds the split's results against :data:`PINS`, a digest of each
case's reference result that this script writes:

    PYTHONPATH=src python tests/torch_dist_refs.py [--serve-only]

(``{case: {"loss": float, "grads": {leaf: [L2 norm, projection on a
fixed random direction]}}}``, a serving case ``{"logits": {"step<i>":
[L2 norm, projection]}}`` and, with Mamba2 layers, ``"states": {name:
[L2 norm, projection]}`` (``torch_dist_ranks.state_leaves``' names)), and
recomputes one case of each kind live to show that the digests are still
the reference's.
"""
import json
import sys
import zlib
from pathlib import Path

import jax
import numpy as np

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro_torch import interop
from repro_torch.data import SyntheticLMDataset
from repro_torch.optim import adamw
from repro_torch.train import trainer

import ssm_pairs as sp
import torch_dist_ranks as ranks

#: every serving case the test holds against the reference
SERVE_CASES = tuple(f"serve {arch}" for arch in ranks.SERVE_ARCHS)
#: every case the test holds against the reference
CASES = (ranks.METHOD_CASES + ranks.FAMILIES + ranks.SPLIT_FAMILIES
         + ("seamless kv",) + SERVE_CASES)
#: the digests of the reference's results, by case
PINS = Path(__file__).resolve().parent / "fixtures" / \
    "torch_split_reference.json"

_FNS = {}


def _flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def direction(leaf: str, shape) -> np.ndarray:
    """The fixed random direction a leaf's gradient is projected on."""
    rng = np.random.default_rng(zlib.crc32(leaf.encode()))
    return rng.standard_normal(shape)


def digest(grads) -> dict:
    """{leaf: [L2 norm, projection on :func:`direction`]} in float64."""
    return {k: [float(np.linalg.norm(g.astype(np.float64))),
                float(np.sum(g.astype(np.float64)
                             * direction(k, g.shape)))]
            for k, g in grads.items()}


def reference_step(jcfg, spec):
    """(loss, step-1 gradients by leaf) of the reference's unsharded step
    at ``jcfg`` for a case ``spec`` (config, train config, steps, batch,
    seq, MoE dispatch); compiled once per config, the remat policy aside
    (it changes no value)."""
    cfg, tc, _, batch, seq, moe_impl = spec
    jcfg = jcfg.replace(remat_policy="none")
    key = (repr(jcfg), tc.full_finetune, moe_impl)
    if key not in _FNS:
        def fn(params, b):
            tr, fr = jadamw.partition(params, jmodel.trainable_mask(
                jcfg, params, tc.full_finetune))
            (loss, _), grads = jax.value_and_grad(
                lambda t: jmodel.loss_fn(jadamw.combine(t, fr), b, jcfg,
                                         moe_impl), has_aux=True)(tr)
            return loss, grads
        _FNS[key] = sp.fast_jit(fn)
    state = trainer.init_train_state(cfg, tc, device="cpu")
    params = interop.params_to_numpy(adamw.combine(state.trainable,
                                                   state.frozen))
    b = {k: np.asarray(v) for k, v in
         SyntheticLMDataset(cfg, batch, seq).batch_at(0).items()}
    loss, grads = _FNS[key](params, b)
    return float(loss), _flat(grads)


def serve_reference(arch, states=False):
    """The reference's logits (steps + 1, B, 1, V) of a serving case: its
    ``prefill`` (default dispatch: capacity) and ``decode_step``s (dense)
    on :func:`torch_dist_ranks.serve_case`'s inputs, one compiled
    function; with ``states``, (the logits, the final cache's Mamba2
    states by :func:`torch_dist_ranks.state_leaves`' names)."""
    cfg, params, batch, lengths, toks = ranks.serve_case(arch)
    jcfg = jget_config(arch).reduced()

    def fn(p, b, ln, toks):
        logits, cache = jmodel.prefill(p, b, jcfg, ranks.SERVE_MAX_LEN,
                                       lengths=ln)
        out = [logits]
        for j in range(ranks.SERVE_STEPS):
            pos = (b["tokens"].shape[1] if ln is None else ln) + j
            if ln is None:
                pos = np.full((ranks.SERVE_BATCH,), pos, np.int32)
            logits, cache = jmodel.decode_step(p, {"tokens": toks[j]},
                                               cache, pos, jcfg)
            out.append(logits)
        return out, ranks.state_leaves(cache)
    got, final = sp.fast_jit(fn)(interop.params_to_numpy(params), batch,
                                 lengths, toks)
    logits = np.stack([np.asarray(x) for x in got])
    if states:
        return logits, {k: np.asarray(v) for k, v in final.items()}
    return logits


def serve_digest(logits) -> dict:
    """:func:`digest` of each step's logits (``"step<i>"``)."""
    return digest({f"step{i}": x for i, x in enumerate(logits)})


def case_reference(case):
    """:func:`reference_step` of one of :data:`CASES`, on the reference's
    SSD scan made NaN-safe (:func:`ssm_pairs.safe_ssd_chunked`) while it
    runs."""
    scan = jssm.ssd_chunked
    jssm.ssd_chunked = sp.safe_ssd_chunked
    try:
        if case in ranks.METHOD_CASES:
            tiny = jget_config("tiny")
            spec = ranks.method_case(case)
            return reference_step(tiny.replace(peft=tiny.peft.replace(
                method=spec[0].peft.method)), spec)
        arch = "seamless-m4t-medium" if case == "seamless kv" else case
        return reference_step(jget_config(arch).reduced(),
                              ranks.family_case(arch))
    finally:
        jssm.ssd_chunked = scan


def main():
    pins = json.loads(PINS.read_text()) if PINS.exists() else {}
    for case in CASES:
        if case in SERVE_CASES:
            logits, states = serve_reference(case.split(" ", 1)[1], True)
            pins[case] = {"logits": serve_digest(logits)}
            if states:
                pins[case]["states"] = digest(states)
            continue
        if case in pins and "--serve-only" in sys.argv:
            continue
        loss, grads = case_reference(case)
        pins[case] = {"loss": loss, "grads": digest(grads)}
    PINS.write_text(json.dumps(pins, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
