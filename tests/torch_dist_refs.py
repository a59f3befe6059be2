"""The reference's side of the split cases of tests/test_torch_distributed.py:
the reference's unsharded loss and step-1 gradients of each named case (a
method or remat case of :func:`torch_dist_ranks.method_case`, a family of
:func:`torch_dist_ranks.family_case`, and ``"seamless kv"``, the fallback
that runs the family case of reduced seamless-m4t-medium at 1x4) from the
port's initial state of the case, converted, on its first batch.

Tracing and compiling the reference for every case takes ~80 s, so the
test holds the split's results against :data:`PINS`, a digest of each
case's reference result that this script writes:

    PYTHONPATH=src python tests/torch_dist_refs.py

(``{case: {"loss": float, "grads": {leaf: [L2 norm, projection on a
fixed random direction]}}}``), and recomputes one case live to show that
the digests are still the reference's.
"""
import json
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

#: every case the test holds against the reference
CASES = (ranks.METHOD_CASES + ranks.FAMILIES + ranks.SPLIT_FAMILIES
         + ("seamless kv",))
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
    pins = {}
    for case in CASES:
        loss, grads = case_reference(case)
        pins[case] = {"loss": loss, "grads": digest(grads)}
    PINS.write_text(json.dumps(pins, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
