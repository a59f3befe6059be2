"""The port's abstract param tree and its counters against the reference
package's at full size: ``abstract_params`` leaf for leaf (path, shape and
dtype) against the reference's ``jax.eval_shape`` tree, and
``count_params`` / ``count_trainable`` equal on it, for the four dense
configs of the zoo and one config of every other family.  The port's tree
is meta tensors: nothing is allocated and no SVD runs on real data.  On a
real (reduced) tree the counters equal the reference's too."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa: E402

ARCHS = ("starcoder2-15b", "granite-8b", "internlm2-1.8b", "nemotron-4-15b",
         "llama32-3b", "deepseek-moe-16b", "mamba2-1.3b", "zamba2-1.2b",
         "internvl2-26b", "seamless-m4t-medium")


def _ref_leaves(tree):
    """(path, shape, dtype name) of the reference's leaves, in order."""
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp),
             tuple(leaf.shape), np.dtype(leaf.dtype).name)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_counts_match_reference(arch, monkeypatch):
    svd_inputs = []
    svd = torch.linalg.svd

    def watched(a, *args, **kw):
        svd_inputs.append(a.device.type)
        return svd(a, *args, **kw)
    monkeypatch.setattr(torch.linalg, "svd", watched)
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = model.abstract_params(cfg)
    want = jmodel.abstract_params(jcfg)
    leaves = tree_leaves_with_path(got)
    assert all(t.is_meta for _, t in leaves)
    assert set(svd_inputs) <= {"meta"}
    assert [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in leaves] == _ref_leaves(want)
    n = model.count_params(got)
    assert n == jmodel.count_params(want) > 5e8
    assert model.count_trainable(cfg, got) == \
        jmodel.count_trainable(jcfg, want) > 0


def test_counts_of_a_real_tree_match_reference():
    """On a reduced tree with real leaves (a train state's split trees
    count too: their ``None`` leaves count nothing)."""
    cfg = get_config("nemotron-4-15b").reduced()
    params = model.init_params(cfg, seed=0, device="cpu")
    jparams = interop.params_to_numpy(params)
    jcfg = jget_config("nemotron-4-15b").reduced()
    n, n_tr = model.count_params(params), model.count_trainable(cfg, params)
    assert (n, n_tr) == (jmodel.count_params(jparams),
                         jmodel.count_trainable(jcfg, jparams))
    mask = model.trainable_mask(cfg, params)
    assert n_tr == sum(t.numel() for t, m in zip(tree_leaves(params),
                                                 tree_leaves(mask)) if m)
    assert n == model.count_params(model.abstract_params(cfg))
