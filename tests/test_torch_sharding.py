"""The port's sharding metadata against the reference package's, in one
process (no ranks): ``param_axes`` leaf for leaf on one reduced config of
every family and on ``tiny`` under all ten PEFT methods (and
``linear_logical_axes`` of a linear by its param names); ``cache_axes`` of
every family's decode cache; ``logical_spec`` over every param of two
full-size configs on the production meshes ``{"data": 16, "model": 16}``
and ``{"pod": 2, "data": 16, "model": 16}`` (pod_role ``dp`` and ``pp``),
and the per-device param bytes those specs imply (the dry-run's), equal as
integers; a decode cell's per-device cache bytes (the dry-run's);
``rules_for`` for train, prefill and decode, a ``kv_heads`` the model
axis does not divide included; ``make_input_specs`` for every
``LM_SHAPES`` kind; the MoE layer's GShard grouped dispatch with G > 1
groups against the reference's, under a mesh context whose mesh only
reports sizes (the reference's ``shard_act`` then constrains nothing);
and the compute split's plan over ``model`` (every linear's kind from the
reference's ``logical_spec`` fallbacks), its local views of each method's
params (views of the leaves) and each method's row-separability flag
(two halves' partial outputs summed against the whole).

The reference's ``logical_spec`` reads only ``mesh.shape``, so a stand-in
object with that mapping serves for its production meshes.  Tolerances:
the MoE layer's outputs 1e-5 and its aux loss 1e-6 (fp32 sums in another
order), as tests/test_torch_moe.py."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import LM_SHAPES as JLM_SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.data import make_input_specs as jmake_input_specs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.sharding import default_rules as jdefault_rules  # noqa: E402
from repro.sharding import logical_spec as jlogical_spec  # noqa: E402
from repro.sharding import mesh_context as jmesh_context  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import LM_SHAPES, get_config  # noqa: E402
from repro_torch.core import peft, registry  # noqa: E402
from repro_torch.data import make_input_specs  # noqa: E402
from repro_torch.distributed import tensor_parallel  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, rules_for  # noqa
from repro_torch.models import model, moe  # noqa: E402
from repro_torch.sharding import (default_rules, logical_spec,  # noqa: E402
                                  mesh_context, placements)
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

FAMILIES = ("granite-8b", "deepseek-moe-16b", "mamba2-1.3b", "zamba2-1.2b",
            "internvl2-26b", "seamless-m4t-medium")
METHODS = ("none", "psoft", "lora", "pissa", "dora", "lora_xs", "oft",
           "boft", "goft", "qgoft")
MESHES = {"16x16": ({"data": 16, "model": 16}, "dp"),
          "2x16x16 dp": ({"pod": 2, "data": 16, "model": 16}, "dp"),
          "2x16x16 pp": ({"pod": 2, "data": 16, "model": 16}, "pp")}


class Sizes:
    """A mesh that only reports its axis sizes (all the reference's
    ``logical_spec``, ``rules_for`` and MoE group count read); ``size`` 1
    makes its ``shard_act`` constrain nothing."""
    size = 1

    def __init__(self, shape):
        self.shape = dict(shape)


def _path(kp):
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def _ref_pairs(tree):
    return [(_path(kp), leaf) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jmodel.LogicalAxes))[0]]


def _axes_pairs(want, got):
    """(path, reference axes, port axes) of every leaf, in order."""
    ref = _ref_pairs(want)
    port = tree_leaves_with_path(got)
    assert [p for p, _ in ref] == [p for p, _ in port]
    return [(p, tuple(a), tuple(b)) for (p, a), (_, b) in zip(ref, port)]


def _cfgs(arch, method=None):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if arch != "tiny":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    if method is not None:
        jcfg = jcfg.replace(peft=jcfg.peft.replace(method=method))
        cfg = cfg.replace(peft=cfg.peft.replace(method=method))
    return jcfg, cfg


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_and_cache_axes_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = jmodel.abstract_params(jcfg), model.abstract_params(cfg)
    pairs = _axes_pairs(jmodel.param_axes(jcfg, jp), model.param_axes(cfg, tp))
    assert all(a == b for _, a, b in pairs), \
        [(p, a, b) for p, a, b in pairs if a != b]
    if cfg.family == "moe":
        assert any("expert" in a for _, a, _ in pairs)
    jc = jax.eval_shape(lambda: jmodel.init_cache(jcfg, 2, 64))
    tc = model.init_cache(cfg, 2, 64, device="meta")
    pairs = _axes_pairs(jmodel.cache_axes(jcfg, jc), model.cache_axes(cfg, tc))
    assert pairs and all(a == b for _, a, b in pairs)


@pytest.mark.parametrize("method", METHODS)
def test_param_axes_of_every_method_match_reference(method):
    jcfg, cfg = _cfgs("tiny", method)
    jp, tp = jmodel.abstract_params(jcfg), model.abstract_params(cfg)
    pairs = _axes_pairs(jmodel.param_axes(jcfg, jp), model.param_axes(cfg, tp))
    assert all(a == b for _, a, b in pairs), \
        [(p, a, b) for p, a, b in pairs if a != b]
    # one linear's axes by its param names, a column- and a row-parallel
    for axes in (("fsdp", "tensor"), ("tensor", "fsdp")):
        for node in (tp["layers"]["attn"]["q"], tp["layers"]["attn"]["o"]):
            want = jpeft.linear_logical_axes(sorted(node), jcfg.peft, *axes,
                                             method=method)
            got = peft.linear_logical_axes(sorted(node), cfg.peft, *axes,
                                           method=method)
            assert got == want


def _ref_block_bytes(shape, spec, sizes, itemsize):
    dims = list(shape)
    for d, axes in enumerate(tuple(spec) + (None,) * (len(dims) - len(spec))):
        for a in ((axes,) if isinstance(axes, str) else axes or ()):
            dims[d] //= sizes[a]
    return math.prod(dims) * itemsize


@pytest.fixture(scope="module")
def full_size_axes():
    """Per full-size config: (path, reference axes, port axes) of every
    param leaf, and the reference's abstract leaves (shape and dtype)."""
    out = {}
    for arch in ("llama32-3b", "deepseek-moe-16b"):
        jcfg, cfg = jget_config(arch), get_config(arch)
        jp, tp = jmodel.abstract_params(jcfg), model.abstract_params(cfg)
        out[arch] = (_axes_pairs(jmodel.param_axes(jcfg, jp),
                                 model.param_axes(cfg, tp)),
                     [leaf for _, leaf in _ref_pairs(jp)])
    return out


@pytest.mark.parametrize("arch", ("llama32-3b", "deepseek-moe-16b"))
@pytest.mark.parametrize("mesh_name", MESHES)
def test_logical_specs_and_device_bytes_match_reference(full_size_axes, arch,
                                                        mesh_name):
    """Every param of the full-size train state's tree, on a production
    mesh: the spec (divisibility fallback included), the placements that
    carry it, and the per-device bytes, equal to the reference's."""
    sizes, role = MESHES[mesh_name]
    jrules = jdefault_rules("pod" in sizes, role)
    rules = default_rules("pod" in sizes, role)
    assert rules.rules == jrules.rules
    pairs, leaves = full_size_axes[arch]
    want_bytes = got_bytes = 0
    split = 0
    for (path, jax_axes, axes), leaf in zip(pairs, leaves):
        want = tuple(jlogical_spec(Sizes(sizes), jrules, jax_axes,
                                   leaf.shape))
        got = logical_spec(sizes, rules, axes, leaf.shape)
        assert got == want[:len(got)] and not any(want[len(got):]), path
        pl = placements(sizes, rules, axes, leaf.shape)
        itemsize = np.dtype(leaf.dtype).itemsize
        want_bytes += _ref_block_bytes(leaf.shape, want, sizes, itemsize)
        got_bytes += math.prod(pl.local_shape(leaf.shape)) * itemsize
        split += not pl.is_replicated
    assert got_bytes == want_bytes and split > 0
    if mesh_name == "16x16":
        cell = dryrun.run_cell(arch, "train_4k")
        assert cell["param_bytes"] == want_bytes


@pytest.mark.parametrize("arch,shape", (("llama32-3b", "decode_32k"),
                                        ("zamba2-1.2b", "long_500k")))
def test_dryrun_cache_bytes_match_reference(arch, shape):
    """A decode cell's per-device cache bytes: the reference's cache tree,
    axes and specs on the production mesh against the dry-run's; the
    roofline's terms from them."""
    jcfg = jget_config(arch)
    jcfg = jcfg.replace(peft=jcfg.peft.replace(method="none"))
    sizes = make_production_mesh()
    jrules = jmesh.rules_for(jcfg, Sizes(sizes), "decode")
    b, length = JLM_SHAPES[shape].global_batch, JLM_SHAPES[shape].seq_len
    cache = jax.eval_shape(lambda: jmodel.init_cache(jcfg, b, length))
    want = 0
    for (path, axes), leaf in zip(
            _ref_pairs(jmodel.cache_axes(jcfg, cache)), [
                leaf for _, leaf in _ref_pairs(cache)]):
        spec = jlogical_spec(Sizes(sizes), jrules, tuple(axes), leaf.shape)
        want += _ref_block_bytes(leaf.shape, tuple(spec), sizes,
                                 np.dtype(leaf.dtype).itemsize)
    cell = dryrun.run_cell(arch, shape)
    assert cell["cache_bytes"] == want > 0
    terms = roofline.terms(cell)
    assert terms["dominant"] in ("compute", "memory", "collective")
    assert terms["bound_s"] == max(terms["compute_s"], terms["memory_s"],
                                   terms["collective_s"]) > 0


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_rules_for_matches_reference(kind):
    for arch, kv_heads in (("llama32-3b", None), ("llama32-3b", 4),
                           ("deepseek-moe-16b", None)):
        jcfg, cfg = jget_config(arch), get_config(arch)
        if kv_heads:
            jcfg = jcfg.replace(num_kv_heads=kv_heads)
            cfg = cfg.replace(num_kv_heads=kv_heads)
        for multi_pod in (False, True):
            sizes = make_production_mesh(multi_pod=multi_pod)
            want = jmesh.rules_for(jcfg, Sizes(sizes), kind)
            got = rules_for(cfg, sizes, kind)
            assert got.rules == want.rules, (arch, kv_heads, multi_pod)
            if kind != "train" and kv_heads:
                assert got.get("cache_seq") == "model"


@pytest.mark.parametrize("arch", ("llama32-3b", "internvl2-26b",
                                  "seamless-m4t-medium", "mamba2-1.3b"))
def test_input_specs_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert list(LM_SHAPES) == list(JLM_SHAPES)
    for name, shape in LM_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            JLM_SHAPES[name])
        want = jmake_input_specs(jcfg, JLM_SHAPES[name])
        got = make_input_specs(cfg, shape)
        assert list(got) == list(want), name
        for k, v in got.items():
            assert v.is_meta and tuple(v.shape) == want[k].shape, (name, k)
            assert str(v.dtype).replace("torch.", "") == \
                np.dtype(want[k].dtype).name, (name, k)


@pytest.fixture(scope="module")
def moe_layer():
    """Reduced deepseek-moe-16b's MoE layer (PSOFT on every expert stack)
    as numpy params in the reference's structure, and 48 tokens."""
    jcfg = jget_config("deepseek-moe-16b").reduced()
    shapes = jax.eval_shape(lambda k: jmoe.moe_init(
        k, jcfg, jnp.float32, jnp.float32, jcfg.peft.target_modules),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)

    def leaf(kp, s):
        z = rng.standard_normal(s.shape).astype(np.float32)
        name = kp[-1].key
        if name == "q":
            return 0.05 * z
        if name in ("alpha", "beta"):
            return 1 + 0.05 * z
        return z / np.sqrt(s.shape[-2] if len(s.shape) >= 2 else 1)
    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    x = rng.standard_normal((4, 12, jcfg.d_model)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("data", (2, 5))
def test_grouped_capacity_dispatch_matches_reference(moe_layer, data):
    """G = 2 groups, and data = 5, which the reference lowers to 4 groups
    (48 tokens); capacity 0.5 drops tokens within each group."""
    params, x = moe_layer
    cap = 0.5
    jcfg = jget_config("deepseek-moe-16b").reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cap))
    cfg = get_config("deepseek-moe-16b").reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    sizes = {"data": data, "model": 1}
    with jmesh_context(Sizes(sizes), jmesh.rules_for(jcfg, Sizes(sizes))):
        assert jmoe._group_count(48) == (2 if data == 2 else 4)
        fn = jax.jit(lambda p, xx: jmoe.moe_apply(p, xx, jcfg, jnp.float32,
                                                  "capacity"))
        want_y, want_aux = fn(params, x)
    tp = interop.params_from_numpy(params, device="cpu")
    with mesh_context(sizes, rules_for(cfg, sizes)):
        assert moe._group_count(48) == (2 if data == 2 else 4)
        y, aux = moe.moe_apply(tp, torch.from_numpy(x), cfg, torch.float32,
                               "capacity")
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-6)
    # one group gives other rows: the groups change the drops
    y1, _ = moe.moe_apply(tp, torch.from_numpy(x), cfg, torch.float32,
                          "capacity")
    assert not torch.allclose(y1, y)


@pytest.mark.parametrize("arch", ("tiny", "llama32-3b", "starcoder2-15b"))
@pytest.mark.parametrize("method", ("psoft", "oft"))
def test_split_plan_follows_the_reference_fallbacks(arch, method):
    """Every linear's kind on (1, 2), (1, 4), (2, 8) and (16, 16) meshes:
    a column split where the reference's ``logical_spec`` keeps the
    output axis (heads, kv heads, mlp) on ``model``, a row split of o and
    down where it keeps their input axis there (``"gathered_row"`` under a
    method that is not row-separable), replicated under its fallbacks;
    the vocabulary likewise.  starcoder2-15b's 4 kv heads fall back at
    model 8 and 16, llama32-3b's 24 heads at 16."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    cfg = cfg.replace(peft=cfg.peft.replace(method=method))
    jrules = jdefault_rules()
    fallbacks = set()
    for data, m in ((1, 2), (1, 4), (2, 8), (16, 16)):
        sizes = {"data": data, "model": m}
        kinds, vocab = tensor_parallel.plan_linears(cfg, sizes,
                                                    rules_for(cfg, sizes))

        def on_model(name, dim):
            return tuple(jlogical_spec(Sizes(sizes), jrules, (name,),
                                       (dim,)))[:1] == ("model",)
        heads = on_model("heads", jcfg.num_heads)
        kv = heads and on_model("kv_heads", jcfg.num_kv_heads)
        mlp = on_model("mlp", jcfg.d_ff)
        row = "row" if method == "psoft" else "gathered_row"
        assert kinds == {
            "q": "col" if heads else "replicated",
            "k": "col" if kv else "replicated",
            "v": "col" if kv else "replicated",
            "o": row if heads else "replicated",
            "gate": "col" if mlp else "replicated",
            "up": "col" if mlp else "replicated",
            "down": row if mlp else "replicated"}, sizes
        assert vocab == on_model("vocab", jcfg.padded_vocab_size)
        fallbacks.update(k for k in ("q", "k") if kinds[k] == "replicated")
        if arch == "starcoder2-15b" and m >= 8:
            assert kinds["q"] == "col" and kinds["k"] == "replicated"
    if arch == "llama32-3b":
        assert fallbacks == {"q", "k"}


def _linear(method, d_in=64, d_out=32, seed=0):
    """One linear of ``method`` (fp32) with every trainable moved off its
    init, so that a rotation or a norm is not the identity."""
    cfg = get_config("tiny").peft.replace(method=method, rank=4)
    m = registry.get_method(method)
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((d_in, d_out), generator=gen) / d_in ** 0.5
    params = m.init(gen, w, cfg, torch.float32, torch.float32)
    for name in m.trainable_names(cfg):
        t = params[name]
        params[name] = t + 0.1 * torch.randn(t.shape, generator=gen)
    if "m" in params:
        params["m"] = params["m"] * 1.5
    return m, cfg, params


@pytest.mark.parametrize("method", METHODS)
def test_local_views_and_row_separability(method):
    """A rank's view of each method's params: the out axis cut for a
    column split, the in axis for a row split (shapes from the method's
    ``logical_axes``), every cut leaf a view of the whole one.  Column
    halves put together give the whole output for every method; row
    halves' partial outputs sum to the whole exactly where the method
    says it is row-separable, and otherwise cannot be computed from the
    halves (a rotation over the whole input) or sum to something else
    (DoRA's norm over the input dim)."""
    m, cfg, params = _linear(method)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((5, 64), generator=gen)
    whole = m.apply(params, x, cfg, torch.float32)
    in_out = m.logical_axes(cfg, "in", "out")
    cols = []
    for kind, cut, halves in (("col", "out", cols), ("row", "in", None)):
        for r in range(2):
            local = tensor_parallel.local_params(params, m, cfg, kind, r, 2)
            for name, t in local.items():
                full = params[name]
                axes = in_out[name]
                want = list(full.shape)
                if cut in axes:
                    want[axes.index(cut)] //= 2
                    assert t.untyped_storage().data_ptr() == \
                        full.untyped_storage().data_ptr(), (kind, name)
                else:
                    assert t is full, (kind, name)
                assert tuple(t.shape) == tuple(want), (kind, name)
            if halves is not None:
                halves.append(m.apply(local, x, cfg, torch.float32))
    torch.testing.assert_close(torch.cat(cols, -1), whole, rtol=1e-5,
                               atol=1e-5)
    try:
        parts = sum(m.apply(tensor_parallel.local_params(
            params, m, cfg, "row", r, 2), x[:, 32 * r:32 * (r + 1)], cfg,
            torch.float32) for r in range(2))
    except (RuntimeError, ValueError):
        parts = None
    if m.row_separable:
        assert method in ("none", "psoft", "lora", "pissa", "lora_xs")
        torch.testing.assert_close(parts, whole, rtol=1e-5, atol=1e-5)
    else:
        assert method in ("dora", "oft", "boft", "goft", "qgoft")
        assert parts is None or not torch.allclose(parts, whole, atol=1e-3)


@pytest.mark.parametrize("heads,kv_heads,size", ((24, 8, 8), (48, 4, 8),
                                                  (6, 2, 3), (4, 4, 2)))
def test_local_kv_heads_follow_global_head_indices(heads, kv_heads, size):
    """Each rank's q heads attend the kv heads their global indices map
    to, whether a rank holds whole GQA groups (llama32-3b at model 8),
    part of one group (starcoder2-15b at model 8) or heads of two groups
    (6 over 2 at model 3)."""
    from repro_torch.models import attention
    gen = torch.Generator().manual_seed(0)
    group = heads // kv_heads
    k = torch.randn((2, 5, kv_heads, 8), generator=gen)
    v = torch.randn((2, 5, kv_heads, 8), generator=gen)
    q = torch.randn((2, 5, heads, 8), generator=gen)
    whole = attention.chunked_attention(q, k, v)
    local = heads // size
    for r in range(size):
        kr, vr = attention.local_kv_heads(k, v, r * local, local, group)
        got = attention.chunked_attention(
            q[:, :, r * local:(r + 1) * local], kr, vr)
        torch.testing.assert_close(
            got, whole[:, :, r * local:(r + 1) * local], rtol=1e-6,
            atol=1e-6)


def test_dryrun_flops_per_device_follow_the_split():
    """llama32-3b ``train_4k`` on 16x16: its 24 heads fall back at model
    16, so of N_active only the MLP's three linears a layer and the head
    (the vocabulary splits) divide over data x model; attention and the
    norms compute replicated across ``model``, their share of the step's
    FLOPs divided over data only.  A serving cell splits the same way:
    ``decode_32k``'s 128 rows over data, the split share over ``model``;
    its ``model`` collectives are the split's own (``serve_collectives``:
    the down sums, the lookup, the logits gather and, its 8 kv heads not
    dividing over 16, the sequence cache's combine), in bytes a device
    moves."""
    cfg = get_config("llama32-3b")
    sizes = make_production_mesh()
    kinds, vocab = tensor_parallel.plan_linears(cfg, sizes,
                                                rules_for(cfg, sizes))
    assert kinds["q"] == "replicated" and kinds["up"] == "col" and vocab
    n_active = dryrun.model_param_stats("llama32-3b")["N_active"]
    split = cfg.num_layers * 3 * cfg.d_model * cfg.d_ff \
        + cfg.padded_vocab_size * cfg.d_model
    cell = dryrun.run_cell("llama32-3b", "train_4k")
    assert cell["split_share"] == pytest.approx(split / n_active, rel=1e-12)
    want = cell["model_flops"] / sizes["data"] * (
        split / n_active / sizes["model"] + 1 - split / n_active)
    assert cell["flops_per_device"] == pytest.approx(want, rel=1e-12)
    assert cell["flops_per_device"] > cell["model_flops"] / math.prod(
        sizes.values())
    serve = dryrun.run_cell("llama32-3b", "decode_32k")
    assert serve["split_share"] == cell["split_share"]
    assert serve["flops_per_device"] == pytest.approx(
        serve["model_flops"] / sizes["data"] * (
            split / n_active / sizes["model"] + 1 - split / n_active),
        rel=1e-12)
    n = sizes["model"]
    tags = tensor_parallel.serve_collectives(
        cfg, kinds, vocab, "cache_seq", n, 128 // sizes["data"], 1, True)
    assert serve["cache_split"] == "cache_seq"
    assert ("seq_sum", 8 * cfg.num_heads * (cfg.resolved_head_dim + 1)) \
        in tags
    act = 2
    want = sum((n - 1) * e * act if t in ("logits", "gather_from", "seq_q")
               else 2 * (n - 1) / n * e * (4 if t.startswith("seq_")
                                           else act) for t, e in tags)
    assert serve["collective_bytes"]["model"] == pytest.approx(want,
                                                               rel=1e-12)


@pytest.mark.parametrize("arch,model_size,cache,experts", (
    ("llama32-3b", 2, "kv_heads", None),
    ("llama32-3b", 3, "cache_seq", None),
    ("deepseek-moe-16b", 2, "kv_heads", "split"),
    ("deepseek-moe-16b", 16, "kv_heads", "split"),
    ("starcoder2-15b", 16, "cache_seq", None)))
def test_serving_plan_follows_the_reference_cache_rules(arch, model_size,
                                                        cache, experts):
    """The serving split's plan under ``rules_for(cfg, mesh, "decode")``:
    the cache splits over kv heads where they divide and over its
    sequence where they do not, as the reference's ``cache_axes`` under
    its rules put the K/V buffers (its ``logical_spec`` of
    ("batch", "cache_seq", "kv_heads", None)); llama32-3b on 3 ranks keeps
    its MLP (8192 columns) replicated while its 128256-row vocabulary
    splits; deepseek-moe-16b's 64 experts and its shared experts' MLP
    (2 x 1408 columns) split."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    sizes = {"data": 1, "model": model_size}
    rules = rules_for(cfg, sizes, "decode")
    kinds, vocab = tensor_parallel.plan_linears(cfg, sizes, rules)
    assert tensor_parallel.cache_layout(cfg, sizes, rules, kinds) == cache
    spec = tuple(jlogical_spec(
        Sizes(sizes), jmesh.rules_for(jcfg, Sizes(sizes), "decode"),
        ("batch", "cache_seq", "kv_heads", None),
        (1, 4096 * model_size, jcfg.num_kv_heads, jcfg.resolved_head_dim)))
    assert spec[1 if cache == "cache_seq" else 2] == "model"
    assert kinds.get("expert") == experts
    if arch == "llama32-3b" and model_size == 3:
        assert (kinds["q"], kinds["k"], kinds["up"], vocab) == \
            ("col", "replicated", "replicated", True)
    if experts:
        assert (kinds["shared_up"], kinds["shared_down"]) == ("col", "row")
    # the train rules keep the cache whole where the kv heads do not
    # divide: a split decode refuses that layout
    train = rules_for(cfg, sizes, "train")
    if cache == "cache_seq":
        assert tensor_parallel.cache_layout(
            cfg, sizes, train, tensor_parallel.plan_linears(
                cfg, sizes, train)[0]) is None


def test_split_serving_refuses_what_it_does_not_split():
    """A split ``prefill`` / ``decode_step`` serves the base model over
    the dense cache: an adapter bank (``adapter_ids``), paged pools, a
    cache the plan leaves whole and a sequence split ``max_len`` does not
    divide raise ``ValueError`` before any collective runs."""
    cfg = get_config("tiny")
    params = model.init_params(cfg, device="cpu")
    kinds, vocab = tensor_parallel.plan_linears(cfg, {"model": 2},
                                                rules_for(cfg, {"model": 2}))

    def split(cache):
        return tensor_parallel.TensorParallel(
            None, 0, 2, kinds, vocab, cfg.num_heads, cfg.num_kv_heads,
            cfg.padded_vocab_size, 0, cache)
    toks = {"tokens": torch.zeros((2, 4), dtype=torch.long)}
    ids = torch.zeros((2,), dtype=torch.long)
    with pytest.raises(ValueError, match="adapter bank"):
        model.prefill(params, toks, cfg, 16, adapter_ids=ids,
                      tp=split("kv_heads"))
    pools = model.init_cache(cfg, 2, 16, page_size=16, device="cpu")
    pools["page_table"] = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="paged pools"):
        model.decode_step(params, {"tokens": toks["tokens"][:, :1]}, pools,
                          4, cfg, tp=split("kv_heads"))
    with pytest.raises(ValueError, match="paged pools"):
        model.init_cache(cfg, 2, 16, page_size=16, device="cpu",
                         tp=split("kv_heads"))
    with pytest.raises(ValueError, match="'decode'"):
        model.init_cache(cfg, 2, 16, device="cpu", tp=split(None))
    with pytest.raises(ValueError, match="multiple"):
        model.init_cache(cfg, 2, 15, device="cpu", tp=split("cache_seq"))
    assert model.init_cache(cfg, 2, 16, device="cpu", tp=split(
        "cache_seq"))["k"].shape == (cfg.num_layers, 2, 8, 4, 32)
    assert model.init_cache(cfg, 2, 16, device="cpu", tp=split(
        "kv_heads"))["k"].shape == (cfg.num_layers, 2, 16, 2, 32)


def test_expert_paths_are_reached_summed_and_kept():
    """An MoE layer's leaves in the split: the expert stacks are module
    ``"expert"`` (their gradients summed over ``model`` and their frozen
    leaves kept split there when the experts split), the shared experts'
    linears their own modules, the router none."""
    kinds, vocab = tensor_parallel.plan_linears(
        get_config("deepseek-moe-16b"), {"model": 2},
        rules_for(get_config("deepseek-moe-16b"), {"model": 2}))
    expert = ("layers", "moe", "up", "w_res")
    shared = ("layers", "moe", "shared", "down", "alpha")
    router = ("layers", "moe", "router", "w")
    assert tensor_parallel.reached_module(expert) == "expert"
    assert tensor_parallel.reached_module(shared) == "shared_down"
    assert tensor_parallel.reached_module(router) is None
    assert tensor_parallel.grad_summed(kinds, vocab, expert)
    assert tensor_parallel.grad_summed(kinds, vocab, shared)
    assert not tensor_parallel.grad_summed(kinds, vocab, router)
    assert tensor_parallel.kept_axes(vocab, expert, True) == ("model",)
    assert tensor_parallel.kept_axes(vocab, expert, False) == ()
    assert tensor_parallel.kept_axes(vocab, shared, True) == ()
