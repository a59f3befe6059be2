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
    axes and specs on the production mesh against the dry-run's, except
    a split Mamba2 layer's ``conv_state``, whose last axis a rank holds as
    the port computes from it (its ``[x_r, B_g, C_g]`` channels, not the
    spec's even cut of ``conv_ch``); the roofline's terms from them."""
    from repro_torch.models import ssm
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
        shape_ = leaf.shape
        if path[-1] == "conv_state":
            assert tuple(spec)[-1] == "model"
            spec = tuple(spec)[:-1] + (None,)
            shape_ = shape_[:-1] + (ssm.split_dims(
                get_config(arch), 0, sizes["model"])["conv_ch"],)
        want += _ref_block_bytes(shape_, tuple(spec), sizes,
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


def _mixer_tp(cfg, sizes, rank):
    """A serving split's plan of ``cfg`` on the size-only mesh ``sizes``
    as rank ``rank`` sees it (no process group: the tests run the
    collectives by hand)."""
    kinds, vocab = tensor_parallel.plan_linears(
        cfg, sizes, rules_for(cfg, sizes, "decode"), serving=True)
    rules = rules_for(cfg, sizes, "decode")
    return tensor_parallel.TensorParallel(
        None, rank, sizes["model"], kinds, vocab, cfg.num_heads,
        cfg.num_kv_heads, cfg.padded_vocab_size, 0,
        tensor_parallel.cache_layout(cfg, sizes, rules, kinds))


@pytest.mark.parametrize("arch", ("mamba2-1.3b", "zamba2-1.2b"))
@pytest.mark.parametrize("reduced", (False, True))
def test_mixer_split_falls_back_where_its_heads_do_not_divide(arch,
                                                              reduced):
    """On 3 ranks neither model's SSM heads (64 at full width, 8 reduced)
    divide, so a serving plan leaves ``in_proj`` and ``out_proj``
    replicated, as the reference's ``logical_spec`` leaves its ``heads``
    off ``model``, and every rank holds the Mamba2 states whole; on 2
    ranks the mixer splits (``"row"`` out_proj under PSOFT)."""
    from repro_torch.models import ssm
    cfg, jcfg = get_config(arch), jget_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    heads = ssm.ssm_dims(cfg)["heads"]
    for m, split in ((3, False), (2, True)):
        sizes = {"data": 1, "model": m}
        tp = _mixer_tp(cfg, sizes, 0)
        on_model = tuple(jlogical_spec(
            Sizes(sizes), jmesh.rules_for(jcfg, Sizes(sizes), "decode"),
            ("heads",), (heads,)))[:1] == ("model",)
        assert tp.mixer == split == on_model
        assert (tp.kinds["in_proj"], tp.kinds["out_proj"]) == (
            ("col", "row") if split else ("replicated", "replicated"))
        if not reduced:
            continue
        cache = model.init_cache(cfg, 2, 48, device="meta", tp=tp)
        whole = model.init_cache(cfg, 2, 48, device="meta")
        states = [(a.shape, b.shape) for (pa, a), (_, b) in zip(
            tree_leaves_with_path(cache), tree_leaves_with_path(whole))
            if pa[-1] in ("conv_state", "ssm_state")]
        assert states and all((a == b) != split for a, b in states)


def test_train_plan_leaves_the_mixer_replicated():
    """A training plan has no kind for the Mamba2 mixer (the reference
    computes it replicated in the step): the train step's split, its
    collectives and its gradient sums are as before; the mixer's leaves
    are its modules, whose gradients a serving plan (which trains
    nothing) would also leave whole on the replicated fallback."""
    cfg = get_config("mamba2-1.3b").reduced()
    sizes = {"data": 1, "model": 2}
    train, vocab = tensor_parallel.plan_linears(cfg, sizes,
                                                rules_for(cfg, sizes))
    serve, _ = tensor_parallel.plan_linears(
        cfg, sizes, rules_for(cfg, sizes, "decode"), serving=True)
    assert "in_proj" not in train and "out_proj" not in train
    assert {k: v for k, v in serve.items()
            if k not in tensor_parallel.MIXER} == train
    for leaf, module in ((("layers", "ssm", "in_proj", "w_res"), "in_proj"),
                         (("layers", "ssm", "out_proj", "alpha"), "out_proj"),
                         (("layers", "ssm", "conv_w"), None),
                         (("layers", "3", "ssm", "in_proj", "q"), "in_proj")):
        assert tensor_parallel.reached_module(leaf) == module
        assert not tensor_parallel.grad_summed(train, vocab, leaf)
    assert tensor_parallel.step_collectives(
        cfg, train, vocab, 2, 4, 32) == tensor_parallel.step_collectives(
        cfg, serve, vocab, 2, 4, 32)


def _two_rank_block(monkeypatch, cfg, params, u, size):
    """The split Mamba2 block's prefill and one decode step on each of
    ``size`` ranks run one after the other in this process, its
    collectives taken over three passes: each pass records every rank's
    inputs and hands each rank the sums (the norm's) and concatenations
    (a ``"gathered_row"`` out_proj's input, which depends on the norm's
    sum) of the last pass's; ``out_proj``'s partial rows are summed here.
    Returns (the outputs, each rank's state blocks after the decode step,
    each rank's plan)."""
    from repro_torch.distributed import collectives
    from repro_torch.models import ssm
    sizes = {"data": 1, "model": size}
    tps = [_mixer_tp(cfg, sizes, r) for r in range(size)]

    def run(last):
        outs, caches, calls = [], [], {}
        for r, tp in enumerate(tps):
            seen = calls.setdefault(r, [])

            def take(t):
                seen.append(t.clone())
                return [last[q][len(seen) - 1] for q in range(size)] \
                    if last else [t] * size

            def all_reduce(t, mesh, axes, *args, tag="", **kw):
                assert tag == "ssm_norm"
                return t.copy_(sum(take(t)))

            def gather_from(x, mesh, axis, dim):
                return torch.cat(take(x), dim)
            monkeypatch.setattr(collectives, "all_reduce", all_reduce)
            monkeypatch.setattr(collectives, "gather_from", gather_from)
            monkeypatch.setattr(collectives, "reduce_from",
                                lambda y, mesh, axis: y)
            local = ssm.local_mixer(params, cfg, tp)
            y, cache = ssm.mamba_block_apply(local, u, cfg, torch.float32,
                                             True, tp=tp)
            y1, cache = ssm.mamba_block_decode(local, u[:, -1:], cache, cfg,
                                               torch.float32, tp=tp)
            outs.append(torch.cat([y, y1], 1))
            caches.append(cache)
        return outs, caches, calls
    calls = None
    for _ in range(3):
        outs, caches, calls = run(calls)
    out = sum(outs) if tps[0].kinds["out_proj"] == "row" else outs[0]
    return out, caches, tps


@pytest.mark.parametrize("method", ("psoft", "dora"))
def test_mixer_split_reads_each_ranks_own_group(monkeypatch, method):
    """Reduced mamba2-1.3b with ``ngroups = 2`` on (1, 2): each rank's 4
    heads read its own group of B and C (its columns of ``in_proj`` and
    channels of the conv), and the two ranks' prefill and decode step,
    their norm sums and out_proj rows summed (PSOFT's ``"row"``; DoRA's
    norm over the input makes out_proj ``"gathered_row"``: every rank
    computes it whole from the gathered input), equal the unsharded block
    within 1e-5, their state blocks gathered the whole states."""
    from repro_torch.models import ssm
    cfg = get_config("mamba2-1.3b").reduced()
    cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, ngroups=2),
                      peft=cfg.peft.replace(method=method))
    params = model.init_params(cfg, seed=3, device="cpu")
    lp = {k: v[0] if torch.is_tensor(v) else {n: t[0] for n, t in v.items()}
          for k, v in params["layers"]["ssm"].items()}
    gen = torch.Generator().manual_seed(4)
    m_ = registry.get_method(method)
    for name in m_.trainable_names(cfg.peft):
        for m in ("in_proj", "out_proj"):
            t = lp[m][name]
            lp[m][name] = t + 0.05 * torch.randn(t.shape, generator=gen)
    lp["dt_bias"] = 0.3 * torch.randn(lp["dt_bias"].shape, generator=gen)
    u = torch.randn((2, 32, cfg.d_model), generator=gen)
    y, cache = ssm.mamba_block_apply(lp, u, cfg, torch.float32, True)
    y1, cache = ssm.mamba_block_decode(lp, u[:, -1:], cache, cfg,
                                       torch.float32)
    got, blocks, tps = _two_rank_block(monkeypatch, cfg, lp, u, 2)
    assert tps[0].kinds["out_proj"] == (
        "row" if method == "psoft" else "gathered_row")
    d = ssm.ssm_dims(cfg)
    for r, tp in enumerate(tps):
        local = ssm.split_dims(cfg, r, 2)
        assert (local["heads"], local["g"], local["group0"]) == (4, 1, r)
        gn = d["g"] * d["n"]
        cols = ssm.in_proj_columns(cfg, r, 2).tolist()
        bc = [c - 2 * d["d_inner"] for c in cols
              if 2 * d["d_inner"] <= c < 2 * d["d_inner"] + 2 * gn]
        assert bc == list(range(r * d["n"], (r + 1) * d["n"])) + list(
            range(gn + r * d["n"], gn + (r + 1) * d["n"]))
    torch.testing.assert_close(got, torch.cat([y, y1], 1), rtol=1e-5,
                               atol=1e-5)
    whole = ssm.gather_state_blocks(cfg, blocks)
    for k in ("conv_state", "ssm_state"):
        torch.testing.assert_close(whole[k], cache[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ("mamba2-1.3b", "zamba2-1.2b"))
def test_dryrun_serving_cells_split_the_mixer(arch):
    """``decode_32k`` on 16x16: the mixer splits (64 heads, 4 a rank), so
    ``split_share`` counts out_proj whole and in_proj at its z, x and dt
    columns (B and C, one group, every rank computes), above the train
    cell's share, which leaves the mixer replicated; ``cache_bytes`` is
    the layout the port holds, a device's rows of the rank's heads of
    ``ssm_state`` and its ``[x_r, B, C]`` conv channels (plus zamba2's
    attention K/V, 2 of 32 kv heads a rank); a rank's in_proj is 772
    columns, which ``psoft_matmul`` runs on ``"wmma"`` (a row pitch of
    1544 bytes is no multiple of 16: TMA cannot read it), and 4384 /
    4256 on (1, 2), on ``"wgmma"``."""
    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    cfg = get_config(arch)
    sizes = make_production_mesh()
    n = sizes["model"]
    d, local = ssm.ssm_dims(cfg), ssm.split_dims(cfg, 0, n)
    share = dryrun.in_proj_share(cfg, n)
    assert share == pytest.approx((2 * d["d_inner"] + d["heads"])
                                  / d["in_proj_out"], rel=1e-12)
    serve = dryrun.run_cell(arch, "decode_32k")
    train = dryrun.run_cell(arch, "train_4k")
    n_active = dryrun.model_param_stats(arch)["N_active"]
    kinds, vocab = tensor_parallel.plan_linears(
        cfg, sizes, rules_for(cfg, sizes, "decode"), serving=True)
    assert tensor_parallel.mixer_splits(cfg, sizes, rules_for(
        cfg, sizes, "decode")) and kinds["in_proj"] == "col"
    merged = model.abstract_params(cfg.replace(
        peft=cfg.peft.replace(method="none")))
    mixer = sum(t.numel() * (share if p[-2] == "in_proj" else 1.0)
                for p, t in tree_leaves_with_path(merged)
                if p[-2:-1] in (("in_proj",), ("out_proj",)))
    assert serve["split_share"] == pytest.approx(
        train["split_share"] + mixer / n_active, rel=1e-9)
    rows = LM_SHAPES["decode_32k"].global_batch // sizes["data"]
    layers = cfg.layer_pattern().count("M")
    states = layers * rows * (
        (cfg.ssm.conv_width - 1) * local["conv_ch"] * 2
        + local["heads"] * d["n"] * cfg.ssm.head_dim * 4)
    assert local["conv_ch"] == d["d_inner"] // n + 2 * d["n"]
    attn = (cfg.num_layers - layers) * rows * 2 * 32768 * (
        cfg.num_kv_heads // n) * cfg.resolved_head_dim * 2
    assert serve["cache_bytes"] == states + attn
    cols = {m: ssm.split_dims(cfg, 0, m)["in_proj_out"] for m in (2, n)}
    assert cols[n] == (772 if arch == "mamba2-1.3b" else 644)
    assert cols[2] == (4384 if arch == "mamba2-1.3b" else 4256)
    assert ops._psoft_engine(torch.bfloat16, cfg.d_model, cols[n], 64,
                             (0, 0, 0)) == "wmma"
    assert ops._psoft_engine(torch.bfloat16, cfg.d_model, cols[2], 64,
                             (0, 0, 0)) == "wgmma"
