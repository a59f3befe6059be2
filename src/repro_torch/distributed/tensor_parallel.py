"""The compute split over the ``model`` mesh axis: head-, MLP-, vocab- and
expert-parallel training in the sharded train step, and split ``prefill``
and ``decode_step``.

The reference's rules send ``heads``, ``kv_heads``, ``mlp``, ``vocab`` and
``expert`` to ``model``, and its model code constrains activations to
them (``shard_act``), so XLA has each ``model`` rank compute its heads of
attention, its columns of the MLP, its slice of the vocabulary and its
experts, and sum the partial row products.  The port makes the same split
by hand.  Each linear of an attention block (self and cross attention, the
dense MLP, an MoE layer's shared experts) is planned as one of
:data:`KINDS`:

- ``"col"``: q, k, v, gate, up: the rank computes its output columns from
  the whole (replicated) input, which :func:`collectives.copy_to` hands
  in once per block input, so that the backward sums the ranks' partial
  input gradients;
- ``"row"``: o, down: the rank's input columns times the weight's rows,
  summed over ranks by :func:`collectives.reduce_from`;
- ``"gathered_row"``: o or down under a method whose ``apply`` does not
  split along its input (``PEFTMethod.row_separable``: DoRA's norm, the
  OFT family's rotations); the input is all-gathered over ``model``
  (:func:`collectives.gather_from`) and every rank computes the whole
  output;
- ``"replicated"``: every rank computes the whole output, as without a
  split.

An MoE layer's expert stacks are ``"split"`` (module ``"expert"``) when
``expert`` lands on ``model``: every rank routes and dispatches every
token, as without a split, runs only its E / n experts' rows through its
slices of the stacks (one grouped launch set a stack at G = E / n, the
rotations of its experts only), and the ranks' partial outputs are summed
over ``model`` (:func:`collectives.reduce_from`).  A sum of (tokens,
d_model) moves less than a gather of the expert outputs along the expert
axis (top-k times the capacity factor times more rows).  In the backward
the expert path's input gradient and the combine's gate gradient are
partial on each rank, and go through :func:`collectives.copy_to`: the
buffer's gradient is summed as the dispatch input's (tokens, d_model),
which the buffer's rows gather back to.  The shared experts' MLP
(``"shared_gate"``, ``"shared_up"``, ``"shared_down"``) is planned like a
dense MLP at its own width.

The plan comes from the rules and the dims through ``logical_spec``, so
the divisibility fallback decides it as in the reference: kv heads that
the ``model`` size does not divide leave k and v replicated, and each rank
attends its q heads to the kv heads those heads map to by their global
indices (:func:`repro_torch.models.attention.local_kv_heads`).  The
embedding and the head split over vocabulary rows when ``vocab`` does:
the lookup masks the ids outside the rank's rows and sums over ranks, and
the loss is a vocab-parallel cross-entropy (:func:`vocab_parallel_ce`);
a split serving step gathers its logits over ``model`` (the reference's
``out_shardings=None``).

A serving split also lays out the dense decode cache (:data:`CACHES`),
as ``cache_axes`` places it under ``rules_for(cfg, mesh, "decode")``:
over ``"kv_heads"`` (a rank holds KH / n heads of every K/V buffer and
decodes its heads as without a split), or, when the kv heads do not
divide, over ``"cache_seq"`` (a rank holds every kv head at max_len / n
positions; the owner of a position writes it, each rank attends every q
head over its positions with the paged-decode kernel's log-sum-exp, and
the ranks combine the partial softmaxes).

A serving split (``plan(..., serving=True)``, the default) also splits the
Mamba2 mixer over its SSM heads where the rules send ``heads`` to
``model`` and the heads divide (the reference's ``cache_axes`` puts
``ssm_state`` on ``heads`` and ``conv_state`` on ``conv_ch``, both on
``model``): ``"in_proj"`` is ``"col"``, a column *set* (the rank's z, x
and dt heads and the B and C channels of the groups its heads read), and
``"out_proj"`` is ``"row"`` (``"gathered_row"`` under a method that is not
row-separable); the gated norm over the whole ``d_inner`` sums each rank's
fp32 sum of squares over ``model`` (tag ``"ssm_norm"``), and each rank
holds its heads of both decode states
(:func:`repro_torch.models.ssm.split_dims`).  Where the heads do not
divide, or the groups neither divide over the ranks nor the ranks over
the groups, both stay ``"replicated"`` and every rank holds the states
whole.  A training plan leaves the mixer and the hybrid's ``fuse``
replicated, as the reference computes them.

The frozen weights keep the reference's layout (split over ``data``, not
over ``model``), so the state, its shardings and its checkpoints do not
change: a rank computes from its slice of each whole linear
(:func:`local_params`: views, no copies); only the embedding, the head
and the expert stacks, whose state the rules split over ``model``, keep
their own rows instead of being gathered (:func:`kept_axes`).  A
trainable gradient is partial on each rank where the plan splits the
compute that uses it (:func:`grad_summed`), and the step sums those over
``model`` too.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import registry
from repro_torch.distributed import collectives
from repro_torch.sharding import logical_spec, mesh_shape

#: the mesh axis the compute splits over
AXIS = "model"
KINDS = ("col", "row", "gathered_row", "replicated")
#: column-split linears and the logical axis of their output split
COL_MODULES = {"q": "heads", "k": "kv_heads", "v": "kv_heads",
               "gate": "mlp", "up": "mlp"}
#: row-split linears and the logical axis of their input split
ROW_MODULES = {"o": "heads", "down": "mlp"}
#: the subtrees whose linears the split reaches, by parent name
REACHED = {"attn": ("q", "k", "v", "o"), "cross": ("q", "k", "v", "o"),
           "mlp": ("gate", "up", "down")}
#: an MoE layer's expert stacks and its shared experts' MLP, by name
EXPERT_LINEARS = ("up", "down", "gate")
SHARED = {m: "shared_" + m for m in ("gate", "up", "down")}
#: the leaves that keep their vocabulary rows (not gathered over ``model``)
VOCAB_LEAVES = (("embed", "w"), ("lm_head", "w"))
#: the families with Mamba2 mixers, and the mixer's linears
MIXER_FAMILIES = ("ssm", "hybrid")
MIXER = ("in_proj", "out_proj")
#: the decode cache's layouts under a serving split: a rank's kv heads of
#: every position, or every kv head of its positions
CACHES = ("kv_heads", "cache_seq")
#: stand-ins for a method's in and out axes, to find its params' dims
_IN, _OUT = "tp_in", "tp_out"


def _splits(mesh, rules, name: str, dim: int) -> bool:
    return logical_spec(mesh, rules, (name,), (dim,))[0] == AXIS


def _mlp_kinds(cfg, split: bool, names: Mapping[str, str]
               ) -> Dict[str, str]:
    def row(module):
        method = registry.get_method(cfg.peft.method_for(module))
        return "row" if method.row_separable else "gathered_row"
    return {names["gate"]: "col" if split else "replicated",
            names["up"]: "col" if split else "replicated",
            names["down"]: row("down") if split else "replicated"}


def mixer_splits(cfg, mesh, rules) -> bool:
    """Whether a serving split of ``cfg`` (an SSM or hybrid config) on
    ``mesh`` under ``rules`` splits the Mamba2 mixer over its SSM heads:
    ``heads`` lands on ``model`` for ``d_inner / head_dim`` heads, and each
    rank's heads read whole groups of B and C (the groups divide over the
    ranks, or the ranks over the groups)."""
    if cfg.family not in MIXER_FAMILIES:
        return False
    heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    size = mesh_shape(mesh).get(AXIS, 1)
    g = cfg.ssm.ngroups
    return _splits(mesh, rules, "heads", heads) and (
        g % size == 0 or size % g == 0)


def plan_linears(cfg, mesh, rules, serving: bool = False
                 ) -> Tuple[Dict[str, str], bool]:
    """(module -> kind for q, k, v, o, gate, up and down, whether the
    vocabulary splits) of ``cfg`` on ``mesh`` (a live mesh or a size
    mapping) under ``rules``; an MoE config adds ``"expert"`` (``"split"``
    or ``"replicated"``) and, with shared experts, ``"shared_gate"``,
    ``"shared_up"`` and ``"shared_down"``, planned like a dense MLP of
    their width; a ``serving`` plan of an SSM or hybrid config adds the
    Mamba2 mixer's ``"in_proj"`` (``"col"``: a column set) and
    ``"out_proj"`` (a row split), both ``"replicated"`` where
    :func:`mixer_splits` does not hold."""
    heads = _splits(mesh, rules, "heads", cfg.num_heads)
    kv = heads and _splits(mesh, rules, "kv_heads", cfg.num_kv_heads)
    kinds = {"q": "col" if heads else "replicated",
             "k": "col" if kv else "replicated",
             "v": "col" if kv else "replicated"}
    method = registry.get_method(cfg.peft.method_for("o"))
    kinds["o"] = ("row" if method.row_separable else "gathered_row") \
        if heads else "replicated"
    kinds.update(_mlp_kinds(cfg, _splits(mesh, rules, "mlp", cfg.d_ff),
                            {m: m for m in SHARED}))
    if cfg.family == "moe":
        kinds["expert"] = "split" if _splits(
            mesh, rules, "expert", cfg.moe.num_experts) else "replicated"
        if cfg.moe.num_shared_experts > 0:
            width = cfg.moe.num_shared_experts * cfg.d_ff
            kinds.update(_mlp_kinds(cfg, _splits(mesh, rules, "mlp", width),
                                    SHARED))
    if serving and cfg.family in MIXER_FAMILIES:
        mixer = mixer_splits(cfg, mesh, rules)
        method = registry.get_method(cfg.peft.method_for("out_proj"))
        kinds["in_proj"] = "col" if mixer else "replicated"
        kinds["out_proj"] = ("row" if method.row_separable
                             else "gathered_row") if mixer else "replicated"
    return kinds, _splits(mesh, rules, "vocab", cfg.padded_vocab_size)


def cache_layout(cfg, mesh, rules, kinds: Mapping[str, str]
                 ) -> Optional[str]:
    """The decode cache's split (:data:`CACHES`) of ``cfg`` on ``mesh``
    under ``rules`` and the linears' ``kinds``: ``"kv_heads"`` where k and
    v split over heads, ``"cache_seq"`` where the rules send the cache's
    sequence to ``model`` (``rules_for(cfg, mesh, "decode")`` does when
    the kv heads do not divide), None otherwise (a cache every rank holds
    whole, which a split decode refuses)."""
    if kinds["k"] == "col":
        return "kv_heads"
    if logical_spec(mesh, rules, ("cache_seq",))[0] == AXIS:
        return "cache_seq"
    return None


def local_params(params: Dict[str, torch.Tensor], method, peft_cfg,
                 kind: str, rank: int, size: int) -> Dict[str, torch.Tensor]:
    """This rank's view of one linear's params (slices of the leaves, no
    copies): for ``"col"`` the out axis of every param that has one is
    cut, for ``"row"`` the in axis; a leaf's dims are read from its
    method's ``logical_axes`` (counted from the last, so a layer's slice
    of a stack works); everything else comes back whole."""
    if kind not in ("col", "row"):
        return params
    axes = method.logical_axes(peft_cfg, _IN, _OUT)
    cut = _OUT if kind == "col" else _IN
    out = {}
    for name, t in params.items():
        ax = axes.get(name)
        if ax is None or cut not in ax:
            out[name] = t
            continue
        d = t.ndim - len(ax) + ax.index(cut)
        chunk = t.shape[d] // size
        out[name] = t.narrow(d, rank * chunk, chunk)
    return out


def column_set(params: Dict[str, torch.Tensor], method, peft_cfg,
               index: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One linear's params with the out axis of every param that has one
    cut to the columns ``index`` (a copy: a column set is not one block),
    the rest whole; dims as in :func:`local_params`."""
    axes = method.logical_axes(peft_cfg, _IN, _OUT)
    out = {}
    for name, t in params.items():
        ax = axes.get(name)
        if ax is None or _OUT not in ax:
            out[name] = t
            continue
        out[name] = t.index_select(t.ndim - len(ax) + ax.index(_OUT), index)
    return out


@dataclass(frozen=True)
class TensorParallel:
    """The split of one sharded step or serving call: the live mesh, this
    rank's coordinate on :data:`AXIS` and its size, the linears' kinds
    (:func:`plan_linears`), the config's head, vocabulary and expert
    sizes, and the decode cache's layout (:func:`cache_layout`)."""
    mesh: Any
    rank: int
    size: int
    kinds: Mapping[str, str]
    vocab: bool
    num_heads: int
    num_kv_heads: int
    vocab_size: int
    num_experts: int = 0
    cache: Optional[str] = None

    def copy_in(self, x: torch.Tensor, modules: Sequence[str]
                ) -> torch.Tensor:
        """``x`` through :func:`collectives.copy_to` when any of
        ``modules`` (the consumers of one block input) is column-split."""
        if any(self.kinds[m] == "col" for m in modules):
            return collectives.copy_to(x, self.mesh, AXIS)
        return x

    def local_heads(self) -> Tuple[int, int]:
        """(q heads, kv heads) this rank's q and k linears output."""
        h, kh = self.num_heads, self.num_kv_heads
        if self.kinds["q"] == "col":
            h //= self.size
        if self.kinds["k"] == "col":
            kh //= self.size
        return h, kh

    def apply(self, method, params, x, peft_cfg, compute_dtype,
              module: str) -> torch.Tensor:
        """One planned linear: its method's ``apply`` on this rank's view,
        the input gathered first for ``"gathered_row"``, the partial
        output summed over ranks for ``"row"``."""
        kind = self.kinds[module]
        if kind == "gathered_row":
            x = collectives.gather_from(x, self.mesh, AXIS, -1)
        local = local_params(params, method, peft_cfg, kind, self.rank,
                             self.size)
        y = method.apply(local, x, peft_cfg, compute_dtype)
        if kind == "row":
            y = collectives.reduce_from(y, self.mesh, AXIS)
        return y

    def vocab_block(self, w: torch.Tensor, dim: int
                    ) -> Tuple[torch.Tensor, int]:
        """(this rank's vocabulary rows of ``w`` along ``dim``, the first
        row's global id): a whole table (a trainable gathered for the
        step) is sliced, a block the state holds split comes as it is."""
        rows = self.vocab_size // self.size
        if w.shape[dim] == self.vocab_size:
            w = w.narrow(dim, self.rank * rows, rows)
        return w, self.rank * rows

    @property
    def mixer(self) -> bool:
        """Whether the Mamba2 mixer and its decode states split over
        :data:`AXIS` (a serving plan only)."""
        return self.kinds.get("in_proj") == "col"

    @property
    def experts(self) -> bool:
        """Whether the expert stacks split over :data:`AXIS`."""
        return self.kinds.get("expert") == "split"

    def expert_range(self) -> Tuple[int, int]:
        """(first expert, experts) this rank computes."""
        if not self.experts:
            return 0, self.num_experts
        n = self.num_experts // self.size
        return self.rank * n, n

    def local_experts(self, layers, dim: int = 1):
        """``layers`` (a stacked layer tree: expert dim ``dim``) with each
        MoE expert stack's leaves cut to this rank's experts: a whole stack
        (a trainable gathered for the step, or a tree every rank holds) is
        sliced (views), a block the state holds split comes as it is."""
        if not self.experts:
            return layers
        first, n = self.expert_range()

        def cut(t):
            if t.shape[dim] == n:
                return t
            if t.shape[dim] != self.num_experts:
                raise ValueError(f"expert stack of shape {tuple(t.shape)}: "
                                 f"dim {dim} is neither {self.num_experts} "
                                 f"nor {n} experts")
            return t.narrow(dim, first, n)
        moe = dict(layers["moe"])
        for m in EXPERT_LINEARS:
            if m in moe:
                moe[m] = {k: cut(v) for k, v in moe[m].items()}
        return {**layers, "moe": moe}

    def for_shared(self) -> "TensorParallel":
        """This split with the shared experts' kinds as gate, up and
        down, for ``mlp_apply`` of the shared MLP."""
        kinds = dict(self.kinds)
        for m, name in SHARED.items():
            kinds[m] = self.kinds.get(name, "replicated")
        return replace(self, kinds=kinds)

    def grad_summed(self, path: Tuple[str, ...]) -> bool:
        """:func:`grad_summed` under this split."""
        return grad_summed(self.kinds, self.vocab, path)


def grad_summed(kinds: Mapping[str, str], vocab: bool,
                path: Tuple[str, ...]) -> bool:
    """Whether the gradient of the trainable leaf at ``path`` is partial
    on each rank under ``kinds`` and ``vocab`` (the compute that uses it
    is split), so that the step sums it over :data:`AXIS`: the leaves of a
    column- or row-split linear, of replicated k and v whose outputs feed
    split q heads, of a split expert stack (each rank's gradient is zero
    outside its experts), and a trained embedding or head split over the
    vocabulary.  A ``"gathered_row"`` or replicated linear's gradient is
    whole on every rank."""
    if tuple(path[:1]) in (("embed",), ("lm_head",)):
        return vocab
    module = reached_module(path)
    if module == "expert":
        return kinds.get("expert") == "split"
    return module is not None and (kinds.get(module) in ("col", "row") or (
        module in ("k", "v") and kinds["q"] == "col"))


def reached_module(path: Tuple[str, ...]) -> Optional[str]:
    """The module of the split that the leaf at ``path`` belongs to: q, k,
    v, o, gate, up or down of an attention block or a dense MLP
    (:data:`REACHED`), ``"shared_gate"``, ``"shared_up"`` or
    ``"shared_down"`` of an MoE layer's shared experts, ``"expert"`` for
    its expert stacks, ``"in_proj"`` or ``"out_proj"`` of a Mamba2 mixer
    (which only a serving plan splits); None for the router and the
    linears the split does not reach (the hybrid's ``fuse``)."""
    path = tuple(path)
    if "ssm" in path:
        rest = path[path.index("ssm") + 1:]
        return rest[0] if len(rest) >= 2 and rest[0] in MIXER else None
    if "moe" in path:
        i = path.index("moe")
        rest = path[i + 1:]
        if rest[:1] == ("shared",) and len(rest) >= 3 \
                and rest[1] in SHARED:
            return SHARED[rest[1]]
        if len(rest) >= 2 and rest[0] in EXPERT_LINEARS:
            return "expert"
        return None
    for i in range(len(path) - 2, 0, -1):
        module, parent = path[i], path[i - 1]
        if module in REACHED.get(parent, ()):
            return module
    return None


def plan(cfg, mesh, rules, serving: bool = True
         ) -> Optional[TensorParallel]:
    """The split of ``cfg`` on a live ``mesh`` whose :data:`AXIS` has more
    than one rank; None otherwise (a size-only mesh, no such axis, or one
    rank on it), and the step then computes as without a split.  Under
    ``rules_for(cfg, mesh, "decode")`` (or ``"prefill"``) its cache layout
    is the one ``cache_axes`` gets there.  A ``serving`` plan (a split
    ``prefill`` / ``decode_step``) also splits the Mamba2 mixer
    (:func:`plan_linears`); the train step plans with ``serving=False``."""
    if mesh is None or not hasattr(mesh, "get_group"):
        return None
    size = mesh_shape(mesh).get(AXIS, 1)
    if size == 1:
        return None
    kinds, vocab = plan_linears(cfg, mesh, rules, serving)
    return TensorParallel(mesh, mesh.get_local_rank(AXIS), size, kinds,
                          vocab, cfg.num_heads, cfg.num_kv_heads,
                          cfg.padded_vocab_size,
                          cfg.moe.num_experts if cfg.family == "moe" else 0,
                          cache_layout(cfg, mesh, rules, kinds))


def kept_axes(vocab: bool, path: Tuple[str, ...],
              experts: bool = False) -> Tuple[str, ...]:
    """The mesh axes the frozen leaf at ``path`` stays split over in the
    step: :data:`AXIS` for the embedding and the head when the vocabulary
    splits (``vocab``) over several ranks, and for an expert stack's
    leaves when the experts do (``experts``)."""
    if vocab and tuple(path) in VOCAB_LEAVES:
        return (AXIS,)
    if experts and reached_module(path) == "expert":
        return (AXIS,)
    return ()


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross-entropy of vocab-split logits: a local max and its
    MAX all-reduce (no gradient), a local sum of exps and its SUM
    all-reduce, and the gold logit from the rank that holds it, SUM
    all-reduced; the backward is the local softmax minus the local
    one-hot, times the incoming gradient."""

    @staticmethod
    def forward(ctx, logits, labels, start, mesh):
        rows = logits.shape[-1]
        m = logits.amax(-1)
        collectives.all_reduce(m, mesh, (AXIS,), dist.ReduceOp.MAX,
                               tag="ce_max")
        sum_exp = torch.exp(logits - m[..., None]).sum(-1)
        collectives.all_reduce(sum_exp, mesh, (AXIS,), tag="ce_sum")
        lse = m + torch.log(sum_exp)
        local = labels.long() - start
        ours = (local >= 0) & (local < rows)
        idx = torch.where(ours, local, torch.zeros_like(local))
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = torch.where(ours, gold, torch.zeros_like(gold))
        collectives.all_reduce(gold, mesh, (AXIS,), tag="ce_gold")
        ctx.save_for_backward(logits, lse, idx, ours)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, ours = ctx.saved_tensors
        p = torch.exp(logits - lse[..., None])
        p.scatter_add_(-1, idx[..., None], -ours.to(p.dtype)[..., None])
        return p * g[..., None], None, None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                      start: int, tp: TensorParallel) -> torch.Tensor:
    """Per-token ``logsumexp(logits) - logits[label]`` over the whole
    vocabulary, from this rank's fp32 logits (..., V / n) for the ids
    from ``start``; a label outside every rank's rows (< 0) gives a gold
    logit of 0, for the caller to mask."""
    return _VocabParallelCE.apply(logits, labels, start, tp.mesh)


def _loss_chunk(s: int, loss_chunk: int = 1024) -> int:
    """The sequence chunk of ``model.chunked_ce_loss`` at length ``s``."""
    c = min(loss_chunk, s)
    while s % c:
        c -= 1
    return c


def step_collectives(cfg, kinds: Mapping[str, str], vocab: bool, size: int,
                     batch: int, seq: int, src_seq: int = 0,
                     patches: int = 0, full_finetune: bool = False
                     ) -> list:
    """The ``(tag, elements)`` of every collective over :data:`AXIS` that
    the split's forward and backward make in one step of ``batch`` rows of
    ``seq`` tokens a rank (``patches`` image positions in front of them,
    an encoder's ``src_seq`` frames), in ``cfg``'s remat policy, under
    :func:`plan_linears`'s ``kinds`` and ``vocab`` on a ``model`` axis of
    ``size`` ranks (the gradient sums not included):

    - ``reduce_from`` (all-reduce of (tokens, d_model)): the vocab-parallel
      lookup, and each row-split o and down in the forward; a remat
      recompute runs a layer up to its last saved tensor only, so it sums
      o again (the norms after it keep its output) but not down (nothing
      after it saves);
    - ``gather_from`` (all-gather of this rank's input): each
      ``"gathered_row"`` linear, in the forward and again in a recompute;
    - ``copy_to`` (all-reduce of (tokens, d_model) in the backward): each
      split block input (attention, cross-attention's queries and its
      encoder output, whose k and v are split or narrowed to the rank's
      heads, MLP) and the head's, except a first block's input
      that nothing trained lies upstream of (autograd does not run that
      backward);
    - ``ce_max``, ``ce_sum``, ``ce_gold``: the cross-entropy's three
      reductions of (rows, chunk) a loss chunk;
    - an MoE layer whose experts split: ``reduce_from`` of the experts'
      partial output (tokens, d_model), again in a recompute when the
      shared experts follow it (their products save tensors after it),
      and in the backward ``copy_to`` of the expert path's input (tokens,
      d_model) and of the combine's gates (tokens, top-k); the shared
      experts' MLP as a dense MLP's.
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    rec = 0 if cfg.remat_policy == "none" else 1
    attn = kinds["q"] == "col"
    moe = cfg.family == "moe"
    mlp = not moe and kinds["up"] == "col"
    shared = moe and kinds.get("shared_up") == "col"
    experts = moe and kinds.get("expert") == "split"
    heads_local = cfg.num_heads // size if attn else cfg.num_heads
    out = []

    def linear_out(module, t, width, recomputed):
        if kinds[module] == "row":
            out.extend([("reduce_from", t * d)] * (1 + recomputed))
        elif kinds[module] == "gathered_row":
            out.extend([("gather_from", t * width)] * (1 + rec))

    def block(t, first, cross=False):
        if attn:
            linear_out("o", t, heads_local * hd, rec)
            if cross:
                linear_out("o", t, heads_local * hd, rec)
        if mlp:
            linear_out("down", t, cfg.d_ff // size, 0)
        if experts:
            out.extend([("reduce_from", t * d)] * (
                1 + (rec if cfg.moe.num_shared_experts else 0)))
            out.extend([("copy_to", t * d), ("copy_to", t * cfg.moe.top_k)])
        if shared:
            linear_out("shared_down", t, cfg.moe.num_shared_experts
                       * cfg.d_ff // size, 0)
            out.append(("copy_to", t * d))
        if attn and not first:
            out.append(("copy_to", t * d))
        if attn and cross:
            out.extend([("copy_to", t * d),
                        ("copy_to", batch * src_seq * d)])
        if mlp:
            out.append(("copy_to", t * d))

    total = seq + patches
    t = batch * total
    if vocab:
        out.append(("reduce_from", batch * seq * d))
    upstream = full_finetune
    if cfg.is_encoder_decoder:
        for i in range(cfg.num_encoder_layers):
            block(batch * src_seq, i == 0 and not upstream)
        for i in range(cfg.num_layers):
            block(t, i == 0 and not upstream, cross=True)
    elif cfg.family == "hybrid":
        for i, ch in enumerate(cfg.layer_pattern()):
            if ch != "M":
                block(t, i == 0 and not upstream)
    elif cfg.family != "ssm":
        for i in range(cfg.num_layers):
            block(t, i == 0 and not upstream)
    if vocab:
        out.append(("copy_to", t * d))
        c = _loss_chunk(total)
        for _ in range(total // c):
            out.extend((tag, batch * c)
                       for tag in ("ce_max", "ce_sum", "ce_gold"))
    return out


def serve_collectives(cfg, kinds: Mapping[str, str], vocab: bool,
                      cache: Optional[str], size: int, batch: int, seq: int,
                      decode: bool, src_seq: int = 0, patches: int = 0
                      ) -> list:
    """The ``(tag, elements)`` of every collective over :data:`AXIS` that
    a split ``prefill`` of ``batch`` rows of ``seq`` tokens (``patches``
    image positions in front, an encoder's ``src_seq`` frames) or, with
    ``decode``, one ``decode_step`` of ``batch`` rows makes under
    :func:`plan_linears`'s ``kinds`` and ``vocab`` and the cache layout
    ``cache`` on a ``model`` axis of ``size`` ranks (nothing in the
    backward: serving has none):

    - ``reduce_from`` (all-reduce of (tokens, d_model)): the
      vocab-parallel lookup, each row-split o and down (self and cross
      attention, the dense MLP, an MoE layer's shared experts), and an MoE
      layer's expert-parallel output;
    - ``gather_from``: each ``"gathered_row"`` o and down's input;
    - ``logits`` (all-gather of (rows, V / n)): the head's rows;
    - a decode over a cache split over its sequence, each self-attention
      layer: ``seq_q`` (all-gather of the rank's q heads, where q is
      split), ``seq_max`` (MAX all-reduce of (rows, H)) and ``seq_sum``
      (all-reduce of (rows, H, hd + 1));
    - each Mamba2 layer whose mixer splits (``kinds["in_proj"]``):
      ``ssm_norm`` (all-reduce of the gated norm's fp32 sums of squares,
      (tokens, 1)) and its ``out_proj``'s ``reduce_from`` (or
      ``gather_from`` of its (tokens, d_inner / n) input).
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h = cfg.num_heads
    h_local = h // size if kinds["q"] == "col" else h
    moe = cfg.family == "moe"
    t = batch * (1 if decode else seq + patches)
    out = []

    def linear(module, rows, width):
        if kinds.get(module) == "row":
            out.append(("reduce_from", rows * d))
        elif kinds.get(module) == "gathered_row":
            out.append(("gather_from", rows * width))

    def mixer(rows):
        if kinds.get("in_proj") == "col":
            out.append(("ssm_norm", rows))
            linear("out_proj", rows,
                   cfg.ssm.expand * cfg.d_model // size)

    def block(rows, self_attn=True, cross=False):
        if self_attn and decode and cache == "cache_seq":
            if kinds["q"] == "col":
                out.append(("seq_q", rows * h_local * hd))
            out.extend([("seq_max", rows * h), ("seq_sum", rows * h * (hd + 1))])
        linear("o", rows, h_local * hd)
        if cross:
            linear("o", rows, h_local * hd)
        if moe:
            if kinds.get("expert") == "split":
                out.append(("reduce_from", rows * d))
            linear("shared_down", rows,
                   cfg.moe.num_shared_experts * cfg.d_ff // size)
        else:
            linear("down", rows, cfg.d_ff // size)

    if vocab:
        out.append(("reduce_from", batch * (1 if decode else seq) * d))
    if cfg.is_encoder_decoder:
        if not decode:
            for _ in range(cfg.num_encoder_layers):
                block(batch * src_seq, self_attn=False)
        for _ in range(cfg.num_layers):
            block(t, cross=True)
    elif cfg.family == "hybrid":
        for ch in cfg.layer_pattern():
            if ch != "M":
                block(t)
            else:
                mixer(t)
    elif cfg.family == "ssm":
        for _ in range(cfg.num_layers):
            mixer(t)
    else:
        for _ in range(cfg.num_layers):
            block(t)
    if vocab:
        out.append(("logits", batch * cfg.padded_vocab_size // size))
    return out
