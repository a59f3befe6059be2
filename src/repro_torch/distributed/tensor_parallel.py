"""The compute split over the ``model`` mesh axis in the sharded train step:
head-, MLP- and vocab-parallel training.

The reference's rules send ``heads``, ``kv_heads``, ``mlp`` and ``vocab``
to ``model``, and its model code constrains activations to them
(``shard_act``), so XLA has each ``model`` rank compute its heads of
attention, its columns of the MLP and its slice of the vocabulary, and sum
the partial row products.  The port makes the same split by hand.  Each
linear of an attention block (self and cross attention, the dense MLP) is
planned as one of :data:`KINDS`:

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

The plan comes from the rules and the dims through ``logical_spec``, so
the divisibility fallback decides it as in the reference: kv heads that
the ``model`` size does not divide leave k and v replicated, and each rank
attends its q heads to the kv heads those heads map to by their global
indices (:func:`repro_torch.models.attention.local_kv_heads`).  The
embedding and the head split over vocabulary rows when ``vocab`` does:
the lookup masks the ids outside the rank's rows and sums over ranks, and
the loss is a vocab-parallel cross-entropy (:func:`vocab_parallel_ce`).

The frozen weights keep the reference's layout (split over ``data``, not
over ``model``), so the state, its shardings and its checkpoints do not
change: a rank computes from its slice of each whole linear
(:func:`local_params`: views, no copies), and only the embedding and the
head, whose state is split over ``model`` by the rules, keep their own
rows instead of being gathered.  A trainable gradient is partial on each
rank where the plan splits the compute that uses it
(:meth:`TensorParallel.grad_summed`), and the step sums those over
``model`` too.  The MoE expert stacks (``expert``), the Mamba2 mixer
(``conv_ch``) and the hybrid's ``fuse`` are not reached: they compute
replicated across ``model`` ranks, as an unsplit step does.
"""
from __future__ import annotations

from dataclasses import dataclass
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
#: the leaves that keep their vocabulary rows (not gathered over ``model``)
VOCAB_LEAVES = (("embed", "w"), ("lm_head", "w"))
#: stand-ins for a method's in and out axes, to find its params' dims
_IN, _OUT = "tp_in", "tp_out"


def _splits(mesh, rules, name: str, dim: int) -> bool:
    return logical_spec(mesh, rules, (name,), (dim,))[0] == AXIS


def plan_linears(cfg, mesh, rules) -> Tuple[Dict[str, str], bool]:
    """(module -> kind for q, k, v, o, gate, up and down, whether the
    vocabulary splits) of ``cfg`` on ``mesh`` (a live mesh or a size
    mapping) under ``rules``."""
    heads = _splits(mesh, rules, "heads", cfg.num_heads)
    split = {"heads": heads, "mlp": _splits(mesh, rules, "mlp", cfg.d_ff),
             "kv_heads": heads and _splits(mesh, rules, "kv_heads",
                                           cfg.num_kv_heads)}

    def row(module):
        method = registry.get_method(cfg.peft.method_for(module))
        return "row" if method.row_separable else "gathered_row"
    kinds = {m: "col" if split[ax] else "replicated"
             for m, ax in COL_MODULES.items()}
    kinds.update({m: row(m) if split[ax] else "replicated"
                  for m, ax in ROW_MODULES.items()})
    return kinds, _splits(mesh, rules, "vocab", cfg.padded_vocab_size)


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


@dataclass(frozen=True)
class TensorParallel:
    """The split of one sharded step: the live mesh, this rank's
    coordinate on :data:`AXIS` and its size, the linears' kinds
    (:func:`plan_linears`) and the config's head and vocabulary sizes."""
    mesh: Any
    rank: int
    size: int
    kinds: Mapping[str, str]
    vocab: bool
    num_heads: int
    num_kv_heads: int
    vocab_size: int

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

    def grad_summed(self, path: Tuple[str, ...]) -> bool:
        """:func:`grad_summed` under this split."""
        return grad_summed(self.kinds, self.vocab, path)


def grad_summed(kinds: Mapping[str, str], vocab: bool,
                path: Tuple[str, ...]) -> bool:
    """Whether the gradient of the trainable leaf at ``path`` is partial
    on each rank under ``kinds`` and ``vocab`` (the compute that uses it
    is split), so that the step sums it over :data:`AXIS`: the leaves of a
    column- or row-split linear, of replicated k and v whose outputs feed
    split q heads, and a trained embedding or head split over the
    vocabulary.  A ``"gathered_row"`` or replicated linear's gradient is
    whole on every rank."""
    if tuple(path[:1]) in (("embed",), ("lm_head",)):
        return vocab
    module = reached_module(path)
    return module is not None and (kinds[module] in ("col", "row") or (
        module in ("k", "v") and kinds["q"] == "col"))


def reached_module(path: Tuple[str, ...]) -> Optional[str]:
    """The linear of :data:`REACHED` that the leaf at ``path`` belongs to
    (q, k, v, o, gate, up or down of an attention block or a dense MLP),
    or None (an MoE layer's, or a linear the split does not reach)."""
    if "moe" in path:
        return None
    for i in range(len(path) - 2, 0, -1):
        module, parent = path[i], path[i - 1]
        if module in REACHED.get(parent, ()):
            return module
    return None


def plan(cfg, mesh, rules) -> Optional[TensorParallel]:
    """The split of ``cfg`` on a live ``mesh`` whose :data:`AXIS` has more
    than one rank; None otherwise (a size-only mesh, no such axis, or one
    rank on it), and the step then computes as without a split."""
    if mesh is None or not hasattr(mesh, "get_group"):
        return None
    size = mesh_shape(mesh).get(AXIS, 1)
    if size == 1:
        return None
    kinds, vocab = plan_linears(cfg, mesh, rules)
    return TensorParallel(mesh, mesh.get_local_rank(AXIS), size, kinds,
                          vocab, cfg.num_heads, cfg.num_kv_heads,
                          cfg.padded_vocab_size)


def kept_axes(vocab: bool, path: Tuple[str, ...]) -> Tuple[str, ...]:
    """The mesh axes the frozen leaf at ``path`` stays split over in the
    step: :data:`AXIS` for the embedding and the head when the vocabulary
    splits (``vocab``) over several ranks."""
    if vocab and tuple(path) in VOCAB_LEAVES:
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
      reductions of (rows, chunk) a loss chunk.
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    rec = 0 if cfg.remat_policy == "none" else 1
    attn = kinds["q"] == "col"
    mlp = cfg.family != "moe" and kinds["up"] == "col"
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
