"""Live adapter lifecycle of the port: versioned hot-swap banks and
serve-while-train.

Adapters may be registered, updated and unregistered in the middle of
:meth:`ServeEngine.run_stream`, without draining:

* **Columns are append-only.**  Each mutation materializes at most one new
  bank column per linear: :func:`stack_deltas` over the one adapter, then
  :func:`repro_torch.core.registry.extend_bank`.  Existing columns are only
  concatenated onto, or gathered bit-exactly by compaction, never
  recomputed; zero-padded ranks and zero-filled forms add exact ``+0.0``
  terms, so a request admitted before a swap decodes the same tokens
  after it.

* **Epochs pin indices.**  A :class:`BankEpoch` is a name -> column view.
  Every admitted request pins the epoch current at its admission (with its
  bank and draft columns and its KV content version); a mutation advances
  to a new epoch that only later admissions see.  An old epoch retires when
  its last pinned request finishes, and compaction then gathers the dead
  columns out of the bank, remapping the surviving pins.

* **Swaps are observable.**  Every mutation emits a :class:`BankSwapEvent`
  (``engine/bank/swap`` on the engine's tracker, mirrored on
  :attr:`AdapterLifecycle.events`) and the epoch and column gauges.  A
  mid-run mutation whose extension fails (an adapter that changed a
  non-linear param, or an MoE expert or shared-expert linear) rolls back:
  the previous epoch keeps serving and the failure is a warning plus an
  ``engine/bank/swap_failed`` event.

* **KV never goes stale.**  Prefix-alias keys are ``name#version``, the
  version monotone per name across re-registration.

:class:`AdapterFeed` closes the loop with training: it restores each new
checkpoint of a directory (:mod:`repro_torch.train.checkpoint`) and swaps
it into the live bank between engine steps.

The lifecycle and the feed hold their engine through a weak proxy, so an
engine and its banks are freed by reference counting alone when its last
user drops it (no reference cycle).
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import registry
from repro_torch.tree import map_dicts, tree_leaves_with_path

PyTree = Any


def _differs(a, b) -> bool:
    """Whether two param subtrees differ: in structure, or in a leaf that
    is neither the same tensor nor equal."""
    if isinstance(a, dict) or isinstance(b, dict):
        return not (isinstance(a, dict) and isinstance(b, dict)) or \
            a.keys() != b.keys() or any(_differs(a[k], b[k]) for k in a)
    if isinstance(a, list) or isinstance(b, list):
        return not (isinstance(a, list) and isinstance(b, list)) or \
            len(a) != len(b) or any(_differs(x, y) for x, y in zip(a, b))
    return a is not b and not torch.equal(a, b)


@dataclasses.dataclass(frozen=True)
class Column:
    """One materialized bank column: a ``(name, version)`` adapter
    snapshot.  Two versions of one name are two columns while both have
    pinned requests; compaction reclaims the dead one."""
    name: str
    version: int


@dataclasses.dataclass(frozen=True)
class BankSwapEvent:
    """One applied bank mutation, emitted as ``engine/bank/swap`` on the
    engine tracker and kept on :attr:`AdapterLifecycle.events`.  ``op`` is
    ``register`` / ``update`` / ``unregister`` / ``retire`` / ``compact``
    (or ``<op>_failed``); ``version`` is the name's content version after
    the op (the retired epoch for ``retire``, the columns reclaimed for
    ``compact``)."""
    step: int
    op: str
    name: str
    version: int
    epoch: int           # current epoch after the op
    columns: int         # bank column count after the op
    live_epochs: int


class BankEpoch:
    """One name -> column view of the bank.  ``refs`` counts the in-flight
    requests pinned to it; a superseded epoch retires at zero.  Compaction
    remaps ``index`` in place: the mapping is fixed, the physical column
    numbers are not."""

    __slots__ = ("version", "index", "refs")

    def __init__(self, version: int, index: Dict[str, int]):
        self.version = version
        self.index = index
        self.refs = 0

    def __repr__(self):
        return (f"BankEpoch(version={self.version}, refs={self.refs}, "
                f"index={self.index})")


class AdapterLifecycle:
    """The hot-swap state machine of one :class:`ServeEngine`.

    Before the first build, mutations apply at once to the column plan
    (nothing is materialized, and with nothing pinned an update keeps its
    name's column index).  Once the bank exists, mutations queue and apply
    at the next :meth:`tree` call, which the engine makes at step
    boundaries, so a swap never lands inside a step.

    :attr:`full_builds`, :attr:`extend_walks` and :attr:`columns_built`
    count the all-column builds, the one-column extension walks and the
    columns materialized by either: one engine builds once, and every
    applied register or update walks once and builds one column."""

    def __init__(self, engine, base_name: str, linear_modules: frozenset,
                 compute_dtype: torch.dtype):
        self.engine = weakref.proxy(engine)
        self.base_name = base_name
        self.linear_modules = linear_modules
        self.compute_dtype = compute_dtype
        self.columns: List[Column] = [Column(base_name, 0)]
        self.current = BankEpoch(0, {base_name: 0})
        self.live: Dict[int, BankEpoch] = {0: self.current}
        #: every swap / retire / compact, in order
        self.events: List[BankSwapEvent] = []
        self.retired_epochs = 0
        self.full_builds = 0
        self.extend_walks = 0
        self.columns_built = 0
        self._versions: Dict[str, int] = {base_name: 0}
        # monotone forever (never reset on unregister): a re-registered
        # name must not alias pages of its previous life
        self._next_version: Dict[str, int] = {base_name: 1}
        self._pending: List[Dict] = []
        self._tree = None
        self._compactable = False

    # -- queries -----------------------------------------------------------
    @property
    def dirty(self) -> bool:
        """Whether :meth:`tree` has work to do (unbuilt, or swaps queued)."""
        return self._tree is None or bool(self._pending)

    def version_of(self, name: str) -> int:
        """The content version of a live adapter name."""
        return self._versions[name]

    def bank_bytes(self) -> int:
        """Device bytes of the bank tensors in the current serve tree (0
        before the first build)."""
        return _bank_bytes(self._tree)

    # -- mutation intake (the engine's API calls these) ---------------------
    def _bump_version(self, name: str) -> int:
        v = self._next_version.get(name, 0)
        self._next_version[name] = v + 1
        self._versions[name] = v
        return v

    def queue_register(self, name: str, raw, cfg) -> None:
        ver = self._bump_version(name)
        if self._tree is None:
            col = len(self.columns)
            self.columns.append(Column(name, ver))
            index = dict(self.current.index)
            index[name] = col
            self._advance(index, "register", name)
        else:
            self._pending.append({"op": "register", "name": name,
                                  "raw": raw, "cfg": cfg, "version": ver})

    def queue_update(self, name: str, raw, cfg, prev_source) -> None:
        prev_ver = self._versions[name]
        ver = self._bump_version(name)
        if self._tree is None:
            # nothing is pinned before the first build: update in place,
            # keeping the name's column index
            col = self.current.index[name]
            self.columns[col] = Column(name, ver)
            self._advance(dict(self.current.index), "update", name)
        else:
            self._pending.append({"op": "update", "name": name,
                                  "raw": raw, "cfg": cfg, "version": ver,
                                  "prev_source": prev_source,
                                  "prev_version": prev_ver})

    def queue_unregister(self, name: str) -> None:
        prev_ver = self._versions.pop(name)
        if self._tree is None:
            col = self.current.index[name]
            del self.columns[col]
            index = {n: (c if c < col else c - 1)
                     for n, c in self.current.index.items() if n != name}
            self._advance(index, "unregister", name)
        else:
            self._pending.append({"op": "unregister", "name": name,
                                  "prev_version": prev_ver})

    # -- epochs ------------------------------------------------------------
    def _advance(self, index: Dict[str, int], op: str, name: str) -> None:
        old = self.current
        self.current = BankEpoch(old.version + 1, index)
        self.live[self.current.version] = self.current
        if old.refs == 0:
            self._retire(old)
        self._sync_engine_views()
        self._emit(op, name, self._versions.get(name, -1))

    @staticmethod
    def _payload(ev: BankSwapEvent) -> Dict[str, Any]:
        # the payload's "step" and "name" would shadow the tracker record's
        d = dataclasses.asdict(ev)
        d["adapter"] = d.pop("name")
        del d["step"]
        return d

    def _retire(self, ep: BankEpoch) -> None:
        self.live.pop(ep.version, None)
        self.retired_epochs += 1
        self._compactable = True
        if ep is not self.current:
            eng = self.engine
            ev = BankSwapEvent(step=eng._obs_step, op="retire", name="",
                              version=ep.version,
                              epoch=self.current.version,
                              columns=len(self.columns),
                              live_epochs=len(self.live))
            self.events.append(ev)
            if eng._obs:
                eng._tracker.event("engine/bank/epoch_retired",
                                   self._payload(ev), step=eng._obs_step)
                self._gauges()

    def _emit(self, op: str, name: str, version: int) -> None:
        eng = self.engine
        ev = BankSwapEvent(step=eng._obs_step, op=op, name=name,
                          version=version, epoch=self.current.version,
                          columns=len(self.columns),
                          live_epochs=len(self.live))
        self.events.append(ev)
        if eng._obs:
            eng._tracker.event("engine/bank/swap", self._payload(ev),
                               step=eng._obs_step)
            self._gauges()

    def _gauges(self) -> None:
        tr = self.engine._tracker
        s = self.engine._obs_step
        tr.gauge("engine/bank/epoch", self.current.version, step=s)
        tr.gauge("engine/bank/columns", len(self.columns), step=s)
        tr.gauge("engine/bank/live_epochs", len(self.live), step=s)

    def _sync_engine_views(self) -> None:
        # the engine's views: the serve tree and the current epoch's
        # name -> column mapping
        eng = self.engine
        eng._tree = self._tree
        eng._adapter_index = dict(self.current.index)

    # -- request pins ------------------------------------------------------
    def pin(self, r, draft_name: Optional[str] = None) -> None:
        """Pin ``r`` to the current epoch at admission: its bank column,
        its draft's column and its KV content version, fixed now so later
        swaps cannot move them.  A resumed request keeps its pin."""
        if getattr(r, "_epoch", None) is not None:
            return
        ep = self.current
        r._bank_col = ep.index[r.adapter]
        r._draft_col = ep.index[draft_name] if draft_name is not None \
            else None
        r._kv_ver = self.columns[r._bank_col].version
        r._epoch = ep
        ep.refs += 1

    def release(self, r) -> None:
        """Drop ``r``'s epoch pin (finish or truncation).  The last release
        of a superseded epoch retires it."""
        ep = getattr(r, "_epoch", None)
        r._epoch = None
        if ep is None:
            return
        ep.refs -= 1
        if ep.refs == 0 and ep is not self.current:
            self._retire(ep)

    # -- building ----------------------------------------------------------
    def tree(self):
        """The current serve tree: a full build on first use, then one
        extension walk per queued register or update.  A failing mutation
        is rolled back and re-raised with the previous tree intact; later
        mutations stay queued."""
        if self._tree is None:
            self._tree = self._full_build()
            self._sync_engine_views()
            return self._tree
        if self._pending:
            # reclaim dead columns first: the swap copies the bank anyway
            self.compact()
            while self._pending:
                mut = self._pending[0]
                try:
                    self._apply(mut)
                except Exception as err:
                    del self._pending[0]
                    self._rollback(mut, err)
                    raise
                del self._pending[0]
        return self._tree

    def _cast_left(self, bank: Optional[Dict]) -> Optional[Dict]:
        """The bank with its ``left`` factors in the compute dtype (every
        consumer casts them to it before use); ``right`` and ``delta`` stay
        fp32."""
        if bank is not None and "left" in bank:
            bank["left"] = bank["left"].to(self.compute_dtype)
        return bank

    def _is_linear(self, node, module) -> bool:
        return set(node) == {"w"} and module in self.linear_modules \
            and node["w"].ndim >= 2

    @staticmethod
    def _refuse_moe(path, base_raw, raws) -> None:
        """A linear under ``"moe"`` (an expert stack or a shared expert) is
        never banked: expert linears see expert-major activations, not
        slot-major ones, so a per-slot gather would pick deltas by buffer
        row.  An adapter whose params for it differ from the base's is
        refused with the reference's message.  The decision reads the
        params and builds no delta: one fp32 delta of one deepseek-moe-16b
        expert stack would be 20.7 GB."""
        if any(_differs(raw, base_raw) for raw in raws):
            raise ValueError(
                f"adapter updates MoE expert linear {'/'.join(path)}; "
                f"per-slot heterogeneous serving does not support expert "
                f"adapters yet — serve them merged / single-adapter")

    def _full_build(self):
        """Every column's bank at once: one :func:`stack_deltas` per
        updated linear over every column's raw source."""
        eng = self.engine
        entries = [eng._sources[c.name] for c in self.columns]
        kinds = {"left": 0, "delta": 0}
        self.full_builds += 1
        self.columns_built += len(self.columns)
        tree = self._build_walk(eng._merged_base, [raw for raw, _ in entries],
                                [pc for _, pc in entries],
                                [c.name for c in self.columns], kinds, ())
        eng._note_bank_kinds(kinds)
        return tree

    def _build_walk(self, node, raws, pcs, names, kinds, path):
        """``node`` of the merged base with every column's bank stacked on
        each linear the adapters ``raws`` update (a method, not a nested
        function: a recursive closure would be a reference cycle that
        holds the lifecycle, and so the bank, until the cycle collector
        runs)."""
        if isinstance(node, dict):
            module = path[-1] if path else None
            if self._is_linear(node, module):
                if "moe" in path:
                    self._refuse_moe(path, raws[0], raws[1:])
                    return node
                bank = registry.stack_deltas(
                    node["w"], [(raw, pc, module)
                                for raw, pc in zip(raws, pcs)])
                if bank is None:
                    return node
                kinds["left" if "left" in bank else "delta"] += 1
                return {"w": node["w"], "bank": self._cast_left(bank)}
            return {k: self._build_walk(v, [r[k] for r in raws], pcs, names,
                                        kinds, path + (k,))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [self._build_walk(v, [r[i] for r in raws], pcs, names,
                                     kinds, path + (str(i),))
                    for i, v in enumerate(node)]
        # a non-linear leaf is shared by every slot: refuse adapters that
        # changed it
        for name, leaf in zip(names[1:], raws[1:]):
            if not torch.equal(leaf, node):
                raise ValueError(
                    f"adapter {name!r} differs from base at non-linear "
                    f"param {'/'.join(path)}; per-slot serving only covers "
                    f"linear-module updates")
        return node

    def _apply(self, mut: Dict) -> None:
        op = mut["op"]
        name = mut["name"]
        if op == "unregister":
            index = {n: c for n, c in self.current.index.items()
                     if n != name}
            self._advance(index, op, name)
            return
        # register / update: materialize exactly one new column
        eng = self.engine
        kinds = {"left": 0, "delta": 0}
        self.extend_walks += 1
        new_tree = self._extend_walk(self._tree, mut["raw"], mut["cfg"],
                                     kinds, ())
        self._tree = new_tree
        self.columns_built += 1
        col = len(self.columns)
        self.columns.append(Column(name, mut["version"]))
        index = dict(self.current.index)
        index[name] = col
        self._advance(index, op, name)
        eng._note_bank_kinds(kinds)

    def _extend_walk(self, node, raw, cfg, kinds, path):
        """The serve tree rebuilt with one adapter's column appended to
        every touched linear's bank; existing bank tensors are only
        concatenated onto, and a failure leaves ``self._tree`` as it
        was."""
        n_cols = len(self.columns)
        if isinstance(node, dict):
            module = path[-1] if path else None
            if registry.is_banked_linear(node) or self._is_linear(node,
                                                                  module):
                if "moe" in path:
                    base_raw = self.engine._sources[self.base_name][0]
                    for k in path:
                        base_raw = base_raw[int(k) if isinstance(
                            base_raw, list) else k]
                    self._refuse_moe(path, base_raw, [raw])
                    return node
                sub = registry.stack_deltas(node["w"], [(raw, cfg, module)])
                if sub is not None:
                    kinds["left" if "left" in sub else "delta"] += 1
                elif "bank" not in node:
                    return node
                bank = registry.extend_bank(node["w"], node.get("bank"),
                                            self._cast_left(sub), n_cols,
                                            n_new=1)
                return {"w": node["w"], "bank": bank}
            return {k: self._extend_walk(v, raw[k], cfg, kinds, path + (k,))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [self._extend_walk(v, raw[i], cfg, kinds,
                                      path + (str(i),))
                    for i, v in enumerate(node)]
        # a non-linear leaf: the new adapter's value must equal it
        if not torch.equal(raw, node):
            raise ValueError(
                f"adapter differs from base at non-linear param "
                f"{'/'.join(path)}; per-slot serving only covers "
                f"linear-module updates")
        return node

    def _rollback(self, mut: Dict, err: Exception) -> None:
        """Undo a failed mutation's engine-side registration so that the
        previous epoch keeps serving.  The burned version stays burned."""
        eng = self.engine
        name = mut["name"]
        if mut["op"] == "register":
            eng._sources.pop(name, None)
            self._versions.pop(name, None)
        elif mut["op"] == "update":
            eng._sources[name] = mut["prev_source"]
            self._versions[name] = mut["prev_version"]
        ev = BankSwapEvent(step=eng._obs_step, op=f"{mut['op']}_failed",
                          name=name, version=mut.get("version", -1),
                          epoch=self.current.version,
                          columns=len(self.columns),
                          live_epochs=len(self.live))
        self.events.append(ev)
        if eng._obs:
            eng._tracker.count("engine/warnings/swap_failed",
                               step=eng._obs_step)
            eng._tracker.event(
                "engine/bank/swap_failed",
                {**self._payload(ev), "error": str(err)},
                step=eng._obs_step)

    # -- compaction --------------------------------------------------------
    def compact(self) -> int:
        """Gather the columns no live epoch references out of the bank
        (kept columns bit-exact), remap every live epoch and every pinned
        request, and return the number of columns reclaimed.  Runs ahead of
        every swap; :meth:`ServeEngine.compact_banks` calls it on
        demand."""
        if self._tree is None or not self._compactable:
            return 0
        self._compactable = False
        referenced = set()
        for ep in self.live.values():
            referenced.update(ep.index.values())
        keep = sorted(referenced)
        dead = len(self.columns) - len(keep)
        if dead == 0:
            return 0
        remap = {old: new for new, old in enumerate(keep)}
        self._tree = self._compact_tree(self._tree, keep)
        self.columns = [self.columns[i] for i in keep]
        for ep in self.live.values():
            ep.index = {n: remap[c] for n, c in ep.index.items()}
        for r in self.engine._pinned_requests():
            if getattr(r, "_bank_col", None) is not None:
                r._bank_col = remap[r._bank_col]
            if getattr(r, "_draft_col", None) is not None:
                r._draft_col = remap[r._draft_col]
        self._sync_engine_views()
        self._emit("compact", "", dead)
        return dead

    def _compact_tree(self, node, keep: Sequence[int]):
        def one(linear, _path):
            if not registry.is_banked_linear(linear):
                return None
            bank = registry.take_bank_columns(linear["bank"], keep)
            if bank is None:
                return {"w": linear["w"]}
            return {"w": linear["w"], "bank": bank}
        return map_dicts(one, node)


def _bank_bytes(node) -> int:
    """Bytes of the bank tensors under ``node`` of a serve tree."""
    return sum(t.numel() * t.element_size()
               for path, t in tree_leaves_with_path(node) if "bank" in path)


# ---------------------------------------------------------------------------
# serve-while-train: checkpoint directory -> live bank
# ---------------------------------------------------------------------------

def adapter_tree(state) -> PyTree:
    """The default :class:`AdapterFeed` extractor: a train state (anything
    with ``trainable`` and ``frozen``) becomes ``adamw.combine(trainable,
    frozen)``, the full param tree with the fine-tuned factors in place;
    anything else is taken to be the param tree."""
    if hasattr(state, "trainable") and hasattr(state, "frozen"):
        from repro_torch.optim import adamw
        return adamw.combine(state.trainable, state.frozen)
    return state


class AdapterFeed:
    """Stream training checkpoints into a live engine's adapter bank.

    Watches ``ckpt_dir`` and serves the newest unseen checkpoint step as
    adapter ``name``: the first one registers it, later ones update it
    (in-flight requests keep their pinned weights; later admissions serve
    the new state).

    :meth:`notify` is a thread-safe push (hand it to ``checkpoint.save(...,
    publish=feed.notify)``; an async save calls it from its writer
    thread), and :meth:`poll` falls back to a directory scan
    (``checkpoint.all_steps``) every ``poll_every``-th call, for
    checkpoints another process wrote.  :meth:`attach` runs :meth:`poll`
    at the engine's step boundaries.

    ``template`` is a tree of tensors shaped like the checkpointed object
    (the restore's structure, dtypes and devices); ``extract`` maps the
    restored object to the param tree to register (default
    :func:`adapter_tree`); ``peft_cfg`` is the adapter's PEFT config
    (default: the engine's); ``start_after`` skips steps up to it."""

    def __init__(self, engine, ckpt_dir: str, name: str, template,
                 *, peft_cfg=None, extract: Optional[Callable] = None,
                 poll_every: int = 1, start_after: Optional[int] = None):
        self.engine = weakref.proxy(engine)
        self.ckpt_dir = ckpt_dir
        self.name = name
        self.template = template
        self.peft_cfg = peft_cfg
        self.extract = adapter_tree if extract is None else extract
        self.poll_every = max(int(poll_every), 1)
        #: checkpoint steps streamed into the bank, in order
        self.applied: List[int] = []
        self._last = -1 if start_after is None else int(start_after)
        self._notified: List[int] = []
        self._lock = threading.Lock()
        self._polls = 0

    def notify(self, step: int) -> None:
        """Mark checkpoint ``step`` as published (thread-safe; the swap
        happens on the engine's thread at the next poll)."""
        with self._lock:
            self._notified.append(int(step))

    def poll(self) -> Optional[int]:
        """Serve the newest unseen checkpoint, if any, and return its step.
        Steps that appeared in between are skipped: the bank serves
        snapshots, not the whole history."""
        from repro_torch.train import checkpoint

        with self._lock:
            notified, self._notified = self._notified, []
        self._polls += 1
        fresh = [s for s in notified if s > self._last]
        if not fresh and (self._polls - 1) % self.poll_every == 0:
            fresh = [s for s in checkpoint.all_steps(self.ckpt_dir)
                     if s > self._last]
        if not fresh:
            return None
        step = max(fresh)
        state = checkpoint.restore(self.template, self.ckpt_dir, step=step)
        params = self.extract(state)
        if self.name in self.engine.list_adapters():
            self.engine.update_adapter(self.name, params, self.peft_cfg)
        else:
            self.engine.register_adapter(self.name, params, self.peft_cfg)
        self._last = step
        self.applied.append(step)
        return step

    def attach(self) -> "AdapterFeed":
        """Run :meth:`poll` at the engine's per-step mutation point."""
        self.engine.add_step_hook(self._on_step)
        return self

    def _on_step(self, engine, step: int) -> None:
        self.poll()
