"""Serving engine of the port: multi-tenant continuous batching over a
block-paged KV cache (or a dense per-slot cache), with streaming
admission, SLO-aware preemption, chunked prefill and per-request sampling.

The engine merges the base tree once (PSOFT adapters fold into plain
weights) and stacks every registered adapter's update into a per-linear
bank (:func:`repro_torch.core.registry.stack_deltas`), built when the first
run starts and then grown, swapped and compacted by the versioned
lifecycle (:mod:`repro_torch.serve.lifecycle`): adapters may be
registered, updated and unregistered mid-run, each admitted request pinned
to the bank epoch it started on.  Prefill and decode pass a per-row
``adapter_ids`` vector down to every banked linear, so one decode step
serves slots on different adapters.
KV lives in refcounted pages (:class:`repro_torch.serve.kv_cache
.PagedKVCache`); admissions whose prompt prefix hashes to resident pages
alias them and prefill only their suffix.  ``cache_mode="dense"`` keeps
one per-slot cache instead (:func:`repro_torch.models.model.init_cache`
with no page size): the SSM and hybrid families' recurrent states do not
page, so ``"auto"`` gives them the dense cache and the attention families
pages.  A dense cache admits without page accounting, prefills each
same-length group of prompts in one call (recurrent families at the exact
prompt length) and copies each row into its slot, and has no preemption,
chunked prefill or speculative decoding, as in the reference.  A VLM
serves text prompts on pages; the audio encoder-decoder is refused at
construction (no request carries source frames).

Admission is streaming (:meth:`ServeEngine.run_stream`): requests are
``submit()``-ed as they arrive — mid-run included — and a
:class:`repro_torch.serve.scheduler.StreamScheduler` picks what each free
slot serves next (priority/deadline ordering, bounded out-of-order
lookahead).  Under page pressure a deadline-at-risk request that cannot get
pages SUSPENDS a lower-priority running slot (its computed KV parks in the
retained-prefix pool; resume re-aliases whatever stayed resident and
re-prefills only the evicted tail), and decode grows pages on demand,
suspending the lowest-priority slot when the pool runs dry.  With
``prefill_chunk_tokens`` a prompt prefills a chunk per step, interleaved
with decode; mid-prefill slots ride the decode call as ghosts whose table
rows are redirected to the trash page.  :meth:`ServeEngine.run` is the thin
wrapper — every request arrives at step 0, strict FIFO, worst-case page
reservation, no preemption.

Generation control is per request (:mod:`repro_torch.serve.sampling`):
temperature / top-k / top-p / seed / stop tokens / logprobs, drawn on the
engine's device with the reference's counter-based threefry stream
(``fold_in(PRNGKey(seed), n_generated)``), so sampled tokens survive
preemption and admission order.  Each sampler call brings its outputs back
in one device-to-host transfer.  Every layer reports through a
:class:`repro_torch.obs.Tracker` (``engine/…``, ``scheduler/…``,
``sampler/…``, ``kv/…``) under the reference's metric names.

Decode can run speculatively (:mod:`repro_torch.serve.spec`): a slot with a
:class:`SpecConfig` drafts ``k`` tokens with a cheap adapter (the base
weights by default) in ``k`` chained decode steps whose tokens stay on the
device, then verifies the ``k + 1`` window positions in one paged prefill
over its own prefix pages.  The target draws use the request's own counter
stream, so acceptance is token equality and the emitted tokens are those
plain decode would emit.  A request with ``n > 1`` forks into ``n`` branch
requests (uids ``(uid, b)``, seeds ``fold_in(seed, b)``) whose prompt pages
alias through the prefix hashing; the parent comes back once, after its
last branch.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, PEFTConfig, torch_dtype
from repro_torch.core import peft as peft_lib, registry
from repro_torch.models import attention, model as model_lib
from repro_torch.obs import NOOP, NULL_SPAN, Tracker
from repro_torch.serve import sampling as sampling_lib
from repro_torch.serve.kv_cache import OutOfPages, PagedKVCache, TRASH_PAGE
from repro_torch.serve.lifecycle import AdapterLifecycle
from repro_torch.serve.sampling import SamplingParams, TokenLogprobs
from repro_torch.serve.scheduler import StreamScheduler, TokenCostModel
from repro_torch.serve.spec import SpecConfig, accepted_prefix
from repro_torch.tree import tree_map

#: adapter name every request uses unless it asks for another
BASE_ADAPTER = "base"

#: logical linears the bank path serves, the reference's set: every module
#: name but "router" (moe_apply reads its weight directly, so a banked
#: router would silently serve the base; a router diff instead hits the
#: lifecycle's non-linear-leaf check)
_LINEAR_MODULES = model_lib._MODULE_NAMES - {"router"}

#: families served on block-paged KV (every MoE call runs the dense
#: dispatch: capacity dispatch couples the rows of a batch; a VLM serves
#: text prompts, as the reference's engine does); the SSM and hybrid
#: families' recurrent states stay on the dense cache
_PAGED_FAMILIES = model_lib.PAGED_FAMILIES
_SERVED_FAMILIES = _PAGED_FAMILIES + ("ssm", "hybrid")
#: why the audio encoder-decoder is refused at construction
_NO_SOURCE_FRAMES = (
    "an encoder-decoder prefill needs the request's source frames "
    "(batch['src_embeds']), which no Request carries: the reference's "
    "engine builds only tokens and fails at its first prefill "
    "(KeyError: 'src_embeds'); serve it at model level with "
    "model.prefill and model.decode_step")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    adapter: str = BASE_ADAPTER
    #: per-request generation control; None inherits the engine default
    sampling: Optional[SamplingParams] = None
    #: speculative-decode control; None inherits the engine default,
    #: ``SpecConfig(k=0)`` opts out of it
    spec: Optional[SpecConfig] = None
    #: parallel completions: ``n > 1`` forks the request into ``n`` branch
    #: requests over one set of prompt pages; the parent comes back once,
    #: after its last branch, with them on :attr:`branches` (its own
    #: ``generated`` stays empty)
    n: int = 1
    #: the branch requests of an ``n > 1`` fan-out (engine-populated)
    branches: List["Request"] = dataclasses.field(default_factory=list)
    #: scheduling weight: higher-priority requests are admitted first and
    #: may preempt lower-priority running slots under page pressure
    priority: int = 0
    #: SLO on the engine's cost clock: finish within this many cost units
    #: of arrival (None = no SLO; default cost units are engine steps)
    deadline: Optional[float] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: "stop" (emitted one of its stop ids, kept in ``generated``),
    #: "length" (max_new_tokens / max_len reached) or, for an ``n > 1``
    #: parent, "branches" (every branch done); None otherwise
    finish_reason: Optional[str] = None
    #: per generated token, when ``sampling.logprobs > 0``
    logprobs: List[TokenLogprobs] = dataclasses.field(default_factory=list)
    #: the run hit max_steps before this request finished
    truncated: bool = False
    #: engine-stamped: the step the request entered the queue / was first
    #: admitted / finished, and how many times it was preempted
    arrival_step: int = 0
    admit_step: Optional[int] = None
    finish_step: Optional[int] = None
    preemptions: int = 0
    #: the same stamps on the scheduler's cost clock
    arrival_cost: float = 0.0
    finish_cost: Optional[float] = None

    @property
    def queueing_delay(self) -> Optional[int]:
        """Engine steps spent waiting for first admission (None: never
        admitted)."""
        if self.admit_step is None:
            return None
        return self.admit_step - self.arrival_step

    @property
    def slo_met(self) -> Optional[bool]:
        """Whether the request finished inside its deadline (None: no
        deadline; False also covers never-finished)."""
        if self.deadline is None:
            return None
        if self.finish_cost is None:
            return False
        return self.finish_cost - self.arrival_cost <= self.deadline

    @property
    def remaining_tokens(self) -> int:
        """Upper bound on tokens left to generate (the scheduler's
        remaining-work estimate)."""
        return max(self.max_new_tokens - len(self.generated), 0)


@dataclasses.dataclass(frozen=True)
class AdmissionEvent:
    """One slot fill (fresh or resumed): ``prefix_tokens`` is the resident
    KV the prefill skipped (aliased shared-prefix pages or a resumed
    request's retained pages); non-empty ``others`` shows the slot was
    refilled while other slots were mid-decode."""
    step: int
    slot: int
    uid: int
    adapter: str
    resumed: bool
    prefix_tokens: int
    queueing_delay: Optional[int]
    others: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class PreemptionEvent:
    """One suspension: ``resident_tokens`` is the KV the slot had computed
    when it yielded."""
    step: int
    slot: int
    uid: int
    adapter: str
    priority: int
    resident_tokens: int


class ServeEngine:
    """Fixed-slot continuous batcher over the paged (or dense-cache) decode
    step.

    ``params`` is the (PEFT-wrapped) tree served as the ``"base"`` adapter;
    :meth:`register_adapter` adds fine-tunes of the same architecture.
    ``device`` holds the KV pools and every per-step tensor, and must be
    where ``params`` live.

    ``sampling`` is the default :class:`SamplingParams` of requests that
    carry none (default: greedy); ``sample_seed`` seeds the derived seeds of
    requests whose params pin none.  ``tracker`` receives the metrics.
    ``prefill_chunk_tokens`` splits admission prefill into chunks of at
    most that many tokens, one per engine step; ``cost_model`` is the
    deadline clock and optional step budget; ``bucket_multiple`` is the
    prefill padding granularity (default 8).  ``spec`` is the default
    :class:`SpecConfig` of requests that carry none (None: plain
    decode).  ``cache_mode`` is ``"paged"``, ``"dense"`` or ``"auto"``
    (paged for the dense, MoE and VLM families, dense for SSM and
    hybrid); a dense cache takes no ``spec`` and no
    ``prefill_chunk_tokens``.  The audio family is refused."""

    def __init__(self, params, cfg: ModelConfig, max_len: int = 256,
                 slots: int = 4, page_size: int = 16,
                 num_pages: Optional[int] = None, device="cuda",
                 cache_mode: str = "auto",
                 sampling: Optional[SamplingParams] = None,
                 sample_seed: int = 0, tracker: Optional[Tracker] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 cost_model: Optional[TokenCostModel] = None,
                 bucket_multiple: Optional[int] = None,
                 spec: Optional[SpecConfig] = None):
        if cfg.family not in _SERVED_FAMILIES:
            raise ValueError(
                f"the port serves the {', '.join(_SERVED_FAMILIES)} "
                f"families only, not {cfg.family!r}"
                + (f": {_NO_SOURCE_FRAMES}" if cfg.is_encoder_decoder
                   else ""))
        self.device = resolve_device(device)
        if params["embed"]["w"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed']['w'].device}, "
                             f"engine device is {self.device}")
        # serving config: every linear is a plain {"w"} (+ bank) once merged
        self.cfg = dataclasses.replace(
            cfg, peft=PEFTConfig(method="none", target_modules=()))
        self.base_peft = cfg.peft
        # raw source trees by name (the bank build needs the unmerged
        # factors); only the base is merged, since it is the serving tree:
        # a merged copy of every adapter would cost the size of the
        # model's linears each
        self._sources: Dict[str, Tuple[object, PEFTConfig]] = {
            BASE_ADAPTER: (params, cfg.peft)}
        self._merged_base = peft_lib.merge_tree(params, cfg.peft)
        #: name -> bank column in the current epoch
        self._adapter_index: Dict[str, int] = {BASE_ADAPTER: 0}
        self._tree = None                            # built at run start
        #: the versioned hot-swap state machine: epoch-pinned bank
        #: columns, mid-run mutations at step boundaries, compaction
        self.lifecycle = AdapterLifecycle(self, BASE_ADAPTER,
                                          _LINEAR_MODULES,
                                          torch_dtype(self.cfg.dtype))
        #: fns called as fn(engine, step) at the top of every run_stream
        #: step, before queued bank mutations apply
        self._step_hooks: List = []
        self.max_len = max_len
        self.slots = slots
        self.default_sampling = (SamplingParams.greedy() if sampling is None
                                 else sampling)
        self.default_sampling.validate(self.cfg.vocab_size)
        self.sample_seed = int(sample_seed)
        if cache_mode == "auto":
            cache_mode = ("paged" if cfg.family in _PAGED_FAMILIES
                          else "dense")
        if cache_mode not in ("paged", "dense"):
            raise ValueError(f"cache_mode must be 'auto', 'paged' or "
                             f"'dense', not {cache_mode!r}")
        if cache_mode == "paged" and cfg.family not in _PAGED_FAMILIES:
            raise ValueError(
                f"cache_mode='paged' supports attention families "
                f"{_PAGED_FAMILIES}, not {cfg.family!r} — SSM/hybrid state "
                f"caches stay dense (use cache_mode='dense' or 'auto')")
        self.cache_mode = cache_mode
        #: speculative-decode config of requests that carry none
        self.default_spec = spec
        if spec is not None and spec.k > 0 and cache_mode != "paged":
            raise ValueError(
                "speculative decoding needs the paged KV cache (the verify "
                "pass runs paged_prefill over the draft window and rollback "
                "releases window pages) — use cache_mode='paged' or drop "
                "spec")
        self.kv: Optional[PagedKVCache] = None
        #: the dense cache (dense mode): one row per slot, and its paged
        #: view's identity table on the card
        self.cache = None
        self._view_table = None
        if cache_mode == "paged":
            self.kv = PagedKVCache(self.cfg, slots, max_len,
                                   page_size=page_size, num_pages=num_pages,
                                   device=self.device)
        else:
            self.cache = model_lib.init_cache(self.cfg, slots, max_len,
                                              device=self.device)
            if self.device.type == "cuda":
                self._view_table = attention.dense_view_table(
                    slots, max_len, self.device)
        #: deadline-clock / step-budget basis (shared with the scheduler)
        self.cost_model = cost_model if cost_model is not None \
            else TokenCostModel()
        #: chunked prefill: prompts prefill at most this many tokens per
        #: engine step, interleaved with decode (None = one-shot prefill)
        self.prefill_chunk_tokens = (None if prefill_chunk_tokens is None
                                     else int(prefill_chunk_tokens))
        if self.prefill_chunk_tokens is not None:
            if self.prefill_chunk_tokens < 1:
                raise ValueError(f"prefill_chunk_tokens must be >= 1, got "
                                 f"{self.prefill_chunk_tokens}")
            if cache_mode != "paged":
                raise ValueError(
                    "chunked prefill needs the paged KV cache (a partial "
                    "prompt holds its completed chunks as pages) — use "
                    "cache_mode='paged' or drop prefill_chunk_tokens")
        self.bucket_multiple = (8 if bucket_multiple is None
                                else int(bucket_multiple))
        if self.bucket_multiple < 1:
            raise ValueError(f"bucket_multiple must be >= 1, got "
                             f"{self.bucket_multiple}")
        self.positions = np.zeros((slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        self.admission_events: List[AdmissionEvent] = []
        self.preemption_events: List[PreemptionEvent] = []
        #: streaming admission policy; run() pins it to strict FIFO,
        #: run_stream() reconfigures it per call
        self.scheduler = StreamScheduler(cost_model=self.cost_model)
        #: the run's cost clock (TokenCostModel units) and this step's spend
        self._cost_clock = 0.0
        self._step_spent = 0.0
        #: per-step (cost_spent, decoded slots) of the last run
        self.last_run_step_costs: List[Tuple[float, int]] = []
        #: host-clock totals of the last run: prefill calls, decode steps
        #: (plain and speculative), draft passes of ``draft_steps`` decode
        #: steps in all, and verify calls (each ends in a device-to-host
        #: transfer, so the device work is included)
        self.last_run_stats: Dict[str, float] = {}
        self._stats: Dict[str, float] = {}
        #: uids queued or active, and uids of an arrival trace not yet
        #: injected: duplicates would corrupt the uid-keyed bookkeeping
        self._inflight: set = set()
        self._pending_trace_uids: set = set()
        self._step = 0              # current engine step (0 when idle)
        # once-per-engine warnings (the tracker still counts every one)
        self._warned_dense_fallback = False
        self._warned_truncation = False
        self._warned_swap_failed = False
        #: cumulative engine steps ever served — the tracker's step domain
        self._obs_step = 0
        self._tracker = NOOP
        self._obs = False
        if tracker is not None:
            self.tracker = tracker

    # -- observability -----------------------------------------------------
    @property
    def tracker(self) -> Tracker:
        """The metrics backend every serving layer reports through; shared
        with the scheduler and the KV cache."""
        return self._tracker

    @tracker.setter
    def tracker(self, t: Tracker) -> None:
        self._tracker = t
        self._obs = not t.is_noop
        self.scheduler.tracker = t
        if self.kv is not None:
            self.kv.set_tracker(t)

    def _observe_decode(self, served: Dict[int, Tuple[Request, int]]
                        ) -> None:
        """Per-decode-step metrics from host-side slot bookkeeping only
        (gated behind ``self._obs`` by the caller): ``served`` maps each
        slot this step decoded for to its request and the tokens it
        emitted (speculative slots accept several)."""
        tr = self._tracker
        s = self._obs_step
        tr.gauge("engine/live_slots", len(served), step=s)
        tr.gauge("scheduler/queue_depth", len(self.scheduler), step=s)
        by_adapter: Dict[str, int] = {}
        for r, n in served.values():
            by_adapter[r.adapter] = by_adapter.get(r.adapter, 0) + n
        for a, n in by_adapter.items():
            tr.count(f"engine/tokens/{a}", n, step=s)
        if self.kv is not None:
            self.kv.observe_pool(step=s)

    # -- adapters ----------------------------------------------------------
    def register_adapter(self, name: str, params,
                         peft_cfg: Optional[PEFTConfig] = None) -> None:
        """Make one fine-tuned tree servable by name.  ``peft_cfg``
        defaults to the engine's construction-time PEFT config.

        Safe mid-:meth:`run_stream`: the bank grows by one column at the
        next step boundary (a new bank epoch) and only requests admitted
        afterwards see the adapter.  A live name raises: swap its weights
        with :meth:`update_adapter`."""
        if name in self._sources:
            if name == BASE_ADAPTER:
                raise ValueError(
                    "cannot re-register the 'base' adapter: every bank "
                    "column stores a delta against the serving base — "
                    "build a new engine to change base weights")
            raise ValueError(
                f"adapter {name!r} is already registered: call "
                f"update_adapter() to swap in new weights (an explicit "
                f"epoch bump; in-flight requests keep the old ones)")
        pc = peft_cfg if peft_cfg is not None else self.base_peft
        self._sources[name] = (params, pc)
        self.lifecycle.queue_register(name, params, pc)

    def update_adapter(self, name: str, params,
                       peft_cfg: Optional[PEFTConfig] = None) -> None:
        """Replace a live adapter's weights with a new fine-tune snapshot
        (:class:`AdapterFeed` calls this).  ``peft_cfg`` defaults to the
        adapter's previous config.  Mid-run the swap lands at the next step
        boundary as a fresh column and epoch: admitted requests finish on
        the weights (and KV) they started with, later ones serve the new
        version; compaction reclaims the old column once its last pinned
        request finishes."""
        if name == BASE_ADAPTER:
            raise ValueError(
                "cannot update the 'base' adapter: every bank column "
                "stores a delta against the serving base — build a new "
                "engine to change base weights")
        if name not in self._sources:
            raise KeyError(
                f"unknown adapter {name!r}; registered: "
                f"{self.list_adapters()} (register_adapter adds new names)")
        prev_source = self._sources[name]
        pc = peft_cfg if peft_cfg is not None else prev_source[1]
        self._sources[name] = (params, pc)
        self.lifecycle.queue_update(name, params, pc, prev_source)

    def unregister_adapter(self, name: str) -> None:
        """Retire an adapter without draining: active and suspended
        requests pinned to it finish on their admission epoch; its column
        is reclaimed at the next compaction.  Raises while queued,
        never-admitted requests still demand the name (they hold no pin to
        finish on)."""
        if name == BASE_ADAPTER:
            raise ValueError("cannot unregister the 'base' adapter")
        if name not in self._sources:
            raise KeyError(
                f"unknown adapter {name!r}; registered: "
                f"{self.list_adapters()}")
        if name in self.scheduler.demanded_adapters(self.default_spec):
            raise ValueError(
                f"cannot unregister adapter {name!r}: queued requests "
                f"still demand it (serve or cancel them first; ACTIVE "
                f"requests are fine — they finish on their pinned epoch)")
        del self._sources[name]
        self.lifecycle.queue_unregister(name)

    def add_step_hook(self, fn) -> None:
        """Run ``fn(engine, step)`` at the top of every :meth:`run_stream`
        step, after that step's arrivals and before queued bank mutations
        apply: the mid-run mutation point (:class:`AdapterFeed` attaches
        here)."""
        self._step_hooks.append(fn)

    def compact_banks(self) -> int:
        """Reclaim the bank columns no live epoch references (retired
        adapter versions) now, instead of at the next swap.  Returns the
        number of columns reclaimed."""
        return self.lifecycle.compact()

    def _pinned_requests(self) -> List[Request]:
        """Every request holding a bank-column pin: the active slots and
        the scheduler's resume lane (what compaction remaps)."""
        out = [r for r in self.active if r is not None]
        out.extend(self.scheduler.resume_requests())
        return out

    def list_adapters(self) -> List[str]:
        return sorted(self._sources)

    def _adapter_source(self, name: str):
        try:
            return self._sources[name]
        except KeyError:
            raise KeyError(f"unknown adapter {name!r}; registered: "
                           f"{self.list_adapters()}") from None

    def _adapter_id(self, name: str) -> int:
        """name -> bank column in the current epoch, O(1)."""
        try:
            return self._adapter_index[name]
        except KeyError:
            self._adapter_source(name)   # raises the descriptive KeyError
            raise

    def _banked_tree(self):
        """Merged base tree with a stacked adapter bank on every linear an
        adapter updates: built once, then grown and compacted by the
        lifecycle, whose queued mutations apply here.  The bank's ``left``
        factors are stored in the compute dtype: every consumer casts them
        to it before use."""
        return self.lifecycle.tree()

    def _refresh_tree(self) -> None:
        """Apply queued bank mutations at a step boundary.  A failing one
        must not take down the in-flight batch: the lifecycle rolls it
        back, and the failure is a once-per-engine warning plus the
        ``engine/bank/swap_failed`` event.  The pre-run build raises."""
        if not self.lifecycle.dirty:
            return
        try:
            self._banked_tree()
        except Exception as err:
            if not self._warned_swap_failed:
                self._warned_swap_failed = True
                warnings.warn(
                    f"mid-run adapter bank swap failed and was rolled "
                    f"back; the previous epoch keeps serving ({err})")

    def _pin(self, r: Request) -> None:
        """Pin a freshly admitted request to the current bank epoch."""
        sc = self._spec_for(r)
        self.lifecycle.pin(r, sc.draft_adapter if sc is not None else None)

    def _slot_col(self, r: Request) -> int:
        """The bank column a request computes with: its admission pin,
        else the current epoch's column."""
        col = getattr(r, "_bank_col", None)
        return col if col is not None else self._adapter_id(r.adapter)

    def _note_bank_kinds(self, kinds: Dict[str, int]) -> None:
        """Count every dense-delta bank on the tracker; warn once per
        engine."""
        if not kinds["delta"]:
            return
        self._tracker.count("engine/warnings/dense_fallback",
                            kinds["delta"], step=self._obs_step)
        if not self._warned_dense_fallback:
            self._warned_dense_fallback = True
            warnings.warn(
                f"{kinds['delta']} of {kinds['delta'] + kinds['left']} "
                f"adapter banks use the DENSE delta fallback. The low-rank "
                f"path needs every adapter's frozen base to equal the "
                f"serving base exactly: serving from a fine-tuned base "
                f"tree, or PiSSA/DoRA/OFT-family/full-FT adapters, all fall "
                f"back.")

    def _kv_key(self, r: Request) -> str:
        """The version-qualified KV prefix-alias key ``name#version``: an
        updated or re-registered adapter's requests never alias an earlier
        version's pages, while one version's requests share prefixes."""
        ver = getattr(r, "_kv_ver", None)
        if ver is None:
            ver = self.lifecycle.version_of(r.adapter)
        return f"{r.adapter}#{ver}"

    # -- sampling ----------------------------------------------------------
    def _sampling_for(self, r: Request) -> SamplingParams:
        return r.sampling if r.sampling is not None else self.default_sampling

    def _seed_for(self, r: Request) -> int:
        sp = self._sampling_for(r)
        return sp.seed if sp.seed is not None \
            else sampling_lib.derive_seed(self.sample_seed, r.uid)

    def _spec_for(self, r: Request) -> Optional[SpecConfig]:
        """The request's effective speculative-decode config, or None when
        it decodes plainly (no config, or the ``k = 0`` opt-out)."""
        sc = r.spec if r.spec is not None else self.default_spec
        return sc if sc is not None and sc.k > 0 else None

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, copied without waiting for
        the card."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)

    def _sampler_args(self, entries) -> Tuple[bool, tuple]:
        """``(greedy_only, per-row parameter tensors)`` of sampler rows
        ``entries`` = ``(params, seed, counter)``: an all-greedy call takes
        the argmax and needs no tensors."""
        temps, ks, ps, seeds, counters = sampling_lib.stack(entries)
        if bool((temps <= 0.0).all()):
            return True, (None,) * 5
        return False, tuple(self._put(a) for a in (temps, ks, ps, seeds,
                                                   counters))

    def _draw(self, logits_rows: torch.Tensor, entries, want_lp: bool):
        """One sampler call on the device over rows ``entries``, its
        outputs brought back in one device-to-host transfer."""
        greedy_only, args = self._sampler_args(entries)
        return sampling_lib.to_host(*sampling_lib.sample_tokens(
            logits_rows, *args, want_logprobs=want_lp,
            greedy_only=greedy_only))

    def _sample_rows(self, logits_rows: torch.Tensor,
                     reqs: List[Optional[Request]],
                     draft_rows: int = 0) -> np.ndarray:
        """Draw every row's next token in one sampler call on the device.

        ``logits_rows`` is the ``(B, vocab)`` last-position logits; ``reqs
        [j]`` is the request row ``j`` samples for, or None for rows whose
        draw is discarded (ghosts, resumed requests whose next token
        predates their suspension).  Each live row's draw is
        ``fold_in(PRNGKey(seed), len(generated))``.  One device-to-host
        transfer brings back the tokens, plus the logprobs when a row asked
        for them.  ``draft_rows`` of the None rows belong to slots the
        speculative path served this step (occupancy metrics only).  The
        caller MUST append the returned token for every non-None row."""
        greedy = SamplingParams.greedy()
        entries = []
        for r in reqs:
            if r is None:
                entries.append((greedy, 0, 0))
            else:
                entries.append((self._sampling_for(r), self._seed_for(r),
                                len(r.generated)))
        if self._obs:
            sampling_lib.record_occupancy(self._tracker, reqs,
                                          step=self._obs_step,
                                          draft_rows=draft_rows)
        want_lp = any(r is not None and self._sampling_for(r).logprobs
                      for r in reqs)
        toks, chosen, top_ids, top_lps = self._draw(logits_rows, entries,
                                                    want_lp)
        if want_lp:
            for j, r in enumerate(reqs):
                n = 0 if r is None else self._sampling_for(r).logprobs
                if n:
                    r.logprobs.append(TokenLogprobs(
                        int(toks[j]), float(chosen[j]),
                        tuple(int(t) for t in top_ids[j, :n]),
                        tuple(float(v) for v in top_lps[j, :n])))
        return toks

    def _hit_stop(self, r: Request) -> bool:
        """Whether the request's latest token is one of its stop ids."""
        return bool(r.generated) and \
            r.generated[-1] in self._sampling_for(r).stop_token_ids

    # -- admission ---------------------------------------------------------
    def _bucket(self, plen: int) -> int:
        """Right-pad prefill length to a ``bucket_multiple`` multiple (pads
        are never attended: logits read the last real token).  Recurrent
        families prefill at the exact length: their states would take the
        pad tokens in."""
        if self.cfg.family in ("ssm", "hybrid"):
            return plen
        m = self.bucket_multiple
        return min(self.max_len, -(-plen // m) * m)

    @staticmethod
    def _target_seq(r: Request) -> np.ndarray:
        """Full sequence a (re)admission must make resident: the prompt
        plus every already-decoded token but the latest (the next decode
        input, preserved across suspend/resume)."""
        return np.concatenate([np.asarray(r.prompt, np.int32),
                               np.asarray(r.generated[:-1], np.int32)])

    @staticmethod
    def _resident_seq(r: Request) -> np.ndarray:
        """Tokens whose KV is resident for an active request: the target
        sequence, or only its completed chunks while mid-prefill."""
        full = ServeEngine._target_seq(r)
        if not getattr(r, "_prefill_done", True):
            return full[:r._prefill_pos]
        return full

    def _record_admissions(self, step: int, group, next_tokens) -> None:
        """Install one admission pass's slot fills.  ``group`` entries are
        ``(slot, r, pref, seq, resumed, end, final)``: ``end`` tokens of
        ``seq`` are resident after this prefill call and ``final`` says
        whether that is all of them.  ``next_tokens[j]`` is the sampled
        first token, or None for rows that don't sample one."""
        for j, (slot, r, pref, seq, resumed, end, final) in enumerate(group):
            others = tuple(q.uid for i, q in enumerate(self.active)
                           if q is not None and i != slot)
            self.active[slot] = r
            first = r.admit_step is None
            if first:
                r.admit_step = step
            tok = next_tokens[j]
            if tok is not None:
                r.generated.append(int(tok))
            if final:
                r._prefill_done = True
                self.positions[slot] = len(seq)
            else:
                r._prefill_done = False
                r._prefill_pos = end
                self.positions[slot] = 0
            ev = AdmissionEvent(step=step, slot=slot, uid=r.uid,
                                adapter=r.adapter, resumed=resumed,
                                prefix_tokens=int(pref),
                                queueing_delay=r.queueing_delay,
                                others=others)
            self.admission_events.append(ev)
            if self._obs:
                tr = self._tracker
                s = self._obs_step
                tr.event("engine/admission", dataclasses.asdict(ev), step=s)
                if tok is not None:
                    tr.count(f"engine/tokens/{r.adapter}", step=s)
                if first:
                    tr.histogram("engine/queueing_delay", r.queueing_delay,
                                 step=s)
                if self.scheduler.at_risk(r, self._cost_clock):
                    tr.count("scheduler/at_risk_admissions", step=s)
                if final and self.prefill_chunk_tokens is not None:
                    tr.histogram("engine/prefill_stall_steps",
                                 step - r.admit_step, step=s)

    def _admit(self, step: int) -> None:
        """Fill every free slot from the scheduler (budget permitting): a
        candidate that doesn't fit the page pool is skipped for up to
        ``lookahead`` later ones; a deadline-at-risk candidate may preempt
        a lower-priority running slot instead of waiting."""
        free = [i for i in range(self.slots) if self.active[i] is None]
        if not free or not self.scheduler.has_work():
            return
        cm = self.cost_model
        if (cm.step_budget is not None
                and self._step_spent >= cm.step_budget
                and any(r is not None for r in self.active)):
            return
        if self.cache_mode == "paged":
            self._admit_paged(free, step)
        else:
            self._admit_dense(free, step)

    def _admit_dense(self, free: List[int], step: int) -> None:
        """Dense slots always fit: admit straight down the policy order,
        one prefill call per bucket (a recurrent family's bucket is the
        exact prompt length), each row then copied into its slot."""
        admitted = []
        while free and self.scheduler.has_work():
            r, _resumed = self.scheduler.window(self._cost_clock)[0]
            self.scheduler.remove(r)
            self._pin(r)
            seq = np.asarray(r.prompt, np.int32)
            admitted.append((free.pop(0), r, 0, seq, False, len(seq), True))
        groups: Dict[int, list] = {}
        for entry in admitted:
            groups.setdefault(self._bucket(len(entry[3])), []).append(entry)
        for bucket, group in groups.items():
            g = len(group)
            toks = np.zeros((g, bucket), np.int32)
            lens = np.zeros((g,), np.int32)
            ids = np.zeros((g,), np.int32)
            for j, (_slot, r, _pref, seq, _res, _end, _fin) in \
                    enumerate(group):
                toks[j, :len(seq)] = seq
                lens[j] = len(seq)
                ids[j] = self._slot_col(r)
            self._step_spent += self.cost_model.prefill_cost(int(lens.sum()))
            t0 = time.perf_counter()
            with self._tracker.time_block("engine/prefill_s",
                                          step=self._obs_step):
                logits, cache = model_lib.prefill(
                    self._tree, {"tokens": self._put(toks)}, self.cfg,
                    self.max_len, self._put(lens), moe_impl="dense",
                    adapter_ids=self._put(ids))
                nxt = self._sample_rows(logits[:, -1, :self.cfg.vocab_size],
                                        [e[1] for e in group])
            self._stats["prefill_s"] += time.perf_counter() - t0
            self._stats["prefill_calls"] += 1
            for j, (slot, *_rest) in enumerate(group):
                self._install_cache(slot, cache, j)
            self._record_admissions(step, group, nxt)

    def _install_cache(self, slot: int, cache, j: int) -> None:
        """Copy prefill row ``j`` into slot ``slot`` of the dense cache, on
        each leaf's batch axis: axis 1 of a layer-stacked leaf, axis 0 of a
        hybrid's per-layer leaf."""
        axis = 0 if isinstance(self.cache, list) else 1
        tree_map(lambda dst, src: dst.select(axis, slot).copy_(
            src.select(axis, j)), self.cache, cache)

    # -- preemption --------------------------------------------------------
    def _suspend(self, slot: int, step: int) -> None:
        """Preempt ``slot``: park its computed KV in the retained-prefix
        pool, release its pages, and queue it for resumption."""
        r = self.active[slot]
        resident = self._resident_seq(r)
        r._kv_pin = self.kv.suspend_slot(slot, resident, self._kv_key(r),
                                         priority=r.priority)
        self.active[slot] = None
        self.positions[slot] = 0
        r.preemptions += 1
        ev = PreemptionEvent(step=step, slot=slot, uid=r.uid,
                             adapter=r.adapter, priority=r.priority,
                             resident_tokens=len(resident))
        self.preemption_events.append(ev)
        if self._obs:
            self._tracker.count("engine/preemptions", step=self._obs_step)
            self._tracker.event("engine/preemption", dataclasses.asdict(ev),
                                step=self._obs_step)
        self.scheduler.push_resume(r)

    def _eligible_victims(self, r: Request, frozen) -> List[int]:
        """Slots suspendable so deadline-at-risk ``r`` can be admitted:
        strictly lower priority (or equal priority with no deadline of its
        own), lowest priority first, most slack first.  ``frozen`` slots
        (admitted this pass) are never victims."""
        sched = self.scheduler
        cands = []
        for j, occ in enumerate(self.active):
            if occ is None or j in frozen:
                continue
            if occ.priority < r.priority or (
                    occ.priority == r.priority
                    and occ.deadline is None and r.deadline is not None):
                cands.append((occ.priority,
                              -sched.slack(occ, self._cost_clock), j))
        return [c[-1] for c in sorted(cands)]

    def _pick_decode_victim(self) -> Optional[int]:
        """Slot to suspend when a KV write cannot get a page: lowest
        priority, then most slack, then most recently admitted."""
        sched = self.scheduler
        cands = [(occ.priority, -sched.slack(occ, self._cost_clock),
                  -(occ.admit_step or 0), j)
                 for j, occ in enumerate(self.active) if occ is not None]
        return min(cands)[-1] if cands else None

    def _try_admit_pages(self, free: List[int], r: Request, resumed: bool,
                         step: int, frozen
                         ) -> Optional[Tuple[int, np.ndarray]]:
        """Allocate slot ``free[0]``'s pages for ``r``; returns (aliased
        prefix length, token sequence) or None when they don't fit.  Under
        the preempting policy a deadline-at-risk ``r`` suspends victims
        (their slots join ``free``) until it fits or none is left, and the
        reservation is prompt-only (decode grows pages on demand)."""
        kv = self.kv
        seq = self._target_seq(r) if resumed \
            else np.asarray(r.prompt, np.int32)
        reserve = None if self.scheduler.preempt \
            else min(len(r.prompt) + r.max_new_tokens, self.max_len)
        alloc = self.prefill_chunk_tokens if reserve is None else None
        while True:
            try:
                if resumed:
                    prefix = kv.resume_slot(
                        free[0], seq, self._kv_key(r),
                        reserve_tokens=reserve, alloc_tokens=alloc,
                        pin=getattr(r, "_kv_pin", None))
                    r._kv_pin = None
                else:
                    prefix = kv.admit(free[0], seq, self._kv_key(r),
                                      reserve_tokens=reserve,
                                      alloc_tokens=alloc)
                return prefix, seq
            except OutOfPages:
                if not (self.scheduler.preempt
                        and self.scheduler.at_risk(r, self._cost_clock)):
                    return None
                victims = self._eligible_victims(r, frozen)
                if not victims:
                    return None
                # suspend only when preemption can cover the shortfall
                need = -(-(len(seq) if reserve is None else reserve)
                         // kv.page_size) - kv.alias_probe(seq,
                                                           self._kv_key(r))
                gain = sum(kv.exclusive_pages(j) for j in victims)
                if kv.allocatable_pages() + gain < need:
                    return None
                self._suspend(victims[0], step)
                free.append(victims[0])

    def _admit_paged(self, free: List[int], step: int) -> None:
        admitted = []          # (slot, request, prefix, seq, resumed)
        frozen = set()         # slots filled this pass: not preemptible
        while free and self.scheduler.has_work():
            pick = None
            skipped = 0
            for r, resumed in self.scheduler.window(self._cost_clock):
                res = self._try_admit_pages(free, r, resumed, step, frozen)
                if res is not None:
                    pick = (r, resumed) + res
                    break
                skipped += 1
            if self._obs and skipped:
                self._tracker.count("scheduler/lookahead_skips", skipped,
                                    step=self._obs_step)
            if pick is None:
                break          # retry after running slots free pages
            r, resumed, prefix, seq = pick
            self.scheduler.remove(r)
            self._pin(r)       # a resumed request keeps its epoch
            slot = free.pop(0)
            frozen.add(slot)
            admitted.append((slot, r, prefix, seq, resumed))
        if not admitted:
            return
        for group, nxt in self._run_prefill_groups(admitted):
            self._record_admissions(step, group, nxt)

    def _chunk_plan(self, prefix: int, total: int) -> Tuple[int, bool]:
        """``(end, final)`` of this prefill call for a row whose first
        ``prefix`` of ``total`` tokens are resident."""
        chunk = self.prefill_chunk_tokens
        if chunk is None or total - prefix <= chunk:
            return total, True
        return prefix + chunk, False

    def _run_prefill_groups(self, entries):
        """One paged prefill call per suffix bucket over ``entries`` =
        ``(slot, r, prefix, seq, resumed)``, each row chunked by
        :meth:`_chunk_plan`.  Returns ``[(group, next_tokens)]`` with
        entries extended by ``(end, final)``; a row samples only on its
        final chunk and only if it never sampled before."""
        kv = self.kv
        plans = [(slot, r, prefix, seq, resumed) + self._chunk_plan(
                     prefix, len(seq))
                 for slot, r, prefix, seq, resumed in entries]
        groups: Dict[int, list] = {}
        for entry in plans:
            _slot, _r, prefix, _seq, _res, end, _fin = entry
            groups.setdefault(self._bucket(end - prefix), []).append(entry)
        out = []
        for bucket, group in groups.items():
            g = len(group)
            toks = np.zeros((g, bucket), np.int32)
            lens = np.zeros((g,), np.int32)
            prefs = np.zeros((g,), np.int32)
            ids = np.zeros((g,), np.int32)
            rows = np.zeros((g, kv.pages_per_slot), np.int32)
            for j, (slot, r, prefix, seq, _res, end, _fin) in \
                    enumerate(group):
                suffix = seq[prefix:end]
                toks[j, :len(suffix)] = suffix
                lens[j] = len(suffix)
                prefs[j] = prefix
                ids[j] = self._slot_col(r)
                rows[j] = kv.tables[slot]
            # the prefix table is empty (no aliasing in the group: the
            # exact chunked path) or the full table masked by prefix_len,
            # which need not be page-aligned (a mid-page chunk boundary)
            n_pref = kv.pages_per_slot if prefs.max() else 0
            self._step_spent += self.cost_model.prefill_cost(int(lens.sum()))
            sample_for = [r if (fin and not r.generated) else None
                          for _s, r, _p, _sq, _res, _e, fin in group]
            t0 = time.perf_counter()
            with self._tracker.time_block("engine/prefill_s",
                                          step=self._obs_step):
                cache = {"k": kv.pools["k"], "v": kv.pools["v"],
                         "page_table": kv.table_tensor(rows),
                         "prefix_table": kv.table_tensor(rows[:, :n_pref])}
                logits, _ = model_lib.paged_prefill(
                    self._tree, {"tokens": self._put(toks)}, cache,
                    self.cfg, self._put(lens), self._put(prefs),
                    adapter_ids=self._put(ids))
                nxt = [None] * g
                if any(q is not None for q in sample_for):
                    drawn = self._sample_rows(
                        logits[:, -1, :self.cfg.vocab_size], sample_for)
                    nxt = [None if sample_for[j] is None else int(drawn[j])
                           for j in range(g)]
            self._stats["prefill_s"] += time.perf_counter() - t0
            self._stats["prefill_calls"] += 1
            for slot, r, _pref, seq, _res, end, _fin in group:
                kv.commit_prompt(slot, seq[:end], self._kv_key(r))
            if self._obs and self.prefill_chunk_tokens is not None:
                self._tracker.count("engine/prefill_chunks", g,
                                    step=self._obs_step)
            out.append((group, nxt))
        return out

    def _any_decodable(self) -> bool:
        return any(r is not None and getattr(r, "_prefill_done", True)
                   for r in self.active)

    def _continue_prefills(self, step: int) -> None:
        """Advance every mid-prefill slot by one chunk (budget permitting;
        at least one chunk runs when nothing else can progress).  A chunk
        whose pages don't fit suspends the preferred victim or, without
        preemption, stalls until running slots free pages."""
        if self.prefill_chunk_tokens is None:
            return
        cm = self.cost_model
        entries = []
        for slot in range(self.slots):
            r = self.active[slot]
            if r is None or getattr(r, "_prefill_done", True):
                continue
            if (cm.step_budget is not None
                    and self._step_spent >= cm.step_budget
                    and (entries or self._any_decodable())):
                break
            target = self._target_seq(r)
            end, _fin = self._chunk_plan(r._prefill_pos, len(target))
            ok = False
            while self.active[slot] is not None:
                try:
                    self.kv.ensure_position(slot, end - 1)
                    ok = True
                    break
                except OutOfPages:
                    if not self.scheduler.preempt:
                        break              # stall: retry next step
                    victim = self._pick_decode_victim()
                    if victim is None:
                        break
                    self._suspend(victim, step)
            if ok and self.active[slot] is not None:
                entries.append((slot, r, r._prefill_pos, target, False))
        # a later slot's victim pick may have suspended an earlier entry
        entries = [e for e in entries if self.active[e[0]] is e[1]]
        if not entries:
            return
        for group, nxt in self._run_prefill_groups(entries):
            self._finish_chunks(step, group, nxt)

    def _finish_chunks(self, step: int, group, next_tokens) -> None:
        """Book a continuation pass's results (no AdmissionEvent: the slot
        was filled when its first chunk ran)."""
        for j, (slot, r, _pref, seq, _res, end, final) in enumerate(group):
            tok = next_tokens[j]
            if tok is not None:
                r.generated.append(int(tok))
            if final:
                r._prefill_done = True
                self.positions[slot] = len(seq)
            else:
                r._prefill_pos = end
                self.positions[slot] = 0
            if self._obs:
                tr = self._tracker
                s = self._obs_step
                if tok is not None:
                    tr.count(f"engine/tokens/{r.adapter}", step=s)
                if final:
                    tr.histogram("engine/prefill_stall_steps",
                                 step - r.admit_step, step=s)

    # -- decode --------------------------------------------------------------
    def _ensure_decode_pages(self, live: List[int], step: int) -> List[int]:
        """Give every live slot the page this step's KV write lands in.
        Under the preempting policy, pool pressure suspends the
        lowest-priority live slot (possibly the needy one) instead of
        faulting; returns the surviving live slots."""
        survivors: List[int] = []
        for i in live:
            while self.active[i] is not None:
                try:
                    self.kv.ensure_position(i, int(self.positions[i]))
                    survivors.append(i)
                    break
                except OutOfPages:
                    if not self.scheduler.preempt:
                        raise
                    victim = self._pick_decode_victim()
                    if victim is None:
                        raise
                    self._suspend(victim, step)
        return [i for i in survivors if self.active[i] is not None]

    def _decode_live(self, live: List[int], step: int):
        """One decode step over every slot; returns (last-position logits,
        surviving live slots).  Dead slots ride as ghosts (token 0, adapter
        0, position 0, all-trash table); so do mid-prefill slots, whose
        real table rows are redirected to the trash page in the call's
        table copy.  On a dense cache a dead slot's ghost write lands in its
        own row, which the next admission overwrites."""
        if self.cache_mode == "paged":
            live = self._ensure_decode_pages(live, step)
            if not live:
                return None, live
        toks = np.zeros((self.slots, 1), np.int32)
        ids = np.zeros((self.slots,), np.int32)
        positions = np.zeros((self.slots,), np.int32)
        for i in live:
            r = self.active[i]
            toks[i, 0] = r.generated[-1]
            ids[i] = self._slot_col(r)
            positions[i] = self.positions[i]
        if self.cache_mode == "dense":
            cache, view = self.cache, self._view_table
        else:
            for i in range(self.slots):
                if self.active[i] is None and \
                        not (self.kv.tables[i] == TRASH_PAGE).all():
                    raise RuntimeError(
                        f"dead slot {i} still maps pages "
                        f"{self.kv.tables[i].tolist()}; its ghost write "
                        f"would corrupt live KV")
            ghosted = [i for i in range(self.slots)
                       if self.active[i] is not None and i not in live]
            table = self.kv.tables
            if ghosted:
                table = table.copy()
                table[ghosted] = TRASH_PAGE
            cache = {"k": self.kv.pools["k"], "v": self.kv.pools["v"],
                     "page_table": self.kv.table_tensor(table)}
            view = None
        logits, _ = model_lib.decode_step(
            self._tree, {"tokens": self._put(toks)}, cache,
            self._put(positions), self.cfg, moe_impl="dense",
            adapter_ids=self._put(ids), view_table=view)
        return logits[:, -1, :self.cfg.vocab_size], live

    # -- speculative decode ------------------------------------------------
    def _spec_step(self, spec_live: List[int], step: int
                   ) -> Tuple[Dict[int, int], List[int]]:
        """One draft + verify pass over the speculative live slots.
        Returns ``(handled, demoted)``: slot -> accepted token count for
        the slots it served, and the slots whose window clamped below 1
        this step (they decode plainly).

        The window is clamped so it never overshoots: ``k + 1 <=
        remaining_tokens`` (a full accept emits k + 1 tokens), positions
        inside ``max_len``, and under pool pressure inside the pages the
        slot already holds (speculation never preempts to grow a
        window)."""
        handled: Dict[int, int] = {}
        demoted: List[int] = []
        # the step's guaranteed write (position `pos`) takes the normal
        # preempting path; only the window's extra pages are best-effort
        spec_live = self._ensure_decode_pages(spec_live, step)
        kv = self.kv
        plans = []
        for i in spec_live:
            r = self.active[i]
            sc = self._spec_for(r)
            pos = int(self.positions[i])
            n0 = int(kv.n_pages[i])
            k = min(sc.k, r.remaining_tokens - 1, self.max_len - 2 - pos)
            if k >= 1:
                try:
                    kv.ensure_position(i, pos + k)
                except OutOfPages:
                    k = min(k, int(kv.n_pages[i]) * kv.page_size - 1 - pos)
            if k < 1:
                demoted.append(i)
                continue
            plans.append((i, r, sc, pos, n0, k))
        # one draft pass and one verify call per distinct window width
        groups: Dict[int, list] = {}
        for pl in plans:
            groups.setdefault(pl[-1], []).append(pl)
        for k in sorted(groups):
            handled.update(self._spec_group(groups[k], k))
        return handled, demoted

    def _draft(self, group, k: int) -> np.ndarray:
        """``k`` chained draft decode steps over every slot: ``(slots, k)``
        drafted tokens.  Group rows decode on their draft adapter at their
        own positions and draw on their own ``(seed, counter + j)``
        streams; every other row rides as a greedy ghost at position ``j``
        with its table row masked to the trash page.  The tokens stay on
        the device between steps and come back in one transfer."""
        kv = self.kv
        greedy = SamplingParams.greedy()
        tok0 = np.zeros((self.slots, 1), np.int32)
        ids = np.zeros((self.slots,), np.int32)
        positions = np.zeros((self.slots,), np.int32)
        entries = [(greedy, 0, 0)] * self.slots
        for i, r, sc, pos, _n0, _k in group:
            tok0[i, 0] = r.generated[-1]
            dcol = getattr(r, "_draft_col", None)
            ids[i] = dcol if dcol is not None \
                else self._adapter_id(sc.draft_adapter)
            positions[i] = pos
            entries[i] = (self._sampling_for(r), self._seed_for(r),
                          len(r.generated))
        table = kv.tables.copy()
        in_group = {pl[0] for pl in group}
        table[[i for i in range(self.slots) if i not in in_group]] = \
            TRASH_PAGE
        cache = {"k": kv.pools["k"], "v": kv.pools["v"],
                 "page_table": kv.table_tensor(table)}
        greedy_only, (temps, ks, ps, seeds, counters) = \
            self._sampler_args(entries)
        tok, ids_t, pos_t = self._put(tok0), self._put(ids), \
            self._put(positions)
        drafted = []
        for j in range(k):
            logits, _ = model_lib.decode_step(
                self._tree, {"tokens": tok}, cache, pos_t + j, self.cfg,
                moe_impl="dense", adapter_ids=ids_t)
            nxt, _, _, _ = sampling_lib.sample_tokens(
                logits[:, -1, :self.cfg.vocab_size], temps, ks, ps, seeds,
                None if greedy_only else counters + j, want_logprobs=False,
                greedy_only=greedy_only)
            drafted.append(nxt)
            tok = nxt[:, None]
        self._stats["draft_steps"] += k
        return torch.stack(drafted, dim=1).cpu().numpy()

    def _verify(self, group, drafted: np.ndarray) -> torch.Tensor:
        """One paged prefill over each group row's ``[last token,
        drafts...]`` window at positions ``pos..pos + k``, on the row's
        serving adapter, with its full page table as the prefix table and
        ``pos`` as the prefix length: ``(g, k + 1, vocab)`` logits, one
        target distribution per window position.  The window's KV writes
        (over the draft's) land at positions ``>= pos``, so the prefix the
        attention reads is committed target KV only."""
        kv = self.kv
        g, w = len(group), drafted.shape[1] + 1
        toks = np.zeros((g, w), np.int32)
        prefs = np.zeros((g,), np.int32)
        ids = np.zeros((g,), np.int32)
        rows = np.zeros((g, kv.pages_per_slot), np.int32)
        for j, (i, r, _sc, pos, _n0, _k) in enumerate(group):
            toks[j, 0] = r.generated[-1]
            toks[j, 1:] = drafted[i]
            prefs[j] = pos
            ids[j] = self._slot_col(r)
            rows[j] = kv.tables[i]
        table = kv.table_tensor(rows)
        cache = {"k": kv.pools["k"], "v": kv.pools["v"],
                 "page_table": table, "prefix_table": table}
        logits, _ = model_lib.paged_prefill(
            self._tree, {"tokens": self._put(toks)}, cache, self.cfg,
            self._put(np.full((g,), w, np.int32)), self._put(prefs),
            adapter_ids=self._put(ids), all_logits=True)
        return logits[:, :, :self.cfg.vocab_size]

    def _spec_group(self, group, k: int) -> Dict[int, int]:
        """Draft, verify and accept one k-wide group of speculative slots:
        one sampler call draws the target token at all ``g (k + 1)`` window
        positions from the rows' own counter streams, and
        :func:`accepted_prefix` keeps the draft prefix the target agrees
        with (plus the bonus draw after a full match), cut at a stop id
        and at ``remaining_tokens``.  Whole pages past the last kept
        position go back to the pool."""
        kv = self.kv
        cm = self.cost_model
        g, w = len(group), k + 1
        t0 = time.perf_counter()
        drafted = self._draft(group, k)
        t1 = time.perf_counter()
        self._step_spent += cm.draft_cost(k)
        logits = self._verify(group, drafted)
        self._step_spent += cm.verify_cost(g * w)
        entries = []
        for _i, r, _sc, _pos, _n0, _k in group:
            sp, seed, m = self._sampling_for(r), self._seed_for(r), \
                len(r.generated)
            entries += [(sp, seed, m + t) for t in range(w)]
        want_lp = any(self._sampling_for(pl[1]).logprobs for pl in group)
        target, chosen, top_ids, top_lps = self._draw(
            logits.reshape(g * w, -1), entries, want_lp)
        st = self._stats
        st["draft_s"] += t1 - t0
        st["verify_s"] += time.perf_counter() - t1
        st["draft_passes"] += 1
        st["verify_calls"] += 1
        target = target.reshape(g, w)
        handled: Dict[int, int] = {}
        for j, (i, r, _sc, pos, n0, _k) in enumerate(group):
            acc = accepted_prefix(drafted[i], target[j])
            sp = self._sampling_for(r)
            for t, tok in enumerate(acc):
                if tok in sp.stop_token_ids:
                    acc = acc[:t + 1]          # keep the stop id itself
                    break
            # cut before appending: remaining_tokens reads generated
            acc = acc[:r.remaining_tokens]
            for t, tok in enumerate(acc):
                r.generated.append(int(tok))
                if sp.logprobs:
                    row, n = j * w + t, sp.logprobs
                    r.logprobs.append(TokenLogprobs(
                        int(tok), float(chosen[row]),
                        tuple(int(x) for x in top_ids[row, :n]),
                        tuple(float(v) for v in top_lps[row, :n])))
            a = len(acc)
            self.positions[i] = pos + a
            # positions past pos + a - 1 hold rejected-draft KV: return
            # their whole pages; max(n0, ...) keeps run()'s worst-case
            # reservation
            kv.truncate_slot(i, max(n0, (pos + a - 1) // kv.page_size + 1))
            handled[i] = a
        if self._obs:
            tr = self._tracker
            s = self._obs_step
            sum_a = sum(handled.values())
            tr.count("engine/spec/draft_tokens", k * g, step=s)
            tr.count("engine/spec/accepted_tokens", sum_a, step=s)
            for a in handled.values():
                tr.histogram("engine/spec/accepted_len", a, step=s)
            tr.gauge("engine/spec/accept_rate", (sum_a - g) / (k * g),
                     step=s)
        return handled

    def _finish_slot(self, slot: int, finished: List[Request], step: int,
                     reason: str = "length") -> None:
        r = self.active[slot]
        r.done = True
        r.finish_reason = reason
        r.finish_step = step
        r.finish_cost = self._cost_clock
        self.lifecycle.release(r)
        self._resolve_finished(r, finished)
        self._inflight.discard(r.uid)
        self.active[slot] = None
        self.positions[slot] = 0
        if self.kv is not None:
            self.kv.free_slot(slot)
        if self._obs:
            tr = self._tracker
            s = self._obs_step
            tr.count(f"engine/finish/{reason}", step=s)
            if r.slo_met is not None:
                tr.count("engine/slo_met" if r.slo_met
                         else "engine/slo_missed", step=s)
            tr.event("engine/finish", {
                "uid": r.uid, "adapter": r.adapter, "reason": reason,
                "tokens": len(r.generated),
                "queueing_delay": r.queueing_delay,
                "preemptions": r.preemptions, "slo_met": r.slo_met}, step=s)

    def _resolve_finished(self, r: Request, finished: List[Request]) -> None:
        """Deliver a finished or truncated request to the run's results.  A
        branch of an ``n > 1`` fan-out resolves into its parent instead:
        the parent comes back once, after its last branch, ``done`` if
        every branch finished, ``truncated`` if any was, with the earliest
        branch admission and the latest branch finish stamps."""
        parent = getattr(r, "_parent", None)
        if parent is None:
            finished.append(r)
            return
        if any(not (b.done or b.truncated) for b in parent.branches):
            return
        parent.done = all(b.done for b in parent.branches)
        parent.truncated = any(b.truncated for b in parent.branches)
        parent.finish_reason = "branches" if parent.done else None
        admits = [b.admit_step for b in parent.branches
                  if b.admit_step is not None]
        parent.admit_step = min(admits) if admits else None
        steps = [b.finish_step for b in parent.branches
                 if b.finish_step is not None]
        parent.finish_step = max(steps) if steps else None
        costs = [b.finish_cost for b in parent.branches
                 if b.finish_cost is not None]
        parent.finish_cost = max(costs) if costs else None
        self._inflight.discard(parent.uid)
        finished.append(parent)

    def _observe_truncated(self, r: Request) -> None:
        """Count a request returned as a partial; a deadlined one has
        missed its SLO."""
        if not self._obs:
            return
        s = self._obs_step
        self._tracker.count("engine/finish/truncated", step=s)
        if r.deadline is not None:
            self._tracker.count("engine/slo_missed", step=s)

    def _finish_admitted(self, finished: List[Request], step: int) -> None:
        """Finish slots whose prefill-sampled first token already completed
        the request (a stop id, or ``max_new_tokens == 1``) and refill them
        before this step's decode."""
        while True:
            ended = False
            for i, r in enumerate(self.active):
                if r is None:
                    continue
                if self._hit_stop(r):
                    self._finish_slot(i, finished, step, reason="stop")
                    ended = True
                elif len(r.generated) >= r.max_new_tokens:
                    self._finish_slot(i, finished, step)
                    ended = True
            if not ended:
                return
            self._admit(step)

    # -- request intake ----------------------------------------------------
    def _validate(self, r: Request) -> None:
        self._adapter_source(r.adapter)
        if r.n < 1:
            raise ValueError(f"request {r.uid}: n must be >= 1, got {r.n}")
        sc = self._spec_for(r)
        if sc is not None:
            if self.cache_mode != "paged":
                raise ValueError(
                    f"request {r.uid}: speculative decoding needs the "
                    f"paged KV cache (verify runs paged_prefill over the "
                    f"draft window; rollback releases window pages) — use "
                    f"cache_mode='paged' or SpecConfig(k=0)")
            self._adapter_source(sc.draft_adapter)  # unknown draft policy
        try:
            self._sampling_for(r).validate(self.cfg.vocab_size)
        except ValueError as e:
            raise ValueError(f"request {r.uid}: {e}") from None
        if not 0 < len(r.prompt) < self.max_len:
            raise ValueError(
                f"request {r.uid}: prompt length {len(r.prompt)} must be in "
                f"[1, max_len) = [1, {self.max_len})")
        if self.cfg.family not in _PAGED_FAMILIES:
            chunk, n = self.cfg.ssm.chunk_size, len(r.prompt)
            if n > chunk and n % chunk:
                raise ValueError(
                    f"request {r.uid}: prompt length {n} is not a multiple "
                    f"of the SSD chunk {chunk} (a recurrent family prefills "
                    f"at the exact prompt length, and ssd_chunked needs the "
                    f"chunk to divide a length above it)")
        if self.kv is None:
            return
        reserve = min(len(r.prompt) + r.max_new_tokens, self.max_len)
        need = -(-reserve // self.kv.page_size)
        if need > self.kv.num_pages - 1:
            raise ValueError(
                f"request {r.uid}: worst-case footprint of {need} pages "
                f"exceeds the pool ({self.kv.num_pages - 1} pages)")

    def submit(self, request: Request, arrival_step: Optional[int] = None,
               _validated: bool = False) -> None:
        """Enqueue one request for streaming admission (before or during
        :meth:`run_stream`; arrival is stamped at the current engine step
        unless ``arrival_step`` overrides it).  A request object served
        before is reset; a uid already queued or active raises."""
        if not _validated:
            self._validate(request)
        if request.uid in self._inflight \
                or request.uid in self._pending_trace_uids:
            raise ValueError(
                f"request uid {request.uid} is already queued or active — "
                f"in-flight uids must be unique")
        request.generated = []
        request.logprobs = []
        request.done = False
        request.truncated = False
        request.finish_reason = None
        request.admit_step = None
        request.finish_step = None
        request.finish_cost = None
        request.preemptions = 0
        if request.n > 1:
            self._submit_fanout(request, arrival_step)
            return
        request._prefill_done = True
        request._prefill_pos = 0
        request._kv_pin = None
        # epoch pins are per admission: a re-submitted request pins the
        # epoch current at its next admission
        request._epoch = None
        request._bank_col = None
        request._draft_col = None
        request._kv_ver = None
        request.arrival_step = (self._step if arrival_step is None
                                else arrival_step)
        request.arrival_cost = (
            self._cost_clock if self._step
            else self.cost_model.steps_to_cost(request.arrival_step))
        self._inflight.add(request.uid)
        self.scheduler.push(request)

    def _submit_fanout(self, request: Request,
                       arrival_step: Optional[int]) -> None:
        """Expand an ``n > 1`` request into ``n`` branch requests with
        uids ``(uid, b)`` and explicit seeds ``fold_in(seed, b)`` of the
        parent's effective seed, so a branch's draws depend on ``(parent
        seed, branch, position)`` only.  The first branch to prefill
        commits the prompt pages and later ones alias them.  The parent is
        never served; it resolves when its last branch does
        (:meth:`_resolve_finished`)."""
        base_seed = self._seed_for(request)
        sp = self._sampling_for(request)
        request.branches = []
        self._inflight.add(request.uid)
        for b in range(request.n):
            br = Request(uid=(request.uid, b), prompt=request.prompt,
                         max_new_tokens=request.max_new_tokens,
                         adapter=request.adapter,
                         sampling=dataclasses.replace(
                             sp, seed=sampling_lib.branch_seed(base_seed, b)),
                         priority=request.priority,
                         deadline=request.deadline, spec=request.spec)
            br._parent = request
            request.branches.append(br)
            self.submit(br, arrival_step=arrival_step, _validated=True)
        request.arrival_step = request.branches[0].arrival_step
        request.arrival_cost = request.branches[0].arrival_cost

    # -- serving -----------------------------------------------------------
    def run(self, requests: List[Request], max_steps: int = 512
            ) -> List[Request]:
        """Serve a static batch to completion (or ``max_steps``): every
        request arrives at step 0, strict FIFO admission with worst-case
        page reservation, no preemption (a thin wrapper over
        :meth:`run_stream`).  Every request comes back: finished ones
        ``done``, the rest ``truncated`` with their partial output."""
        seen = set()
        for r in requests:
            self._validate(r)
            if r.uid in seen or r.uid in self._inflight:
                raise ValueError(f"duplicate request uid {r.uid} in run() "
                                 f"batch — in-flight uids must be unique")
            seen.add(r.uid)
        for r in requests:
            self.submit(r, arrival_step=0, _validated=True)
        return self.run_stream(max_steps=max_steps, lookahead=0,
                               preempt=False)

    def run_stream(self,
                   arrivals: Optional[Iterable[Tuple[int, Request]]] = None,
                   max_steps: int = 512, lookahead: int = 4,
                   preempt: bool = True) -> List[Request]:
        """Streaming serve: ``arrivals`` is an optional trace of ``(step,
        request)`` pairs, each injected once the engine reaches that step
        (on top of anything already submitted).  ``lookahead`` bounds
        out-of-order admission past a head that doesn't fit; ``preempt``
        enables SLO-aware suspension, with prompt-only reservation and
        decode-time page growth (paged mode only).  Returns every request
        served this run (the completion/truncation contract of
        :meth:`run`)."""
        preempt = preempt and self.cache_mode == "paged"
        self.scheduler.configure(lookahead, preempt)
        trace = sorted(arrivals, key=lambda a: a[0]) if arrivals else []
        trace_uids = set()
        for _, r in trace:
            self._validate(r)
            if r.uid in trace_uids or r.uid in self._inflight:
                raise ValueError(
                    f"duplicate request uid {r.uid} in arrivals trace — "
                    f"in-flight uids must be unique")
            trace_uids.add(r.uid)
        self._banked_tree()
        self._pending_trace_uids = trace_uids
        self._stats = dict(prefill_s=0.0, prefill_calls=0, decode_s=0.0,
                           decode_steps=0, decode_tokens=0, draft_s=0.0,
                           draft_passes=0, draft_steps=0, verify_s=0.0,
                           verify_calls=0)
        finished: List[Request] = []
        steps = 0
        next_arrival = 0
        preempted_before = len(self.preemption_events)
        cm = self.cost_model
        self._cost_clock = 0.0
        self._step_spent = 0.0
        self.last_run_step_costs = []
        while (next_arrival < len(trace) or self.scheduler.has_work()
                or any(r is not None for r in self.active)) \
                and steps < max_steps:
            steps += 1
            self._step = steps
            self._obs_step += 1
            # unbudgeted the cost clock IS the step counter in cost units;
            # budgeted it advances by what the previous step spent
            if cm.step_budget is None:
                self._cost_clock = cm.steps_to_cost(steps)
            else:
                self._cost_clock += max(self._step_spent,
                                        cm.decode_step_cost)
            self._step_spent = 0.0
            while (next_arrival < len(trace)
                    and trace[next_arrival][0] <= steps):
                s, r = trace[next_arrival]
                self._pending_trace_uids.discard(r.uid)
                self.submit(r, arrival_step=s, _validated=True)
                next_arrival += 1
            # the step's mutation point: hooks may register, update or
            # unregister adapters; the queued mutations then apply in one
            # refresh, never inside a step
            for hook in tuple(self._step_hooks):
                hook(self, steps)
            self._refresh_tree()
            # mid-prefill slots advance a chunk before new admissions
            # compete for the step's budget
            self._continue_prefills(steps)
            self._admit(steps)
            self._finish_admitted(finished, steps)
            busy = [i for i, r in enumerate(self.active) if r is not None]
            live = [i for i in busy
                    if getattr(self.active[i], "_prefill_done", True)]
            if not live:
                if (not busy and self.cache_mode == "paged"
                        and self.scheduler.has_work()
                        and next_arrival >= len(trace)):
                    head = self.scheduler.window(self._cost_clock)[0][0]
                    raise self.kv.oom(
                        f"request {head.uid} (prompt {len(head.prompt)} "
                        f"tokens) cannot fit an idle page pool of "
                        f"{self.kv.num_pages - 1} pages x "
                        f"{self.kv.page_size} "
                        f"({self.kv.pages_resident()} resident, "
                        f"{self.kv.pages_resident() - self.kv.pages_in_use()}"
                        f" retained)")
                self.last_run_step_costs.append((self._step_spent, 0))
                continue
            span = (self._tracker.time_block("engine/decode_step_s",
                                             step=self._obs_step)
                    if self._obs else NULL_SPAN)
            t0 = time.perf_counter()
            #: slot -> (request, tokens emitted this step)
            served: Dict[int, Tuple[Request, int]] = {}
            plain = live
            with span:
                spec_live = [i for i in live
                             if self._spec_for(self.active[i]) is not None]
                if spec_live:
                    handled, demoted = self._spec_step(spec_live, steps)
                    served = {i: (self.active[i], a)
                              for i, a in handled.items()}
                    # demoted slots decode plainly this step; the spec
                    # pass may have suspended slots under pool pressure
                    plain = sorted(
                        [i for i in live if i not in spec_live
                         and self.active[i] is not None] + demoted)
                if plain:
                    rows, plain = self._decode_live(plain, steps)
                if plain:
                    # mid-prefill and spec-served slots ride the batch as
                    # ghosts: None rows draw nothing and return no token
                    reqs: List[Optional[Request]] = [None] * self.slots
                    for i in plain:
                        reqs[i] = self.active[i]
                    toks = self._sample_rows(rows, reqs,
                                             draft_rows=len(served))
            if plain:
                self._step_spent += cm.decode_step_cost
                for i in plain:
                    r = self.active[i]
                    r.generated.append(int(toks[i]))
                    self.positions[i] += 1
                    served[i] = (r, 1)
            if served:
                self._stats["decode_s"] += time.perf_counter() - t0
                self._stats["decode_steps"] += 1
                self._stats["decode_tokens"] += sum(
                    n for _r, n in served.values())
                if self._obs:
                    self._observe_decode(served)
            for i in sorted(served):
                r = self.active[i]
                if r is not served[i][0]:
                    continue            # suspended by a later page fault
                if self._hit_stop(r):
                    # stop id emitted: finish now, the slot refills at the
                    # next admission pass
                    self._finish_slot(i, finished, steps, reason="stop")
                elif (len(r.generated) >= r.max_new_tokens
                        or self.positions[i] >= self.max_len - 1):
                    self._finish_slot(i, finished, steps)
            if self._obs and cm.step_budget is not None:
                self._tracker.gauge("engine/step_budget_utilization",
                                    self._step_spent / cm.step_budget,
                                    step=self._obs_step)
            self.last_run_step_costs.append((self._step_spent, len(served)))
        self.last_run_stats = dict(self._stats, steps=steps)
        #: suspensions this run
        self.last_run_preemptions = \
            len(self.preemption_events) - preempted_before
        self.last_run_truncated = bool(
            next_arrival < len(trace) or self.scheduler.has_work()
            or any(r is not None for r in self.active))
        if self.last_run_truncated:
            self._truncate(finished, trace[next_arrival:], max_steps)
        self._pending_trace_uids = set()
        self._step = 0
        self._cost_clock = 0.0
        self._step_spent = 0.0
        return finished

    def _truncate(self, finished: List[Request], unarrived, max_steps: int
                  ) -> None:
        """Return everything still active, queued or not yet arrived as a
        partial (``truncated``), freeing pages and suspension pins."""
        n_active = sum(r is not None for r in self.active)
        n_queued = len(self.scheduler) + len(unarrived)
        if self._obs:
            self._tracker.count("engine/warnings/truncation",
                                step=self._obs_step)
        if not self._warned_truncation:
            self._warned_truncation = True
            warnings.warn(
                f"run hit max_steps={max_steps} with {n_active} active and "
                f"{n_queued} queued requests; returning them as partials "
                f"(done=False, truncated=True)")
        for i, r in enumerate(self.active):
            if r is None:
                continue
            r.truncated = True
            self._observe_truncated(r)
            self.lifecycle.release(r)
            self._resolve_finished(r, finished)
            self._inflight.discard(r.uid)
            self.active[i] = None
            self.positions[i] = 0
            if self.kv is not None:
                self.kv.free_slot(i)
        for r in self.scheduler.drain():
            r.truncated = True
            self._observe_truncated(r)
            self.lifecycle.release(r)
            if r._kv_pin is not None:
                # abandoned suspension: its retained pages demote to
                # ordinary residency
                self.kv.release_pin(r._kv_pin)
                r._kv_pin = None
            self._inflight.discard(r.uid)
            self._resolve_finished(r, finished)
        for _, r in unarrived:
            r.truncated = True
            self._observe_truncated(r)
            self._resolve_finished(r, finished)
