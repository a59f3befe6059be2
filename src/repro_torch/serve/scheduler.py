"""Streaming admission scheduler: arrival-stamped request queue with
priority/deadline ordering, bounded out-of-order lookahead, and a resume
lane for preempted requests.  A copy of the reference's
``repro/serve/scheduler.py``.

The scheduler is pure host-side policy — it never touches pages or device
state.  The engine asks it *which* request to try next
(:meth:`StreamScheduler.window`); the engine owns the page allocator and
reports back by removing admitted requests and pushing preempted ones onto
the resume lane.

**Ordering.**  Candidates are ranked by ``(-priority, deadline slack,
resumed-first, submission order)``:

* higher ``Request.priority`` first;
* among equal priorities, smaller *slack* first — slack is how much of the
  :class:`TokenCostModel` cost clock a request can still afford to wait and
  finish inside its ``Request.deadline`` (requests without a deadline have
  infinite slack).  The default cost model makes cost units equal engine
  steps;
* preempted requests outrank fresh arrivals at equal priority/slack (their
  prefill work is already invested and mostly resident);
* FIFO submission order breaks all remaining ties, so with uniform
  priorities and no deadlines the policy degenerates to exact FIFO.

**Bounded lookahead.**  Only the resume lane plus the first ``1 +
lookahead`` pending requests are candidates.  A request that cannot be
admitted (its pages don't fit) no longer blocks everything behind it — the
engine tries the next candidate in the window — but nothing *outside* the
window can overtake it, which bounds how long a large head can starve.
``lookahead=0`` restores strict FIFO head-of-line semantics (what
``ServeEngine.run`` uses).

**Deadline risk.**  :meth:`at_risk` flags requests whose slack has dropped
to ``risk_margin`` steps or fewer; the engine only preempts running slots
on behalf of at-risk candidates.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Tuple

from repro_torch.obs import NOOP, Tracker

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serve.engine import Request


@dataclass(frozen=True)
class TokenCostModel:
    """Estimated cost of engine work, in abstract *cost units*.

    The scheduler's deadline clock runs on these units rather than raw
    engine steps: one decode step costs ``decode_step_cost`` and prefilling
    ``n`` prompt tokens costs ``prefill_fixed_cost + n *
    prefill_token_cost``.  The defaults (decode step = 1, prefill free)
    make the cost clock numerically identical to the engine-step clock.
    Calibrate the costs in seconds (:meth:`calibrate`) and the same clock
    becomes a wall-clock SLO basis.

    ``step_budget``: optional cost ceiling per engine step.  When set, the
    engine chunk-prefills only while the step's accumulated cost stays
    under budget (always making at least one chunk of progress), so long
    prompts can't monopolize a step that live decodes are also paying for.
    ``None`` = unbudgeted: admission prefills whole prompts in one shot.
    """

    decode_step_cost: float = 1.0
    prefill_token_cost: float = 0.0
    prefill_fixed_cost: float = 0.0
    step_budget: Optional[float] = None
    #: cost of one speculative draft decode step (None: priced like a full
    #: decode step; a calibrated model may set it lower for a cheap draft)
    draft_step_cost: Optional[float] = None

    def __post_init__(self):
        if self.decode_step_cost <= 0:
            raise ValueError("decode_step_cost must be > 0, got "
                             f"{self.decode_step_cost}")
        if self.prefill_token_cost < 0 or self.prefill_fixed_cost < 0:
            raise ValueError("prefill costs must be >= 0")
        if self.draft_step_cost is not None and self.draft_step_cost <= 0:
            raise ValueError(f"draft_step_cost must be > 0 or None, got "
                             f"{self.draft_step_cost}")
        if self.step_budget is not None and self.step_budget <= 0:
            raise ValueError(f"step_budget must be > 0, got "
                             f"{self.step_budget}")

    def steps_to_cost(self, steps: float) -> float:
        """Engine-step count → cost units."""
        return steps * self.decode_step_cost

    def prefill_cost(self, tokens: int) -> float:
        """Cost of one prefill call over ``tokens`` suffix tokens."""
        return self.prefill_fixed_cost + tokens * self.prefill_token_cost

    def draft_cost(self, k: int) -> float:
        """Cost of drafting ``k`` speculative tokens (``k`` chained draft
        decode steps)."""
        c = self.draft_step_cost if self.draft_step_cost is not None \
            else self.decode_step_cost
        return k * c

    def verify_cost(self, tokens: int) -> float:
        """Cost of one speculative verify pass over ``tokens`` window
        positions in all: one decode step plus prefill-rate token work."""
        return self.decode_step_cost + tokens * self.prefill_token_cost

    @classmethod
    def calibrate(cls, decode_step_s: float, prefill_token_s: float,
                  prefill_fixed_s: float = 0.0,
                  step_budget_s: Optional[float] = None) -> "TokenCostModel":
        """Build a wall-clock cost model from measured per-step seconds
        (e.g. from the ``engine/decode_step_s`` / ``engine/prefill_s``
        tracker spans).  Cost units are then seconds and
        ``Request.deadline`` is a wall-clock SLO."""
        return cls(decode_step_cost=decode_step_s,
                   prefill_token_cost=prefill_token_s,
                   prefill_fixed_cost=prefill_fixed_s,
                   step_budget=step_budget_s)


class StreamScheduler:
    """Admission policy for :meth:`repro_torch.serve.engine.ServeEngine
    .run_stream`.

    ``lookahead``: how many pending requests beyond the head may be tried
    when the head doesn't fit (0 = strict FIFO).  ``preempt``: whether the
    engine may suspend running slots for deadline-at-risk candidates.
    ``risk_margin``: slack (in engine steps) at or below which a deadlined
    request counts as at risk.
    """

    def __init__(self, lookahead: int = 4, preempt: bool = True,
                 risk_margin: int = 2,
                 cost_model: Optional[TokenCostModel] = None):
        self.configure(lookahead, preempt, risk_margin)
        self._pending: List["Request"] = []    # submission order
        self._resume: List["Request"] = []     # suspension order
        self._stamp = 0                        # total submission counter
        #: deadline-clock basis; the default model makes cost units equal
        #: engine steps
        self.cost_model = cost_model or TokenCostModel()
        #: metrics backend (repro_torch.obs) — the engine shares its own;
        #: queue depth is gauged per admission pass, submissions are counted
        self.tracker: Tracker = NOOP

    def configure(self, lookahead: int, preempt: bool,
                  risk_margin: Optional[int] = None) -> None:
        if lookahead < 0:
            raise ValueError(f"lookahead must be >= 0, got {lookahead}")
        self.lookahead = int(lookahead)
        self.preempt = bool(preempt)
        if risk_margin is not None:
            self.risk_margin = int(risk_margin)

    # -- queue state -------------------------------------------------------
    def push(self, request: "Request") -> None:
        """Enqueue a fresh arrival (stamped with submission order)."""
        request._sched_stamp = self._stamp
        self._stamp += 1
        self._pending.append(request)
        if not self.tracker.is_noop:
            self.tracker.count("scheduler/submitted")
            self.tracker.gauge("scheduler/queue_depth", len(self))

    def push_resume(self, request: "Request") -> None:
        """Enqueue a preempted request for resumption."""
        self._resume.append(request)

    def remove(self, request: "Request") -> None:
        """Drop an admitted request from whichever lane holds it."""
        for lane in (self._resume, self._pending):
            for i, r in enumerate(lane):
                if r is request:
                    del lane[i]
                    return
        raise ValueError(f"request {request.uid} not queued")

    def has_work(self) -> bool:
        return bool(self._pending or self._resume)

    def resume_requests(self) -> List["Request"]:
        """Suspended requests awaiting resumption.  They keep their
        admission-time epoch pins, so bank compaction remaps their pinned
        columns with the active slots'."""
        return list(self._resume)

    def demanded_adapters(self, default_spec=None) -> set:
        """Adapter names queued NEVER-ADMITTED requests still need: their
        serving adapters plus their effective speculative draft adapters
        (``default_spec`` is the engine-wide fallback draft config; a
        request's own ``spec``, where it has one, wins).  The resume lane
        is excluded."""
        names = set()
        for r in self._pending:
            names.add(r.adapter)
            sc = getattr(r, "spec", None)
            sc = sc if sc is not None else default_spec
            if sc is not None and getattr(sc, "k", 0) > 0:
                names.add(sc.draft_adapter)
        return names

    def __len__(self) -> int:
        return len(self._pending) + len(self._resume)

    def drain(self) -> List["Request"]:
        """Remove and return everything still queued (truncation path);
        resume-lane requests first (they hold partial output)."""
        out = self._resume + self._pending
        self._resume, self._pending = [], []
        return out

    # -- policy ------------------------------------------------------------
    def slack(self, request: "Request", now: float) -> float:
        """Cost units this request can still wait and make its deadline:
        ``(arrival + deadline) - now - remaining_work``.  ``now`` is the
        engine's cost clock.  Remaining work is one decode step's cost per
        token left to generate (prefill rides the admission step) — an
        upper bound: a ``stop_token_ids`` hit finishes sooner, which only
        ever improves true slack.  Infinite for requests without a
        deadline."""
        deadline = getattr(request, "deadline", None)
        if deadline is None:
            return math.inf
        cm = self.cost_model
        remaining = request.remaining_tokens * cm.decode_step_cost
        arrival = getattr(request, "arrival_cost", None)
        if arrival is None:
            arrival = cm.steps_to_cost(request.arrival_step)
        return (arrival + deadline) - now - remaining

    def at_risk(self, request: "Request", now: float) -> bool:
        return self.slack(request, now) \
            <= self.cost_model.steps_to_cost(self.risk_margin)

    def _key(self, request: "Request", now: float, resumed: bool):
        return (-request.priority, self.slack(request, now),
                0 if resumed else 1, request._sched_stamp)

    def window(self, now: float) -> List[Tuple["Request", bool]]:
        """Policy-ordered admission candidates: the whole resume lane plus
        the first ``1 + lookahead`` pending requests, as ``(request,
        resumed)`` pairs.  ``now`` is the engine's cost clock."""
        # gauge at step=None (tracker's last step): the engine's cost clock
        # resets across runs — the tracker's step domain is the engine's
        # cumulative counter
        if not self.tracker.is_noop:
            self.tracker.gauge("scheduler/queue_depth", len(self))
            self.tracker.gauge("scheduler/resume_lane_depth",
                               len(self._resume))
        cands = [(r, True) for r in self._resume]
        cands += [(r, False) for r in self._pending[:1 + self.lookahead]]
        cands.sort(key=lambda c: self._key(c[0], now, c[1]))
        return cands
