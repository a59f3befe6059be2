"""OBS-GATE true negatives: the three sanctioned gating shapes and a
self-gating sink called ungated.

Parsed by the rule engine in tests, never executed.
"""
NULL_SPAN = None


def record_occupancy(tracker, reqs):
    if tracker.is_noop:
        return
    tracker.count("sampler/live_rows", len(reqs))


class StreamScheduler:
    def push(self, request):
        if not self.tracker.is_noop:
            self.tracker.count("scheduler/submitted")         # if-gated
        self._queue.append(request)


class ServeEngine:
    def _decode_live(self, live, step):
        span = (self._tracker.time_block("engine/decode_step_s")
                if self._obs else NULL_SPAN)                   # ternary
        record_occupancy(self._tracker, live)                  # self-gated
        return live, span

    def _observe(self, live):
        if not self._obs:
            return
        self._tracker.gauge("engine/live", len(live))          # early return
