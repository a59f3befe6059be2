"""OBS-GATE true positives: ungated tracker calls on the decode path.

Parsed by the rule engine in tests, never executed.
"""


class StreamScheduler:
    def push(self, request):
        self.tracker.count("scheduler/submitted")          # TP 1
        self._queue.append(request)


class ServeEngine:
    def _decode_live(self, live, step):
        self._tracker.gauge("engine/live", len(live))      # TP 2
        return live
