"""DEPRECATION fixtures: a covered shim, an uncovered one, a silent one.

Parsed by the rule engine in tests, never executed.
"""
import warnings


class Engine:
    def serve(self, requests):
        return requests

    def run_batch(self, requests):
        warnings.warn("use serve", DeprecationWarning, stacklevel=2)
        return self.serve(requests)


def old_sample(logits):
    # TP: warns, but no test exercises the warning
    warnings.warn("use sample_tokens", DeprecationWarning, stacklevel=2)
    return logits.argmax(-1)


def legacy_merge(tree):
    """Deprecated: use merge_tree instead."""
    return tree                       # TP: declares DEPRECATED, never warns
