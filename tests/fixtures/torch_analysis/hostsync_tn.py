"""HOSTSYNC true negatives: the allowlisted boundary, a sync inside a
raise, a reasoned suppression, on-device work, a cold helper.

Parsed by the rule engine in tests, never imported or executed.
"""
import torch


def to_host(tokens):
    # the allowlisted boundary: .numpy() on the .cpu() is the same transfer
    return tokens.cpu().numpy()


class Engine:
    def _decode_live(self, logits, table):
        if logits.ndim != 2:
            raise ValueError(f"bad table {table.tolist()}")   # step ends
        rows = table.tolist()  # repro-lint: disable=HOSTSYNC (numpy table)
        nxt = logits.argmax(-1)                  # stays on the device
        return to_host(nxt), rows, logits.to("cuda", non_blocking=True)

    def _cold_helper(self, x):
        return x.item()                          # not on the hot path
