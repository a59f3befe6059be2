"""HOSTSYNC true positives: one host sync per line in a hot-path function.

Parsed by the rule engine in tests, never imported or executed.
"""
import numpy as np
import torch


class Engine:
    def _decode_live(self, logits, stream, event):
        a = logits.argmax(-1).item()              # TP 1
        b = logits.argmax(-1).tolist()            # TP 2
        c = logits.cpu()                          # TP 3
        d = logits.numpy()                        # TP 4
        e = logits.to("cpu")                      # TP 5
        f = logits.to(device="cpu")               # TP 6
        g = torch.equal(logits, logits)           # TP 7
        torch.cuda.synchronize()                  # TP 8
        stream.synchronize()                      # TP 9
        event.synchronize()                       # TP 10
        h = np.asarray(logits)                    # TP 11
        return a, b, c, d, e, f, g, h
