"""Speculative decoding: the draft-policy configuration and the acceptance
rule (the reference's :mod:`repro.serve.spec`, copied).

Each engine step, a slot with a :class:`SpecConfig` drafts ``k`` tokens
with a cheap path (the merged base weights, or any registered adapter),
then verifies all ``k + 1`` window positions in one batched target pass
over the paged KV (``paged_prefill`` with ``all_logits=True``).  The draft
proposal and the target draw for generated-token index ``n`` use the same
counter-based stream, ``fold_in(PRNGKey(seed), n)``
(:mod:`repro_torch.serve.sampling`), so the target draw at window position
``i`` is the token the non-speculative engine would emit there, and
acceptance is token equality (:func:`accepted_prefix`).  Accepted length
is always in ``[1, k + 1]``.

The verify pass reads the committed prefix KV plus the in-pass window keys
and values, never the draft's KV writes, so its logits equal the decode
path's for the same context up to rounding: greedy requests match
non-speculative decode token for token wherever no two candidates lie
within that rounding of each other.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

#: draft policy meaning "decode the draft with the engine's merged base
#: weights" (bank id 0, no adapter delta)
BASE_DRAFT = "base"


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Per-request speculative-decode control (frozen: share freely).

    ``k``: draft window, tokens proposed per engine step; ``0`` disables
    speculation (opts a request out of an engine-wide default).  The
    engine clamps the effective window per step so a request never drafts
    past ``max_new_tokens``, ``max_len`` or the slot's page reach.

    ``draft_adapter``: the registered adapter the draft path decodes with;
    :data:`BASE_DRAFT` serves the merged base weights.
    """

    k: int = 4
    draft_adapter: str = BASE_DRAFT

    def __post_init__(self):
        if self.k < 0:
            raise ValueError(f"spec k must be >= 0 (0 = off), got {self.k}")


def accepted_prefix(draft: Sequence[int], target: Sequence[int]
                    ) -> List[int]:
    """The tokens one speculative window emits.

    ``draft`` is the ``k`` proposals ``d_1..d_k``; ``target`` the ``k + 1``
    per-position target draws ``t_0..t_k`` of the verify pass.  ``t_0`` is
    always emitted; draft ``d_{i+1}`` is accepted iff it equals ``t_i``,
    which validates the next target draw ``t_{i+1}``; the first mismatch
    stops the window.  Returns 1 to ``k + 1`` tokens."""
    out = [int(target[0])]
    for i, d in enumerate(draft):
        if int(d) != int(target[i]):
            break
        out.append(int(target[i + 1]))
    return out
