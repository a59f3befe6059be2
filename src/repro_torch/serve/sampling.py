"""Per-request sampling: :class:`SamplingParams` and one batched sampler
over ``(B, V)`` logits with per-row parameter tensors.

Generation control is a *request* property: every
:class:`repro_torch.serve.engine.Request` carries (or inherits from the
engine default) a :class:`SamplingParams` — temperature / top-k / top-p
filtering, a reproducibility seed, stop-token ids and optional per-token
logprobs.  The engine stacks the rows' parameters into ``(B,)`` tensors
each step (:func:`stack`), so any per-request mix shares one code path.

**Draws equal the reference's bit for bit.**  Token ``n`` of a request is
drawn with the key ``fold_in(PRNGKey(seed), n)`` of JAX's default
threefry2x32 generator (with ``jax_threefry_partitionable``), written here
in torch integer ops on int64 tensors masked to 32 bits:

* ``PRNGKey(s)`` for a 32-bit seed is the pair ``(0, s)``;
* ``fold_in(key, c)`` is ``threefry2x32(key, (0, c))``;
* the candidate row's random bits are ``out0 ^ out1`` of
  ``threefry2x32(key, (0, iota))``;
* the uniform draw keeps the top 23 bits as a mantissa in ``[1, 2)``,
  subtracts 1 and clamps at the smallest normal float32;
* the Gumbel noise is ``-log(-log(u))`` and the draw is the argmax of
  noise plus filtered scaled logits in candidate space.

The random bits match exactly; ``log``, ``logsumexp`` and ``cumsum`` may
differ from XLA's by an ulp, so the Gumbel values, the nucleus mass and the
logprobs match within rounding and token identity is checked at fixed
seeds (``tests/test_torch_sampling.py``).

**Greedy.**  ``temperature=0`` argmaxes over the full vocabulary.  Rows mix
freely: the sampler computes both paths and selects per row.  A step whose
rows are ALL greedy takes only the argmax (``greedy_only=True``, which the
caller decides from host values): the same tokens, without the threefry
rounds' small launches.

**Bounded support.**  Sampled rows draw from the :data:`MAX_CANDIDATES`
highest-scoring tokens, ordered by (scaled logit descending, token id
ascending) — the reference's ``lax.top_k`` order, made explicit here
because ``torch.topk`` documents no order for ties: the top-k runs over
int64 keys that pack the float's total order above the inverted id, so no
two keys tie.  Candidate ``j`` survives iff ``j < top_k`` (0 = off) AND
the cumulative full-softmax probability of candidates *before* it is
``< top_p``; the top candidate always survives.  Logprobs are reported
from the model's distribution (log-softmax of the raw logits).

On CUDA tensors everything runs on the card; :func:`to_host` brings a
step's outputs back in ONE device-to-host transfer.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

#: hard cap on per-token alternative logprobs a request may ask for (the
#: sampler always computes this many; the engine keeps what was asked for)
MAX_LOGPROBS = 8

#: sampling-support cap: non-greedy draws consider the top this-many scaled
#: logits.  ``top_k`` beyond it is rejected at validation.
MAX_CANDIDATES = 128

_M32 = 0xFFFFFFFF
#: threefry2x32's rotation constants, alternating per block of 4 rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: block length of XLA's rewrite of a cumulative sum (:func:`_prefix_sums`)
_SCAN_BLOCK = 16
#: smallest normal float32: the floor of the uniform draw
_TINY = float(np.finfo(np.float32).tiny)


class TokenLogprobs(NamedTuple):
    """Logprobs for one generated token: the chosen token's log-probability
    under the model's (pre-temperature) distribution plus the top
    alternatives, ids and logprobs sorted most-probable first."""
    token: int
    logprob: float
    top_tokens: Tuple[int, ...]
    top_logprobs: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation control (frozen: share freely).

    ``temperature``: 0 = greedy argmax; > 0 scales logits before sampling.
    ``top_k``: keep only the k highest-probability tokens (0 = off; at
    most :data:`MAX_CANDIDATES`).
    ``top_p``: nucleus filtering — keep the minimal candidate set whose
    cumulative probability reaches ``top_p`` (1.0 = off).
    ``seed``: reproducibility seed; ``None`` derives a per-request seed
    from the engine's ``sample_seed`` and the request uid.
    ``stop_token_ids``: emitting any of these finishes the request
    immediately (the stop token IS included in ``generated``).
    ``logprobs``: record this many alternative logprobs per generated token
    (0 = off, max :data:`MAX_LOGPROBS`) on ``Request.logprobs``.
    """
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()
    logprobs: int = 0

    def __post_init__(self):
        # accept any iterable of ints for stop ids; store a hashable tuple
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))

    @classmethod
    def greedy(cls, **kw) -> "SamplingParams":
        """Deterministic argmax decoding (the engine default)."""
        return cls(temperature=0.0, **kw)

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0

    def validate(self, vocab_size: int) -> None:
        """Loud rejection of unservable parameters (called at submit)."""
        if not np.isfinite(self.temperature) or self.temperature < 0.0:
            raise ValueError(
                f"temperature must be finite and >= 0 (0 = greedy), got "
                f"{self.temperature}")
        if not 0 <= self.top_k <= MAX_CANDIDATES:
            raise ValueError(
                f"top_k must be in [0, {MAX_CANDIDATES}] (0 = off; the "
                f"fused sampler draws from a bounded candidate set, see "
                f"sampling.MAX_CANDIDATES), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1] (1 = off), got "
                             f"{self.top_p}")
        if self.seed is not None and not 0 <= self.seed < 2 ** 32:
            raise ValueError(
                f"seed must be in [0, 2**32) (PRNGKey folds in 32 bits; "
                f"a wider seed would silently alias) or None, got "
                f"{self.seed}")
        if not 0 <= self.logprobs <= MAX_LOGPROBS:
            raise ValueError(
                f"logprobs must be in [0, {MAX_LOGPROBS}] (fixed sampler "
                f"output shape; see sampling.MAX_LOGPROBS), got "
                f"{self.logprobs}")
        for t in self.stop_token_ids:
            if not 0 <= t < vocab_size:
                raise ValueError(
                    f"stop token id {t} outside vocab [0, {vocab_size}) — "
                    f"it could never be emitted, so the request would "
                    f"silently lose its stop condition")


# ---------------------------------------------------------------------------
# threefry2x32 in torch integer ops
# ---------------------------------------------------------------------------

def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of key ``(k1, k2)`` on
    counts ``(x0, x1)``: int64 tensors (or ints) holding uint32 values,
    broadcast together.  Returns the two uint32 output words as int64."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(seed: torch.Tensor, counter: torch.Tensor):
    """``fold_in(PRNGKey(seed), counter)`` per row: the key pair as two
    int64 tensors."""
    zero = torch.zeros_like(seed)
    return threefry2x32(zero, seed & _M32, zero, counter & _M32)


def random_bits(k1: torch.Tensor, k2: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` per row of keys ``(k1, k2)`` (B,):
    (B, n) int64 holding uint32 values."""
    iota = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(iota),
                          iota)
    return b1 ^ b2


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 uniform in ``[tiny, 1)`` from 32 random bits."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    return torch.clamp_min(floats * (1.0 - _TINY) + _TINY, _TINY)


def gumbel(k1: torch.Tensor, k2: torch.Tensor, n: int) -> torch.Tensor:
    """The "low" Gumbel noise ``-log(-log(u))`` of ``jax.random.gumbel``,
    (B, n) float32."""
    return -torch.log(-torch.log(uniform_from_bits(random_bits(k1, k2, n))))


# ---------------------------------------------------------------------------
# seeds and parameter rows
# ---------------------------------------------------------------------------

def derive_seed(base_seed: int, uid: int) -> int:
    """Stable per-request seed for requests that don't pin their own:
    a splitmix-style mix of the engine seed and the request uid."""
    x = (int(base_seed) * 0x9E3779B97F4A7C15 + int(uid) + 1) \
        & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 27
    return int(x & 0x7FFFFFFF)


def branch_seed(seed: int, branch: int) -> int:
    """Per-branch seed for ``n > 1`` parallel completions: the last word of
    ``fold_in(PRNGKey(seed), branch)``."""
    _k1, k2 = fold_in(torch.tensor([int(seed) & _M32]),
                      torch.tensor([int(branch) & _M32]))
    return int(k2[0])


def stack(entries: Sequence[Tuple[SamplingParams, int, int]]):
    """Stack ``(params, effective_seed, counter)`` rows into the per-row
    numpy arrays :func:`sample_tokens` consumes as tensors: temperatures
    (float32), top-k (int32), top-p (float32), seeds and counters
    (int64 holding uint32 values)."""
    n = len(entries)
    temps = np.zeros((n,), np.float32)
    top_ks = np.zeros((n,), np.int32)
    top_ps = np.ones((n,), np.float32)
    seeds = np.zeros((n,), np.int64)
    counters = np.zeros((n,), np.int64)
    for j, (sp, seed, counter) in enumerate(entries):
        temps[j] = sp.temperature
        top_ks[j] = sp.top_k
        top_ps[j] = sp.top_p
        seeds[j] = int(seed) & _M32
        counters[j] = int(counter) & _M32
    return temps, top_ks, top_ps, seeds, counters


def record_occupancy(tracker, reqs, step=None, draft_rows: int = 0) -> None:
    """Sampler batch occupancy metrics (:mod:`repro_torch.obs`): live rows
    over the rows drawn (dead slots decode as ghosts, resumed requests'
    tail-rebuild draws are discarded); ``reqs`` holds None for those.
    ``draft_rows`` of the None rows belong to slots a speculative pass
    already served this step: they leave both the ghost count and the
    occupancy denominator."""
    live = sum(r is not None for r in reqs)
    tracker.histogram("sampler/batch_occupancy",
                      live / max(len(reqs) - draft_rows, 1), step=step)
    tracker.count("sampler/live_rows", live, step=step)
    tracker.count("sampler/ghost_rows", len(reqs) - live - draft_rows,
                  step=step)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def _top_ids(z: torch.Tensor, c: int) -> torch.Tensor:
    """(B, c) token ids of the ``c`` largest entries of each row of float32
    ``z``, ordered by value descending and id ascending (``lax.top_k``'s
    order, with its total order of floats: -0.0 below 0.0).  Each key packs
    the float's order-preserving int32 above the inverted id, so keys are
    distinct and ``torch.topk`` has no ties to order."""
    bits = z.contiguous().view(torch.int32).to(torch.int64)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    ids = torch.arange(z.shape[-1], dtype=torch.int64, device=z.device)
    keys = (ordered << 32) | (_M32 - ids)
    return torch.topk(keys, c, dim=-1, sorted=True).indices


def _prefix_sums(p: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis of float32 ``p`` (B, n),
    added in XLA's order for ``jnp.cumsum`` on the CPU, so the rounding is
    the reference's: blocks of 16 summed left to right, plus the left to
    right sum of the earlier blocks' totals (XLA rewrites a cumulative
    reduce-window so).  Exact for n up to 256, one level of blocks; the
    sampler's rows have at most :data:`MAX_CANDIDATES`."""
    b, n = p.shape
    nb = -(-n // _SCAN_BLOCK)
    x = torch.nn.functional.pad(p, (0, nb * _SCAN_BLOCK - n)).view(
        b, nb, _SCAN_BLOCK)
    inner = torch.empty_like(x)
    acc = torch.zeros_like(x[:, :, 0])
    for j in range(_SCAN_BLOCK):
        acc = torch.add(acc, x[:, :, j], out=inner[:, :, j])
    before = torch.zeros((b, nb), dtype=p.dtype, device=p.device)
    for k in range(1, nb):
        torch.add(before[:, k - 1], inner[:, k - 1, -1], out=before[:, k])
    return (inner + before[:, :, None]).view(b, nb * _SCAN_BLOCK)[:, :n]


def _candidates(z: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor):
    """Candidate set of each row of scaled logits: ``(values, token_ids,
    keep)`` over the top ``min(MAX_CANDIDATES, V)`` entries.  ``keep[b,
    j]`` applies the row's top-k (positional) and top-p (cumulative
    full-softmax mass of earlier candidates) filters; the top candidate
    always survives."""
    c = min(MAX_CANDIDATES, z.shape[-1])
    idx = _top_ids(z, c)
    cand = z.gather(-1, idx)
    denom = torch.logsumexp(z, dim=-1, keepdim=True)
    probs = torch.exp(cand - denom)
    mass_before = _prefix_sums(probs) - probs   # exclusive prefix
    k = torch.where(top_k > 0, top_k, c).clamp(1, c)
    pos = torch.arange(c, device=z.device)[None, :]
    keep = (pos < k[:, None]) & (mass_before < top_p[:, None])
    keep[:, 0] = True
    return cand, idx, keep


def _scaled(logits: torch.Tensor, temperature: torch.Tensor) -> torch.Tensor:
    safe_t = torch.where(temperature > 0.0, temperature,
                         torch.ones_like(temperature))
    return logits.float() / safe_t[:, None]


def support_mask(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """(B, V) bool mask of each row's sampling support — the tokens a
    non-greedy draw may return (the candidate logic the sampler uses)."""
    _, idx, keep = _candidates(_scaled(logits, temperature), top_k, top_p)
    mask = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
    return mask.scatter_(1, idx, keep)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  seed: torch.Tensor, counter: torch.Tensor, *,
                  want_logprobs: bool, greedy_only: bool = False):
    """Every row's next token from ``(B, V)`` logits and per-row parameter
    tensors on the logits' device: ``temperature``/``top_p`` float32,
    ``top_k`` integer, ``seed``/``counter`` int64 holding uint32 values.

    Returns ``(tokens, chosen, top_ids, top_logprobs)`` on that device:
    tokens (B,) int64, and with ``want_logprobs`` the chosen token's model
    logprob (B,), the top :data:`MAX_LOGPROBS` ids (B, n) and their
    logprobs (B, n); else three Nones.  ``greedy_only`` (every row's
    temperature is 0, known on the host) skips the draw: the tokens are the
    argmax either way."""
    logits = logits.float()
    n_top = min(MAX_LOGPROBS, logits.shape[-1])
    greedy_tok = logits.argmax(dim=-1)
    if greedy_only:
        tokens = greedy_tok
        top_ids = _top_ids(logits, n_top) if want_logprobs else None
    else:
        cand, cand_idx, keep = _candidates(_scaled(logits, temperature),
                                           top_k, top_p)
        k1, k2 = fold_in(seed, counter)
        noise = gumbel(k1, k2, cand.shape[-1])
        choice = (noise + torch.where(keep, cand, -torch.inf)).argmax(dim=-1)
        sampled = cand_idx.gather(-1, choice[:, None])[:, 0]
        tokens = torch.where(temperature > 0.0, sampled, greedy_tok)
        # temperature scaling is monotone, so the top candidates by scaled
        # score ARE the top raw-logit tokens
        top_ids = cand_idx[:, :n_top]
    if not want_logprobs:
        return tokens, None, None, None
    denom = torch.logsumexp(logits, dim=-1, keepdim=True)
    top_lps = logits.gather(-1, top_ids) - denom
    chosen = logits.gather(-1, tokens[:, None])[:, 0] - denom[:, 0]
    return tokens, chosen, top_ids, top_lps


def to_host(tokens: torch.Tensor, chosen=None, top_ids=None, top_lps=None):
    """:func:`sample_tokens`' outputs as numpy arrays, brought back in ONE
    device-to-host transfer: the ids and the float32 logprobs' bits travel
    packed in one int32 tensor."""
    if chosen is None:
        return tokens.cpu().numpy(), None, None, None
    n = top_ids.shape[-1]
    packed = torch.cat([tokens[:, None].to(torch.int32),
                        top_ids.to(torch.int32),
                        chosen.float()[:, None].view(torch.int32),
                        top_lps.float().contiguous().view(torch.int32)],
                       dim=1).cpu().numpy()
    lps = np.ascontiguousarray(packed[:, 1 + n:]).view(np.float32)
    return (packed[:, 0].astype(np.int64), lps[:, 0],
            packed[:, 1:1 + n].astype(np.int64), lps[:, 1:])
