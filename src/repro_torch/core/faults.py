"""Fault plans for the ported engines — host-side numpy.

Copy of ``repro/core/faults.py``'s ``FaultEvent``, ``FaultPlan``,
``RetryPolicy``, ``TransientOutcome`` and ``apply_transient``, unchanged in
arithmetic and in the order of every random draw, so faulted tables are
bit-identical to the reference's.  The reference's ``FaultInjector`` (its
OO engines' event replay) has no counterpart: the port has only the
``vec`` backend.

Window semantics: a fault is active at time ``t`` iff
``t_start <= t < t_end``.  Kinds: ``node`` (crash window for one target,
``-1`` = all), ``link`` (network delays multiplied by ``severity``),
``region`` (regional outage) and ``transient`` (a request submitted in the
window fails with probability ``severity`` per attempt, retried under a
:class:`RetryPolicy`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np

KINDS = ("node", "link", "region", "transient")
_KIND_CODE = {k: i for i, k in enumerate(KINDS)}


@dataclass(frozen=True)
class FaultEvent:
    """One typed fault window.  ``t_end=inf`` means no recovery."""
    kind: str
    t_start: float
    t_end: float = math.inf
    target: int = -1
    severity: float = 1.0


class FaultPlan:
    """A validated, compiled schedule of :class:`FaultEvent` windows.

    Compilation builds the SoA tensors once (``kind_code``, ``target``,
    ``t_start``, ``t_end``, ``severity``, each ``[E]``); the query
    helpers below evaluate them against vectors of decision times and
    are the *only* way scenarios read a plan, so the OO and vec
    consumers cannot drift on window semantics.
    """

    def __init__(self, events: Sequence[FaultEvent] = (), seed: int = 0):
        events = tuple(events)
        for i, ev in enumerate(events):
            if ev.kind not in KINDS:
                raise ValueError(
                    f"FaultPlan: event {i}: unknown kind {ev.kind!r} "
                    f"(expected one of {KINDS})")
            if not (math.isfinite(ev.t_start) and ev.t_start >= 0.0):
                raise ValueError(
                    f"FaultPlan: event {i} ({ev.kind}): t_start must be "
                    f"finite and >= 0, got {ev.t_start}")
            if not ev.t_end > ev.t_start:
                raise ValueError(
                    f"FaultPlan: event {i} ({ev.kind}): t_end must be "
                    f"> t_start, got [{ev.t_start}, {ev.t_end})")
            if ev.kind == "link" and not ev.severity >= 1.0:
                raise ValueError(
                    f"FaultPlan: event {i} (link): severity is a delay "
                    f"multiplier and must be >= 1, got {ev.severity}")
            if ev.kind == "transient" and not 0.0 <= ev.severity <= 1.0:
                raise ValueError(
                    f"FaultPlan: event {i} (transient): severity is a "
                    f"failure probability in [0, 1], got {ev.severity}")
        self.events = events
        self.seed = int(seed)
        self.kind_code = np.array([_KIND_CODE[e.kind] for e in events],
                                  np.int8)
        self.target = np.array([e.target for e in events], np.int64)
        self.t_start = np.array([e.t_start for e in events], np.float64)
        self.t_end = np.array([e.t_end for e in events], np.float64)
        self.severity = np.array([e.severity for e in events], np.float64)

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        counts = {k: int(np.sum(self.kind_code == c))
                  for k, c in _KIND_CODE.items()}
        body = ", ".join(f"{k}={n}" for k, n in counts.items() if n)
        return f"FaultPlan({body or 'empty'}, seed={self.seed})"

    def has(self, kind: str) -> bool:
        return bool(np.any(self.kind_code == _KIND_CODE[kind]))

    def select(self, kind: str):
        """(target, t_start, t_end, severity) arrays for one kind."""
        m = self.kind_code == _KIND_CODE[kind]
        return self.target[m], self.t_start[m], self.t_end[m], \
            self.severity[m]

    def check_targets(self, kind: str, n_targets: int, what: str) -> None:
        """Reject plan targets outside ``[-1, n_targets)`` for a kind."""
        tgt = self.select(kind)[0]
        bad = (tgt < -1) | (tgt >= n_targets)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"FaultPlan: {kind} event targets {what} "
                f"{int(tgt[i])}, but only {n_targets} exist")

    # -- window queries (the shared consumption contract) ------------------

    def _active(self, kind: str, times: np.ndarray):
        tgt, ts, te, sev = self.select(kind)
        times = np.asarray(times, np.float64)
        act = (ts[None, :] <= times[:, None]) & (times[:, None] < te[None, :])
        return act, tgt, sev                       # [T, E], [E], [E]

    def down_mask(self, kind: str, times, n_targets: int) -> np.ndarray:
        """``[T, n_targets]`` bool: target ``i`` down at ``times[t]``."""
        act, tgt, _ = self._active(kind, times)
        if act.shape[1] == 0:
            return np.zeros((act.shape[0], n_targets), bool)
        hit = (tgt[:, None] < 0) | (tgt[:, None] == np.arange(n_targets))
        return (act[:, :, None] & hit[None, :, :]).any(axis=1)

    def degrade_factor(self, times, n_targets: int) -> np.ndarray:
        """``[T, n_targets]`` f64: product of active ``link`` severities
        touching each target (1.0 where no window is active)."""
        act, tgt, sev = self._active("link", times)
        if act.shape[1] == 0:
            return np.ones((act.shape[0], n_targets), np.float64)
        hit = (tgt[:, None] < 0) | (tgt[:, None] == np.arange(n_targets))
        f = np.where(act[:, :, None] & hit[None, :, :],
                     sev[None, :, None], 1.0)
        return np.prod(f, axis=1)

    def transient_prob(self, times) -> np.ndarray:
        """``[T]`` f64: per-attempt failure probability at each time
        (max severity over active ``transient`` windows, else 0)."""
        act, _, sev = self._active("transient", times)
        if act.shape[1] == 0:
            return np.zeros(act.shape[0], np.float64)
        return np.max(np.where(act, sev[None, :], 0.0), axis=1)


# -- retry with exponential backoff + jitter + budget --------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with bounded jitter and a time budget.

    Retry ``k`` (1-based) waits ``base_delay_s * backoff**(k-1) *
    (1 + jitter_frac * u_k)`` with ``u_k`` uniform in ``[-1, 1]``;
    retries stop once the cumulative delay would exceed ``budget_s``.
    ``jitter_frac`` must stay in ``[0, 1)`` so delays remain positive
    and the budget cutoff is monotone.
    """
    max_retries: int = 3
    base_delay_s: float = 0.5
    backoff: float = 2.0
    jitter_frac: float = 0.0
    budget_s: float = math.inf

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("RetryPolicy: max_retries must be >= 0")
        if not self.base_delay_s >= 0.0:
            raise ValueError("RetryPolicy: base_delay_s must be >= 0")
        if not self.backoff >= 1.0:
            raise ValueError("RetryPolicy: backoff must be >= 1")
        if not 0.0 <= self.jitter_frac < 1.0:
            raise ValueError("RetryPolicy: jitter_frac must be in [0, 1)")

    def delays(self, jitter: np.ndarray) -> np.ndarray:
        """``[n, max_retries]`` backoff delays from unit jitter draws
        (``jitter`` uniform in ``[-1, 1]``).  Powers of ``backoff`` come
        from ``cumprod`` (multiplies only — no libm ``pow``)."""
        r = self.max_retries
        jitter = np.asarray(jitter, np.float64)
        if jitter.shape[-1] != r:
            raise ValueError(f"RetryPolicy.delays: expected {r} jitter "
                             f"draws per row, got {jitter.shape}")
        pows = np.cumprod(np.concatenate(
            [[1.0], np.full(max(r - 1, 0), self.backoff)]))
        return self.base_delay_s * pows * (1.0 + self.jitter_frac * jitter)


class TransientOutcome(NamedTuple):
    """Host-side resolution of transient failures for one request stream
    (shared verbatim by the OO broker and the vec tables)."""
    eff_submit: np.ndarray    # [n] f64 submit + accumulated backoff delay
    attempts: np.ndarray      # [n] i64 attempts actually made (>= 1)
    gave_up: np.ndarray       # [n] bool retries/budget exhausted -> dropped
    prob: np.ndarray          # [n] f64 per-attempt failure probability


def apply_transient(plan: FaultPlan, policy: Optional[RetryPolicy],
                    submit: np.ndarray, seed: int) -> TransientOutcome:
    """Resolve every request's transient-failure attempts up front.

    Attempt draws and jitter are seeded from ``seed`` alone (drawn for
    every request regardless of its failure probability), so the outcome
    is deterministic and identical across backends.  The per-attempt
    failure probability is evaluated at the *original* submit time for
    all attempts of a request.  A request whose first success lands past
    the retry count or the cumulative-delay budget gives up; its
    effective submit stays at the original time (it never executes).
    """
    submit = np.asarray(submit, np.float64)
    n = submit.shape[0]
    policy = policy if policy is not None else RetryPolicy(max_retries=0)
    r = policy.max_retries
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(n, r + 1))
    jitter = rng.uniform(-1.0, 1.0, size=(n, r))
    prob = plan.transient_prob(submit)
    fails = u < prob[:, None]                             # [n, r+1]
    delays = policy.delays(jitter)                        # [n, r]
    cum = np.concatenate([np.zeros((n, 1)), np.cumsum(delays, axis=1)],
                         axis=1)                          # [n, r+1]
    allowed = cum <= policy.budget_s                      # monotone in k
    ok = ~fails
    any_ok = ok.any(axis=1)
    first_ok = np.argmax(ok, axis=1)                      # 0 when none
    served = any_ok & allowed[np.arange(n), first_ok]
    attempts = np.where(served, first_ok + 1,
                        allowed.sum(axis=1)).astype(np.int64)
    eff = np.where(served, submit + cum[np.arange(n), first_ok], submit)
    return TransientOutcome(eff_submit=eff, attempts=attempts,
                            gave_up=~served, prob=prob)
