"""Trace-driven multi-tenant traffic for the serving loop
(``repro.serve.workload``), seeded and deterministic with numpy's
generator, so a trace equals the reference's for a seed:

  * ``heavy_tail_lengths``: lognormal or Zipf length laws, clipped to a
    [lo, hi] band;
  * ``bursty_arrivals``: burst clusters on ``poisson_arrivals`` (cluster
    starts Poisson at ``rate / burst_size``, geometric cluster sizes,
    tight exponential jitter), so the long-run rate stays ``rate``;
  * ``diurnal_arrivals``: a sinusoidally modulated Poisson process by
    thinning;
  * ``TenantClass`` / ``WorkloadSpec`` / ``make_trace``: tenant classes
    with weights, length overrides and TTFT/TPOT SLO targets, stamped on
    each ``Request``; ``tenant_by_name`` looks a class up.

Tenancy and SLOs are scheduling metadata: whatever trace rides the loop,
every request's tokens equal its solo ``greedy_generate``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import poisson_arrivals

from .request import Request


@dataclass(frozen=True)
class TenantClass:
    """One service class: ``share`` is its slice of the request stream,
    ``weight`` its scheduling priority (admission order, fairness
    share), the SLO fields its latency targets (``inf`` = best-effort).
    ``prompt_median`` / ``output_median`` override the spec's length
    medians for this class (interactive chat is short, batch analytics
    is long)."""
    name: str
    share: float = 1.0
    weight: float = 1.0
    ttft_slo_s: float = math.inf
    tpot_slo_s: float = math.inf
    prompt_median: Optional[int] = None
    output_median: Optional[int] = None

    def __post_init__(self):
        if self.share <= 0 or self.weight <= 0:
            raise ValueError("share and weight must be > 0")


# HOBBIT/MOBBIT tier *experts* by criticality; the same two-tier shape
# applied to requests: a latency-sensitive interactive class that gets
# priority and real SLO targets, and a throughput batch class that
# tolerates preemption (longer prompts, no deadlines).
DEFAULT_TENANTS: Tuple[TenantClass, ...] = (
    TenantClass("interactive", share=3.0, weight=4.0,
                ttft_slo_s=8.0, tpot_slo_s=1.0),
    TenantClass("batch", share=1.0, weight=1.0),
)


# ------------------------------------------------------------- lengths
def heavy_tail_lengths(rng: np.random.Generator, n: int, median: int, *,
                       dist: str = "lognormal", sigma: float = 0.8,
                       alpha: float = 2.0, lo: int = 2,
                       hi: int = 2048) -> np.ndarray:
    """``n`` integer lengths from a heavy-tailed law centered (in
    median) on ``median``, clipped to ``[lo, hi]``.

    ``lognormal``: exp(N(log median, sigma^2)) — sigma ~0.8 gives a
    p99/median ratio around 6x.  ``zipf``: ``median * Z`` with
    ``Z ~ Zipf(alpha)`` (median(Z) = 1, so the median is preserved);
    alpha near 2 makes the tail much fatter than any lognormal."""
    if n <= 0:
        return np.zeros(0, np.int64)
    if median < 1:
        raise ValueError("median must be >= 1")
    if dist == "lognormal":
        vals = rng.lognormal(mean=math.log(median), sigma=sigma, size=n)
    elif dist == "zipf":
        if alpha <= 1.0:
            raise ValueError("zipf alpha must be > 1")
        vals = median * rng.zipf(alpha, size=n).astype(np.float64)
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


# ------------------------------------------------------------ arrivals
def bursty_arrivals(rate: float, n: int, seed: int = 0, *,
                    burst_size: float = 4.0,
                    spread_frac: float = 0.1) -> List[float]:
    """``n`` arrival times whose long-run rate is ``rate`` req/s but
    which land in tight clusters: cluster starts are the plain Poisson
    process at ``rate / burst_size``, each cluster carries a geometric
    number of requests (mean ``burst_size``), and members within a
    cluster spread by exponential jitter with mean ``spread_frac / rate``
    (a tenth of the mean inter-arrival gap by default — the burst is
    effectively simultaneous at serving granularity).  ``rate <= 0``
    degenerates to everything-at-t0, like ``poisson_arrivals``."""
    if rate <= 0 or n <= 0:
        return [0.0] * max(n, 0)
    if burst_size < 1:
        raise ValueError("burst_size must be >= 1")
    rng = np.random.default_rng(seed)
    # n cluster starts always cover n requests (>= 1 request/cluster)
    starts = poisson_arrivals(rate / burst_size, n, seed=seed + 1)
    out: List[float] = []
    for t0 in starts:
        k = int(rng.geometric(1.0 / burst_size))
        jitter = np.cumsum(rng.exponential(spread_frac / rate, size=k))
        out.extend(float(t0 + j) for j in jitter)
        if len(out) >= n:
            break
    return sorted(out)[:n]


def diurnal_arrivals(rate: float, n: int, seed: int = 0, *,
                     depth: float = 0.8,
                     period_s: Optional[float] = None) -> List[float]:
    """``n`` arrivals from an inhomogeneous Poisson process whose rate
    swings sinusoidally, ``lambda(t) = rate * (1 + depth *
    sin(2 pi t / period))`` — the diurnal peak/trough cycle compressed
    onto the trace's timescale.  Default period puts ~2 full cycles
    over the trace (``n / rate`` expected span) so a run sees both rush
    hour and the dead of night.  Sampled by thinning: propose at the
    peak rate, accept with probability ``lambda(t) / peak``."""
    if rate <= 0 or n <= 0:
        return [0.0] * max(n, 0)
    if not 0.0 <= depth < 1.0:
        raise ValueError("depth must be in [0, 1)")
    period = period_s if period_s else max(n / rate / 2.0, 1e-9)
    rng = np.random.default_rng(seed)
    peak = rate * (1.0 + depth)
    out, t = [], 0.0
    while len(out) < n:
        t += rng.exponential(1.0 / peak)
        lam = rate * (1.0 + depth * math.sin(2.0 * math.pi * t / period))
        if rng.uniform() * peak <= lam:
            out.append(t)
    return out


# ------------------------------------------------------------ the trace
@dataclass(frozen=True)
class WorkloadSpec:
    """Everything that shapes a trace (all laws seeded by
    ``make_trace(seed)``): how many requests at what long-run rate,
    which arrival process, the length laws, and the tenant mix."""
    n_requests: int = 64
    rate: float = 50.0               # req/s of modeled time (<=0: burst)
    arrival: str = "bursty"          # poisson | bursty | diurnal
    prompt_median: int = 16
    output_median: int = 8
    length_dist: str = "lognormal"   # lognormal | zipf
    prompt_sigma: float = 0.8
    output_sigma: float = 0.6
    zipf_alpha: float = 2.0
    min_prompt: int = 4
    max_prompt: int = 64
    min_output: int = 1
    max_output: int = 24
    burst_size: float = 4.0
    diurnal_depth: float = 0.8
    diurnal_period_s: Optional[float] = None
    tenants: Tuple[TenantClass, ...] = DEFAULT_TENANTS

    def __post_init__(self):
        if self.n_requests < 0:
            raise ValueError("n_requests must be >= 0")
        if self.arrival not in ("poisson", "bursty", "diurnal"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")
        if self.length_dist not in ("lognormal", "zipf"):
            raise ValueError(
                f"unknown length distribution {self.length_dist!r}")
        if not self.tenants:
            raise ValueError("at least one tenant class required")


def _arrivals(spec: WorkloadSpec, seed: int) -> List[float]:
    if spec.arrival == "poisson":
        return poisson_arrivals(spec.rate, spec.n_requests, seed=seed)
    if spec.arrival == "bursty":
        return bursty_arrivals(spec.rate, spec.n_requests, seed=seed,
                               burst_size=spec.burst_size)
    return diurnal_arrivals(spec.rate, spec.n_requests, seed=seed,
                            depth=spec.diurnal_depth,
                            period_s=spec.diurnal_period_s)


def make_trace(cfg, spec: WorkloadSpec = WorkloadSpec(),
               seed: int = 0) -> List[Request]:
    """Generate the trace: arrivals from the spec's process, a tenant
    class per request (share-weighted, seeded), lengths from the
    heavy-tailed law with per-class median overrides, token ids from
    ``cfg.vocab_size``.  Deterministic in ``(cfg.vocab_size, spec,
    seed)``; rids are assigned in arrival order."""
    n = spec.n_requests
    rng = np.random.default_rng(seed)
    arrivals = sorted(_arrivals(spec, seed + 1))
    shares = np.asarray([t.share for t in spec.tenants], np.float64)
    t_idx = rng.choice(len(spec.tenants), size=n, p=shares / shares.sum())
    reqs: List[Request] = []
    for i in range(n):
        ten = spec.tenants[int(t_idx[i])]
        p_med = ten.prompt_median or spec.prompt_median
        o_med = ten.output_median or spec.output_median
        # per-request child streams: class mix and length draws stay
        # aligned however the tenant set or medians change
        child = np.random.default_rng((seed, 1 + i))
        plen = int(heavy_tail_lengths(
            child, 1, p_med, dist=spec.length_dist,
            sigma=spec.prompt_sigma, alpha=spec.zipf_alpha,
            lo=spec.min_prompt, hi=spec.max_prompt)[0])
        budget = int(heavy_tail_lengths(
            child, 1, o_med, dist=spec.length_dist,
            sigma=spec.output_sigma, alpha=spec.zipf_alpha,
            lo=spec.min_output, hi=spec.max_output)[0])
        prompt = child.integers(0, cfg.vocab_size, plen).astype(np.int32)
        reqs.append(Request(
            rid=i, prompt=prompt, max_new_tokens=budget,
            arrival_s=float(arrivals[i]), tenant=ten.name,
            weight=ten.weight, ttft_slo_s=ten.ttft_slo_s,
            tpot_slo_s=ten.tpot_slo_s))
    return reqs


def tenant_by_name(tenants: Sequence[TenantClass], name: str) -> TenantClass:
    """The tenant class called ``name``; ``KeyError`` if none is."""
    for t in tenants:
        if t.name == name:
            return t
    raise KeyError(name)
