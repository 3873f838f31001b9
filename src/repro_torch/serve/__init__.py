"""Continuous-batching serving over the cacheless OD-MoE engine
(``repro.serve``):

  * ``request``: ``Request`` / ``RequestState`` / ``RequestQueue`` and the
    ``make_traffic`` mix: arrival, admission, per-request decode and
    shadow state, lifecycle;
  * ``kvpool``: ``KVPool`` and the paged cache views: KV memory as a page
    budget on the engine's device, per-request page tables, byte-exact
    swap-out and swap-in;
  * ``composer``: ``BatchComposer``: which runnable requests decode
    together, preferring overlapping SEP-predicted expert sets, within
    the pool's free pages;
  * ``workload``: trace-driven multi-tenant traffic;
  * ``loop``: ``ServingLoop``: prefill on admission, composed decode,
    budget-aware admission with preemption and page-exact resume, on the
    modelled clock (TTFT/TPOT/throughput) beside measured step times;
  * ``cluster``: ``ClusterRouter`` and ``make_cluster``: N replica loops
    over one shared worker fleet, expert store and gate statistics,
    per-request routing (least-loaded, weighted, round-robin), an
    autoscaling hook, and merged per-replica and cluster-wide reports.

Guarantee: per-request outputs equal solo decoding; batch composition,
deferral, preemption, replica routing and placement are scheduling.
"""
from .cluster import ClusterResult, ClusterRouter, make_cluster
from .composer import BatchComposer
from .kvpool import (KVPool, KVPoolStats, PagedCacheBatch, PagedRequestCache, PoolExhausted,
                     dense_cache_footprint)
from .loop import ServeResult, ServingLoop, StepRecord, preemption_victim
from .request import Request, RequestQueue, RequestState, make_traffic
from .workload import (DEFAULT_TENANTS, TenantClass, WorkloadSpec, bursty_arrivals,
                       diurnal_arrivals, heavy_tail_lengths, make_trace, tenant_by_name)

__all__ = [
    "BatchComposer", "ClusterResult", "ClusterRouter", "make_cluster",
    "KVPool", "KVPoolStats", "PagedCacheBatch", "PagedRequestCache",
    "PoolExhausted", "dense_cache_footprint", "ServeResult", "ServingLoop", "StepRecord",
    "preemption_victim", "Request", "RequestQueue", "RequestState", "make_traffic",
    "DEFAULT_TENANTS", "TenantClass", "WorkloadSpec", "bursty_arrivals", "diurnal_arrivals",
    "heavy_tail_lengths", "make_trace", "tenant_by_name",
]
