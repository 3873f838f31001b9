"""Small public names of the JAX package that the port carries too, each
held against its JAX counterpart on the same inputs:
``GroupSchedule.assign``, ``AlignmentPolicy.label``,
``RequestQueue.active``, ``tenant_by_name``, ``ExpertStore.get_host`` and
the kernel families exported from ``repro_torch.kernels``."""
import jax
import numpy as np
import pytest
import torch

import repro.kernels as jkernels
import repro_torch.kernels as tkernels
from _torch_bridge import bridge, torch_cfg
from conftest import tiny_moe
from repro.core import AlignmentPolicy as JAlign
from repro.core import ExpertStore as JStore
from repro.core.schedule import GroupSchedule as JSched
from repro.models import init_params as jinit
from repro.serve import Request as JRequest
from repro.serve import RequestQueue as JQueue
from repro.serve import RequestState as JState
from repro.serve.workload import DEFAULT_TENANTS as JTENANTS
from repro.serve.workload import TenantClass as JTenant
from repro.serve.workload import tenant_by_name as jtenant_by_name
from repro_torch.core import AlignmentPolicy, ExpertStore, GroupSchedule
from repro_torch.serve import (DEFAULT_TENANTS, Request, RequestQueue, RequestState, TenantClass,
                               tenant_by_name)


@pytest.mark.parametrize("n,g", [(8, 2), (8, 8), (16, 8), (12, 3)])
def test_group_schedule_assign_equals_jax(n, g):
    """Experts map one to one onto the layer's group, wrapping when a
    layer routes more experts than the group has workers."""
    ours, theirs = GroupSchedule(n, g), JSched(n, g)
    for mi in range(5):
        for experts in ([3, 7], [1, 2, 3], [5, 5], list(range(9)), []):
            assert ours.assign(mi, experts) == theirs.assign(mi, experts)


@pytest.mark.parametrize("periods", [(1, 1), (1, 16), (0, 3), (2, 0), (0, 0)])
def test_alignment_label_equals_jax(periods):
    assert AlignmentPolicy(*periods).label() == JAlign(*periods).label()


def test_request_queue_active_equals_jax():
    """Admission order, through pops, activations and a retirement."""
    arrivals = (0.5, 0.0, 2.0, 0.0, 1.0)

    def run(req_cls, queue_cls, state_cls):
        reqs = [req_cls(rid=i, prompt=np.zeros(2, np.int32), max_new_tokens=2, arrival_s=t)
                for i, t in enumerate(arrivals)]
        q = queue_cls(reqs)
        seen = [[s.rid for s in q.active]]
        states = {}
        for now in (0.0, 1.0):
            for r in q.pop_arrived(now):
                states[r.rid] = state_cls(request=r, token=None, cache_list=[], pos=None)
                q.activate(states[r.rid])
            seen.append([s.rid for s in q.active])
        q.retire(states[3])
        seen.append([s.rid for s in q.active])
        assert all(isinstance(s, state_cls) for s in q.active)
        return seen

    assert run(Request, RequestQueue, RequestState) == run(JRequest, JQueue, JState) == \
        [[], [1, 3], [1, 3, 0, 4], [1, 0, 4]]


def test_tenant_by_name_equals_jax():
    assert [t.name for t in DEFAULT_TENANTS] == [t.name for t in JTENANTS]
    for t in JTENANTS:
        assert tenant_by_name(DEFAULT_TENANTS, t.name) == \
            TenantClass(**vars(jtenant_by_name(JTENANTS, t.name)))
    dup = [TenantClass("a", share=1.0), TenantClass("a", share=2.0)]
    assert tenant_by_name(dup, "a").share == jtenant_by_name(
        [JTenant("a", share=1.0), JTenant("a", share=2.0)], "a").share == 1.0
    for tenants, lookup in ((DEFAULT_TENANTS, tenant_by_name), (JTENANTS, jtenant_by_name)):
        with pytest.raises(KeyError):
            lookup(tenants, "no-such-tenant")


@pytest.mark.parametrize("policy", [None, "int8"])
def test_expert_store_get_host_equals_jax(policy):
    """The full-width host weights of every routed expert, whatever the
    wire format (the int8 store still hands back the unquantized
    weights); a layer without experts and a pad row raise ``KeyError``."""
    cfg = tiny_moe(num_layers=3, moe_every=2, moe_offset=1, padded_experts=10, d_ff=32)
    params = jinit(cfg, jax.random.PRNGKey(4))
    ours, theirs = ExpertStore(torch_cfg(cfg), bridge(params), policy), JStore(cfg, params, policy)
    assert ours.moe_layers == theirs.moe_layers == [1]
    for e in range(cfg.num_experts):
        got, want = ours.get_host(1, e), theirs.get_host(1, e)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].device.type == "cpu"
            np.testing.assert_array_equal(got[name].numpy(), want[name])
    for key in ((0, 0), (1, cfg.num_experts)):
        for store in (ours, theirs):
            with pytest.raises(KeyError):
                store.get_host(*key)


def test_kernel_families_are_exported_as_in_jax():
    """``repro_torch.kernels`` exports the four families under the names
    ``repro.kernels`` uses, each a callable of the port."""
    assert sorted(tkernels.__all__) == sorted(jkernels.__all__)
    for name in jkernels.__all__:
        fn = getattr(tkernels, name)
        assert callable(fn) and fn.__module__.startswith("repro_torch.kernels")
    x = torch.randn(2, 3, 8)
    w = [torch.randn(2, 8, 4), torch.randn(2, 8, 4), torch.randn(2, 4, 8)]
    assert torch.equal(tkernels.moe_ffn(x, *w), tkernels.moe_ffn_ref(x, *w))
