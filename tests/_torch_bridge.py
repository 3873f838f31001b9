"""Helpers shared by the port's parity tests: JAX config and parameters
across to ``repro_torch``, always through numpy (``jax.random`` cannot be
replayed in torch, so every comparison runs on bridged weights)."""
import dataclasses

import jax
import numpy as np

import repro_torch.models as tm


def torch_cfg(cfg):
    """The port's ``ModelConfig`` with the same field values."""
    return tm.ModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})


def bridge(params, device="cpu"):
    """JAX parameter pytree -> port parameters, leaf for leaf."""
    return tm.from_numpy(jax.tree.map(np.asarray, params), device)


def prompt(cfg, seed: int, length: int = 12):
    """A numpy-seeded prompt (1, length) int32, fed to both packages."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, length)).astype(np.int32)


def torch_trace(trace):
    """A JAX engine ``Trace`` as the port's ``Trace``: the same records
    (tokens, routing, predictions, gates, waves, hosted experts, wave widths
    and commits), as numpy."""
    from repro_torch.core import LayerRecord, TokenRecord, Trace

    def arr(a):
        return None if a is None else np.asarray(a)

    out = Trace()
    for rec in trace.records:
        tr = TokenRecord(index=rec.index, aligned_token=rec.aligned_token,
                         aligned_kv=rec.aligned_kv, spec_len=rec.spec_len,
                         committed=rec.committed)
        for lr in rec.layers:
            tr.layers.append(LayerRecord(
                layer=lr.layer, moe_index=lr.moe_index, group=lr.group,
                predicted=arr(lr.predicted), true=np.asarray(lr.true),
                correct=lr.correct, reloads=lr.reloads,
                assignments=list(lr.assignments),
                waves=[list(w) for w in (lr.waves or [])],
                touched=tuple(lr.touched), gates=arr(lr.gates),
                hosted=tuple(getattr(lr, "hosted", ()))))
        out.records.append(tr)
    return out


def torch_requests(requests):
    """JAX ``repro.serve.Request``s as the port's, field for field."""
    from repro_torch.serve import Request
    return [Request(rid=r.rid, prompt=np.asarray(r.prompt), max_new_tokens=r.max_new_tokens,
                    arrival_s=r.arrival_s, tenant=r.tenant, weight=r.weight,
                    ttft_slo_s=r.ttft_slo_s, tpot_slo_s=r.tpot_slo_s)
            for r in requests]


def step_fields(step):
    """A serving ``StepRecord`` of either package as plain values: batch
    membership, pool occupancy, queue counts and the composed record's
    routing, predictions and loads (the modelled times are compared apart,
    within a tolerance)."""
    rec = step.record

    def arr(a):
        return None if a is None else np.asarray(a).tolist()

    layers = [(lr.layer, lr.moe_index, lr.group, arr(lr.predicted), arr(lr.true), lr.correct,
               lr.reloads, list(lr.assignments), [list(w) for w in (lr.waves or [])],
               tuple(lr.touched)) for lr in rec.layers]
    return (step.step, list(step.request_ids), step.alive_workers, step.kv_pages_used,
            step.queue_counts, rec.index, rec.aligned_token, rec.aligned_kv, rec.spec_len,
            rec.committed, layers)


def torch_profiles(profiles):
    """JAX ``repro.fleet.WorkerProfile``s as the port's, field for field."""
    from repro_torch.fleet import WorkerProfile
    return tuple(WorkerProfile(p.worker, p.link_gbps, p.capacity) for p in profiles)


def torch_faults(events):
    """A JAX fault script (``repro.fleet.FaultEvent``s) as the port's."""
    from repro_torch.fleet import FaultEvent
    return [FaultEvent(e.step, e.worker, e.kind, factor=e.factor, moe_index=e.moe_index)
            for e in events]


def profile_fields(profile):
    """A ``WorkerProfile`` of either package (or None) as plain values."""
    return None if profile is None else (profile.worker, profile.link_gbps, profile.capacity)


def fault_fields(events):
    """Fault events of either package as plain tuples."""
    return [(e.step, e.worker, e.kind, e.factor, e.moe_index) for e in events]


def numpy_params(cfg, seed: int):
    """Parameters in the layout of the JAX package's ``init_params(cfg)``
    (leaf for leaf, from ``jax.eval_shape``, so nothing compiles), drawn
    from a numpy generator: norm scales near 1, matrices scaled by their
    fan-in, vectors small.  Returns the numpy tree; ``jax.tree.map(
    jnp.asarray, tree)`` and ``repro_torch.models.from_numpy(tree)`` feed
    it to both packages."""
    from repro.models import init_params
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init_params(cfg, k), jax.random.PRNGKey(0))

    def leaf(path, s):
        if "scale" in jax.tree_util.keystr(path):
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif len(s.shape) >= 2:
            a = rng.standard_normal(s.shape) * s.shape[-2] ** -0.5
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return a.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
