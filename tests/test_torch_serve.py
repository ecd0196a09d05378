"""The port's serving stack against the JAX package's.

Traffic is numpy ``RandomState`` in both packages, so the request lists
are identical; the scheduler makes identical decisions on identical
offers. ``ServeEngine.run`` at smoke width in float32, with the JAX
params carried across and both engines priced by the same explicit
``DeviceModel(peak_flops, hbm_bw)``, produces identical ledgers
(``trace_keys``: tokens and every modeled time). Inside the port, the
batched engine's tokens equal the per-request ``greedy_decode``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as JTF
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.serve import DeviceModel as JDeviceModel
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import TrafficConfig as JTrafficConfig
from repro.serve import generate_requests as j_generate
from repro_torch.configs import get_arch
from repro_torch.core.serving import greedy_decode
from repro_torch.launch import serve as serve_cli
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import (DeviceModel, Request, Scheduler,
                               SchedulerConfig, ServeEngine, TrafficConfig,
                               generate_requests)
from repro_torch.utils.convert import transformer_params_from_jax

SCHED = dict(n_slots=3, max_seq_len=96, max_queue=32)
PRICES = dict(peak_flops=989e12, hbm_bw=3.35e12)


def _traffic_kw(seed=7):
    return dict(process="poisson", rate_rps=2e5, n_requests=9,
                mean_prompt_len=24, max_prompt_len=70, mean_out_len=5,
                max_out_len=10, seed=seed)


@pytest.mark.parametrize("process", ["poisson", "bursty"])
@pytest.mark.parametrize("seed", [0, 11])
def test_generate_requests_identical_to_jax(process, seed):
    kw = dict(process=process, rate_rps=50.0, n_requests=24,
              mean_prompt_len=40, max_prompt_len=200, seed=seed)
    want = j_generate(JTrafficConfig(**kw), 512)
    got = generate_requests(TrafficConfig(**kw), 512)
    assert len(got) == len(want) == 24
    for a, b in zip(got, want):
        assert (a.id, a.arrival_s, a.n_out) == (b.id, b.arrival_s, b.n_out)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_scheduler_admissions_identical_to_jax():
    rng = np.random.RandomState(3)
    kw = dict(n_slots=3, max_seq_len=40, max_queue=4, token_budget=80,
              max_prefills_per_step=2)
    js, ts = JScheduler(JSchedulerConfig(**kw)), Scheduler(
        SchedulerConfig(**kw))
    log_j, log_t = [], []
    for rid in range(60):
        plen, nout = int(rng.randint(1, 40)), int(rng.randint(1, 12))
        prompt = np.zeros(plen, np.int32)
        log_j.append(js.offer(JRequest(id=rid, arrival_s=0.0, prompt=prompt,
                                       n_out=nout)))
        log_t.append(ts.offer(Request(id=rid, arrival_s=0.0, prompt=prompt,
                                      n_out=nout)))
        if rng.rand() < 0.5:
            log_j.append([(a.request.id, a.slot) for a in js.admit()])
            log_t.append([(a.request.id, a.slot) for a in ts.admit()])
        if js.in_flight and rng.rand() < 0.4:
            slot = sorted(js.in_flight)[rng.randint(len(js.in_flight))]
            log_j.append(js.release(slot).id)
            log_t.append(ts.release(slot).id)
    assert log_t == log_j
    assert [r.id for r in ts.rejected_full] == [r.id for r in js.rejected_full]
    assert [r.id for r in ts.rejected_too_long] == \
        [r.id for r in js.rejected_too_long]


@pytest.fixture(scope="module")
def served():
    """gemma2-27b SMOKE in float32, one set of params in both packages."""
    jcfg = jax_get_arch("gemma2-27b", smoke=True).replace(dtype="float32")
    tcfg = get_arch("gemma2-27b", smoke=True).replace(dtype="float32")
    jp = JTF.init_params(jax.random.key(0), jcfg)
    tp = transformer_params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     "cpu")
    return jcfg, tcfg, jp, tp


def test_engine_ledger_identical_to_jax(served):
    jcfg, tcfg, jp, tp = served
    jeng = JServeEngine(jcfg, jp, scheduler=JSchedulerConfig(**SCHED),
                        device=JDeviceModel(**PRICES))
    teng = ServeEngine(tcfg, tp, scheduler=SchedulerConfig(**SCHED),
                       device=DeviceModel(**PRICES))
    assert teng.decode_step_s == jeng.decode_step_s
    jrep = jeng.run(j_generate(JTrafficConfig(**_traffic_kw()),
                               jcfg.vocab_size), registry=JRegistry())
    trep = teng.run(generate_requests(TrafficConfig(**_traffic_kw()),
                                      tcfg.vocab_size),
                    registry=MetricsRegistry())
    assert len(trep.completed) == 9
    assert trep.trace_keys() == jrep.trace_keys()
    assert (trep.n_steps, trep.n_prefills, trep.makespan_s) == \
        (jrep.n_steps, jrep.n_prefills, jrep.makespan_s)
    assert trep.latency_summary() == jrep.latency_summary()


def test_batched_tokens_equal_greedy_decode_across_arrival_orders(served):
    _, tcfg, _, tp = served
    eng = ServeEngine(tcfg, tp, scheduler=SchedulerConfig(**SCHED))
    traffic = generate_requests(TrafficConfig(**_traffic_kw(seed=5)),
                                tcfg.vocab_size)
    ref = {r.id: greedy_decode(tp, tcfg, torch.from_numpy(r.prompt[None])
                               .long(), r.n_out, SCHED["max_seq_len"])[0][0]
           .tolist() for r in traffic}
    rev = sorted(r.arrival_s for r in traffic)[::-1]
    reordered = sorted((dataclasses.replace(r, arrival_s=t)
                        for r, t in zip(traffic, rev)),
                       key=lambda r: r.arrival_s)
    slots_seen = []
    for reqs in (traffic, reordered):
        report = eng.run(list(reqs), registry=MetricsRegistry())
        assert len(report.completed) == len(traffic)
        for rec in report.records:
            assert rec.tokens == ref[rec.id], f"req {rec.id} slot {rec.slot}"
        slots_seen.append([r.slot for r in report.records])
    assert slots_seen[0] != slots_seen[1]


def test_one_token_prompts_in_used_slots_match_greedy_and_jax(served):
    """One-token prompts admitted into slots that earlier requests used,
    after decode steps have advanced every slot's position: one joins
    mid-run, one after the system drained. Their prefill takes the decode
    branch of attention and must start from position 0."""
    jcfg, tcfg, jp, tp = served
    sched = dict(n_slots=2, max_seq_len=32, max_queue=8)
    teng = ServeEngine(tcfg, tp, scheduler=SchedulerConfig(**sched),
                       device=DeviceModel(**PRICES))
    jeng = JServeEngine(jcfg, jp, scheduler=JSchedulerConfig(**sched),
                        device=JDeviceModel(**PRICES))
    prompts = np.random.RandomState(9).randint(
        0, tcfg.vocab_size, size=(4, 12)).astype(np.int32)
    # (prompt_len, n_out, arrival); request 1 retires after one decode
    # step, so request 2 reuses its slot while request 0 still decodes
    spec = [(12, 8, 0.0), (5, 2, 0.0), (1, 6, None), (1, 5, 1.0)]
    step = teng.decode_step_s
    mid = sum(teng.prefill_s(Request(id=i, arrival_s=0.0,
                                     prompt=prompts[i, :spec[i][0]],
                                     n_out=1)) for i in (0, 1)) + 3 * step
    reqs = [(i, prompts[i, :plen], n_out, mid if t is None else t)
            for i, (plen, n_out, t) in enumerate(spec)]
    trep = teng.run([Request(id=i, arrival_s=t, prompt=p, n_out=n)
                     for i, p, n, t in reqs], registry=MetricsRegistry())
    jrep = jeng.run([JRequest(id=i, arrival_s=t, prompt=p, n_out=n)
                     for i, p, n, t in reqs], registry=JRegistry())
    assert len(trep.completed) == 4
    recs = {r.id: r for r in trep.records}
    for rid in (2, 3):
        rec = recs[rid]
        earlier = [r for r in trep.records if r.slot == rec.slot
                   and r.id != rid and r.finish_s <= rec.admit_s]
        assert earlier, f"request {rid} did not reuse a slot"
        want = greedy_decode(tp, tcfg, torch.from_numpy(prompts[rid, :1][None])
                             .long(), rec.n_out, sched["max_seq_len"])[0]
        assert rec.tokens == want[0].tolist(), f"request {rid}"
    assert recs[2].admit_s < recs[0].finish_s
    assert trep.trace_keys() == jrep.trace_keys()


def test_rejections_and_single_token_requests(served):
    _, tcfg, _, tp = served
    eng = ServeEngine(tcfg, tp, scheduler=SchedulerConfig(
        n_slots=1, max_seq_len=16, max_queue=1))
    mk = lambda i, plen, n_out, t: Request(
        id=i, arrival_s=t, prompt=np.full(plen, i + 1, np.int32), n_out=n_out)
    reqs = [mk(0, 40, 8, 1e-6), mk(1, 4, 1, 2e-6), mk(2, 4, 4, 2e-6),
            mk(3, 4, 4, 2e-6)]
    reg = MetricsRegistry()
    report = eng.run(reqs, registry=reg)
    out = {r.id: r for r in report.records}
    assert out[0].outcome == "rejected_too_long"
    assert out[1].outcome == "completed" and len(out[1].tokens) == 1
    assert out[1].finish_s == out[1].first_token_s and out[1].tpot_s == 0.0
    assert out[2].outcome == out[3].outcome == "rejected_full"
    assert reg["serve.requests"].value(outcome="rejected_full") == 2


def test_ledger_span_tree_matches_jax(served):
    """The port's engine lays the same request > {queue, prefill, decode}
    and decode_step spans, at the same virtual times, as the JAX one."""
    from repro.obs import Tracer as JTracer
    from repro_torch.obs.trace import Tracer

    jcfg, tcfg, jp, tp = served
    jeng = JServeEngine(jcfg, jp, scheduler=JSchedulerConfig(**SCHED),
                        device=JDeviceModel(**PRICES))
    teng = ServeEngine(tcfg, tp, scheduler=SchedulerConfig(**SCHED),
                       device=DeviceModel(**PRICES))
    jt, tt = JTracer(), Tracer()
    jeng.run(j_generate(JTrafficConfig(**_traffic_kw(seed=3)),
                        jcfg.vocab_size), tracer=jt, registry=JRegistry())
    report = teng.run(generate_requests(TrafficConfig(**_traffic_kw(seed=3)),
                                        tcfg.vocab_size), tracer=tt,
                      registry=MetricsRegistry())
    assert tt.tree_keys() == jt.tree_keys()
    for span in tt.find("request"):
        assert [c.name for c in tt.children(span)] == ["queue", "prefill",
                                                        "decode"]
    assert len(tt.find("decode_step")) == report.n_steps


def test_device_model_prices_one_chip_only():
    with pytest.raises(NotImplementedError, match="link_model"):
        DeviceModel(n_chips=4)
    assert DeviceModel().peak_flops == 989e12


def test_serve_cli_smoke_on_cpu():
    report = serve_cli.main(["--arch", "gemma2-27b", "--smoke", "--device",
                             "cpu", "--requests", "6", "--slots", "2"])
    assert len(report.completed) == 6 and report.n_prefills == 6
    assert report.makespan_s > 0 and report.modeled_tok_s > 0
