"""The port's batched-serving example against the JAX package's engine.

``serve_batched``'s sections run on the CPU at the script's width
(gemma2-27b SMOKE, bfloat16 as the script serves it) from the JAX
package's params (``utils/convert.transformer_params_from_jax``). The
arrival rate derives from the engine's modeled decode step, so the
port's engine takes a ``DeviceModel`` built with the JAX package's
default constants, and both see the same requests. Tolerances:

  * the modeled decode step, the requests, the decode steps, prefills
    and makespan: equal (the same arithmetic on the same numbers);
  * every request's first token equals the JAX engine's; a later token
    may differ only where the port's pick lies within a top-2 logit gap
    of 0.25 (bfloat16 products round in other places in the two
    packages; ``PERF.md`` §2), and the tokens after it are not compared;
  * the script's own check: request 0's tokens equal ``greedy_decode``.
"""
import jax
import numpy as np
import pytest
import torch

from jax_replay import load_example, one_torch_thread, to_numpy_tree  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as JTF
from repro.serve import DeviceModel as JDeviceModel
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import TrafficConfig as JTrafficConfig
from repro.serve import generate_requests as j_generate
from repro_torch.core.serving import greedy_decode
from repro_torch.serve import DeviceModel
from repro_torch.utils.convert import transformer_params_from_jax

sb = load_example("serve_batched")
MARGIN_TOL = 0.25


@pytest.fixture(scope="module")
def served():
    jcfg = jax_get_arch(sb.ARCH, smoke=True)
    tcfg = sb.get_arch(sb.ARCH, smoke=True)
    jp = JTF.init_params(jax.random.key(0), jcfg)
    tp = transformer_params_from_jax(to_numpy_tree(jp), tcfg, "cpu")
    jeng = JServeEngine(jcfg, jp, scheduler=JSchedulerConfig(
        n_slots=sb.N_SLOTS, max_seq_len=sb.MAX_SEQ_LEN))
    capacity = sb.N_SLOTS / jeng.decode_step_s
    jreqs = j_generate(JTrafficConfig(rate_rps=0.5 * capacity / 24,
                                      **sb.TRAFFIC), jcfg.vocab_size)
    jrep = jeng.run(jreqs)
    ref = JDeviceModel()
    engine, reqs, rep = sb.serve(tcfg, tp, DeviceModel(
        peak_flops=ref.peak_flops, hbm_bw=ref.hbm_bw))
    return tcfg, tp, jeng, jreqs, jrep, engine, reqs, rep


def test_serve_ledger_matches_jax(served):
    _, _, jeng, jreqs, jrep, engine, reqs, rep = served
    assert engine.decode_step_s == jeng.decode_step_s
    assert len(reqs) == len(jreqs) == sb.TRAFFIC["n_requests"]
    for a, b in zip(reqs, jreqs):
        assert (a.id, a.arrival_s, a.n_out) == (b.id, b.arrival_s, b.n_out)
        np.testing.assert_array_equal(a.prompt, b.prompt)
    assert len(rep.completed) == len(jrep.completed) == len(reqs)
    assert (rep.n_steps, rep.n_prefills, rep.makespan_s) == \
        (jrep.n_steps, jrep.n_prefills, jrep.makespan_s)


def test_serve_tokens_match_jax(served):
    tcfg, tp, _, _, jrep, _, reqs, rep = served
    compared = 0
    for rec, jrec, req in zip(rep.records, jrep.records, reqs):
        assert rec.tokens[0] == jrec.tokens[0], rec.id
        apart = [i for i, (a, b) in enumerate(zip(rec.tokens, jrec.tokens))
                 if a != b]
        if apart:
            _, gaps = greedy_decode(tp, tcfg, torch.from_numpy(
                req.prompt[None]).long(), req.n_out, sb.MAX_SEQ_LEN)
            assert float(gaps[0, apart[0]]) < MARGIN_TOL, (rec.id, apart)
        compared += apart[0] if apart else len(rec.tokens)
    assert compared > len(reqs)


def test_serve_request0_equals_greedy_decode(served):
    tcfg, tp, _, _, _, _, reqs, rep = served
    sb.check_request0(tcfg, tp, reqs, rep)
