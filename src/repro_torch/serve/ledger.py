"""Per-request latency ledger — the serving analogue of the comm ledger.

Every request that enters the engine leaves one ``RequestRecord`` carrying
its full lifecycle on the virtual clock: arrival → (queue wait) → admit →
(prefill) → first token → (decode) → finish. Derived latencies follow the
standard serving taxonomy:

  queue_wait  admit − arrival          (admission control delay)
  TTFT        first_token − arrival    (time to first token, queue incl.)
  TPOT        decode / (n_out − 1)     (per-output-token decode time)
  e2e         finish − arrival

The ledger is surfaced through ``repro_torch.obs`` twice:

  * ``emit_spans`` lays one ``request`` span per record — children
    ``queue`` / ``prefill`` / ``decode`` — on the virtual clock
    (track ``req/<id>``), next to the engine's live ``decode_step``
    spans, so the Perfetto export shows request lifetimes against batch
    occupancy;
  * ``publish_metrics`` feeds the ``serve.*`` histograms/counters whose
    p50/p95/p99 summaries the latency tables read (see the metric table
    in docs/serving.md). The latency histograms pin a high sample cap
    (65536) so the table columns stay *exact* percentiles of the ledger
    even past the default reservoir threshold;
  * ``publish_series`` feeds the per-request latency *sample series*
    (``serve.ttft_s`` / ``serve.tpot_s`` / ``serve.e2e_s``, one sample at
    each request's completion time) that the sliding-window SLO monitor
    (``obs.slo``) evaluates.

Records hold modeled times only — deterministic per (traffic seed,
scheduler config); measured wall-clock lives in the engine report, never
in the ledger.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.obs.trace import CAT_COMPUTE, CAT_CONTROL, VIRTUAL
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.series import SeriesRegistry

# latency histograms keep raw samples up to this cap so the p50/p95/p99
# table columns stay exact percentiles of the ledger (never reservoir
# approximations) at any realistic smoke/quick/full request volume
LATENCY_SAMPLE_CAP = 65536


@dataclass
class RequestRecord:
    """One request's lifecycle on the virtual clock (modeled seconds)."""

    id: int
    prompt_len: int
    n_out: int
    arrival_s: float
    outcome: str = "completed"   # completed | rejected_full | rejected_too_long
    slot: int = -1
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    token_times_s: List[float] = field(default_factory=list)

    # -- derived latencies (None until the lifecycle point is reached) ------

    @property
    def queue_wait_s(self) -> Optional[float]:
        return None if self.admit_s is None else self.admit_s - self.arrival_s

    @property
    def ttft_s(self) -> Optional[float]:
        return (None if self.first_token_s is None
                else self.first_token_s - self.arrival_s)

    @property
    def decode_s(self) -> Optional[float]:
        if self.finish_s is None or self.first_token_s is None:
            return None
        return self.finish_s - self.first_token_s

    @property
    def tpot_s(self) -> Optional[float]:
        """Per-output-token decode time (0 for single-token requests)."""
        d = self.decode_s
        if d is None:
            return None
        return d / (self.n_out - 1) if self.n_out > 1 else 0.0

    @property
    def e2e_s(self) -> Optional[float]:
        return (None if self.finish_s is None
                else self.finish_s - self.arrival_s)

    def trace_key(self) -> tuple:
        """Deterministic identity for same-seed ⇒ same-trace assertions:
        everything modeled, including the generated token ids."""
        return (self.id, self.outcome, self.slot, self.prompt_len,
                self.n_out, self.arrival_s, self.admit_s,
                self.first_token_s, self.finish_s, tuple(self.tokens),
                tuple(self.token_times_s))


def emit_spans(tracer, records: List[RequestRecord]):
    """Lay the ledger onto a Tracer as ``request > {queue, prefill,
    decode}`` spans (virtual clock, one ``req/<id>`` track per request).

    Emitted after the run, in request-id order, so the span tree is a pure
    function of the ledger — the export *is* the ledger, not a parallel
    approximation of it.
    """
    if not tracer:
        return
    for r in sorted(records, key=lambda r: r.id):
        track = f"req/{r.id:03d}"
        if r.finish_s is None:    # rejected: a zero-length marker
            tracer.instant("rejected", r.arrival_s, cat=CAT_CONTROL,
                           track=track, clock=VIRTUAL,
                           attrs={"request": r.id, "outcome": r.outcome})
            continue
        rid = tracer.begin("request", r.arrival_s, cat=CAT_CONTROL,
                           track=track, clock=VIRTUAL,
                           attrs={"request": r.id, "slot": r.slot,
                                  "prompt_len": r.prompt_len,
                                  "n_out": r.n_out})
        tracer.add("queue", r.arrival_s, r.admit_s, cat=CAT_CONTROL,
                   track=track, clock=VIRTUAL,
                   attrs={"request": r.id})
        tracer.add("prefill", r.admit_s, r.first_token_s, cat=CAT_COMPUTE,
                   track=track, clock=VIRTUAL,
                   attrs={"request": r.id, "tokens": r.prompt_len})
        tracer.add("decode", r.first_token_s, r.finish_s, cat=CAT_COMPUTE,
                   track=track, clock=VIRTUAL,
                   attrs={"request": r.id, "tokens": r.n_out - 1})
        tracer.end(rid, r.finish_s)


def publish_metrics(registry: MetricsRegistry, records: List[RequestRecord]):
    """Feed the ledger into the ``serve.*`` metric families.

    Histograms retain raw samples, so their p50/p95/p99 summaries (the
    latency-table columns) are exact percentiles of the ledger.
    """
    req = registry.counter("serve.requests", unit="requests",
                           help="requests by outcome")
    toks = registry.counter("serve.tokens_out", unit="tokens",
                            help="generated tokens over completed requests")
    hists = {
        "queue_wait_s": registry.histogram(
            "serve.queue_wait_s", unit="s",
            help="admission-control delay (admit - arrival)",
            cap=LATENCY_SAMPLE_CAP),
        "ttft_s": registry.histogram(
            "serve.ttft_s", unit="s",
            help="time to first token (queue wait + prefill)",
            cap=LATENCY_SAMPLE_CAP),
        "tpot_s": registry.histogram(
            "serve.tpot_s", unit="s",
            help="per-output-token decode time",
            cap=LATENCY_SAMPLE_CAP),
        "e2e_s": registry.histogram(
            "serve.e2e_s", unit="s", help="end-to-end request latency",
            cap=LATENCY_SAMPLE_CAP),
    }
    for r in records:
        req.inc(1, outcome=r.outcome)
        if r.outcome != "completed":
            continue
        toks.inc(r.n_out)
        for name, h in hists.items():
            v = getattr(r, name)
            if v is not None:
                h.observe(v)


def publish_series(series: SeriesRegistry, records: List[RequestRecord]):
    """Feed the ledger into per-request latency sample series.

    One sample per completed request on the virtual clock — TTFT at the
    moment the first token lands, TPOT/e2e at request finish — so the
    sliding-window SLO monitor (``obs.slo``) sees latencies in the order
    the serving system actually produced them. Samples arrive in request
    id order; the ``Series`` sorts by time lazily on read.
    """
    s_ttft = series.series("serve.ttft_s", clock=VIRTUAL, unit="s",
                           help="per-request time to first token")
    s_tpot = series.series("serve.tpot_s", clock=VIRTUAL, unit="s",
                           help="per-request per-output-token decode time")
    s_e2e = series.series("serve.e2e_s", clock=VIRTUAL, unit="s",
                          help="per-request end-to-end latency")
    for r in records:
        if r.outcome != "completed":
            continue
        if r.ttft_s is not None:
            s_ttft.record(r.first_token_s, r.ttft_s)
        if r.finish_s is not None:
            if r.tpot_s is not None:
                s_tpot.record(r.finish_s, r.tpot_s)
            if r.e2e_s is not None:
                s_e2e.record(r.finish_s, r.e2e_s)
