"""Open-loop arrival processes for the serving driver.

Offered load is *open-loop*: requests arrive on their own schedule whether
or not the server keeps up — the regime where queueing delay explodes past
saturation, which closed-loop (one-in-one-out) load generators can never
show. Two processes:

  * ``poisson`` — exponential inter-arrival times at ``rate_rps``;
  * ``bursty``  — a Markov-modulated Poisson process: the generator
    alternates between a quiet phase at ``rate_rps`` and burst phases at
    ``burst_factor × rate_rps`` (exponentially distributed phase lengths),
    the classic flash-crowd shape.

Prompt and output lengths are sampled per request from bounded geometric
distributions around the configured means. Everything is drawn from one
``numpy.random.RandomState(seed)``, so a ``TrafficConfig`` is a pure
function seed → request list: same seed ⇒ identical arrival times, token
ids, lengths — the property the serve determinism tests pin.

Arrivals meet the engine through the discrete-event machinery the training
runtime already uses: ``offered_load`` schedules one ``"arrival"`` event
per request on a ``runtime.clock.EventQueue`` (modeled seconds, FIFO
tie-breaking), and ``ServeEngine.run`` pops them against its virtual
``Clock``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.runtime.clock import EventQueue


@dataclass(frozen=True)
class Request:
    """One inference request: a prompt, a generation budget, an arrival
    time on the virtual clock.

    ``prompt`` is a concrete int32 token array of shape ``(prompt_len,)``;
    ``n_out`` counts generated tokens *including* the one the prefill's
    last-position logits produce. ``frontend`` optionally carries
    precomputed patch/frame embeddings ``(n_frontend_tokens,
    frontend_dim)`` for frontend archs (threaded through to
    ``TF.prefill``).
    """

    id: int
    arrival_s: float                 # modeled seconds (virtual clock)
    prompt: np.ndarray               # (prompt_len,) int32 token ids
    n_out: int                       # output tokens to generate (>= 1)
    frontend: Optional[np.ndarray] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_tokens(self) -> int:
        """Cache footprint of the finished request in token slots
        (prompt + generated; the last generated token is never written
        back, frontend tokens are accounted by the scheduler)."""
        return self.prompt_len + self.n_out


@dataclass(frozen=True)
class TrafficConfig:
    """One open-loop load scenario, fully determined by ``seed``."""

    process: str = "poisson"         # "poisson" | "bursty"
    rate_rps: float = 10.0           # mean arrival rate, requests/s (modeled)
    n_requests: int = 32
    mean_prompt_len: int = 32        # geometric around the mean, >= 1
    max_prompt_len: int = 128
    mean_out_len: int = 16
    max_out_len: int = 64
    # bursty (MMPP) phase structure: bursts run burst_factor × rate_rps,
    # phases last ~mean_phase_s each (exponential)
    burst_factor: float = 8.0
    mean_phase_s: float = 1.0
    seed: int = 0


def _bounded_geometric(rng: np.random.RandomState, mean: int, lo: int,
                       hi: int) -> int:
    """Geometric sample with the given mean, clipped to [lo, hi]."""
    if mean <= lo:
        return lo
    v = rng.geometric(1.0 / float(mean))
    return int(min(max(v, lo), hi))


def generate_requests(tcfg: TrafficConfig, vocab_size: int) -> List[Request]:
    """Materialize the request list for one scenario (sorted by arrival).

    A pure function of (tcfg, vocab_size): one RandomState drives
    inter-arrivals, burst phases, lengths and token ids in a fixed draw
    order, so the trace is reproducible across runs and platforms.
    """
    if tcfg.process not in ("poisson", "bursty"):
        raise ValueError(f"unknown arrival process {tcfg.process!r} "
                         "(expected 'poisson' or 'bursty')")
    rng = np.random.RandomState(tcfg.seed)
    t = 0.0
    # bursty phase state: (burst?, phase end time)
    in_burst, phase_end = False, 0.0
    if tcfg.process == "bursty":
        phase_end = rng.exponential(tcfg.mean_phase_s)
    out: List[Request] = []
    for rid in range(tcfg.n_requests):
        rate = tcfg.rate_rps
        if tcfg.process == "bursty":
            while t >= phase_end:
                in_burst = not in_burst
                phase_end += rng.exponential(tcfg.mean_phase_s)
            if in_burst:
                rate = tcfg.rate_rps * tcfg.burst_factor
        t += rng.exponential(1.0 / rate)
        plen = _bounded_geometric(rng, tcfg.mean_prompt_len, 1,
                                  tcfg.max_prompt_len)
        nout = _bounded_geometric(rng, tcfg.mean_out_len, 1,
                                  tcfg.max_out_len)
        prompt = rng.randint(0, vocab_size, size=(plen,)).astype(np.int32)
        out.append(Request(id=rid, arrival_s=t, prompt=prompt, n_out=nout))
    return out


def offered_load(requests: List[Request]) -> EventQueue:
    """Schedule one ``"arrival"`` event per request on a fresh EventQueue.

    ``event.client`` carries the request id (the queue's fields predate
    serving; the engine resolves ids back to Request objects). Same-time
    arrivals pop in request-id order — the deterministic FIFO tie-break
    the clock guarantees.
    """
    q = EventQueue()
    for r in sorted(requests, key=lambda r: (r.arrival_s, r.id)):
        q.push(r.arrival_s, "arrival", client=r.id)
    return q


def arrival_summary(requests: List[Request]) -> dict:
    """Offered-load stats for reports: achieved rate, token volumes."""
    if not requests:
        return {"n_requests": 0, "rate_rps": 0.0, "prompt_tokens": 0,
                "out_tokens": 0}
    span = max(r.arrival_s for r in requests)
    return {
        "n_requests": len(requests),
        "rate_rps": len(requests) / span if span > 0 else float("inf"),
        "prompt_tokens": int(sum(r.prompt_len for r in requests)),
        "out_tokens": int(sum(r.n_out for r in requests)),
    }
