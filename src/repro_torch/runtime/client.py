"""Per-client processes: sampled compute rates, network draws, dropout.

The port's copy of the JAX package's ``runtime/client.py`` (numpy only):
the same ``RandomState`` salt and draw order, so a cohort equals the
reference's.

A ``ClientProcess`` is the runtime's unit of heterogeneity — each client
owns a compute rate (local steps per modeled second) and its own α–β
``NetworkModel`` uplink, drawn once per run from a ``Heterogeneity``
profile via a seeded numpy generator so the whole event trace is
reproducible from (config, seed).

The straggler model is the standard two-population one (cf. the
overhead-bounded Local SGD line in PAPERS.md): a ``straggler_frac``
fraction of clients runs ``straggler_slowdown``× slower; an optional
lognormal ``jitter`` roughens both the compute rates and the link
bandwidths of *all* clients. ``dropout`` is the per-upload probability
that a client's message is lost (sync: the client misses the round and
keeps its round-start params; async: the finished work is discarded and
the client re-pulls).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np

from repro_torch.comm.cost import NetworkModel, link_model

# salt separating the heterogeneity draws from TrainConfig.seed's key streams
_HETERO_SEED_SALT = 0x0E7E


@dataclass(frozen=True)
class Heterogeneity:
    """Sampling profile for a population of clients."""

    base_step_time_s: float = 1e-3   # nominal wall-time of one local step
    straggler_frac: float = 0.0      # fraction of clients slowed down
    straggler_slowdown: float = 1.0  # their compute-rate divisor (1 = none)
    jitter: float = 0.0              # lognormal σ on rates and bandwidths
    dropout: float = 0.0             # P(an upload is lost)
    link: Optional[str] = None       # comm.link_model preset; None → network=
    seed: int = 0

    @property
    def enabled(self) -> bool:
        """Whether any draw can differ across clients / rounds."""
        return ((self.straggler_frac > 0.0 and self.straggler_slowdown != 1.0)
                or self.jitter > 0.0 or self.dropout > 0.0)

    @classmethod
    def from_config(cls, cfg) -> "Heterogeneity":
        """Build the profile from a TrainConfig's runtime fields."""
        return cls(base_step_time_s=cfg.base_step_time_s,
                   straggler_frac=cfg.straggler_frac,
                   straggler_slowdown=cfg.straggler_slowdown,
                   jitter=cfg.compute_jitter, dropout=cfg.dropout_rate,
                   seed=cfg.seed)

    def replace(self, **kw) -> "Heterogeneity":
        """Functional update (dataclasses.replace) of profile fields."""
        return replace(self, **kw)


@dataclass(frozen=True)
class ClientProcess:
    """One simulated client: its clock-relevant parameters only (model
    state lives in the backend; processes are pure cost descriptors)."""

    cid: int
    rate: float                       # relative compute speed, 1.0 = nominal
    step_time_s: float                # modeled seconds per local step
    network: NetworkModel = field(default_factory=NetworkModel)
    straggler: bool = False

    def compute_time(self, n_steps: int) -> float:
        """Modeled seconds this client needs for ``n_steps`` local SGD
        steps (``n_steps × step_time_s``; stragglers have larger
        step_time_s)."""
        return n_steps * self.step_time_s

    def upload_time(self, n_bytes: float) -> float:
        """Modeled seconds to ship ``n_bytes`` payload bytes over this
        client's α–β uplink (one latency α + serialization at β)."""
        return self.network.time(n_bytes)


def sample_clients(n: int, hetero: Heterogeneity,
                   network: Optional[NetworkModel] = None
                   ) -> List[ClientProcess]:
    """Draw n ClientProcesses from the profile (deterministic in seed).

    The base uplink is ``hetero.link``'s calibrated preset when set, else
    the ``network`` argument (a TrainConfig's comm_* model), else the
    default WAN. All draws come from one seeded RandomState in a fixed
    order, so the cohort is a pure function of (n, hetero, network).
    """
    base_net = (link_model(hetero.link) if hetero.link is not None
                else (network or NetworkModel()))
    rng = np.random.RandomState((hetero.seed + _HETERO_SEED_SALT) % (2 ** 31))
    n_strag = int(round(hetero.straggler_frac * n))
    stragglers = set(rng.choice(n, size=n_strag, replace=False).tolist()
                     if n_strag else [])
    clients = []
    for cid in range(n):
        rate = 1.0
        bw = base_net.bandwidth_gbps
        if hetero.jitter > 0.0:
            rate /= float(np.exp(rng.normal(0.0, hetero.jitter)))
            bw /= float(np.exp(rng.normal(0.0, hetero.jitter)))
        is_strag = cid in stragglers
        if is_strag:
            rate /= hetero.straggler_slowdown
        clients.append(ClientProcess(
            cid=cid, rate=rate,
            step_time_s=hetero.base_step_time_s / rate,
            network=NetworkModel(latency_s=base_net.latency_s,
                                 bandwidth_gbps=bw,
                                 count_downlink=base_net.count_downlink),
            straggler=is_strag))
    return clients
