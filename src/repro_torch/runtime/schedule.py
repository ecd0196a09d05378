"""Upload schedules — how one client's round-end message meets the clock.

The port's copy of the JAX package's ``runtime/schedule.py``: pure
arithmetic on the modeled clock, so its events equal the reference's.

The event runtime prices every executed barrier round by replaying it as
client events. The *upload schedule* decides what those events are:

  BlockingSchedule    the historical model: the client finishes all k local
                      steps, then ships one monolithic message —
                      ``arrival = compute_done + α + total_bytes/bandwidth``.

  StreamingSchedule   per-leaf streaming reduce (communication/compute
                      overlap): leaf l's round delta
                      is final as soon as the *last local step* updates
                      leaf l, and backprop releases leaves in
                      reverse-layer order spread across that final step —
                      so leaf uploads start *before* ``compute_done`` and
                      overlap the remaining layers' compute. The uplink is
                      one serial streamed connection: the per-message
                      latency α is paid once when the stream opens, then
                      each leaf serializes at β as soon as it is released
                      and the link is free.

Both schedules also price the *downlink* (``broadcast_events``) when the
client link bills it (``NetworkModel.count_downlink``): blocking ships the
consensus as one monolithic broadcast after the whole round has merged;
streaming ships leaf l's broadcast as soon as the server finishes reducing
leaf l — high-index leaves (reduced first under the reverse-order uplink)
serialize down while the server is still merging the early layers, so the
next round starts ``≈ α + first_leaf_bytes/β`` after the final merge
instead of a full model transfer later.

Numerics are untouched either way — the schedule is pure clock accounting
on top of the bit-exact synchronous replay, which is exactly why streaming
and blocking runs of the same config produce identical parameters while
their modeled wall-clocks differ. Units throughout: times in modeled
seconds, payloads in bytes, compute in local steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.runtime.client import ClientProcess

# (time_s, event kind, info tuple) — info carries the leaf index for
# per-leaf arrivals so traces stay attributable
ScheduledEvent = Tuple[float, str, tuple]


@dataclass(frozen=True)
class UploadSchedule:
    """Base protocol: turn one client's barrier round into clock events.

    ``round_events`` returns ``(events, finish_s)`` where ``events`` is the
    client's event list for the round — each ``(time_s, kind, info)`` —
    and ``finish_s`` (modeled seconds) is when the client's full message
    has arrived at the server; the barrier merges at the max finish over
    clients. ``leaf_bytes[i]`` is leaf i's compressed payload in bytes,
    ``leaf_fracs[i]`` its share of one local step's compute (unitless,
    sums to 1 — proportional to parameter count). ``active=False`` replays
    a dropped client: it missed its compute window but still answers the
    barrier with its zero-delta message.
    """

    name = "base"
    # capability flags the event runtime branches on: does the schedule
    # stream the uplink per leaf, and does it stream the *whole* round
    # (per-leaf WAN hop + per-leaf downlink) rather than the uplink only?
    streams_uplink = False
    streams_round = False

    def round_events(self, client: ClientProcess, start: float, k_steps: int,
                     leaf_bytes: Sequence[int], leaf_fracs: Sequence[float],
                     active: bool = True
                     ) -> Tuple[List[ScheduledEvent], float]:
        raise NotImplementedError

    def broadcast_events(self, client: ClientProcess,
                         leaf_done: Sequence[float],
                         leaf_bytes: Sequence[int]
                         ) -> Tuple[List[ScheduledEvent], float]:
        """Price the server→client downlink of one round.

        ``leaf_done[l]`` is the modeled time the server finished reducing
        leaf l (all equal to the merge instant under a blocking barrier);
        ``leaf_bytes[l]`` is leaf l's *dense* broadcast payload (the
        downlink ships the uncompressed consensus — cost_model.md).
        Returns ``(events, ready_s)``: ``ready_s`` is when the client
        holds the full consensus and can begin the next round's local
        compute. On links that don't bill the downlink
        (``count_downlink=False``) this is free: no events, ready at the
        final merge.
        """
        raise NotImplementedError


@dataclass(frozen=True)
class BlockingSchedule(UploadSchedule):
    """One monolithic upload after all local compute — the historical
    round price ``k·step_time + α + Σ bytes / bandwidth`` per client."""

    name = "blocking"

    def round_events(self, client, start, k_steps, leaf_bytes, leaf_fracs,
                     active=True):
        total = sum(leaf_bytes)
        if not active:
            # upload-only zero-delta answer (missed the compute window)
            t = start + client.upload_time(total)
            return [(t, "arrival", ())], t
        done = start + client.compute_time(k_steps)
        t = done + client.upload_time(total)
        return [(done, "compute_done", ()), (t, "arrival", ())], t

    def broadcast_events(self, client, leaf_done, leaf_bytes):
        net = client.network
        merged = max(leaf_done)
        if not net.count_downlink:
            return [], merged
        # one monolithic broadcast after the whole round has merged
        t = merged + net.latency_s + sum(leaf_bytes) / net.bandwidth_Bps
        return [(t, "broadcast_arrival", ())], t


@dataclass(frozen=True)
class StreamingSchedule(UploadSchedule):
    """Per-leaf streaming uploads overlapping the final local step.

    Release model: the final local step spans
    ``[done − step_time, done]``; its backward pass completes leaves in
    reverse-layer order, leaf l becoming final once its share of the
    step's compute (``leaf_fracs``, ∝ parameter count) has accumulated.
    Link model: one streamed connection — α once at stream open, then
    strictly serial ``bytes/bandwidth`` per leaf in release order; a leaf
    released while the link is busy queues. Emits one ``leaf_arrival``
    per leaf (info = (leaf index,)) plus the usual ``compute_done``;
    the client's finish is the last leaf's arrival, which is what lets a
    multi-leaf model hide most of its upload behind its own compute.

    By default the *whole round* streams: the downlink broadcast also
    runs per leaf in server-completion order (in the JAX package the
    inter-pod WAN hop of a hierarchical topology does too; the port's
    hierarchical topology is still to come). ``uplink_only=True`` is the
    uplink-only comparator — per-leaf uplink, but a monolithic
    broadcast.
    """

    uplink_only: bool = False

    streams_uplink = True

    @property
    def name(self):
        return "streaming-uplink" if self.uplink_only else "streaming"

    @property
    def streams_round(self):
        return not self.uplink_only

    def round_events(self, client, start, k_steps, leaf_bytes, leaf_fracs,
                     active=True):
        net = client.network
        order = list(range(len(leaf_bytes)))[::-1]  # reverse-layer release
        events: List[ScheduledEvent] = []
        if not active:
            # zero-delta answer: every leaf is "ready" at round start;
            # the stream just serializes them back-to-back
            t = start + net.latency_s
            for leaf in order:
                t += leaf_bytes[leaf] / net.bandwidth_Bps
                events.append((t, "leaf_arrival", (leaf,)))
            return events, t
        done = start + client.compute_time(k_steps)
        step = client.compute_time(1)
        t_back = done - step            # final step begins
        events.append((done, "compute_done", ()))
        cum = 0.0
        link_free = None
        finish = done
        for leaf in order:
            cum += leaf_fracs[leaf]
            ready = t_back + step * cum
            if link_free is None:
                link_free = ready + net.latency_s  # stream opens once
            send = max(ready, link_free)
            finish = send + leaf_bytes[leaf] / net.bandwidth_Bps
            link_free = finish
            events.append((finish, "leaf_arrival", (leaf,)))
        return events, finish

    def broadcast_events(self, client, leaf_done, leaf_bytes):
        net = client.network
        merged = max(leaf_done)
        if not net.count_downlink:
            return [], merged
        if self.uplink_only:
            # uplink-only comparator: monolithic broadcast after the merge
            t = merged + net.latency_s + sum(leaf_bytes) / net.bandwidth_Bps
            return [(t, "broadcast_arrival", ())], t
        # streamed downlink: leaf l ships as soon as the server finishes
        # reducing it. Completion order is reverse-leaf order (the uplink
        # streams leaves back-to-front), so high-index leaves serialize
        # down while the early layers are still merging and the round's
        # last landing — leaf 0, the first the next forward pass needs —
        # trails the final merge by only α (amortized) + its own
        # serialization instead of the full model's.
        events: List[ScheduledEvent] = []
        link_free = None
        fin = merged
        for leaf in range(len(leaf_bytes) - 1, -1, -1):
            ready = leaf_done[leaf]
            if link_free is None:
                link_free = ready + net.latency_s  # stream opens once
            send = max(ready, link_free)
            fin = send + leaf_bytes[leaf] / net.bandwidth_Bps
            link_free = fin
            events.append((fin, "leaf_broadcast", (leaf,)))
        return events, fin


def get_schedule(spec) -> UploadSchedule:
    """Resolve an upload schedule from a config string (or pass through).

    Accepted specs: "blocking" (default) | "streaming" / "stream" |
    "streaming-uplink" (per-leaf uplink only: a monolithic broadcast — the
    uplink-only comparator).
    """
    if isinstance(spec, UploadSchedule):
        return spec
    if spec in (None, "blocking", "block"):
        return BlockingSchedule()
    if spec in ("streaming", "stream"):
        return StreamingSchedule()
    if spec in ("streaming-uplink", "stream-uplink", "uplink"):
        return StreamingSchedule(uplink_only=True)
    raise ValueError(f"unknown upload schedule spec: {spec!r}")
