# Discrete-event runtime: so far the virtual clock and event queue the
# serving engine runs on (the training runtime waits, ROADMAP queue 1).
from repro_torch.runtime.clock import Clock, Event, EventQueue

__all__ = ["Clock", "Event", "EventQueue"]
