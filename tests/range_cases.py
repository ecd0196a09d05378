"""A SMOKE training run through the driver, and the profiler ranges it
should open.

Shared by the CPU tests of the ranges (``test_torch_layer_ranges.py``)
and the JAX-free GPU tests, which run the same steps on the card.
"""
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import local_sgd as LS
from repro_torch.core.stl_sgd import StagewiseDriver
from repro_torch.launch.train import synthetic_batches

STEPS, CLIENTS = 2, 2
# the Function whose forward each arch's layers run
MIXER = {"mamba2-2.7b": "ssd", "musicgen-medium": "flash_attention"}


def smoke_run(arch: str, device, tracer=None, k: int = STEPS):
    """``STEPS`` local steps of ``CLIENTS`` clients, a round after every
    ``k``: the SMOKE arch's steps from ``build_train_steps`` on
    ``device``, run by ``StagewiseDriver``."""
    cfg = get_arch(arch, smoke=True)
    state = LS.init_state(0, cfg, CLIENTS, device=device)
    train, sync, _ = LS.build_train_steps(cfg, device)
    seq = 2 * cfg.ssm.chunk_size if cfg.ssm is not None else 16
    drv = StagewiseDriver(TrainConfig(algo="local", k1=k, T1=STEPS,
                                      n_stages=1), train, sync)
    return drv.run(state, synthetic_batches(cfg, CLIENTS, 1, seq,
                                            device=device), tracer=tracer)


def expected_counts(arch: str) -> dict:
    """How often each range opens in ``smoke_run``: forward, backward and
    update once a client a step; the mixer's forward a layer a client a
    step, twice with the remat recompute, its backward once; the driver's
    feed and loss read once a step; one burst, one round."""
    layers = get_arch(arch, smoke=True).n_layers
    per_client = STEPS * CLIENTS
    mixer = MIXER[arch]
    return {"local_sgd.forward": per_client,
            "local_sgd.backward": per_client,
            "local_sgd.update": per_client,
            f"{mixer}.forward": 2 * per_client * layers,
            f"{mixer}.backward": per_client * layers,
            "driver.batch": STEPS, "driver.loss_read": STEPS,
            "driver.local_steps": 1, "driver.reduce": 1,
            "engine.run": 1, "engine.stage": 1}


def host_ranges(prof, names):
    """(name, start ns, end ns) of the host events named in ``names``."""
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() in names and e.device_type() == cpu]


def inside(span, outers) -> bool:
    """Whether ``span`` lies within one of ``outers`` (same triples)."""
    return any(a <= span[1] and span[2] <= b for _, a, b in outers)
