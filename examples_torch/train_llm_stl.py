"""End-to-end driver: train a small qwen3-family LM with STL-SGD on the
port (``--hundred-m``: the ~100M-param config).

Uses the real distributed step builders (the same ones the dry run traces
for the production mesh), 4 clients on a 1×1 host mesh (a world-1 process
group: NCCL on the card, gloo on the CPU), and the stagewise η↓ / k↑
schedule. On the card every attention forward runs the flash kernel and
every local step the fused momentum-SGD kernel.

    PYTHONPATH=src python examples_torch/train_llm_stl.py \\
        [--steps 200] [--hundred-m] [--device cpu]
"""
import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.configs.base import AttentionConfig, TrainConfig
from repro_torch.core import local_sgd as LS
from repro_torch.core.simulate import resolve_device
from repro_torch.core.stl_sgd import StagewiseDriver
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import synthetic_batches
from repro_torch.utils.tree import tree_leaves

SCHEDULE = dict(algo="stl_sc", eta1=0.3, k1=4, T1=48, n_stages=4, iid=True,
                momentum=0.9)


def model_config(hundred_m=False):
    """(arch config, batch a client, sequence length)."""
    base = get_arch("qwen3-14b", smoke=True)
    if hundred_m:
        # ~100M params: 8 layers, d=512, vocab 8k (qwen3 family: qk_norm GQA)
        return base.replace(
            name="qwen3-100m", n_layers=8, d_model=512, d_ff=1536,
            vocab_size=8192,
            attention=AttentionConfig(kind="gqa", n_heads=8, n_kv_heads=4,
                                      head_dim=64, qk_norm=True)), 2, 256
    # a small stand-in of the same family (same code path)
    return base.replace(
        name="qwen3-mini", n_layers=4, d_model=256, d_ff=768,
        vocab_size=4096,
        attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=2,
                                  head_dim=64, qk_norm=True)), 2, 128


def init(cfg, clients, *, device):
    """``clients`` equal replicas of random params (seed 0) on ``device``."""
    state = LS.init_state(0, cfg, clients, device=device)
    n_params = sum(p.numel() for p in tree_leaves(state["params"])) // clients
    print(f"model: {cfg.name}  params={n_params / 1e6:.1f}M  "
          f"clients={clients}")
    return state


def train(cfg, state, batch, seq, steps, *, device, rng=None):
    """``steps`` local steps of STL-SGD^sc through ``StagewiseDriver`` on a
    1×1 host mesh (its process group started and ended here when none is
    running), over ``launch.train.synthetic_batches``. Returns
    (driver state, wall seconds)."""
    device = resolve_device(device)
    clients = tree_leaves(state["params"])[0].shape[0]
    started = not dist.is_initialized()
    mesh = make_host_mesh(1, 1, device=device)
    try:
        train_local, sync_step, _ = LS.build_train_steps(
            cfg, mesh, client_axis="data", momentum=0.9, rng=rng)
        driver = StagewiseDriver(TrainConfig(**SCHEDULE), train_local,
                                 sync_step)
        batches = synthetic_batches(cfg, clients, batch, seq, seed=0,
                                    device=device)
        t0 = time.perf_counter()
        ds = driver.run(state, batches, max_iters=steps)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    finally:
        if started:
            dist.destroy_process_group()
    print(f"\n{ds.iters_total} iters / {ds.rounds_total} comm rounds "
          f"in {dt:.1f}s ({ds.iters_total * clients * batch * seq / dt:.0f} "
          f"tok/s)")
    print("loss by stage:", [f"s{r.stage}:k={r.k}:{r.mean_loss:.3f}"
                             for r in ds.results])
    if steps >= 150:
        assert ds.results[-1].mean_loss < ds.results[0].mean_loss, \
            "loss must fall"
    print("communication rounds saved vs SyncSGD at same iters: "
          f"{ds.iters_total - ds.rounds_total} "
          f"({ds.iters_total / max(ds.rounds_total, 1):.1f}x fewer)")
    return ds, dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--hundred-m", action="store_true",
                    help="the ~100M-param config (8 layers, d=512)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without it) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg, batch, seq = model_config(args.hundred_m)
    state = init(cfg, args.clients, device=device)
    ds, _ = train(cfg, state, batch, seq, args.steps, device=device)
    return ds


if __name__ == "__main__":
    main()
