"""The sharded cases of ``tests/test_torch_mesh.py``: one table of
training cases, a bfloat16 dense round (``BF16_CASE``) and the serving
cases (``SERVE_CASES``), run three ways — the JAX package jitted with
``in_shardings`` on 4 host devices (``REFERENCE``, a subprocess), the
port's mesh route on 4 ``gloo`` processes (``port_worker``) and the
port's single-device route (the test process).

Every case starts from a state of numpy arrays the test process makes
(the JAX package's ``init_state``, or it plus seeded noise per client so
that an int8 round starts from distinct replicas) and sees the same
numpy batches; the int8 rounds' bits replay JAX's draws (``JaxKey``).
Results are dicts keystr path → numpy array, pickled.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

B, S, K, ETA = 2, 32, 2, 0.05

# name: (arch, mesh shape, mesh axes, client_axis, n_clients); "m4":
# both clients on each rank, 4 heads on 4 model ranks with 2 KV heads (k
# and v replicated, each rank taking its q head's KV head)
CASES = {
    "dm-qwen3": ("qwen3-14b", (2, 2), ("data", "model"), "data", 2),
    "m4-qwen3": ("qwen3-14b", (1, 4), ("data", "model"), "data", 2),
    "dm-mamba2": ("mamba2-2.7b", (2, 2), ("data", "model"), "data", 2),
    "pdm-qwen3": ("qwen3-14b", (2, 2, 1), ("pod", "data", "model"),
                  ("pod", "data"), 4),
    "pod-qwen3": ("qwen3-14b", (2, 2, 1), ("pod", "data", "model"),
                  "pod", 2),
}


# a dense round of distinct bfloat16 replicas on a (data=4, model=1)
# mesh: one client a rank, so the mean's sum crosses every rank
BF16_CASE = ("qwen3-14b", (4, 1), ("data", "model"), "data", 4)


def rounds_of(case):
    """(name, reducer, inter reducer, start) of each round a case runs:
    start "local" is the state after K local steps, "noise" the noisy
    start. Two-level rounds: intra reducer ∘ inter reducer."""
    axis = CASES[case][3]
    if axis == "pod" or case.startswith("m4"):
        return [("dense", "dense", None, "local")]
    if isinstance(axis, tuple):
        return [("hier", "dense", "int8", "local"),
                ("hier-noise", "dense", "int8", "noise"),
                ("hier-int8", "int8", "int8", "local"),
                ("hier-int8-noise", "int8", "int8", "noise"),
                ("hier-topk-noise", "topk", "dense", "noise")]
    return [("dense", "dense", None, "local"),
            ("int8", "int8", None, "local"),
            ("int8-noise", "int8", None, "noise"),
            ("topk", "topk", None, "local"),
            ("topk-noise", "topk", None, "noise")]


# rounds the port also runs streaming (leaf by leaf, reverse-layer
# order), as "<name>-streaming": equal to the blocking round bit for bit
STREAMING_ROUNDS = {"dm-qwen3": "topk-noise", "pdm-qwen3": "hier-int8-noise"}
# a round whose state the port's mesh run gathers and places again
# (``gather_state`` / ``place_state``), then rounds once more from it and
# from the state it kept: "<name>-replaced" and "<name>-again", equal
REPLACED_ROUND = ("pdm-qwen3", "hier-int8-noise")

# top-k ties across the model split: a hand-made tree of deltas from five
# values (most magnitudes tied), each leaf split over data (clients) and
# model (its dim), reduced from a zero reference and residual at each
# frac (0.9: each rank's block holds fewer elements than the leaf's k)
TIE_MESH = ((2, 2), ("data", "model"))
TIE_FRACS = (0.3, 0.9)


def tie_tree():
    """name → (deltas (2, ...), the dim split over ``model``)."""
    rng = np.random.RandomState(7)
    return {"a": ((rng.randint(-2, 3, (2, 4, 6)) / 2).astype(np.float32), 2),
            "b": ((rng.randint(-2, 3, (2, 6, 4)) / 2).astype(np.float32), 1)}


def batches(cfg_vocab, case, seed=0):
    n = CASES[case][4]
    lead = (n, 2, B) if CASES[case][3] == "pod" else (n, B)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(K):
        toks = rng.randint(0, cfg_vocab, lead + (S + 1,))
        out.append({"tokens": toks[..., :-1].astype(np.int32),
                    "labels": toks[..., 1:].astype(np.int32)})
    return out


def flat(tree_paths):
    """[(path, leaf)] → {path: numpy}."""
    return {p: np.array(x) for p, x in tree_paths}


# ---------------------------------------------------------------------------
# the JAX package, 4 host devices (run as a script: argv = inputs, output)
# ---------------------------------------------------------------------------

REFERENCE = r'''
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, @SRC@)
sys.path.insert(0, @TESTS@)
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.core import local_sgd as JLS
from repro.launch.mesh import _make_mesh, mesh_context
import mesh_cases as MC

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
for case, (arch, shape, axes, ca, n) in MC.CASES.items():
    mesh = _make_mesh(shape, axes)
    cfg = get_arch(arch, smoke=True).replace(dtype="float32")
    start = jax.tree.map(jnp.asarray, inp[case]["init"])
    st_sh = JLS.state_shardings(cfg, mesh, start["params"], start["opt"],
                                ca)
    lead = ("pod", "data", None) if ca == "pod" else (ca, None)
    b_sh = {k: NamedSharding(mesh, P(*lead, None))
            for k in ("tokens", "labels")}
    res = {}
    with mesh_context(mesh):
        local, _, _ = JLS.build_train_steps(cfg, mesh, client_axis=ca)
        jl = jax.jit(local, in_shardings=(st_sh, b_sh, None),
                     out_shardings=(st_sh, None))
        state = jax.device_put(start, st_sh)
        for b in MC.batches(cfg.vocab_size, case):
            state, _ = jl(state, jax.device_put(
                jax.tree.map(jnp.asarray, b), b_sh), MC.ETA)
        res["local"] = state
        noisy = jax.device_put(jax.tree.map(jnp.asarray, inp[case]["noise"]),
                               st_sh)
        for name, red, inter, frm in MC.rounds_of(case):
            # the rounds run eagerly on the sharded arrays: under jit XLA
            # rewrites q·(s/qmax) an ulp off the source's arithmetic
            sync = (JLS.build_sync_step(red, hierarchical=True, n_pods=2,
                                        inter_reducer=inter)
                    if inter else JLS.build_sync_step(red))
            s0 = res["local"] if frm == "local" else noisy
            if red == "dense" and inter is None:
                sync = jax.jit(sync, in_shardings=(st_sh,),
                               out_shardings=st_sh)
            res[name] = sync(s0)
    out[case] = {k: {part: MC.flat(
        (jax.tree_util.keystr(p), x) for p, x in
        jax.tree_util.tree_flatten_with_path(t)[0])
        for part, t in v.items() if part != "step"} for k, v in res.items()}

arch, shape, axes, ca, n = MC.BF16_CASE
mesh = _make_mesh(shape, axes)
cfg = get_arch(arch, smoke=True)
start = jax.tree.map(jnp.asarray, inp["bf16"])
st_sh = JLS.state_shardings(cfg, mesh, start["params"], start["opt"], ca)
with mesh_context(mesh):
    sync = jax.jit(JLS.build_sync_step("dense"), in_shardings=(st_sh,),
                   out_shardings=st_sh)
    res = sync(jax.device_put(start, st_sh))
out["bf16"] = {part: MC.flat(
    (jax.tree_util.keystr(p), np.asarray(x, np.float32)) for p, x in
    jax.tree_util.tree_flatten_with_path(res[part])[0])
    for part in ("params", "opt")}

from repro.models import transformer as TF
from repro.sharding import param_specs
from repro.sharding.rules import cache_specs, feasible_specs

mesh = _make_mesh((2, 2), ("data", "model"))
to_sh = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                                  is_leaf=lambda s: isinstance(s, P))
out["serving"] = {}
for name, (arch, rows, prompt) in MC.SERVE_CASES.items():
    cfg = get_arch(arch, smoke=True).replace(dtype="float32")
    params = jax.tree.map(jnp.asarray, inp["serving"][arch])
    cache = TF.init_cache(cfg, rows, MC.MAX_LEN)
    # serve_specs' layout: rows over data, or the sequence for one row
    bax, sax = (("data",), ()) if rows % 2 == 0 else ((), ("data",))
    psh = to_sh(feasible_specs(param_specs(params, client_axis=None),
                               params, mesh))
    csh = to_sh(feasible_specs(cache_specs(cache, data_axes=bax,
                                           seq_axes=sax), cache, mesh))
    tsh = NamedSharding(mesh, P(bax or None, None))
    toks = [jnp.asarray(t) for t in MC.serve_tokens(cfg.vocab_size, rows,
                                                    prompt)]
    with mesh_context(mesh):
        pre = jax.jit(lambda p, c, t: TF.prefill(p, cfg, t, c),
                      in_shardings=(psh, csh, tsh))
        dec = jax.jit(lambda p, c, t: TF.decode_step(p, cfg, t, c),
                      in_shardings=(psh, csh, tsh))
        params, cache = jax.device_put(params, psh), jax.device_put(cache, csh)
        last, cache = pre(params, cache, toks[0])
        logits = [last[:, -1]]
        for t in toks[1:]:
            last, cache = dec(params, cache, t)
            logits.append(last[:, -1])
    out["serving"][name] = [np.array(x) for x in logits]
pickle.dump(out, open(sys.argv[2], "wb"))
'''


def reference_script(src: str, tests: str) -> str:
    return (REFERENCE.replace("@SRC@", repr(src))
            .replace("@TESTS@", repr(tests)))


# ---------------------------------------------------------------------------
# the port, one gloo process a rank
# ---------------------------------------------------------------------------

def port_worker(rank, world, init, inp_path, out_path):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        out = run_port_cases(inp_path)
        out["serving"] = run_serving_cases(inp_path)
        out["ties"] = run_tie_cases()
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_port_cases(inp_path, device_route=False):
    """Every case through the port: on a mesh of the process group's
    ranks, or (``device_route``) on one device."""
    import jax
    import torch

    from jax_replay import JaxKey
    from repro_torch.configs import get_arch
    from repro_torch.core import local_sgd as TLS
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.utils.convert import train_state_from_jax
    from repro_torch.utils.tree import tree_flatten_with_path

    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    out = {}
    for case, (arch, shape, axes, ca, n) in CASES.items():
        cfg = get_arch(arch, smoke=True).replace(dtype="float32")
        where = "cpu" if device_route else _device_mesh("cpu", shape, axes)

        def place(state):
            st = train_state_from_jax(state, "cpu")
            return st if device_route else TLS.place_state(st, where, ca)

        def whole(state):
            state = state if device_route else TLS.gather_state(state)
            return {k: flat(tree_flatten_with_path(v)[0])
                    for k, v in state.items() if k != "step"}

        local, _, _ = TLS.build_train_steps(cfg, where, client_axis=ca,
                                            n_pods=2)
        state = place(inp[case]["init"])
        for b in batches(cfg.vocab_size, case):
            b = {k: torch.from_numpy(v).long() for k, v in b.items()}
            state, _ = local(state, b, ETA)
        res = {"local": whole(state)}
        local_np = {"params": _unflat(res["local"]["params"],
                                      inp[case]["init"]["params"]),
                    "opt": _unflat(res["local"]["opt"],
                                   inp[case]["init"]["opt"]),
                    "step": K}
        for name, red, inter, frm in rounds_of(case):
            for streaming in (False, True):
                if streaming and STREAMING_ROUNDS.get(case) != name:
                    continue
                _, sync, _ = TLS.build_train_steps(
                    cfg, where, client_axis=ca, reducer=red,
                    inter_reducer=inter, n_pods=2, streaming=streaming,
                    rng=JaxKey(jax.random.key(0)))
                s0 = place(local_np if frm == "local"
                           else inp[case]["noise"])
                s1 = sync(s0)
                res[name + ("-streaming" if streaming else "")] = whole(s1)
            if (case, name) == REPLACED_ROUND and not device_route:
                s1["step"] += 1   # the next round's key
                again = sync(TLS.place_state(TLS.gather_state(s1), where,
                                             ca))
                res[name + "-replaced"] = whole(again)
                res[name + "-again"] = whole(sync(s1))
        out[case] = res

    arch, shape, axes, ca, n = BF16_CASE
    cfg = get_arch(arch, smoke=True)
    where = "cpu" if device_route else _device_mesh("cpu", shape, axes)
    state = train_state_from_jax(inp["bf16"], "cpu")
    if not device_route:
        state = TLS.place_state(state, where, ca)
    _, sync, _ = TLS.build_train_steps(cfg, where, client_axis=ca)
    state = sync(state)
    state = state if device_route else TLS.gather_state(state)
    out["bf16"] = {part: flat((p, x.float()) for p, x in
                              tree_flatten_with_path(state[part])[0])
                   for part in ("params", "opt")}
    return out


def run_tie_cases():
    """``TopKMean.reduce`` of ``tie_tree`` on a mesh of the process
    group's ranks at each of ``TIE_FRACS``: {frac: {"consensus" | "res":
    {name: whole numpy}}}."""
    import torch
    from torch.distributed.tensor import Shard

    from repro_torch.comm import TopKMean
    from repro_torch.comm.shards import LeafShards, client_group, \
        row_placements
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.sharding.rules import from_local, place
    from repro_torch.utils.rng import TorchKey

    mesh = _device_mesh("cpu", *TIE_MESH)
    tree = tie_tree()
    out = {}
    for frac in TIE_FRACS:
        x, state, shards = {}, {"ref": {}, "res": {}}, []
        for name in sorted(tree):
            arr, dim = tree[name]
            pl = (Shard(0), Shard(dim))
            whole = torch.from_numpy(arr)
            x[name] = place(whole, mesh, pl).to_local()
            state["ref"][name] = place(torch.zeros(whole.shape[1:]), mesh,
                                       row_placements(pl, 3)).to_local()
            state["res"][name] = torch.zeros_like(x[name])
            shards.append(LeafShards(client_group(mesh, ("data",), 2),
                                     whole.shape, pl))
        cons, new = TopKMean(frac=frac).reduce(x, state, TorchKey(0),
                                               shards)
        out[frac] = {
            "consensus": {n: np.array(from_local(
                cons[n], mesh, row_placements(sh.placements, 3),
                sh.shape[1:]).full_tensor()) for n, sh in zip(sorted(tree),
                                                             shards)},
            "res": {n: np.array(from_local(
                new["res"][n], mesh, sh.placements, sh.shape).full_tensor())
                for n, sh in zip(sorted(tree), shards)}}
    return out


# serving on a (data=2, model=2) mesh: name → (arch, batch rows, prompt
# length); one row puts the cache's sequence over `data` (long_500k's
# layout), so a decode step's write lands on one rank
SERVE_CASES = {"qwen3-rows": ("qwen3-14b", 4, 12),
               "qwen3-seq": ("qwen3-14b", 1, 12),
               "mamba2-rows": ("mamba2-2.7b", 4, 12)}
DECODE_STEPS, MAX_LEN = 3, 32


def serve_tokens(vocab, rows, prompt):
    """A serving case's prompt and its decode steps' tokens."""
    rng = np.random.RandomState(3)
    return [rng.randint(0, vocab, (rows, n)).astype(np.int32)
            for n in (prompt,) + (1,) * DECODE_STEPS]


def run_serving_cases(inp_path, device_route=False):
    """Each serving case's last-position logits of the prefill and of
    each decode step, from the JAX package's float32 params in the
    inputs: through the device route, or placed by ``serve_shardings`` on
    a (2, 2) mesh of the process group's ranks."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.core.serving import serve_shardings
    from repro_torch.launch.mesh import _device_mesh, mesh_context
    from repro_torch.models import transformer as TF
    from repro_torch.sharding.rules import distribute, is_dtensor
    from repro_torch.utils.convert import transformer_params_from_jax

    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    out = {}
    for name, (arch, rows, prompt) in SERVE_CASES.items():
        cfg = get_arch(arch, smoke=True).replace(dtype="float32")
        params = transformer_params_from_jax(inp["serving"][arch], cfg,
                                             "cpu")
        cache = TF.init_cache(cfg, rows, MAX_LEN, device="cpu")
        toks = [torch.from_numpy(t).long()
                for t in serve_tokens(cfg.vocab_size, rows, prompt)]
        mesh = None
        if not device_route:
            mesh = _device_mesh("cpu", (2, 2), ("data", "model"))
            split = rows % 2 == 0
            psh, csh, tsh = serve_shardings(
                cfg, mesh, params, cache,
                data_axes=("data",) if split else (),
                seq_axes=() if split else ("data",))
            params, cache = distribute(params, psh), distribute(cache, csh)
            toks = [distribute(t, tsh) for t in toks]
        logits = []
        with torch.no_grad(), mesh_context(mesh), implicit_replication():
            last, cache = TF.prefill(params, cfg, toks[0], cache)
            logits.append(last[:, -1])
            for t in toks[1:]:
                last, cache = TF.decode_step(params, cfg, t, cache)
                logits.append(last[:, -1])
        out[name] = [np.array(x.full_tensor() if is_dtensor(x) else x)
                     for x in logits]
    return out


def _unflat(flat_dict, like):
    """{path: array} back into the tree of ``like`` (numpy leaves)."""
    import jax

    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(like)[0]]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like),
                                        [flat_dict[p] for p in paths])


def spawn_port(inp_path, out_path, tmp):
    import torch.multiprocessing as mp

    mp.spawn(port_worker, args=(4, "file://" + os.path.join(tmp, "store"),
                                inp_path, out_path), nprocs=4)
