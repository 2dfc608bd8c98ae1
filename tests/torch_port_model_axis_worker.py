"""One process of the port's sharded step on a mesh with a model axis.

    python tests/torch_port_model_axis_worker.py COORD WORLD RANK OPTIONS

COORD is ``host:port`` of the process group (``-`` for one process with no
group), WORLD and RANK its size and this process's rank, OPTIONS a JSON
object:

  * ``mesh``: ``["2d", n_data, n_model]``, ``["hier_model", hosts, chips,
    n_model]`` or ``["1d", n_shards]``;
  * ``graph``: ``"sbm"`` (n 512, 32 features, 5 classes) or a registered
    dataset (``"synth-arxiv"``: rabbit order, then the in-band degree
    sort); ``hidden`` (16 for sbm, 32 otherwise);
  * ``device``: ``"cpu"`` (gloo) or ``"cuda"`` (NCCL, ``cuda:RANK``);
  * ``optimizer`` ``"adam"`` (adam_l2, lr 0.01) or ``"sgd"`` (lr ``lr``),
    ``steps``, ``params`` (numpy parameters to start from), and any option
    of ``make_sharded_gcn_train_step``.

It prints ``LOSSES`` (every step's global loss), ``MS`` (the host clock's
median ms of the steps after the first, each step's loss read back),
``PARAMS`` (the full parameters, ``gather_model_params``) and ``EVAL``
(``{band: log-probs}`` of the bands whose first model slot it owns; sbm
only) or ``ACC`` (test accuracy). It imports neither jax nor gcn_tpu, so it
runs on a machine with cards as on the CPU.
"""

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gcn_tpu_torch.graph.normalize import gcn_normalize  # noqa: E402
from gcn_tpu_torch.models.gcn_core import init_gcn_params  # noqa: E402
from gcn_tpu_torch.parallel import (band_degree_sort_order,  # noqa: E402
                                    create_mesh, create_mesh_2d,
                                    create_mesh_hier_model,
                                    gather_model_params,
                                    initialize_multihost,
                                    make_sharded_gcn_train_step,
                                    rows_per_shard_for,
                                    shard_graph_by_rows,
                                    shard_model_params)
from gcn_tpu_torch.train.optim import adam_l2  # noqa: E402
from gcn_tpu_torch.utils.checkpoint import named_leaves  # noqa: E402


def problem(graph, n_bands, seed=0):
    """(graph, features, labels, train mask, test mask) in band order."""
    if graph == "sbm":
        from gcn_tpu_torch.data.synthetic import class_features, sbm

        adj, labels = sbm(n=512, n_classes=5, avg_degree=8.0, seed=3)
        x = class_features(labels, feat_dim=32, seed=3)
        n = len(labels)
        return (gcn_normalize(adj), x, labels, np.ones(n, np.float32),
                np.ones(n, np.float32))
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.reorder import reorder_graph

    data = get_dataset(graph, seed=seed)
    g, perm = reorder_graph(gcn_normalize(data.adj), "rabbit")
    n = data.num_nodes
    bperm = band_degree_sort_order(g, rows_per_shard_for(n, n_bands))
    perm = perm[bperm]
    masks = []
    for idx in (data.idx_train, data.idx_test):
        mask = np.zeros(n, np.float32)
        mask[np.asarray(idx)] = 1.0
        masks.append(mask[perm])
    return (g.permute(bperm), data.features[perm].astype(np.float32),
            data.labels[perm], *masks)


def run(kw, coord="-", world=1, rank=0):
    """Train as OPTIONS ``kw`` say; returns a dict of ``losses``, ``ms``,
    ``params`` (numpy, full), ``eval`` ({band: log-probs}, sbm only) and
    ``acc`` (other graphs)."""
    kw = dict(kw)
    mesh_spec = kw.pop("mesh")
    graph = kw.pop("graph", "sbm")
    hidden = kw.pop("hidden", 16 if graph == "sbm" else 32)
    device = kw.pop("device", "cpu")
    optimizer = kw.pop("optimizer", "adam")
    lr = kw.pop("lr", 0.01)
    steps = kw.pop("steps", 4)
    p0 = kw.pop("params", None)
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    if coord != "-":
        initialize_multihost(coord, world, rank, device=device)
    kind, *shape = mesh_spec
    mesh = {"2d": create_mesh_2d, "hier_model": create_mesh_hier_model,
            "1d": create_mesh}[kind](*shape, device=device)
    g, x, labels, mask_tr, mask_te = problem(graph, mesh.n_shards)
    sg = shard_graph_by_rows(g, mesh.n_shards)
    if mesh.model_axis is not None:
        kw.setdefault("model_axis", mesh.model_axis)
    step, eval_fn, shard_fn = make_sharded_gcn_train_step(mesh, sg, **kw)
    adj, xs, ys, ms = shard_fn(x, labels, mask_tr)
    if p0 is None:
        full = init_gcn_params(torch.Generator().manual_seed(0), x.shape[1],
                               hidden, int(labels.max()) + 1,
                               device=mesh.device)
    else:
        full = {layer: {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                                        device=mesh.device)
                        for k, v in leaves.items()}
                for layer, leaves in p0.items()}
    params = shard_model_params(full, mesh)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    opt = (adam_l2(leaves, lr, 5e-4) if optimizer == "adam"
           else torch.optim.SGD(leaves, lr=lr))
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(params, opt, (8, i), adj, xs, ys, ms)))
        times.append(time.perf_counter() - t0)
    lp = eval_fn(params, adj, xs)
    out = dict(losses=losses,
               ms=statistics.median(times[1:] or times) * 1e3,
               params={layer: {k: v.cpu().numpy() for k, v in lv.items()}
                       for layer, lv in gather_model_params(
                           params, mesh).items()})
    rps = sg.rows_per_shard
    if graph == "sbm":
        out["eval"] = {b: lp[i * rps:(i + 1) * rps].cpu().numpy()
                       for i, b in enumerate(mesh.shards)
                       if mesh.model_slots[0] == 0}
    else:
        lo = mesh.shards[0] * rps
        own = slice(lo, lo + lp.shape[0])
        te = torch.as_tensor(np.pad(mask_te, (0, sg.n_rows_padded - len(
            mask_te)))[own], device=lp.device)
        y = torch.as_tensor(np.pad(labels, (0, sg.n_rows_padded - len(
            labels)))[own], device=lp.device)
        hit = torch.stack([((lp.argmax(1) == y) * te).sum(),
                           te.sum()]).double()
        if mesh.data_parallel:
            torch.distributed.all_reduce(hit, group=mesh.data_group)
        out["acc"] = float(hit[0] / hit[1])
    if coord != "-":
        torch.distributed.destroy_process_group()
    return out


def main():
    coord, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    out = run(json.loads(sys.argv[4]), coord, world, rank)
    print("LOSSES", json.dumps(out["losses"]), flush=True)
    print("MS", out["ms"], flush=True)
    if rank == 0:
        print("PARAMS", json.dumps({layer: {k: v.tolist()
                                            for k, v in lv.items()}
                                    for layer, lv in out["params"].items()}),
              flush=True)
    if "eval" in out:
        print("EVAL", json.dumps({b: lp.tolist()
                                  for b, lp in out["eval"].items()}),
              flush=True)
    else:
        print("ACC", out["acc"], flush=True)


if __name__ == "__main__":
    main()
