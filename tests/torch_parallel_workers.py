"""Rank bodies for tests/test_torch_parallel.py and
tests/test_torch_train_parallel.py: each runs in a process of
its own (spawned), joins a gloo group on the CPU through the port's
`init_distributed`, runs one sharded function of the port (`parallel/`,
`desc/train.make_sharded_train_step`)
and saves what it returned under `out_dir`.  Imports torch and the port
only, so that a spawned rank starts quickly."""
import os

import numpy as np


def run_ranks(target, world: int, args: tuple, timeout_s: float, during=None):
    """Start `world` spawned processes of target(rank, world, port, *args),
    call during() (if given) while they run, and join them; a rank that is
    still running after `timeout_s` is killed and the call fails, as does
    a rank that exits non-zero.  Returns what during() returned."""
    import multiprocessing as mp
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, port, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        result = during() if during is not None else None
        for p in procs:
            p.join(timeout_s)
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {timeout_s} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
        return result
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)


def _join(rank, world, port):
    import torch
    torch.set_num_threads(1)
    from mods_tpu_torch.parallel.distributed import init_distributed
    assert init_distributed(f"localhost:{port}", world, rank, device="cpu") == (rank, world)


def knn_rank(rank, world, port, n_data, n_model, cases, out_dir):
    """sharded_knn on each (queries, db, k) of `cases`, on the
    n_data x n_model mesh and on a world x 1 one (one block: the local
    top-k, the gather and the merge over it); a database whose rows do not
    split into the "model" blocks must raise."""
    import torch.distributed as dist
    _join(rank, world, port)
    from mods_tpu_torch.parallel.mesh import make_mesh, sharded_knn
    try:
        mesh = make_mesh(n_data, n_model, device="cpu")
        out = {}
        for i, (q, db, k) in enumerate(cases):
            d, idx = sharded_knn(mesh, q, db, k)
            out[f"d{i}"], out[f"idx{i}"] = d.numpy(), idx.numpy()
        one_block = make_mesh(world, 1, device="cpu")
        for i, (q, db, k) in enumerate(cases):
            d, idx = sharded_knn(one_block, q, db, k)
            out[f"d1_{i}"], out[f"idx1_{i}"] = d.numpy(), idx.numpy()
        q, db, k = cases[0]
        try:
            sharded_knn(mesh, q, db[:n_model * 7 + 1], 4)
        except ValueError:
            out["uneven_raised"] = np.ones(1)
        np.savez(os.path.join(out_dir, f"knn{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def batch_rank(rank, world, port, imgs1, imgs2, cfg, draws, max_kp, out_dir):
    import torch.distributed as dist
    _join(rank, world, port)
    from mods_tpu_torch.parallel.mesh import batch_match_sharded, make_mesh
    try:
        mesh = make_mesh(world, 1, device="cpu")
        H, inl, tent = batch_match_sharded(mesh, cfg, imgs1, imgs2,
                                           draws=draws, max_kp=max_kp)
        out = dict(H=H.numpy(), inl=inl.numpy(), tent=tent.numpy())
        try:
            batch_match_sharded(mesh, cfg, imgs1[:world + 1], imgs2[:world + 1],
                                max_kp=max_kp)
        except ValueError:
            out["uneven_raised"] = np.ones(1)
        np.savez(os.path.join(out_dir, f"batch{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def train_rank(rank, world, port, params, anchors, positives, ids, out_dir):
    """One step of desc.train.make_sharded_train_step on a world x 1 mesh
    (Adam, the cosine schedule of 1e-3 over 10 steps) from the JAX params
    dict `params`, on the whole batch that every rank passes; saves the
    loss, the weights and their gradients after the step.  A batch that
    does not split over "data" must raise."""
    import torch
    import torch.distributed as dist
    _join(rank, world, port)
    from mods_tpu_torch.desc import train as T
    from mods_tpu_torch.parallel.mesh import make_mesh
    try:
        net = T.from_jax_params(params, "cpu")
        opt, sched = T.cosine_adam(net, 1e-3, 10)
        step = T.make_sharded_train_step(make_mesh(world, 1, device="cpu"), opt, sched)
        t = lambda x: torch.from_numpy(x)
        loss = step(net, t(anchors), t(positives), t(ids))
        out = {f"w_{k}": v for k, v in net.params().items()}
        out.update({f"g_{k}": w.grad.numpy() for k, w in net.named_parameters()})
        out["loss"] = np.asarray(float(loss))
        try:
            step(net, t(anchors[:world + 1]), t(positives[:world + 1]), t(ids[:world + 1]))
        except ValueError:
            out["uneven_raised"] = np.ones(1)
        np.savez(os.path.join(out_dir, f"train{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
