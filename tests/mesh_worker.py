"""Meshed runs of the port on gloo CPU ranks, for tests/test_torch_parallel.py.

A module of its own, importing torch and the port only, so that the spawned
ranks import nothing slow (no JAX). ``spawn(tmp_path, world, job, **kw)``
starts ``world`` processes, each joining a gloo group through a ``FileStore``
in ``tmp_path`` at one torch thread, runs ``JOBS[job](**kw)`` on every rank
and returns every rank's result, in rank order.
"""
import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from eeg_multimodal_torch.data.datasets import MultiModalArrays
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.utils.trees import tree_items

TINY = dict(vocab_size=50, hidden_size=768, num_layers=2, num_heads=12,
            intermediate_size=64, max_position_embeddings=16)
S = 8


def config(mt="ti", dp="lapacian_dropout", cross="double_stream", **kw):
    return dataclasses.replace(TF.config_for(mt, dp, cross), bert_config=TB.BertConfig(**TINY),
                               **kw)


def arrays(n, seed, mt="ti"):
    """``n`` rows of the ``mt`` pairing, made with numpy (as
    test_torch_sweep.py's): token streams of S ids (row 1 padded after 5),
    image streams a (1, 512) embedding."""
    rng = np.random.RandomState(seed)

    def stream(kind):
        if kind == "t":
            mask = np.ones((n, S), np.int32)
            mask[1, 5:] = 0
            return rng.randint(0, 50, (n, S)).astype(np.int32), mask
        return rng.randn(n, 1, 512).astype(np.float32), np.ones((n, 1), np.int32)

    return MultiModalArrays(*stream(mt[0]), *stream(mt[1]),
                            rng.randint(0, 2, n).astype(np.int32), mt)


def numpy_tree(tree):
    return {p: t.detach().float().cpu().numpy().copy() for p, t in tree_items(tree)}


def lead_tree(tree):
    """The gathered whole tree as numpy on rank 0, None elsewhere: every
    rank holds the same one, and each costs ~150 MB of disk as a result."""
    return numpy_tree(tree) if dist.get_rank() == 0 else None


# ---------------------------------------------------------------------------
# Jobs: each runs on every rank, with the process group up
# ---------------------------------------------------------------------------

def fit_job(mesh_shape, fc_kw, tc_kw, epsilon, n_train, n_test, out_dir=None):
    from eeg_multimodal_torch.parallel.mesh import make_mesh
    from eeg_multimodal_torch.parallel.sharding import gather_params
    from eeg_multimodal_torch.parallel.train import shard_trainer
    from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer

    tr = Trainer(config(**fc_kw), TrainConfig(**tc_kw), device="cpu")
    mesh = shard_trainer(tr, make_mesh(*mesh_shape))
    paths = {}
    if out_dir:
        paths = dict(log_path=os.path.join(out_dir, "log") + "/",
                     model_path=os.path.join(out_dir, "best.pickle"))
    out = tr.fit(arrays(n_train, 1), arrays(n_test, 2), epsilon, echo=False, **paths)
    return {"history": out["history"], "f1_best": out["f1_best"],
            "params": lead_tree(gather_params(mesh, tr.params)),
            "shard": tuple(tr.params["bert"]["layers"][0]["attn"]["query"]["kernel"].shape)}


def step_job(mesh_shape, tree, batch, weight, epsilon, noise):
    """One faithful step from the whole numpy ``tree``, dropout off, the DP
    noise of both phases handed in; returns (loss, acc, the gathered tree)."""
    from eeg_multimodal_torch.parallel.mesh import make_mesh
    from eeg_multimodal_torch.parallel.sharding import gather_params
    from eeg_multimodal_torch.parallel.train import shard_trainer
    from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer
    from eeg_multimodal_torch.utils.trees import tree_map

    params = tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    tr = Trainer(config(), TrainConfig(batch_size=len(weight)), params=params, device="cpu")
    mesh = shard_trainer(tr, make_mesh(*mesh_shape))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    tr.dp_os, tr.model_os, loss, acc = tr.steps.train_step(
        tr.params, tr.dp_os, tr.model_os, b, torch.from_numpy(weight), epsilon,
        torch.Generator().manual_seed(0), dp_noise=tuple(torch.from_numpy(n) for n in noise),
        dropout=False)
    return {"loss": float(loss), "acc": float(acc),
            "params": lead_tree(gather_params(mesh, tr.params))}


def dpsgd_job(mesh_shape, n_train, n_test, target_epsilon=2.0):
    from eeg_multimodal_torch.dp.dpsgd import DPSGDConfig
    from eeg_multimodal_torch.parallel.mesh import make_mesh
    from eeg_multimodal_torch.parallel.sharding import gather_params
    from eeg_multimodal_torch.parallel.train import shard_dpsgd_trainer
    from eeg_multimodal_torch.train.dpsgd_trainer import DPSGDTrainer

    tr = DPSGDTrainer(config(dp="DPSGD"), DPSGDConfig(target_epsilon, epochs=1, batch_size=2,
                                                      learning_rate=1e-3), device="cpu")
    mesh = shard_dpsgd_trainer(tr, make_mesh(*mesh_shape))
    out = tr.fit(arrays(n_train, 1), arrays(n_test, 2), echo=False)
    return {"history": out["history"], "sigma": out["sigma"],
            "params": lead_tree(gather_params(mesh, tr.params))}


def sweep_job(mesh_shape, epsilons, tc_kw, n_train, n_test, log_root=None):
    from eeg_multimodal_torch.parallel.mesh import make_mesh
    from eeg_multimodal_torch.train.sweep import SweepMember, SweepRunner
    from eeg_multimodal_torch.train.trainer import TrainConfig

    members = [SweepMember(e) for e in epsilons]
    runner = SweepRunner(config(), TrainConfig(**tc_kw), members,
                         mesh=make_mesh(*mesh_shape), device="cpu")
    return runner.run(arrays(n_train, 1), arrays(n_test, 2), log_root=log_root, echo=False)


def dcp_job(mesh_shape, path):
    """The flagship tiny tree sharded, saved through ``save_pytree_dcp`` under
    the mesh; returns the whole tree."""
    from eeg_multimodal_torch.parallel.mesh import make_mesh
    from eeg_multimodal_torch.parallel.sharding import shard_params
    from eeg_multimodal_torch.train.checkpoint import save_pytree_dcp

    whole = TF.init(config(), 5, "cpu")
    mesh = make_mesh(*mesh_shape)
    save_pytree_dcp(path, shard_params(mesh, whole), mesh=mesh)
    return lead_tree(whole)


JOBS = {"fit": fit_job, "step": step_job, "dpsgd": dpsgd_job, "sweep": sweep_job,
        "dcp": dcp_job}


def _rank(rank, world, store_path, job, kw, out_path):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        result = JOBS[job](**kw)
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, world, job, **kw):
    """Run ``job`` on ``world`` gloo ranks; returns the list of every rank's
    result."""
    tmp = str(tmp_path)
    store, out = os.path.join(tmp, f"store_{job}"), os.path.join(tmp, f"result_{job}")
    if os.path.exists(store):
        os.remove(store)
    mp.start_processes(_rank, args=(world, store, job, kw, out), nprocs=world, join=True,
                       start_method="spawn")
    results = []
    for r in range(world):
        with open(f"{out}.{r}", "rb") as f:
            results.append(pickle.load(f))
        os.remove(f"{out}.{r}")  # a result may hold a whole tree: keep no copy on disk
    return results
