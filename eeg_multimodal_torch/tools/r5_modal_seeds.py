"""CompareModal's ti cell on the reference protocol at several seeds.

    python -m eeg_multimodal_torch.tools.r5_modal_seeds --run_dir /tmp/r5/base \\
        --data_root /tmp/r5/tree_dist --out /tmp/r5/modal3

The port of the JAX package's ``tools/r5_modal_seeds.py``: the exact
``CompareModal`` ti driver configuration (``experiments/drivers.py``
``configs()[0]`` through ``TrainAndTest.train``) at each seed of
``--seeds``, from the MLM encoder of a ``pretrain_finetune`` run directory
(``bert_mlm.pickle`` in ``save_pytree``'s format and ``compact_vocab.npz``),
its compact word table scattered back to full rows (the driver path reads
the stock tree's full-vocab ids). Writes ``<out>/summary.json`` with the
mean and spread of the best accuracy and F1 beside the reference's 0.977.
Runs on the card unless ``device="cpu"``; there every BERT self-attention
goes through the attention kernels. The JAX script's choice of PRNG
(``rbg``) has no counterpart: the port draws from its own generators.
"""
import argparse
import json
import os

import numpy as np

from ..examples.pretrained import expanded_encoder, load_run
from ..experiments.drivers import CompareModal
from ..train.api import TrainAndTest
from ..utils.device import resolve_device


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", default="/tmp/r5/base")
    p.add_argument("--data_root", default="/tmp/r5/tree_dist")
    p.add_argument("--out", default="/tmp/r5/modal3")
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--seeds", default="980616,1,2")
    return p


def main(argv=None, device=None):
    """Train every seed; returns the summary written."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    bert = expanded_encoder(*load_run(args.run_dir, dev))

    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        job = TrainAndTest(
            epochs=args.epochs, data_root=args.data_root,
            artifacts_root=os.path.join(args.out, f"seed{seed}"),
            bert_params=bert, seed=seed, device=dev,
        )
        cfg = CompareModal(python_job=job).configs()[0]  # the ti cell
        assert cfg["multimodal_type"] == "ti", cfg
        res = job.train(**cfg)
        best = res["best"] or max(res["history"], key=lambda h: h["f1"])
        rows.append({"seed": seed, "best_acc": best["test_acc"],
                     "best_f1": best["f1"], "epoch": best["epoch"]})
        print(f"[modal3] seed {seed}: acc {best['test_acc']:.4f} "
              f"f1 {best['f1']:.4f} @ep{best['epoch']}", flush=True)

    accs = np.array([r["best_acc"] for r in rows])
    f1s = np.array([r["best_f1"] for r in rows])
    summary = {
        "rows": rows,
        "acc_mean": float(accs.mean()), "acc_std": float(accs.std()),
        "f1_mean": float(f1s.mean()), "f1_std": float(f1s.std()),
        "reference": 0.977,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1), flush=True)
    return summary


if __name__ == "__main__":
    main()
