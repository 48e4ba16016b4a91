"""The data pipeline: raw task files to the embedding tree.

    python -m eeg_multimodal_torch.scripts.data <task_1.txt> [task_2.txt ...] \\
        [--device cpu]

The port of the JAX package's ``scripts/data.sh`` (the reference's
``python/scripts/data.sh``), through the port's command line:

  1. ``cli process <tasks> --out data/processed``: raw task txt -> the
     processed CSVs (on the host);
  2. ``cli embed --data_root .``: the CSVs -> the embedding tree (images and
     tokens, every encoder the trainers read), on the card unless
     ``--device cpu``.

The shell script ``cd``s to its checkout first; this module works in the
current directory: run it from the directory that should hold ``data/``.
"""
import argparse

from .. import cli
from ..utils.device import resolve_device


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("tasks", nargs="+", help="raw task txt files")
    p.add_argument("--device", default=None,
                   help="torch device of the embed (default: the CUDA card; 'cpu' for the CPU)")
    return p


def main(argv=None, device=None):
    """Process, then embed; ``device`` is the default of ``--device``.
    Returns 0, as the shell script's status."""
    args = parser().parse_args(argv)
    dev = args.device if args.device is not None else device
    resolve_device(dev)  # raises before any file is written when there is no card
    cli.main(["process", *args.tasks, "--out", "data/processed"])
    cli.main(["embed", "--data_root", "."] + ([] if dev is None else ["--device", str(dev)]))
    return 0


if __name__ == "__main__":
    main()
