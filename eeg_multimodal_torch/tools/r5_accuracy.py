"""The round-5 accuracy pipeline, phase by phase, resumable.

    python -m eeg_multimodal_torch.tools.r5_accuracy [phase ...]   # default: all, in order

The port of the JAX package's ``tools/r5_accuracy.sh``: the same seven
phases in the same order, each through the port's command line and tools
with the shell script's arguments and log files, a marker file under
``R5`` (``/tmp/r5``) once a phase is done, so that a rerun skips it:

  tree     the user tree: the reference's processed CSVs
           (``python/data/processed`` under ``$REFERENCE_DIR``, else
           ``~/reference``: ``data/datasets.py::reference_dir``) copied,
           then ``cli embed``;
  distill  ``cli distill`` twice, the full fit and the half-fit leakage
           control, against the reference's real test-split CLIP array;
  base     ``cli pretrain``: the MLM + row-reg encoder, 8000 steps, and the
           flagship, 120 epochs (log ``base.log``);
  half     the half-fit tree's flagship from base's encoder (``half.log``);
  sr       ``tools.validate_bf16_moments`` at 3 seeds x {bf16, f32}, the
           bf16 arm with ``EEG_VALIDATE_PRECAST=1`` (``sr.log``);
  modal3   ``tools.r5_modal_seeds`` from base's run (``modal3.log``);
  pretext  the NDP pretext grid (aug_ww_clip, aug20, ww, clip), then the
           NDP baseline from base's encoder, each variant its own marker.

A phase that fails prints ``phase <name> FAILED`` and the run exits 1.
Each command runs in this process through :func:`run_command` (its
``main``), its output into its log file where the shell script redirects
it. Runs on the card unless ``device="cpu"`` (handed to the command
line's ``--device`` and each tool's ``device``), and raises before any
phase when there is no card.
"""
import contextlib
import glob
import importlib
import os
import shutil
import sys
import time
import traceback

from ..data.datasets import reference_dir
from ..utils.device import resolve_device

R5 = "/tmp/r5"
PHASES = ("tree", "distill", "base", "half", "sr", "modal3", "pretext")
CLI = "eeg_multimodal_torch.cli"
VALIDATE = "eeg_multimodal_torch.tools.validate_bf16_moments"
MODAL_SEEDS = "eeg_multimodal_torch.tools.r5_modal_seeds"
PRETEXT_VARIANTS = {  # in the shell script's order: the combined variant first
    "aug_ww_clip": ["--aug_factor", "20", "--whole_word", "--clip_weight", "1.0",
                    "--mlm_steps", "16000"],
    "aug20": ["--aug_factor", "20"],
    "ww": ["--whole_word"],
    "clip": ["--clip_weight", "1.0"],
}


def log(msg):
    print(f"[r5 {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def run_command(module, argv, log_path=None, append=False, env=None, device=None):
    """Run ``module``'s ``main`` on ``argv`` in this process, its output
    (stdout and stderr) into ``log_path`` (appended with ``append``), the
    environment ``env`` set around it; returns 0, or 1 when it raised or
    returned a non-zero status. The command line takes ``--device``, the
    tools ``device``."""
    mod = importlib.import_module(module)
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    out = open(log_path, "a" if append else "w") if log_path else None
    try:
        with contextlib.ExitStack() as stack:
            if out is not None:
                stack.enter_context(contextlib.redirect_stdout(out))
                stack.enter_context(contextlib.redirect_stderr(out))
            try:
                if module == CLI:
                    status = mod.main(argv + ([] if device is None else ["--device", str(device)]))
                else:
                    status = mod.main(argv, device=device)
            except SystemExit as e:
                status = e.code
            except Exception:
                traceback.print_exc()
                return 1
        return 1 if isinstance(status, int) and status != 0 else 0
    finally:
        if out is not None:
            out.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tail(path, n):
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines[-n:]:
        print(line)


class Pipeline:
    """The phases over the reference at ``ref``, artifacts under ``root``."""

    def __init__(self, ref, root, device=None):
        self.ref, self.root, self.device = ref, root, device

    def path(self, *parts):
        return os.path.join(self.root, *parts)

    def done_marker(self, name):
        open(self.path(f".done_{name}"), "w").close()

    def is_done(self, name):
        return os.path.exists(self.path(f".done_{name}"))

    def run(self, module, argv, log_name=None, append=False, env=None):
        log_path = self.path(log_name) if log_name else None
        return run_command(module, argv, log_path, append, env, self.device) == 0

    def tree(self):
        log("P0: user tree (processed CSVs + embedding build)")
        processed = self.path("user_tree", "data", "processed")
        os.makedirs(processed, exist_ok=True)
        csvs = sorted(glob.glob(os.path.join(self.ref, "python", "data", "processed", "*.csv")))
        if not csvs:  # cp with no match fails, and so does the shell phase
            print(f"no processed CSVs under {self.ref}/python/data/processed", file=sys.stderr)
            return False
        for src in csvs:
            shutil.copy(src, processed)
        return self.run(CLI, ["embed", "--data_root", self.path("user_tree")])

    def distill(self):
        log("P1: distilled act trees (full fit + half-fit leakage control)")
        real = os.path.join(self.ref, "feature", "action", "test_clip_v2.pickle")
        return (self.run(CLI, ["distill", "--data_root", self.path("user_tree"),
                               "--out", self.path("tree_dist"), "--real_test_pickle", real])
                and self.run(CLI, ["distill", "--data_root", self.path("user_tree"),
                                   "--out", self.path("tree_dist_half"), "--fit_fraction",
                                   "0.5", "--real_test_pickle", real]))

    def base(self):
        log("P2: baseline MLM+row-reg encoder + flagship 120ep (pipeline path)")
        if not self.run(CLI, ["pretrain", "--data_root", self.path("tree_dist"),
                              "--out", self.path("base"), "--row_reg_weight", "1.0",
                              "--mlm_steps", "8000", "--epochs", "120"], "base.log"):
            return False
        tail(self.path("base.log"), 2)
        return True

    def half(self):
        log("P2b: half-fit-distiller control flagship")
        # base's MLM + row-reg encoder: the pretext reads only the text side,
        # and the two distilled trees differ only in their act images, so
        # the half arm isolates the distiller's fit
        if not self.run(CLI, ["pretrain", "--data_root", self.path("tree_dist_half"),
                              "--out", self.path("half"), "--row_reg_weight", "1.0",
                              "--bert_ckpt", self.path("base", "bert_mlm.pickle"),
                              "--epochs", "120"], "half.log"):
            return False
        tail(self.path("half.log"), 2)
        return True

    def pretext(self):
        """The NDP pretext grid, each variant a pretrain and an NDP
        fine-tune, then the NDP baseline from base's encoder; its markers
        are its own, and the phase writes none."""
        for v, extra in PRETEXT_VARIANTS.items():
            if self.is_done(f"ndp_{v}"):
                continue
            log(f"P3: NDP pretext variant {v} ({' '.join(extra)})")
            if not self.run(CLI, ["pretrain", "--data_root", self.path("tree_dist"),
                                  "--out", self.path(f"ndp_{v}"), "--row_reg_weight", "1.0",
                                  "--mlm_steps", "8000", "--dp_mode", "NDP", "--epochs", "120",
                                  *extra], f"ndp_{v}.log"):
                return False
            tail(self.path(f"ndp_{v}.log"), 2)
            self.done_marker(f"ndp_{v}")
        if not self.is_done("ndp_base"):
            log("P3: NDP baseline finetune from base encoder")
            if not self.run(CLI, ["pretrain", "--data_root", self.path("tree_dist"),
                                  "--out", self.path("ndp_base"), "--bert_ckpt",
                                  self.path("base", "bert_mlm.pickle"), "--row_reg_weight",
                                  "1.0", "--dp_mode", "NDP", "--epochs", "120"],
                            "ndp_base.log"):
                return False
            tail(self.path("ndp_base.log"), 2)
            self.done_marker("ndp_base")
        return True

    def sr(self):
        log("P4: SR/bf16-moment validation, 3 seeds x {bf16, f32}")
        # bf16 arm: the whole bench configuration (bf16 moments with
        # stochastic rounding and the carried bf16 param copy); f32 arm: the
        # seed-band control (f32 moments, no precast)
        for seed in ("980616", "1", "2"):
            for m in ("bf16", "f32"):
                env = {"EEG_VALIDATE_PRECAST": "1" if m == "bf16" else ""}
                if not self.run(VALIDATE, ["--run_dir", self.path("base"), "--data_root",
                                           self.path("tree_dist"), "--out",
                                           self.path("sr_validation"), "--seed", seed,
                                           "--moments", m, "--epochs", "50"],
                                "sr.log", append=True, env=env):
                    return False
        return True

    def modal3(self):
        log("P5: CompareModal ti driver path, 3 seeds")
        if not self.run(MODAL_SEEDS, ["--run_dir", self.path("base"), "--data_root",
                                      self.path("tree_dist"), "--out", self.path("modal3")],
                        "modal3.log"):
            return False
        tail(self.path("modal3.log"), 4)
        return True

    def phase(self, name):
        """Run phase ``name`` unless its marker says it is done (``pretext``
        keeps a marker per variant); returns whether it succeeded."""
        if name not in PHASES:
            print(f"no phase {name!r}; the phases are {' '.join(PHASES)}", file=sys.stderr)
            return False
        if name != "pretext" and self.is_done(name):
            return True
        if not getattr(self, name)():
            return False
        if name != "pretext":
            self.done_marker(name)
            log(f"phase {name} done")
        return True


def main(argv=None, device=None):
    """Run the phases named in ``argv`` (default: all seven, in order);
    returns the exit status: 0, or 1 at the first phase that failed."""
    phases = (sys.argv[1:] if argv is None else list(argv)) or list(PHASES)
    resolve_device(device)  # raises before any phase when there is no card
    os.makedirs(R5, exist_ok=True)
    pipeline = Pipeline(reference_dir(), R5, device)
    for ph in phases:
        if not pipeline.phase(ph):
            log(f"phase {ph} FAILED")
            return 1
    log("all requested phases complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
