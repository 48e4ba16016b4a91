"""Run one cell of the benchmark once and print its result line.

    python3 -m dpmld_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names a configuration
(``dpmld_bench/configs/<name>.json``) and a traffic mix
(``dpmld_bench/traffic/<name>.json``, whose ``driver`` names
``dpmld_bench/drivers/<driver>.py``); its limits are
``dpmld_bench/limits/<cell>.json``, and each metric is read by
``dpmld_bench/metrics/<metric>.py``. The configuration's ``model_type``
names its text encoder's two parts, ``dpmld_bench/encoders/<model_type>.py``
(the program's) and ``dpmld_bench/reference/encoders/<model_type>.py``.
Set-up builds the rows and weights from the seed, the program's step
object, and drives its first steps; the window runs for ``--seconds``;
with ``--trace 1`` a profiled span follows it, and the encoder part's
``counters()``, where it has them, are read around it. Then the program's
state is freed and the plain reference follows the timed path's first steps
(or a sample of the eval epochs) from the seed, and each compared number is
printed beside its limit: as the last lines on standard error, and as the
result line's last key.

Exits non-zero without a result when no CUDA card is present, or when a
module of JAX or of the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "dpmld_bench")
# the program builds its kernels into the checkout's ``.cache/kernels``
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = {"jax", "jaxlib", "flax", "eeg_multimodal_tpu"}


def process_start() -> float:
    """Seconds since boot at which this process started, on the clock of
    ``time.clock_gettime(CLOCK_BOOTTIME)``; None where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def since_start(start) -> float:
    if start is None:
        return time.time() - T_IMPORT
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def reader(metric: str):
    """The module ``dpmld_bench/metrics/<metric>.py`` (a metric's name may
    hold dots), which reads the metric with ``read(ctx)``."""
    name = "dpmld_bench.metrics." + metric.replace(".", "_")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "metrics", metric + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def encoder_parts(model_type: str):
    """The program's and the reference's part of the text encoder
    ``model_type`` (``dpmld_bench/encoders/<model_type>.py`` and
    ``dpmld_bench/reference/encoders/<model_type>.py``), loaded once a
    process; the shared code takes them by the configuration's
    ``model_type`` from then on."""
    from .encoders import part
    from .reference.encoders import part as reference_part

    try:
        return part(model_type), reference_part(model_type)
    except LookupError:
        raise SystemExit(
            f"no text encoder part for model_type {model_type!r}: looked for "
            f"dpmld_bench/encoders/{model_type}.py and "
            f"dpmld_bench/reference/encoders/{model_type}.py") from None


def check_config(conf: dict, cfg: dict):
    """Raise ValueError unless the configuration ``conf`` of BENCHMARK.json
    and its file ``cfg`` keep to the contract. A cut configuration lists in
    ``reduced`` exactly the keys of the file's ``published`` (each key's
    published value) and states its ``deployment`` (how many chips share a
    layer, how it is divided, which share this chip holds); an uncut one
    has neither. Each cut key is one of the counts that the reference part's
    ``cuts`` lets change (a part without it lets none), cut to a whole
    number from its floor there to below the published value. The text
    encoder's two parts exist and the program runs the file's widths."""
    if set(conf) != {"name", "source", "file", "reduced", "why"}:
        raise ValueError(f"configuration {conf.get('name')!r}: keys {sorted(conf)}")
    if not conf["file"].startswith("dpmld_bench/configs/"):
        raise ValueError(f"configuration file {conf['file']!r} is not under dpmld_bench/configs/")
    reduced, published = conf["reduced"], cfg.get("published", {})
    if len(set(reduced)) != len(reduced) or set(reduced) != set(published):
        raise ValueError(f"reduced {sorted(reduced)} is not the keys of the file's published "
                         f"{sorted(published)}")
    deployment = cfg.get("deployment")
    if bool(reduced) != (deployment is not None):
        raise ValueError("a cut configuration states its deployment, and only a cut one")
    if deployment is not None and (not isinstance(deployment, str)
                                   or not 1 <= len(deployment) <= 200 or "\n" in deployment):
        raise ValueError("deployment is one line of 1 to 200 characters")
    model_type = cfg["model_type"]
    program_part, reference_part = encoder_parts(model_type)
    cuts = getattr(reference_part, "cuts", None)
    floors = cuts({**cfg, **published}) if cuts and reduced else {}
    for key in reduced:
        if key not in floors:
            raise ValueError(f"reduced key {key!r} is not a count that the {model_type!r} "
                             f"part lets a cut change ({sorted(floors)})")
        if key not in cfg:
            raise ValueError(f"reduced key {key!r} is not in the configuration file")
        value, full = cfg[key], published[key]
        if not all(type(v) is int for v in (value, full)) or not floors[key] <= value < full:
            raise ValueError(f"reduced key {key!r}: {value!r} is not a whole number from the "
                             f"floor {floors[key]!r} to below the published {full!r}")
    program_part.check_widths(cfg)


def cell_spec(workload: str):
    """(BENCHMARK.json, the cell, its configuration, traffic and limits),
    once the configuration keeps to the contract (``check_config``)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(ROOT, conf["file"])
    check_config(conf, cfg)
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    limits = load_json(HERE, "limits", workload + ".json")
    return bench, cell, cfg, traffic, limits


def metrics_of(bench, cell, trace: bool):
    """The metrics the cell reports in this kind of run, in file order."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def run_cell(workload, seed, seconds, trace, device, start=None, edit=None):
    """One run of ``workload``; returns (result, the check's lines).
    ``edit(cfg, traffic)`` may change the specs in place before the run (the
    tests' small sizes)."""
    import torch

    from . import drivers, encoders, program
    from . import trace as tracing
    from .reference.check import judge

    parts = [("imports", since_start(start))]
    bench, cell, cfg, traffic, limits = cell_spec(workload)
    if edit is not None:
        edit(cfg, traffic)
    prog = program.build(cfg, traffic, seed)
    parts.append(("rows and vocab", since_start(start)))
    driver = drivers.driver(traffic).Driver(prog, cfg, traffic, seed, device)
    parts.append(("weights and state", since_start(start)))
    driver.setup()
    setup_s = since_start(start)
    parts.append(("first steps", setup_s))
    print("setup_s parts: " + ", ".join(f"{name} {t - t0!r}" for (name, t), t0
                                        in zip(parts, [0.0] + [t for _, t in parts])),
          file=sys.stderr)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    window = driver.window(seconds)
    attempted, failed = driver.attempts()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    span, counters = None, {}
    if trace:
        sp = driver.span(traffic["span_steps"] if "span_steps" in traffic
                         else traffic["span_epochs"])
        span = tracing.profile(sp["run"], device, getattr(encoders.of(cfg), "counters", dict))
        counters = span.pop("counters")
        span["steps"] = sp["steps"]
        slow = (span["wall_s"] / sp["steps"]) / (window["seconds"] / window["steps"])
        print(f"trace: the span's wall time a step is {slow!r} times the window's",
              file=sys.stderr)
        print(f"trace: the program's spans hold {span['program']['coverage']!r} of the "
              f"span's device time", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {bad}")
    driver.release()
    numbers = driver.check()
    correct, lines = judge(numbers, limits)
    # what the readers read; ``span`` is None and ``counters`` {} in an
    # untraced run
    ctx = dict(cell=cell, config=cfg, traffic=traffic, seq_len=prog.seq_len,
               members=len(traffic["epsilons"]), kind=traffic["driver"], setup_s=setup_s,
               window=window, span=span, counters=counters)
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if span is not None:
        dev["busy_s"], dev["window_s"] = span["busy_s"], span["wall_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in span["device_ops"]],
                               "idle_gaps": [list(x) for x in span["idle_gaps"]]}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    return result, lines


def main(argv=None):
    start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, cell, _, _, _ = cell_spec(args.workload)
    import torch

    # one host thread: the window is the host's dispatch loop, and a pool of
    # intra-op threads made it slower and less steady on the H100's host
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"dpmld_bench: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                             start)
    from .card import card_line

    print(card_line(device), file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"dpmld_bench: modules of JAX or the JAX package loaded: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
