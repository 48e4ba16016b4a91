"""train_step_p95_ms: the 95th percentile, over every train step of the
window, of the interval between the CUDA events recorded after consecutive
steps (the first from an event recorded before the first step); an
interval that holds an eval epoch counts."""
import statistics


def read(ctx):
    if ctx["kind"] != "train" or len(ctx["window"]["step_ms"]) < 20:
        return None
    return statistics.quantiles(ctx["window"]["step_ms"], n=20)[18]
