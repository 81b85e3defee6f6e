"""mfu.train: the model's FLOPs in the traced window (``counts.py``: the
corrected copy of bench.py's count; training 3x the forward with the train
heads) over the window, as a share of the tier's published peak (67 TFLOP/s
float32 with TF32 off, 989 bfloat16), in %."""

from portbench.counts import PEAK_FLOPS


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    t = r.trace
    return 100.0 * t.units * r.model_flops_per_unit() / t.window_s / PEAK_FLOPS[r.dtype]
