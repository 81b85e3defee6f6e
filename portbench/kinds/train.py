"""Training cells: ``build_train_step``'s step on in-memory batches, and the
comparison of its first six steps with the plain reference.

Set-up builds the model with its train heads, makes the weights and a pool
of ``pool_batches`` batches from the seed, builds the step (the one object
the window then drives) on a generator seeded from the run's seed, and
takes its first six steps through the window's own call, each on another
batch of the pool, the step drawing its own augmentation, pooling samples
and dropout from that generator as in the window.  They build the kernels,
warm every shape and pass Ranger's first lookahead (every six steps).
Their losses, the norm of each leaf's first gradient as the optimizer got
it (Ranger's first moment after one step, / (1 - beta1)), and the norm of
each leaf's change over the six steps are kept.  A traced run then
profiles ``trace_units`` steps twice (``trace.py``) and times Ranger's
step alone over ``trace_units`` more, the device drained before and after
it.  The window then steps on the next batches of the pool for
``--seconds``, ending in a synchronize.

After the window and once the program is freed, the benchmark draws the
six steps' randomness again from a generator seeded alike, in the order
the step draws it (``inputs.train_draws``, the layout of ``models/
hspose.py::draw_train``), and the reference takes the same six steps from
the same weights, batches and draws.  The numbers read (the cell's limits
file names those compared) are: ``loss_gap``, the largest relative gap of
the six losses; ``grad_gap``, the worst leaf's gap of first-gradient norms
against the larger of that leaf's reference norm and the median leaf's;
``update_gap``, the same for the change over six steps, over the leaves
whose reference gradient is at least a thousandth of the median leaf's
(the others move by round-off alone under Adam); and the median leaf's
gaps (``_median``).  A bfloat16
configuration's numbers are also read in units of the reference's own in
bfloat16 (``_rel``).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from portbench import inputs
from portbench.common import (Cell, Outcome, checks_of, device_of, free_device_memory, median,
                              sub_seed, synchronize)
from portbench.readings import Readings
from portbench.reference import model as ref
from portbench.reference.precision import Precision
from portbench.trace import traced
from portbench.weights import make_weights, param_spec, trainable

CHIPS = 1  # one process drives one card

WEIGHTS, BATCHES, STEP = 0, 1, 3  # purposes of the run's sub-seeds
CHECK_STEPS = ref.OPTIM["lookahead_k"]  # through Ranger's first lookahead
SMALL_GRAD = 1e-3  # leaves below this share of the median leaf's gradient move by round-off


def setup(cell: Cell, seed: int, device):
    from hspose_tpu_torch.engine.train_step import build_train_step
    from hspose_tpu_torch.models.hspose import build_model
    from portbench.common import port_config

    t = cell.traffic
    if t["pool_batches"] < CHECK_STEPS:
        raise ValueError(f"pool_batches < {CHECK_STEPS}: the checked steps take distinct batches")
    cfg = port_config(cell, train={"batch_size": t["batch"]})
    model = build_model(cfg.model, device=device, train_heads=True)
    weights = make_weights(cell.model, True, sub_seed(seed, WEIGHTS), device)
    model.load_state_dict(weights)
    step = build_train_step(cfg, model, step_generator(seed, device))
    batches = inputs.train_batches(t["batch"], cell.points, t["pool_batches"],
                                   sub_seed(seed, BATCHES), device)
    return model, step, weights, batches


def step_generator(seed: int, device) -> torch.Generator:
    """The generator that the step draws its randomness from."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, STEP))


def replayed_draws(cell: Cell, seed: int, device) -> List[inputs.Draws]:
    """The first CHECK_STEPS steps' randomness, drawn again as the step
    draws it from a generator seeded alike."""
    g = step_generator(seed, device)
    return [inputs.train_draws(cell.traffic["batch"], cell.points, g)
            for _ in range(CHECK_STEPS)]


def first_steps(model, step, weights, one_step, names) -> Dict[str, object]:
    """The first CHECK_STEPS steps through the window's call, and what the
    comparison reads of them."""
    params = dict(model.named_parameters())
    b1 = step.optimizer.cfg.betas[0]
    out: Dict[str, object] = {"losses": []}
    for i in range(CHECK_STEPS):
        out["losses"].append(one_step()["total_loss"])
        if i == 0:
            out["grad_norms"] = {n: float(step.optimizer.state[params[n]]["exp_avg"].norm()) / (1 - b1)
                                 for n in names}
    with torch.no_grad():
        out["change_norms"] = {n: float((params[n] - weights[n]).norm()) for n in names}
    return out


def optimizer_alone(opt, one_step, steps: int, device) -> float:
    """Seconds per step of Ranger's ``step()`` over ``steps`` steps, the
    device drained before and after it: its host work and its kernels, with
    nothing of the backward in the way."""
    real, spent = opt.step, [0.0]

    def timed(*args, **kw):
        synchronize(device)
        t1 = time.perf_counter()
        result = real(*args, **kw)
        synchronize(device)
        spent[0] += time.perf_counter() - t1
        return result

    opt.step = timed
    try:
        for _ in range(steps):
            one_step()
    finally:
        del opt.step
    return spent[0] / steps


def reference_steps(cell: Cell, weights, batches, draws, prec: Precision) -> Dict[str, object]:
    """The reference's steps, one a batch, from the benchmark's weights."""
    names = trainable(param_spec(cell.model, True))
    P = {k: (v.clone().requires_grad_(True) if k in names else v.clone())
         for k, v in weights.items()}
    opt = ref.Ranger([P[n] for n in names])
    arch = ref.Arch.of(cell.model)
    out: Dict[str, object] = {"losses": []}
    for i in range(CHECK_STEPS):
        for n in names:
            P[n].grad = None
        total, _ = ref.train_loss(P, arch, batches[i], draws[i], prec)
        out["losses"].append(float(total.detach()))
        if math.isfinite(out["losses"][-1]):  # the step's NaN guard skips the update
            total.backward()
            opt.step()
        if i == 0:
            grads = opt.last_grads or [torch.zeros_like(P[n]) for n in names]
            out["grad_norms"] = {n: float(g.norm()) for n, g in zip(names, grads)}
        del total
    with torch.no_grad():
        out["change_norms"] = {n: float((P[n] - weights[n]).norm()) for n in names}
    return out


def leaf_gaps(program: Dict[str, object], reference: Dict[str, object], key: str,
              leaves=None) -> Dict[str, float]:
    """Per leaf, the gap of the norms ``key`` against the larger of the
    leaf's reference norm and the median leaf's."""
    r, p = reference[key], program[key]
    leaves = list(r) if leaves is None else leaves
    med = median(r[n] for n in leaves)
    return {n: abs(p[n] - r[n]) / max(r[n], med) for n in leaves}


def moved_leaves(reference: Dict[str, object]) -> List[str]:
    """Leaves whose first reference gradient is at least SMALL_GRAD of the
    median leaf's; the others move under Adam by round-off alone."""
    g = reference["grad_norms"]
    med = median(g.values())
    return [n for n in g if g[n] >= SMALL_GRAD * med]


def gaps(program: Dict[str, object], reference: Dict[str, object],
         tier: Dict[str, object] | None = None) -> Dict[str, float]:
    """The numbers compared; with ``tier`` (the reference in the
    configuration's own precision) also as multiples of the tier's (``_rel``)."""
    def rel(a, b):
        if not (math.isfinite(a) and math.isfinite(b)):
            return 0.0 if (math.isfinite(a) == math.isfinite(b)) else math.inf
        return abs(a - b) / abs(b)

    def numbers(other):
        grad = leaf_gaps(other, reference, "grad_norms")
        update = leaf_gaps(other, reference, "change_norms", moved_leaves(reference))
        return {"loss_gap": max(rel(a, b) for a, b in zip(other["losses"], reference["losses"])),
                "grad_gap": max(grad.values()), "grad_gap_median": median(grad.values()),
                "update_gap": max(update.values()), "update_gap_median": median(update.values())}

    out = numbers(program)
    if tier is not None:
        yard = numbers(tier)
        out.update({k + "_rel": v / yard[k] for k, v in list(out.items()) if yard[k] > 0})
    return out


def worst_leaves(program, reference) -> Dict[str, str]:
    """The leaves that set ``grad_gap`` and ``update_gap``."""
    grad = leaf_gaps(program, reference, "grad_norms")
    update = leaf_gaps(program, reference, "change_norms", moved_leaves(reference))
    return {"grad": max(grad, key=grad.get), "update": max(update, key=update.get)}


TIER = {"bfloat16": "bf16"}  # the reference's precision that a configuration states


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float,
        yardstick: bool | None = None) -> Outcome:
    t = cell.traffic
    model, step, weights, batches = setup(cell, seed, device)
    names = trainable(param_spec(cell.model, True))
    taken = [0]

    def one_step():
        with torch.profiler.record_function("portbench.step"):
            metrics = step(batches[taken[0] % len(batches)])
        taken[0] += 1
        return metrics

    program = first_steps(model, step, weights, one_step, names)
    synchronize(device)
    host, traces = {}, (None, None)
    if trace:
        traces = tuple(traced(lambda j: one_step(), t["trace_units"], host_ranges)
                       for host_ranges in (False, True))
        host["optimizer_s_per_step"] = optimizer_alone(step.optimizer, one_step,
                                                       t["trace_units"], device)

    steps = skipped = 0
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    while True:
        skipped += int(one_step()["skipped_nan"])
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    synchronize(device)
    elapsed = time.perf_counter() - t0
    window = {"units": steps, "elapsed_s": elapsed, "samples": steps * t["batch"]}
    readings = Readings("train", cell.dtype, cell.model, t, setup_s, window, *traces, host)
    device_info = device_of(device)
    del model, step
    free_device_memory(device)

    checked = batches[:CHECK_STEPS]
    draws = replayed_draws(cell, seed, device)
    reference = reference_steps(cell, weights, checked, draws, Precision())
    if yardstick is None:
        yardstick = any(k.endswith("_rel") for k in cell.limits)
    tier = (reference_steps(cell, weights, checked, draws, Precision(TIER[cell.dtype]))
            if yardstick and cell.dtype in TIER else None)
    numbers = gaps(program, reference, tier)
    return Outcome(readings, steps, skipped, checks_of(numbers, cell.limits),
                   device_info["memory_peak_bytes"],
                   {"device": device_info, "numbers": numbers, "program": program,
                    "reference": reference, "tier": tier, "weights": weights,
                    "batches": checked, "draws": draws})
