"""The arithmetic of the per-layer metrics, over a run's context: the trace
summary (``trace.summarize``), the traced steps, the measured window and
the cell's shapes (``harness.cell_shapes``). Each function returns None where
its run has nothing to read, and never 0 for a share of a roofline or of
the peak. ``metrics/<name>.py`` binds one of them to a metric's name."""

from __future__ import annotations

from portbench import costs

#: the sigmoid-loss kernels (``csrc/sigmoid_loss.cu``), forward and backward
SIGMOID_KERNELS = ("sigmoid_fwd_kernel", "sum_partials_kernel",
                   "sigmoid_bwd_kernel", "sum_slots_kernel")


def _traced(ctx: dict):
    tr = ctx.get("trace")
    if not tr or not ctx.get("traced_steps") or tr["busy_s"] <= 0:
        return None
    return tr


def ops_per_step(ctx: dict):
    tr = _traced(ctx)
    return None if tr is None else tr["device_ops"] / ctx["traced_steps"]


def device_ms_per_step(ctx: dict):
    tr = _traced(ctx)
    return None if tr is None else 1e3 * tr["busy_s"] / ctx["traced_steps"]


def wall_samples_per_s(ctx: dict):
    return ctx.get("samples_per_s") or None


def idle_share(ctx: dict):
    tr = _traced(ctx)
    return None if tr is None else 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def model_flops(s: dict) -> int:
    if s["family"] == "em":
        return costs.em_model_flops(s["dims"], s["B"], s["d0"], s["periodic"], s["sig"])
    return costs.adc_model_flops(s["dims"], s["B"], s["enc_d"], s["n_atoms"],
                                 s["n_ca"], s["sig"], s["ca_sig"])


def mfu(ctx: dict):
    if _traced(ctx) is None:
        return None
    flops = model_flops(ctx["shapes"]) * ctx["window_steps"]
    return 100.0 * flops / ctx["window_s"] / costs.PEAK_F32_FLOPS


def backmap_ms_per_step(ctx: dict):
    tr = _traced(ctx)
    if tr is None:
        return None
    s = sum(tr["host_op_device_s"].values())
    return None if s <= 0 else 1e3 * s / ctx["traced_steps"]


def train_step_roofline(ctx: dict):
    tr = _traced(ctx)
    s = ctx["shapes"]
    if tr is None or s["family"] != "em":
        return None
    least, _ = costs.fused_step_least_s(s["dims"], s["n_enc"], s["B"], s["d0"],
                                        s["periodic"], s["sig"])
    return 100.0 * least / (tr["busy_s"] / ctx["traced_steps"])


def sigmoid_least_ms(s: dict) -> float:
    """Least ms of a step's sketch-map losses, forward and backward: the
    encoder input's, and for the ADC the CA pairs' at their flat width."""
    d = min(s["dims"])
    if s["family"] == "em":
        losses = [(s["d0"], s["periodic"], s["sig"])]
    else:
        losses = [(s["enc_d"], True, s["sig"]),
                  (s["n_ca"] * (s["n_ca"] - 1) // 2, False, s["ca_sig"])]
    return sum(costs.sigmoid_bound(s["B"], D, d, per, back, prm)[0]
               for D, per, prm in losses for back in (False, True))


def sigmoid_roofline(ctx: dict):
    tr = _traced(ctx)
    if tr is None:
        return None
    dev_s = sum(t for name, t in tr["kernel_s"].items()
                if any(k in name for k in SIGMOID_KERNELS))
    if dev_s <= 0:
        return None
    return 100.0 * sigmoid_least_ms(ctx["shapes"]) * 1e-3 / (dev_s / ctx["traced_steps"])
