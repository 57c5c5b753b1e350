"""Share of its roofline that the dense sweep kernels
(``csrc/dense_sweep.cu``: the persistent launch and the per-sweep pair)
reach in the traced embed, in %.

The bound of one sweep over n rows counts every input read once and the
output written once (y and the new y, (n, d); the column group's edge
records, kg x 24 bytes a row, 4 more with edge masks; the scales and
the hubness weights, (n,); the neighbour ids (k, n) where negatives are
screened against them) at 3.35 TB/s, or its float32 operations at 67
TFLOP/s, whichever is longer; times the sweeps each step of the embed
ran (``info["sweeps"]``), over the device time of the sweep kernels."""

from portbench import peaks

KERNELS = ("sweeps_kernel", "attraction_kernel", "kick_kernel")


def sweep_bound_s(n, kg, k, n_neg, d, hub, exclusion=True, mask=False):
    table = kg * (24 + 4 * mask)
    once = (8 * d + table + 4 + 4 * hub + 4 * k * exclusion) * n
    ops = (kg * (48 + 5 * d) + n_neg * (16 + 6 * d + k * exclusion)
           + 2 * d) * n
    return max(once / peaks.HBM_BYTES_PER_S, ops / peaks.F32_FLOPS)


def read(run):
    info = run.traced_info
    if run.trace is None or info is None:
        return None
    cfg = run.config
    params = dict(cfg.get("params", {}), **run.mix.get("params", {}))
    k, d = cfg["embed"]["nbng"], cfg["embed"]["dim"]
    steps = [(run.n, info)]
    if "first_step" in info:
        m = max(k + 1, int(round(run.n * cfg["embed"]["hierarchy_fraction"])))
        steps.append((m, info["first_step"]))
    bound = 0.0
    for n, step in steps:
        if step.get("optimizer") != "dense":
            return None
        bound += step["sweeps"] * sweep_bound_s(
            n, k // step["n_groups"], k, step["n_neg"], d,
            bool(params.get("hubness_weighting", False)),
            bool(params.get("dense_neighbor_exclusion", True)),
            float(params.get("dense_mask_p", 1.0)) < 1.0)
    t = run.trace.seconds_of(*KERNELS)
    return 100.0 * bound / t if t > 0 else None
