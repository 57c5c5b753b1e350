"""Share of its roofline that the IVF local join reaches in the traced
embed, in %, whatever route served it (either join kernel or the torch
join).

The work is the program's count of the candidate distances its plans
call for (the counter ``knn.ivf.pairs``, both graphs at layer 1): 2 d
flop a pair at the bf16 peak (989 TFLOP/s), or each graph's rows read
once and its (n, k) ids and distances written once at 3.35 TB/s,
whichever is longer; over the device's busy time (the union of its
activities) inside the embed's ``ivf_join`` spans."""

from portbench import peaks, spans
from portbench.harness import merged


def graph_rows(run, kp) -> list:
    """Rows of each graph the IVF build made (above brute_force_limit)."""
    emb = run.config["embed"]
    rows = [run.n]
    if emb.get("layer", 0) > 0:
        rows.insert(0, max(kp.knbn + 1,
                           int(round(run.n * emb["hierarchy_fraction"]))))
    return [r for r in rows if r > kp.brute_force_limit]


def build_k(kp) -> int:
    if kp.refine_rounds > 0 and kp.build_k_factor > 1.0:
        return max(kp.knbn + 1, int(round(kp.knbn * kp.build_k_factor)))
    return kp.knbn


def bound_s(pairs: int, d: int, rows: list, k: int) -> float:
    flop_s = 2.0 * d * pairs / peaks.BF16_FLOPS
    bytes_s = sum(4.0 * r * d + 8.0 * r * k for r in rows) \
        / peaks.HBM_BYTES_PER_S
    return max(flop_s, bytes_s)


def read(run):
    from annembed_tpu_torch import KnnParams
    info = run.traced_info
    joins = spans.named(info, ("ivf_join",))
    pairs = (info or {}).get("counters", {}).get("knn.ivf.pairs")
    if run.trace is None or not joins or not pairs:
        return None
    kp = KnnParams(**merged(run.config["knn_params"],
                            run.mix.get("knn_params")))
    inside = spans.union((s, e) for _, _, s, e in joins)
    busy = spans.overlap_ns(spans.union((s, e) for _, s, e in
                                        run.trace.device), inside) * 1e-9
    if busy <= 0:
        return None
    return 100.0 * bound_s(pairs, run.config["columns"],
                           graph_rows(run, kp), build_k(kp)) / busy
