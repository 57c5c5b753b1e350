"""Share of its roofline that the NN-descent rounds reach in the traced
embed, in %, whatever route served them (the round kernel or the torch
slab chain).

The work is the program's count of the candidate distances the rounds
score (the counter ``knn.nndescent.pairs``, every round of both graphs
at layer 1): each scored candidate's row read once in the scoring dtype
(2 d bytes in bf16, 4 d in f32), and each round's (n, k) ids and
distances read and written once (16 n k bytes), at 3.35 TB/s; over the
device's busy time (the union of its activities) inside the embed's
``nndescent_round_<i>`` spans, so each round's union table and its
sampling count against it.  A program without the counter or the spans
reads as nothing."""

from pathlib import Path

from portbench import harness, peaks, spans
from portbench.harness import merged

_IVF = harness.load_file(Path(__file__).resolve().parents[1], "metrics",
                         "ivf_join_roofline")


def bound_s(pairs: int, d: int, dtype: str, rows: list, k: int,
            rounds: int) -> float:
    row_bytes = (2 if dtype == "bfloat16" else 4) * d
    lists = sum(16.0 * r * k * rounds for r in rows)
    return (pairs * row_bytes + lists) / peaks.HBM_BYTES_PER_S


def read(run):
    from annembed_tpu_torch import KnnParams
    info = run.traced_info
    rounds = spans.named(info, prefix="nndescent_round_")
    pairs = (info or {}).get("counters", {}).get("knn.nndescent.pairs")
    if run.trace is None or not rounds or not pairs:
        return None
    kp = KnnParams(**merged(run.config["knn_params"],
                            run.mix.get("knn_params")))
    inside = spans.union((s, e) for _, _, s, e in rounds)
    busy = spans.overlap_ns(spans.union((s, e) for _, s, e in
                                        run.trace.device), inside) * 1e-9
    if busy <= 0:
        return None
    return 100.0 * bound_s(pairs, run.config["columns"], kp.dtype,
                           _IVF.graph_rows(run, kp), _IVF.build_k(kp),
                           kp.refine_rounds) / busy
