"""Share of its roofline that the top-1 kernel (``csrc/top1_l2.cu``,
with its corpus split) reaches in the traced embed, in %.

The bound counts the work the search needs, from its shapes alone:
every row of the table a query (n), the sample (m rows) the corpus, d
columns; 2 n m d flop at the highest dense peak any implementation
could use (bf16, 989 TFLOP/s), or the inputs read once and the outputs
written once at 3.35 TB/s, whichever is longer.  It does not count the
passes an implementation makes (the 3xTF32 kernel makes three)."""

from portbench import peaks

KERNELS = ("top1_l2_kernel", "split_corpus_kernel")


def bound_s(nq: int, m: int, d: int) -> float:
    flop_s = 2.0 * nq * m * d / peaks.BF16_FLOPS
    bytes_s = 4.0 * ((nq + m) * d + 2 * nq) / peaks.HBM_BYTES_PER_S
    return max(flop_s, bytes_s)


def sample_rows(run) -> int:
    knbn = run.config["embed"]["nbng"]
    return max(knbn + 1,
               int(round(run.n * run.config["embed"]["hierarchy_fraction"])))


def read(run):
    if run.trace is None or run.config["embed"].get("layer", 0) < 1:
        return None
    t = run.trace.seconds_of(*KERNELS)
    if t <= 0:
        return None
    return 100.0 * bound_s(run.n, sample_rows(run),
                           run.config["columns"]) / t
