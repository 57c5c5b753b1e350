"""Device seconds of the mesh's collectives in the traced embed: the
union of the intervals of the NCCL kernels (names starting ``nccl``) on
rank 0's card, inside the traced window.  A collective's kernel runs
from its launch until every rank has brought its part, so this counts
the time rank 0 waits for a slower rank as well as the transfer: the
number that fewer or cheaper exchanges (one all-gather a sweep) move.
None where the trace holds no NCCL kernel (one card)."""

from portbench import spans


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    ivs = [(max(s, t.t0_ns), min(e, t.t1_ns)) for name, s, e in t.device
           if name.startswith("nccl")]
    if not ivs:
        return None
    return sum(e - s for s, e in spans.union(ivs)) * 1e-9
