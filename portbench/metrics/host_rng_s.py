"""Seconds of the random draws made on the host (the spans ``rng.*``:
the hierarchy's sample, the k-means row draw and initialisation, the
optimizer's relabel permutation, the step-2 noise), the mean over the
window's embeds."""

from portbench import spans


def read(run):
    return spans.window_mean(run, lambda i: spans.seconds(i, prefix="rng."))
