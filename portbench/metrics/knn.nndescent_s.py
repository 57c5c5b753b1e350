"""Seconds of the IVF builds' NN-descent refinement (every
``nndescent_round_<i>`` and the ``nndescent_rerank``; both graphs at
layer 1), the mean over the window's embeds."""

from portbench import spans


def read(run):
    return spans.window_mean(
        run, lambda i: spans.seconds(i, prefix="nndescent_"))
