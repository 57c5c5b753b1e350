"""Seconds of the edge probabilities (``proba_edges``, both steps at
layer 1; each waits for its device work, and step 2's seed before it
waits for its own), the mean over the window's embeds."""

from portbench import spans


def read(run):
    return spans.window_mean(
        run, lambda i: spans.seconds(i, ("proba_edges",)))
