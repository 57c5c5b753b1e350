"""Seconds of the table's copy to the card (``copy_in``, which waits for
it) and of the embedding's copy back (``readback``), the mean over the
window's embeds."""

from portbench import spans


def read(run):
    return spans.window_mean(
        run, lambda i: spans.seconds(i, ("copy_in", "readback")))
