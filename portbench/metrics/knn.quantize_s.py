"""Seconds of the IVF builds' coarse quantizer (``ivf_quantize``: the
k-means row draw, fit and assignment of every row; both graphs at layer
1), the mean over the window's embeds."""

from portbench import spans


def read(run):
    return spans.window_mean(
        run, lambda i: spans.seconds(i, ("ivf_quantize",)))
