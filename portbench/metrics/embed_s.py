"""Wall seconds of one ``embed()`` call, host table in and host
embedding out: the window's wall time over the embeds it completed."""


def read(run):
    return run.window_s / run.embeds
