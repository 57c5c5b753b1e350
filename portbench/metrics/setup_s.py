"""Seconds from the process's start to the first timed embed: imports,
kernel builds (found in the checkout's build cache after the first
run), the rows made on the card and copied to the host, the warm-up and
the mix's own set-up."""


def read(run):
    return run.setup_s
