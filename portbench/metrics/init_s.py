"""Seconds of the diffusion-maps initialisation (the spectral layer),
the mean over the window's embeds: ``info["init_time"]`` at layer 0,
the first step's at layer 1; the phase waits for the init on the
device."""


def read(run):
    vals = []
    for info in run.infos:
        step = info.get("first_step", info)
        if "init_time" in step:
            vals.append(step["init_time"])
    return sum(vals) / len(vals) if vals else None
