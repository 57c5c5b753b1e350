"""Seconds of the cross-entropy optimizer, the mean over the window's
embeds: ``info["optimize_time"]``, plus the first step's at layer 1;
each waits for the embedding on the device."""


def read(run):
    vals = [i["optimize_time"] + i.get("first_step", {}).get(
        "optimize_time", 0.0) for i in run.infos]
    return sum(vals) / len(vals) if vals else None
