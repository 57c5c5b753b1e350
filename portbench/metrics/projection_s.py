"""Seconds of the hierarchy's projection (each row's nearest sampled
row: the top-1 kernel's caller), ``info["graph_build_phases"]
["projection"]``, the mean over the window's embeds; the phase waits
for the projection on the device.  None where it was not built."""


def read(run):
    vals = [i["graph_build_phases"]["projection"] for i in run.infos
            if "projection" in i.get("graph_build_phases", {})]
    return sum(vals) / len(vals) if vals else None
