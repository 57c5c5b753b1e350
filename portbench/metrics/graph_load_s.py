"""Seconds of loading the graph cache (``info["checkpoints"]
["graph_load_s"]``, ending in a device sync), the mean over the
window's embeds.  None where nothing was loaded."""


def read(run):
    vals = [i["checkpoints"]["graph_load_s"] for i in run.infos
            if "graph_load_s" in i.get("checkpoints", {})]
    return sum(vals) / len(vals) if vals else None
