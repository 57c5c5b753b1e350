"""Seconds of the kNN graph build, the mean over the window's embeds:
``info["graph_build_time"]`` at layer 0; the small and the large graph
of ``info["graph_build_phases"]`` at layer 1.  Both phases wait for the
graph on the device before their clocks stop.  None where the graph was
loaded from a cache."""


def read(run):
    vals = []
    for info in run.infos:
        if "graph_load_s" in info.get("checkpoints", {}):
            continue
        phases = info.get("graph_build_phases")
        if phases is not None:
            vals.append(phases["small_graph"] + phases["large_graph"])
        else:
            vals.append(info["graph_build_time"])
    return sum(vals) / len(vals) if vals else None
