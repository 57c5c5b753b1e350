"""Neighbourhood conservation of the judged embed (upstream
embedder.rs:620-681, with exact searches): the share of each checked
row's exact data-space neighbours that lie within its exact
``radius_k``-NN embedded radius, over the configuration's seeded check
rows.  Worked out by the reference (reference/exact.py)."""


def read(run):
    return run.reference.get("nbhd_kept")
