"""recall@knbn of the approximate (IVF + NN-descent) graph the judged
embed returned, against the reference's exact search, on the first
``recall_rows`` seeded check rows: what the graph build's knobs trade
against its seconds."""


def read(run):
    return run.reference.get("knn_recall")
