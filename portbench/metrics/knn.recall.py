"""recall@knbn of the graph the judged embed returned, against the
reference's exact search, on the first ``recall_rows`` seeded check
rows."""


def read(run):
    return run.reference.get("knn_recall")
