"""The reference's readings of one embed: its graph, its projection and
its embedding, judged against exact searches on the rows the benchmark
made.  The exact data-space search of the check rows is made once and
serves every embed judged on the same rows.  Imports nothing of the
program under test."""

from __future__ import annotations

import numpy as np
import torch

from . import exact, forces


class Reference:
    """The rows ``x_host`` (n, d) with their source clusters ``labels``,
    judged at the check rows ``rows`` for the configuration ``config``."""

    def __init__(self, config: dict, x_host: np.ndarray,
                 labels: torch.Tensor, rows: torch.Tensor, device: str):
        self.config = config
        self.device = device
        self.knbn = config["embed"]["nbng"]
        self.x = torch.from_numpy(x_host).to(device)
        self.labels = labels.to(device)
        self.rows = rows.to(device)
        self.ex_ids, self.ex_d2 = exact.exact_knn(
            self.x, self.x[self.rows], self.knbn, exclude=self.rows)

    def close(self) -> None:
        del self.x

    def graph(self, ids: torch.Tensor, dists: torch.Tensor) -> dict:
        """The returned graph's rows at the check rows."""
        ids, dists = ids.to(self.device), dists.to(self.device)
        miss, err, _ = exact.judge_graph(self.x, self.rows, ids, dists,
                                         self.ex_ids, self.ex_d2)
        nr = min(self.config["check"]["recall_rows"], self.rows.shape[0])
        _, _, recall = exact.judge_graph(
            self.x, self.rows[:nr], ids[:nr], dists[:nr], self.ex_ids[:nr],
            self.ex_d2[:nr])
        return {"knn_miss": miss, "knn_dist_err": err, "knn_recall": recall}

    def sample_size(self) -> int:
        e = self.config["embed"]
        return max(self.knbn + 1,
                   int(round(self.x.shape[0] * e["hierarchy_fraction"])))

    def projection(self, sample_ids, p_idx, p_dist) -> dict:
        """The hierarchy's sample and the projection at the check rows."""
        miss, err = exact.judge_projection(
            self.x, self.rows, sample_ids.to(self.device),
            p_idx.to(self.device), p_dist.to(self.device),
            self.sample_size())
        return {"proj_miss": miss, "proj_dist_err": err}

    def control_graph(self, precision: str):
        """The graph rows a search at ``precision`` would return."""
        return exact.search_at(self.x, self.x[self.rows], self.knbn,
                               precision, exclude=self.rows)

    def control_projection(self, sample_ids, precision: str):
        """The projection a search at ``precision`` would return."""
        xs = self.x[sample_ids.to(self.device)]
        idx, dist = exact.search_at(xs, self.x[self.rows], 1, precision)
        return idx[:, 0], dist[:, 0]

    def embedding(self, y_host: np.ndarray) -> dict:
        """The embedding: rows not finite (or all, for a wrong shape),
        label impurity and neighbourhood kept at the check rows."""
        chk = self.config["check"]
        y = torch.from_numpy(np.ascontiguousarray(y_host, np.float32)).to(
            self.device)
        n = self.x.shape[0]
        if tuple(y.shape) != (n, self.config["embed"]["dim"]):
            return {"bad_rows": n, "embed_impurity": 1.0, "nbhd_kept": 0.0}
        bad, impurity, kept = exact.judge_embedding(
            y, self.labels, self.rows, self.ex_ids, chk["radius_k"],
            chk["label_k"])
        return {"bad_rows": bad, "embed_impurity": impurity,
                "nbhd_kept": kept}

    def rest(self, y_host: np.ndarray, g_ids, g_dists) -> dict:
        """Whether the embedding is at rest under the objective's forces
        (``forces.py``) at the first ``check["rest_rows"]`` check rows,
        worked out from the whole returned graph: ``pull``, and the
        compared ``pull_imbalance`` = |pull|; and ``shared_rows``, the
        share of rows that another row's position hides."""
        c, e = self.config, self.config["embed"]
        y = torch.from_numpy(np.ascontiguousarray(y_host, np.float32)).to(
            self.device)
        n = self.x.shape[0]
        if (tuple(y.shape) != (n, e["dim"])
                or not bool(torch.isfinite(y).all())
                or tuple(g_ids.shape) != (n, self.knbn)):
            return {"pull_imbalance": float("inf"), "shared_rows": 1.0}
        rows = self.rows[:c["check"]["rest_rows"]]
        ids = g_ids.to(self.device).long().clamp(0, n - 1)
        att, rep = forces.rest_forces(
            y, ids, g_dists.to(self.device), rows,
            scale_rho=e.get("scale", 1.0), nbsample=e.get("nbsample", 10),
            n_sub=c["params"].get("n_sub", 60),
            hubness=bool(c["params"].get("hubness_weighting", False)))
        pull = forces.pull(y, rows, att, rep, self.labels)
        return {"pull": pull, "pull_imbalance": abs(pull),
                "shared_rows": exact.shared_rows(y)}
