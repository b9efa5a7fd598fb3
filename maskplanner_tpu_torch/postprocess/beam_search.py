"""TSP-style beam search for segment-ordering experiments (numpy).

Reference: ``utils/nar_beam_search.py`` — masked top-k beam advance with
backpointers over node-transition probabilities, used for ordering /
concatenation experiments (not on the released inference path). Host-side
numpy implementation with identical masking semantics (visited nodes get
a huge mask multiplier so they never win the top-k on maximization of
negative costs).
"""
from __future__ import annotations

import math

import numpy as np


def get_best(sequences, cost, ids=None, batch_size=None):
    """Per-group argmin selection (reference nar_beam_search.py:8-26)."""
    cost = np.asarray(cost)
    if ids is None:
        idx = int(cost.argmin())
        return sequences[idx : idx + 1], cost[idx : idx + 1]
    ids = np.asarray(ids)
    splits = np.hstack([0, np.where(ids[:-1] != ids[1:])[0] + 1])
    mincosts = np.minimum.reduceat(cost, splits)
    group_lengths = np.diff(np.hstack([splits, len(ids)]))
    all_argmin = np.flatnonzero(np.repeat(mincosts, group_lengths) == cost)
    result = np.full(len(group_lengths) if batch_size is None else batch_size,
                     -1, dtype=int)
    result[ids[all_argmin[::-1]]] = all_argmin[::-1]
    return ([sequences[i] if i >= 0 else None for i in result],
            [cost[i] if i >= 0 else math.inf for i in result])


class Beamsearch:
    """Beam search over node sequences (reference nar_beam_search.py:29-140)."""

    def __init__(self, beam_size: int, batch_size: int, num_nodes: int,
                 start_nodes: np.ndarray):
        self.batch_size = batch_size
        self.beam_size = beam_size
        self.num_nodes = int(num_nodes)
        self.start_nodes = np.asarray(start_nodes, dtype=np.int64)
        self.mask = np.ones((batch_size, beam_size, num_nodes), np.float64)
        self.update_mask(self.start_nodes)
        self.scores = np.zeros((batch_size, beam_size), np.float64)
        self.all_scores: list[np.ndarray] = []
        self.prev_Ks: list[np.ndarray] = []
        self.next_nodes: list[np.ndarray] = [self.start_nodes]

    def get_current_state(self):
        return np.broadcast_to(
            self.next_nodes[-1][:, :, None],
            (self.batch_size, self.beam_size, self.num_nodes)).copy()

    def get_current_origin(self):
        return self.prev_Ks[-1]

    def advance(self, trans_probs: np.ndarray):
        """trans_probs: (batch, beam, num_nodes) log-probs of next node."""
        trans_probs = np.asarray(trans_probs, np.float64)
        if self.prev_Ks:
            beam_lk = trans_probs + self.scores[:, :, None]
        else:
            beam_lk = trans_probs.copy()
            beam_lk[:, 1:] = -1e10  # all beams start identical
        beam_lk = beam_lk * self.mask
        flat = beam_lk.reshape(self.batch_size, -1)
        best_ids = np.argsort(-flat, axis=1)[:, : self.beam_size]
        self.scores = np.take_along_axis(flat, best_ids, axis=1)
        prev_k = best_ids // self.num_nodes
        self.prev_Ks.append(prev_k)
        new_nodes = best_ids - prev_k * self.num_nodes
        self.next_nodes.append(new_nodes)
        # permute masks along the beam dim to follow the backpointers
        self.mask = np.take_along_axis(
            self.mask, prev_k[:, :, None].repeat(self.num_nodes, axis=2),
            axis=1)
        self.update_mask(new_nodes)

    def update_mask(self, new_nodes: np.ndarray):
        arr = np.arange(self.num_nodes)[None, None, :]
        hit = arr == new_nodes[:, :, None]
        self.mask = self.mask * (1.0 - hit)
        self.mask[self.mask == 0] = 1e10

    def sort_best(self):
        # reference parity (nar_beam_search.py:116-119): sorts along
        # axis 0 — the beam axis in the upstream graph-convnet-tsp code
        # this class descends from
        order = np.argsort(-self.scores, axis=0)
        return np.take_along_axis(self.scores, order, axis=0), order

    def get_best(self):
        # reference parity (nar_beam_search.py:121-125): the reference
        # itself returns scores[1], ids[1] (second-ranked row) — kept
        # verbatim; the module is not called from any released path
        scores, ids = self.sort_best()
        return scores[1], ids[1]

    def get_hypothesis(self, k: np.ndarray):
        """Walk backpointers to reconstruct the chosen tour."""
        assert self.num_nodes == len(self.prev_Ks) + 1
        k = np.asarray(k, np.int64)
        hyp = -np.ones((self.batch_size, self.num_nodes), np.int64)
        for j in range(len(self.prev_Ks) - 1, -2, -1):
            hyp[:, j + 1] = np.take_along_axis(
                self.next_nodes[j + 1], k, axis=1).reshape(self.batch_size)
            if j >= 0:
                k = np.take_along_axis(self.prev_Ks[j], k, axis=1)
        return hyp
