"""Pair files: the ``from,to`` CSVs the dataset reads.

Counterpart of ``pose_transfer_tpu/data/pairs.py`` without pandas. A pair
table is a column mapping ``{"from": [...], "to": [...]}`` (``seq0`` ...
for the iterative tables); the functions give the rows in the order of the
pandas versions, ``sample_rows`` draws what ``DataFrame.sample(n,
random_state=0)`` draws, and ``write_csv`` writes the text of
``to_csv(index=False)``.

- ``make_pair_nonvid``: fashion-style; the person id is the first
  ``_``-token of the image name; all ordered permutations of a person's
  images.
- ``make_pairs``: video-style (h36m); the person id is everything up to
  the last ``_``-token; frame i → i+2 within each sequence.
- ``make_pairs_iterative``: sequences of ``frame_diff + 1`` frames, one
  start every 10 frames, stride 2.
- ``make_pairs_restricted``: ``make_pairs`` over the walking action
  classes only (``act_NN`` with NN ≥ 14).
- ``write_pair_files``: pose_dim 16 → ``make_pairs``, else
  ``make_pair_nonvid``; subsampled with ``random_state=0``.
"""

from __future__ import annotations

import csv
import re
from itertools import permutations

import numpy as np

from .annotations import _read_rows


def _by_person(names, tokens: slice) -> dict[str, list[str]]:
    """Names grouped by person id, persons in order of first appearance."""
    groups: dict[str, list[str]] = {}
    for n in names:
        groups.setdefault("_".join(n.split("_")[tokens]), []).append(n)
    return groups


def _frame_steps(groups) -> dict:
    fr, to = [], []
    for seq in groups:
        for i in range(len(seq) - 2):
            fr.append(seq[i])
            to.append(seq[i + 2])
    return {"from": fr, "to": to}


def make_pair_nonvid(names) -> dict:
    """All ordered same-person permutations (fashion, pose_dim 18)."""
    fr, to = [], []
    for seq in _by_person(names, slice(0, 1)).values():
        for a, b in permutations(seq, 2):
            fr.append(a)
            to.append(b)
    return {"from": fr, "to": to}


def make_pairs(names) -> dict:
    """Frame i → i+2 within each video sequence (h36m, pose_dim 16)."""
    return _frame_steps(_by_person(names, slice(None, -1)).values())


def make_pairs_iterative(names, frame_diff: int = 10) -> dict:
    """Sequences seq0..seq<frame_diff> for iterative testing."""
    seq = [[] for _ in range(frame_diff + 1)]
    for rows in _by_person(names, slice(None, -1)).values():
        for i in range(0, len(rows), 10):
            if i + 2 * frame_diff < len(rows):
                for j in range(frame_diff + 1):
                    seq[j].append(rows[i + j * 2])
    return {f"seq{j}": seq[j] for j in range(frame_diff + 1)}


def make_pairs_restricted(names) -> dict:
    """Like make_pairs but only walking action classes (act id >= 14)."""
    groups = []
    for person, rows in _by_person(names, slice(None, -1)).items():
        m = re.search(r"act_([0-9]{2})", person)
        if m is not None and int(m.groups()[0]) >= 14:
            groups.append(rows)
    return _frame_steps(groups)


def num_rows(table: dict) -> int:
    return len(next(iter(table.values())))


def sample_rows(table: dict, n: int, seed: int = 0) -> dict:
    """``n`` rows without replacement, as ``DataFrame.sample(n,
    random_state=seed)`` draws them."""
    idx = np.random.RandomState(seed).choice(num_rows(table), size=n,
                                             replace=False)
    return {k: [v[i] for i in idx] for k, v in table.items()}


def build_pairs(names, pose_dim: int, max_pairs: int | None = None) -> dict:
    """pose_dim-dispatched pair construction + seeded subsampling.
    ``names``: the image names in annotation order (a name-indexed
    annotation mapping iterates them)."""
    pairs = make_pairs(names) if pose_dim == 16 else make_pair_nonvid(names)
    if max_pairs is not None:
        pairs = sample_rows(pairs, min(max_pairs, num_rows(pairs)))
    return pairs


def read_csv(path: str) -> dict:
    """A pair CSV as a column mapping."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols = {k: [] for k in header}
        for row in reader:
            for k, v in zip(header, row):
                cols[k].append(v)
    return cols


def write_csv(table: dict, path: str) -> None:
    """The text of pandas' ``to_csv(path, index=False)``."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(table)
        w.writerows(zip(*table.values()))


def write_pair_files(opt) -> tuple[int, int]:
    """Write the train and test pair CSVs from the annotation files.

    ``opt`` needs: annotations_file_{train,test}, pairs_file_{train,test}
    (and their ``_interpol``, ``_check`` and ``_iterative`` twins),
    pose_dim, images_for_train, images_for_test. Returns pair counts.
    """
    counts = []
    for split in ("train", "test"):
        names = [r["name"] for r in
                 _read_rows(getattr(opt, f"annotations_file_{split}"))]
        limit = getattr(opt, f"images_for_{split}")
        pairs = build_pairs(names, opt.pose_dim, limit)
        print(f"Compute pair dataset for {split}... "
              f"Number of pairs: {num_rows(pairs)}")
        if getattr(opt, "checkMode", 0):
            # check mode: a seeded 4000-pair sample at the -check path
            # instead of the full file
            sampled = sample_rows(pairs, min(4000, num_rows(pairs)))
            print(f"Number of pairs: {num_rows(sampled)}")
            write_csv(sampled, getattr(opt, f"pairs_file_{split}_check"))
            counts.append(num_rows(sampled))
            continue
        write_csv(pairs, getattr(opt, f"pairs_file_{split}"))
        # the dataset prefers the -interpol pair files: write them too, so
        # that a fresh directory trains at once
        write_csv(pairs, getattr(opt, f"pairs_file_{split}_interpol"))
        if getattr(opt, "write_iterative", False) and opt.pose_dim == 16:
            write_csv(make_pairs_iterative(names, opt.frame_diff),
                      getattr(opt, f"pairs_file_{split}_iterative"))
        counts.append(num_rows(pairs))
    return tuple(counts)
