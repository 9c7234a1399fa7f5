"""Greedy limb assignment + person grouping (host step; numpy copy of
islx/ops/grouping.py: the compact-connection path of the fused step and the
all-pairs path of the parity ``Body``).

This is the one intentionally-host stage of the body pipeline: the greedy
mutual-exclusion pick over sorted limb candidates and the person-subset merge
are inherently sequential with data-dependent table growth
(reference semantics: src/body.py:166-231). The inputs are tiny (<=24 limbs x
K<=32^2 candidate pairs), so this costs microseconds; all the heavy work
(NMS, PAF integrals) already happened on device.

Implements exactly the reference's rules, including its tie-breaking:
candidates are enumerated in (i, j) row-major order and stably sorted by
score descending (src/body.py:166), a person row is pruned when it has <4
parts or mean part-score < 0.4 (src/body.py:227-231).

Outputs match the reference contract: ``candidate[N,4] = (x, y, score, id)``
and ``subset[P, njoint+2]`` where the last two columns are (total score,
part count) (src/body.py:233-235).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def build_candidates(xy: np.ndarray, score: np.ndarray, count: np.ndarray
                     ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Fixed-K device peaks -> ragged candidate table with global ids.

    xy: [C,K,2], score: [C,K], count: [C] (one frame of the unpacked peak tables).
    Returns (candidate[N,4], per-channel global-id arrays).
    """
    blocks = []
    ids: List[np.ndarray] = []
    next_id = 0
    for c in range(xy.shape[0]):
        n = int(count[c])
        gid = np.arange(next_id, next_id + n)
        ids.append(gid)
        if n:
            blocks.append(np.column_stack([
                xy[c, :n, 0].astype(np.float64),
                xy[c, :n, 1].astype(np.float64),
                score[c, :n].astype(np.float64),
                gid.astype(np.float64)]))
        next_id += n
    candidate = np.concatenate(blocks, 0) if blocks else np.zeros((0, 4))
    return candidate, ids


def select_connections(limb_score: np.ndarray, limb_ok: np.ndarray,
                       counts: np.ndarray, ids: List[np.ndarray],
                       limb_seq: np.ndarray
                       ) -> Tuple[List[np.ndarray], List[int]]:
    """Greedy per-limb assignment (reference semantics: src/body.py:140-178).

    limb_score/limb_ok: [L,K,K] from islx_torch.ops.paf.score_limbs.
    Returns (connection_all, special_k): per limb either an [M,5] array of
    (globalA, globalB, score, i, j) or [] when a side has no candidates.
    """
    connection_all: List[np.ndarray] = []
    special_k: List[int] = []
    for k in range(limb_seq.shape[0]):
        a_part, b_part = int(limb_seq[k, 0]), int(limb_seq[k, 1])
        n_a, n_b = int(counts[a_part]), int(counts[b_part])
        if n_a == 0 or n_b == 0:
            special_k.append(k)
            connection_all.append([])
            continue
        ii, jj = np.nonzero(limb_ok[k, :n_a, :n_b])
        ss = limb_score[k, ii, jj].astype(np.float64)
        # stable sort, score desc, ties keep (i, j) enumeration order
        # (src/body.py:142-166)
        order = np.lexsort((jj, ii, -ss))
        used_i = np.zeros(n_a, bool)
        used_j = np.zeros(n_b, bool)
        rows = []
        cap = min(n_a, n_b)
        for t in order:
            i, j = int(ii[t]), int(jj[t])
            if not used_i[i] and not used_j[j]:
                used_i[i] = used_j[j] = True
                rows.append([ids[a_part][i], ids[b_part][j], ss[t],
                             float(i), float(j)])
                if len(rows) >= cap:
                    break
        connection_all.append(np.array(rows, dtype=np.float64)
                              if rows else np.zeros((0, 5)))
    return connection_all, special_k


def select_connections_sorted(pair: np.ndarray, score: np.ndarray,
                              ok: np.ndarray, k: int, counts: np.ndarray,
                              ids: List[np.ndarray], limb_seq: np.ndarray
                              ) -> Tuple[List[np.ndarray], List[int]]:
    """Greedy assignment from device-pre-sorted compact connection lists
    (islx_torch.ops.paf.compact_connections). Reference semantics:
    src/body.py:140-178."""
    connection_all: List[np.ndarray] = []
    special_k: List[int] = []
    for li in range(limb_seq.shape[0]):
        a_part, b_part = int(limb_seq[li, 0]), int(limb_seq[li, 1])
        n_a, n_b = int(counts[a_part]), int(counts[b_part])
        if n_a == 0 or n_b == 0:
            special_k.append(li)
            connection_all.append([])
            continue
        used_i = np.zeros(n_a, bool)
        used_j = np.zeros(n_b, bool)
        rows = []
        cap = min(n_a, n_b)
        for t in range(pair.shape[1]):
            if not ok[li, t]:
                break  # sorted: invalid entries are all at the tail
            i, j = divmod(int(pair[li, t]), k)
            if i >= n_a or j >= n_b:
                continue
            if not used_i[i] and not used_j[j]:
                used_i[i] = used_j[j] = True
                rows.append([ids[a_part][i], ids[b_part][j],
                             float(score[li, t]), float(i), float(j)])
                if len(rows) >= cap:
                    break
        connection_all.append(np.array(rows, dtype=np.float64)
                              if rows else np.zeros((0, 5)))
    return connection_all, special_k


class _People:
    """Growing person table with an (slot, part-id) -> rows index so each
    connection resolves its owning rows by TWO dict lookups instead of the
    reference's linear table scan (semantics per src/body.py:182-231; the
    native kernel in native/grouping.cpp is the third, C++ formulation).

    Rows are dense float vectors [njoint+1]: slots 0..njoint-2 hold global
    part ids (-1 empty), [-2] accumulated score, [-1] part count. Row order
    (== reference scan order) is the insertion order of the ``rows`` list;
    merges keep the earlier row and drop the later one.

    The index maps each (slot, gid) to a LIST of rows: the reference's
    found==2 non-disjoint branch (src/body.py:214-217) writes partB into
    row j1 while row j2 still holds it, so two rows can own the same
    (slot, gid) and a later probe of that key must see both. (With the
    shipped body25/coco limb tables such a duplicated key is never probed
    again — each slot is indexB of at most one earlier limb — but
    group_people accepts arbitrary limb tables, and the C++ kernel's
    linear scan would see both.)
    """

    def __init__(self, njoint: int):
        self.njoint = njoint
        self.rows: List[np.ndarray] = []
        self._owner: dict = {}   # (slot, int(gid)) -> [row objects]

    def find(self, slot_a: int, gid_a: float, slot_b: int, gid_b: float):
        """First two rows owning (slot_a, gid_a) or (slot_b, gid_b), in
        table order — the reference's scan records at most two matches
        (src/body.py:193-197)."""
        owners = list(self._owner.get((slot_a, int(gid_a)), ()))
        for r in self._owner.get((slot_b, int(gid_b)), ()):
            if not any(r is o for o in owners):
                owners.append(r)
        if len(owners) > 1:
            owners.sort(key=self._pos)
        return owners[:2]

    def _pos(self, row) -> int:
        for i, r in enumerate(self.rows):
            if r is row:
                return i
        raise KeyError("row not in table")

    def _unlist(self, row, slot: int, gid: float) -> None:
        lst = self._owner.get((slot, int(gid)))
        if lst is not None:
            for i, r in enumerate(lst):
                if r is row:
                    del lst[i]
                    break
            if not lst:
                del self._owner[(slot, int(gid))]

    def claim(self, row, slot: int, gid: float) -> None:
        old = row[slot]
        if old >= 0:
            self._unlist(row, slot, old)
        row[slot] = gid
        lst = self._owner.setdefault((slot, int(gid)), [])
        if not any(r is row for r in lst):
            lst.append(row)

    def add_part(self, row, slot: int, gid: float, part_score: float,
                 conn_score: float, force: bool = False) -> None:
        """Attach part ``gid`` at ``slot`` (src/body.py:197-201 semantics:
        count +1 and score += even when overwriting a different id).

        force=True reproduces the two-owner overlap branch
        (src/body.py:214-218), which increments count/score UNCONDITIONALLY
        — even when the row already holds exactly this id."""
        if row[slot] == gid and not force:
            return
        self.claim(row, slot, gid)
        row[-1] += 1
        row[-2] += part_score + conn_score

    def new_row(self, slot_a: int, gid_a: float, slot_b: int, gid_b: float,
                score: float) -> None:
        row = -1.0 * np.ones(self.njoint + 1)
        row[-1] = 2
        row[-2] = score
        self.rows.append(row)
        self.claim(row, slot_a, gid_a)
        self.claim(row, slot_b, gid_b)

    def disjoint(self, r1, r2) -> bool:
        return not np.any((r1[:-2] >= 0) & (r2[:-2] >= 0))

    def merge(self, r1, r2, conn_score: float) -> None:
        """Fold r2's parts into r1 and drop r2 (src/body.py:208-213)."""
        take = r2[:-2] >= 0
        r1[:-2] = np.where(take, r2[:-2], r1[:-2])
        for slot in np.nonzero(take)[0]:
            # transfer r2's ownership entry to r1 in place (r1 held -1 at
            # every taken slot — disjointness — so it is not in the list)
            lst = self._owner[(int(slot), int(r2[slot]))]
            for i, r in enumerate(lst):
                if r is r2:
                    lst[i] = r1
                    break
        r1[-2:] += r2[-2:]
        r1[-2] += conn_score
        del self.rows[self._pos(r2)]  # by identity; list.remove would == arrays

    def table(self) -> np.ndarray:
        """Prune weak rows (src/body.py:227-231) and stack."""
        keep = [r for r in self.rows
                if r[-1] >= 4 and r[-2] / r[-1] >= 0.4]
        return (np.stack(keep) if keep
                else -1 * np.ones((0, self.njoint + 1)))


def group_people(candidate: np.ndarray, connection_all: List[np.ndarray],
                 special_k: List[int], limb_seq: np.ndarray, njoint: int
                 ) -> np.ndarray:
    """Merge limb connections into person rows (semantics: src/body.py:182-231).

    Each connection (gid_a, gid_b, score) resolves the rows already owning
    either endpoint via the part-ownership index (_People.find): none ->
    start a person (except the final two limb types), one -> extend it with
    the B part, two -> merge disjoint people or extend the earlier row.
    """
    people = _People(njoint)
    for k in range(limb_seq.shape[0]):
        if k in special_k:
            continue
        slot_a, slot_b = int(limb_seq[k, 0]), int(limb_seq[k, 1])
        for conn in connection_all[k]:
            gid_a, gid_b, cscore = conn[0], conn[1], float(conn[2])
            owners = people.find(slot_a, gid_a, slot_b, gid_b)
            if len(owners) == 2:
                r1, r2 = owners
                if people.disjoint(r1, r2):
                    people.merge(r1, r2, cscore)
                else:
                    people.add_part(r1, slot_b, gid_b,
                                    float(candidate[int(gid_b), 2]), cscore,
                                    force=True)
            elif len(owners) == 1:
                people.add_part(owners[0], slot_b, gid_b,
                                float(candidate[int(gid_b), 2]), cscore)
            elif k < njoint - 2:
                part_scores = float(candidate[int(gid_a), 2]
                                    + candidate[int(gid_b), 2])
                people.new_row(slot_a, gid_a, slot_b, gid_b,
                               part_scores + cscore)
    return people.table()


def assemble_sorted(peaks_xy: np.ndarray, peaks_score: np.ndarray,
                    peaks_count: np.ndarray, pair: np.ndarray,
                    score: np.ndarray, ok: np.ndarray, k: int,
                    limb_seq: np.ndarray, njoint: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Device peak + compact connection tables -> (candidate, subset)."""
    candidate, ids = build_candidates(peaks_xy, peaks_score, peaks_count)
    connection_all, special_k = select_connections_sorted(
        pair, score, ok, k, peaks_count, ids, limb_seq)
    subset = group_people(candidate, connection_all, special_k, limb_seq, njoint)
    return candidate, subset


def assemble(peaks_xy: np.ndarray, peaks_score: np.ndarray,
             peaks_count: np.ndarray, limb_score: np.ndarray,
             limb_ok: np.ndarray, limb_seq: np.ndarray, njoint: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Peak + all-pairs limb tables -> (candidate, subset)."""
    candidate, ids = build_candidates(peaks_xy, peaks_score, peaks_count)
    connection_all, special_k = select_connections(
        limb_score, limb_ok, peaks_count, ids, limb_seq)
    subset = group_people(candidate, connection_all, special_k, limb_seq, njoint)
    return candidate, subset
