"""The port's filter_junctions (pipeline/report.py: acceptance rules and
the shadow knockout as array work) against the JAX package's loop on the
same events and stats: the same accepted and gtf_match for every event."""

import types

import numpy as np
import pytest

J, DEL, INS, FUS = 0, 1, 2, 3     # ops/splice.KIND_*


def _events(rows, seed=0):
    """Event table holding rows (left, right, kind, antisense, ...) at
    shuffled ids among as many events that no stats entry names; (events,
    the id of each row)."""
    rng = np.random.default_rng(seed)
    n = 2 * len(rows)
    ids = rng.permutation(n)[:len(rows)]
    ev = dict(left=rng.integers(0, 1 << 40, n),
              right=rng.integers(0, 1 << 40, n),
              kind=rng.integers(0, 4, n).astype(np.int8),
              antisense=rng.integers(0, 2, n).astype(bool))
    for i, r in zip(ids, rows):
        ev["left"][i], ev["right"][i], ev["kind"][i], ev["antisense"][i] = \
            r[:4]
    return ev, ids.tolist()


def _stats(cls, rows, ids, order):
    """{id: cls} from rows' (supporting, left_extent, right_extent, min_mm
    [, gtf_match]), inserted in `order`."""
    out = {}
    for k in order:
        r = rows[k]
        st = cls(supporting=r[4], left_extent=r[5], right_extent=r[6],
                 min_mm=r[7])
        if len(r) > 8:
            st.gtf_match = r[8]
        out[ids[k]] = st
    return out


def _flags(stats):
    return {e: (st.accepted, st.gtf_match) for e, st in stats.items()}


def run_both(rows, params, gtf, parts=None, seed=0):
    """Flags from the port's filter over every row, from the JAX package's
    over each part of the rows (all rows if parts is None), and from the
    JAX package's over each junction alone (no knockout)."""
    from tophat_tpu.pipeline import report as ref
    from tophat_tpu_torch.pipeline import report as port

    ev, ids = _events(rows, seed)
    order = np.random.default_rng(seed + 1).permutation(len(rows)).tolist()
    got = _stats(port.EventStats, rows, ids, order)
    port.filter_junctions(ev, got, params, gtf_accept=gtf)
    want, alone = {}, {}
    for part in (parts if parts is not None else [order]):
        st = _stats(ref.EventStats, rows, ids, part)
        ref.filter_junctions(ev, st, params, gtf_accept=gtf)
        want.update(st)
    for k in order:
        st = _stats(ref.EventStats, rows, ids, [k])
        ref.filter_junctions(ev, st, params, gtf_accept=gtf)
        alone.update(st)
    assert set(got) == set(want) == set(alone)
    return _flags(got), _flags(want), _flags(alone)


def shadowed(want, alone):
    """The events that pass acceptance alone but not among the others."""
    return {e for e in want if alone[e][0] and not want[e][0]}


def _p(a=8, mm=0):
    return types.SimpleNamespace(min_anchor_len=a, splice_mismatches=mm)


def _jn(left, right, anti, sup, ext=20, mm=0, kind=J):
    return (left, right, kind, anti, sup, ext, ext, mm)


def _gtf(rows, pick):
    return {(rows[k][0], rows[k][1], bool(rows[k][3])) for k in pick}


def clustered(seed, clusters, size, long_share=0.05):
    """`clusters` groups of `size` events 100 kbp apart (so that no two
    groups reach one another within any anchor length), each with a few
    shared donors and acceptors, both senses, supports 1-6 (many ties),
    extents 5-40, 0-2 mismatches, some introns either side of 50,000, and a
    few indels and fusions; (rows, the row indices of each group)."""
    rng = np.random.default_rng(seed)
    rows, parts = [], []
    for c in range(clusters):
        base = 1_000_000 + c * 100_000
        donors = base + rng.integers(0, 300, 4)
        part = []
        for _ in range(size):
            left = int(rng.choice(donors) + rng.integers(-12, 13))
            intron = (int(rng.integers(49_990, 50_011))
                      if rng.random() < long_share
                      else int(rng.choice([400, 900, 2500])
                               + rng.integers(-12, 13)))
            kind = J if rng.random() < 0.9 else int(rng.integers(1, 4))
            part.append(len(rows))
            rows.append((left, left + intron, kind, bool(rng.integers(2)),
                         int(rng.integers(1, 7)), int(rng.integers(5, 41)),
                         int(rng.integers(5, 41)), int(rng.integers(0, 3))))
        parts.append(part)
    return rows, parts


def _hand_cases():
    c = {}
    c["shared_left"] = (
        [_jn(1000, 1100 + 100 * i, i % 2 == 1, s)
         for i, s in enumerate([1, 3, 2, 5, 5, 1, 4, 2])]
        + [_jn(1000, 9000, False, 9)], _p(), None)
    c["shared_right"] = (
        [_jn(20000 - 150 * i, 21000, i % 3 == 0, s)
         for i, s in enumerate([2, 1, 6, 3, 3, 1, 2])], _p(), None)
    c["shared_both"] = (
        [_jn(30000, 31000, False, 2), _jn(30000, 31000, True, 3),
         _jn(32000, 33000, False, 4), _jn(32000, 33000, True, 4),
         _jn(34000, 35000, True, 1), _jn(34000, 35000, False, 1),
         _jn(34000, 35000, False, 7)], _p(), None)
    near = []
    for a in (8, 3):
        for k, d in enumerate((a, a + 1, -a, -(a + 1))):
            base = 100_000 * (1 + k) + (0 if a == 8 else 50_000)
            near += [_jn(base, base + 1000, False, 1),
                     _jn(base + d, base + 5000, True, 2),
                     _jn(base + 20000, base + 21000, True, 1),
                     _jn(base + 19000, base + 21000 + d, False, 2)]
    c["anchor_distance"] = (near, _p(8), None)
    c["anchor_distance_a3"] = (near, _p(3), None)
    c["ties"] = (
        [_jn(40000, 41000, False, 3), _jn(40002, 42000, True, 3),
         _jn(40100, 43000, True, 3), _jn(39000, 43004, False, 3)],
        _p(), None)
    rows = [_jn(50000, 51000, False, 9), _jn(50004, 52000, True, 2),
            _jn(53000, 54000, True, 1), _jn(53002, 55000, False, 8),
            _jn(56000, 57000, False, 2), _jn(56000, 57000, True, 2)]
    c["gtf_knocker"] = (rows, _p(), _gtf(rows, [0, 2, 4]))
    c["rejected_knocker"] = (
        [_jn(60000, 61000, False, 9, ext=5), _jn(60003, 62000, True, 2),
         _jn(63000, 64000, False, 9, mm=2), _jn(63000, 64500, True, 2),
         _jn(66000, 116_001, True, 1), _jn(66000, 67000, False, 1),
         _jn(66005, 67500, False, 0)], _p(mm=1), None)
    c["indels_fusions"] = (
        [_jn(70000, 70003, False, 9, kind=DEL),
         _jn(70000, 71000, True, 2),
         _jn(70002, 70002, False, 9, ext=2, kind=INS),
         _jn(71000, 500_000, False, 9, kind=FUS),
         _jn(70004, 71004, False, 3), _jn(72000, 72010, True, 1, ext=1,
                                           mm=2, kind=DEL)], _p(), None)
    lng = []
    for k, (intron, sup, ext) in enumerate(
            (i, s, e) for i in (50_000, 50_001) for s in (1, 2)
            for e in (12, 13)):
        base = 1_000_000 * (k + 1)
        lng.append(_jn(base, base + intron, k % 2 == 0, sup, ext=ext))
        lng.append((base + 500_000, base + 500_000 + intron, J, False,
                    sup, ext, 40, 0))
    c["long_introns"] = (lng, _p(), None)
    c["mismatches"] = (
        [_jn(80000 + 5000 * m, 81000 + 5000 * m, False, 1, mm=m)
         for m in range(3)], _p(mm=1), None)
    c["prior_gtf_match"] = (
        [_jn(90000, 91000, False, 1) + (True,), _jn(90001, 92000, True, 5),
         _jn(93000, 94000, True, 1, ext=4) + (True,)], _p(), set())
    c["empty"] = ([], _p(), None)
    c["no_junctions"] = (
        [_jn(1000, 1003, False, 2, kind=DEL), _jn(1000, 1000, False, 5,
                                                  kind=INS),
         _jn(5000, 900_000, True, 1, kind=FUS)], _p(), {(1000, 1003, False)})
    return c


HAND = _hand_cases()


@pytest.mark.parametrize("name", list(HAND) + [
    "clustered_gtf", "clustered_gtf_none", "clustered_gtf_empty",
    "dense", "unannotated_20000"])
def test_filter_junctions_matches_reference(name):
    """Same accepted and gtf_match as the JAX package's filter, event by
    event. The 20,000-junction case (no GTF, so nearly every junction is
    knocked-out or kept by the knockout) runs the port over all of it and
    the reference's O(J^2) loop over each 100-kbp group on its own, which
    gives the same flags since no group reaches another."""
    parts = None
    if name in HAND:
        rows, params, gtf = HAND[name]
    elif name.startswith("clustered"):
        rows, _ = clustered(5, 12, 40)
        params = _p(8)
        gtf = {"clustered_gtf_none": None, "clustered_gtf_empty": set()}.get(
            name, _gtf(rows, range(0, len(rows), 7)))
    elif name == "dense":
        rows, _ = clustered(11, 1, 1500, long_share=0.02)
        params, gtf = _p(5, 1), _gtf(rows, range(0, len(rows), 10))
    else:
        rows, parts = clustered(17, 500, 40)
        params, gtf = _p(8, 2), None
    got, want, alone = run_both(rows, params, gtf, parts)
    assert got == want
    if name in ("dense", "unannotated_20000"):
        # most junctions pass acceptance (A ~ J), and the knockout engages
        assert sum(a for a, _ in alone.values()) > 0.6 * len(rows)
        assert shadowed(want, alone)
