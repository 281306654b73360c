"""Junction / indel discovery parity: contiguous stitch, pair windows and
their motif scan, indel pairs and their scan, and discover_events of the
port against the JAX package on the same segment tables — exact
equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.fixture(scope="module")
def spliced():
    """Reads across planted GT-AG introns, deletions and insertions (and a
    few contiguous ones), their genome-space rows and JAX segment tables
    (host numpy)."""
    from tophat_tpu.index.fm import build_fm_index
    from tophat_tpu.ops.align import pad_reads
    from tophat_tpu.pipeline.segment import build_genome_space, map_segments

    rng = np.random.default_rng(41)
    n = 40000
    codes = rng.integers(0, 4, n).astype(np.int8)
    codes[9000:9010] = 4
    L = 76
    seqs = []
    for k in range(10):
        a = 2000 + 3500 * k
        il = int(rng.integers(120, 900))
        codes[a:a + 2] = [2, 3]
        codes[a + il - 2:a + il] = [0, 2]
        for rep in range(3):
            t = int(rng.integers(20, 56))
            seqs.append(np.concatenate([codes[a - t:a],
                                        codes[a + il:a + il + L - t]]))
    for k in range(6):
        s = 1000 + 6000 * k + 2700
        t = int(rng.integers(26, 50))
        d = 1 + k % 3
        seqs.append(np.concatenate([codes[s:s + t],
                                    codes[s + t + d:s + L + d]]))
        ins = rng.integers(0, 4, d).astype(np.int8)
        seqs.append(np.concatenate([codes[s:s + t], ins,
                                    codes[s + t:s + L - d]]))
    seqs.append(codes[8980:8980 + L].copy())     # over the N run
    for k in range(5):                           # contiguous, 1 mismatch
        s = 1500 + 7000 * k
        seq = codes[s:s + L].copy()
        seq[10 + 9 * k] = (seq[10 + 9 * k] + 1) % 4
        seqs.append(seq)
    seqs = [s.astype(np.int8) for s in seqs]
    rf, rr, lens = pad_reads(seqs)
    gs = build_genome_space(rf, rr, lens, 25, pad_rows_pow2=True)
    fm = build_fm_index(codes)
    offsets = np.array([0, n], np.int32)
    tables = map_segments(fm, offsets, gs, segment_mismatches=2,
                          hits_per_seed=32, max_hits=16)
    return codes, fm, offsets, gs, tuple(np.asarray(a) for a in tables)


def _t(a):
    return torch.as_tensor(np.array(a))


def test_stitch_matches(spliced):
    from tophat_tpu.ops.stitch import stitch_contiguous as jstitch
    from tophat_tpu_torch.ops.stitch import stitch_contiguous

    _, _, _, gs, (pos, mm, valid) = spliced
    want = jstitch(jnp.asarray(pos), jnp.asarray(mm), jnp.asarray(valid),
                   jnp.asarray(gs.cuts), jnp.asarray(gs.nseg))
    got = stitch_contiguous(_t(pos), _t(mm), _t(valid), gs.cuts, gs.nseg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].any()


def test_window_scan_matches(spliced):
    import tophat_tpu.ops.splice as J
    import tophat_tpu_torch.ops.splice as T

    codes, _, _, gs, (pos, mm, valid) = spliced
    cap = 512
    jw = J.build_pair_windows(jnp.asarray(pos), jnp.asarray(valid),
                              jnp.asarray(gs.cuts), jnp.asarray(gs.nseg),
                              jnp.asarray(gs.lengths), 50, 500000, 25)
    tw = T.build_pair_windows(_t(pos), _t(valid), _t(gs.cuts).long(),
                              _t(gs.nseg).long(), _t(gs.lengths).long(),
                              50, 500000, 25)
    fields = ("row", "gl", "gr", "sup_start", "sup_len", "valid")
    # the port makes the valid lanes of JAX's flat table alone, in order
    jvalid = np.asarray(jw.valid)
    for f in fields:
        np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                      np.asarray(getattr(jw, f))[jvalid],
                                      err_msg=f)
    jw, jovf = J.compact_windows(jw, cap)
    tw, tovf = T.compact_windows(tw, cap)
    assert tovf == bool(jovf)
    for f in fields:
        np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                      np.asarray(getattr(jw, f)), err_msg=f)
    sup_max = int(np.max(gs.cuts[:, 1:] - gs.cuts[:, :-1])) + 17
    jscan = J.scan_windows(jnp.asarray(codes), jnp.asarray(gs.readsg), jw,
                           sup_max)
    tscan = T.scan_windows(_t(codes), _t(gs.readsg), tw, sup_max)
    for a, b in zip(tscan, jscan):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jc = J.compact_scan_hits(*jscan, jw.row, 256)
    tc = T.compact_scan_hits(*tscan, tw.row, 256)
    for a, b in zip(tc[:4], jc[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tc[4] == int(jc[4]) and tc[5] == bool(jc[5]) and tc[4] > 0


def test_indel_scan_matches(spliced):
    import tophat_tpu.ops.splice as J
    import tophat_tpu_torch.ops.splice as T

    codes, _, _, gs, (pos, mm, valid) = spliced
    jp, jovf = J.build_indel_pairs(jnp.asarray(pos), jnp.asarray(mm),
                                   jnp.asarray(valid), jnp.asarray(gs.cuts),
                                   jnp.asarray(gs.nseg), 3, 3, 256)
    tp, tovf = T.build_indel_pairs(_t(pos), _t(mm), _t(valid),
                                   _t(gs.cuts).long(), _t(gs.nseg).long(),
                                   3, 3, 256)
    assert tovf == bool(jovf)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                      err_msg=k)
    two_seg_max = int(2 * np.max(gs.cuts[:, 1:] - gs.cuts[:, :-1])) + 1
    want = J.scan_indel_pairs(jnp.asarray(codes), jnp.asarray(gs.readsg),
                              jnp.asarray(gs.lengths), jp, two_seg_max)
    got = T.scan_indel_pairs(_t(codes), _t(gs.readsg),
                             _t(gs.lengths).long(), tp, two_seg_max)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[4].sum() >= 4


def test_discover_events_matches(spliced):
    from tophat_tpu.pipeline.juncs import discover_events as jdiscover
    from tophat_tpu.pipeline.params import Params as JParams
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.pipeline.juncs import discover_events
    from tophat_tpu_torch.pipeline.params import Params

    codes, jfm, offsets, gs, tables = spliced
    fm = FMIndex.from_numpy(jfm, device="cpu")
    want = jdiscover(jfm, offsets, gs, JParams(coverage_search=False),
                     seg_tables=tuple(jnp.asarray(a) for a in tables))
    got = discover_events(fm, offsets, gs, Params(coverage_search=False),
                          seg_tables=tuple(_t(a) for a in tables))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype
    kinds = set(got["kind"].tolist())
    assert {0, 1, 2} <= kinds
