"""Mesh parity, function level: the port's parallel/ (a mesh whose device
list repeats the CPU device) against the JAX package's parallel/ on its 8
virtual CPU devices (tests/conftest.py) and against the one-device runs of
both packages — row sharding, range-sharded sub-indexes, sharded full-read
and segment alignment, realignment per row shard and the sharded pipeline
step. Integer outputs must be equal."""

import contextlib

import jax
import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


@contextlib.contextmanager
def port_mesh(n_reads, n_genome=1):
    """The port's mesh of n_reads x n_genome shards, all on the CPU."""
    from tophat_tpu_torch.parallel import auto
    from tophat_tpu_torch.parallel.mesh import make_mesh

    auto.activate(make_mesh(n_reads, n_genome, [CPU] * (n_reads * n_genome)))
    try:
        yield auto
    finally:
        auto.deactivate()


@contextlib.contextmanager
def jax_mesh(n_reads, n_genome=1):
    from tophat_tpu.parallel import auto
    from tophat_tpu.parallel.mesh import make_mesh

    n = n_reads * n_genome
    auto.activate(make_mesh(n_reads, n_genome, jax.devices()[:n]))
    try:
        yield auto
    finally:
        auto.deactivate()


def test_make_mesh_shapes():
    from tophat_tpu.parallel.mesh import make_mesh as jmake
    from tophat_tpu_torch.parallel.mesh import GENOME_AXIS, READS_AXIS
    from tophat_tpu_torch.parallel.mesh import make_mesh

    for nr, ng in ((8, 1), (2, 4), (4, 2), (1, 1)):
        m = make_mesh(nr, ng, [CPU] * (nr * ng))
        assert m.shape == dict(jmake(nr, ng, jax.devices()[:nr * ng]).shape)
        assert m.shape == {READS_AXIS: nr, GENOME_AXIS: ng}
        assert len(m.reads_devices) == nr and m.first == CPU
    assert make_mesh(None, 2, [CPU] * 8).shape[READS_AXIS] == 4
    with pytest.raises(ValueError):
        make_mesh(3, 2, [CPU] * 8)


@pytest.mark.parametrize("B", [13, 3])
def test_shard_rows_pads_like_jax(B):
    """B not a multiple of 8: each shard's rows equal the JAX shard's, pad
    rows repeating the last row; with B < 8 some shards are all pad."""
    rng = np.random.default_rng(B)
    a = rng.integers(0, 4, (B, 5)).astype(np.int8)
    b = np.arange(B, dtype=np.int32)
    with jax_mesh(8) as jauto:
        (ja, jb), jB = jauto.shard_rows(a, b)
        jshards = [[np.asarray(s.data) for s in sorted(
            x.addressable_shards, key=lambda s: s.index[0].start or 0)]
            for x in (ja, jb)]
    with port_mesh(8) as auto:
        shards, pB = auto.shard_rows(a, b)
        tree, tB = auto.shard_pytree_rows(dict(a=a, b=b))
    assert pB == jB == tB == B and len(shards) == 8
    for i, (sa, sb) in enumerate(shards):
        np.testing.assert_array_equal(sa.numpy(), jshards[0][i])
        np.testing.assert_array_equal(sb.numpy(), jshards[1][i])
        np.testing.assert_array_equal(tree[i]["a"].numpy(), jshards[0][i])
    from tophat_tpu_torch.parallel.mesh import gather_rows, make_mesh

    back = gather_rows(make_mesh(8, 1, [CPU] * 8), [s[1] for s in shards], B)
    np.testing.assert_array_equal(back.numpy(), b)


def _two_contig_problem(seed=13, n=1 << 16, L=64, B=64):
    """tests/test_parallel.py's input: two contigs, reads with 2% errors."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.int8)
    starts = rng.integers(0, n - L, B)
    reads = codes[starts[:, None] + np.arange(L)[None, :]].astype(np.int8)
    mut = rng.random((B, L)) < 0.02
    reads = np.where(mut, rng.integers(0, 4, (B, L)), reads).astype(np.int8)
    return codes, reads, np.array([0, n // 2, n])


def test_build_sharded_fm_matches_jax_leaves():
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.parallel.shard_fm import build_sharded_fm as jbuild
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.fm import TABLES
    from tophat_tpu_torch.parallel.shard_fm import build_sharded_fm

    codes, _, offsets = _two_contig_problem(n=20000)
    codes[19990:] = 4                             # an N tail
    jstack, jstarts = jbuild(JGenome(codes=codes, offsets=offsets,
                                     names=["a", "b"]), 3, overlap=100,
                             kmer_k=6)
    subs, starts = build_sharded_fm(Genome(codes=codes, offsets=offsets,
                                           names=["a", "b"]), 3, 100,
                                    kmer_k=6, devices=[CPU] * 3)
    np.testing.assert_array_equal(starts, jstarts)
    for j, sub in enumerate(subs):
        assert sub.n == int(np.asarray(jstack.n).reshape(-1)[0])
        for k in TABLES:
            np.testing.assert_array_equal(
                getattr(sub, k).numpy(),
                np.asarray(getattr(jstack, k))[j].astype(np.int64), k)
    assert subs[2].has_n and subs[0].nbytes == sum(
        getattr(subs[0], k).nbytes for k in TABLES)


def test_sharded_align_2x4_matches_jax_and_one_index():
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.index.fm import build_fm_index as jbuild_fm
    from tophat_tpu.ops.align import align_reads as jalign
    from tophat_tpu.ops.align import pad_reads
    from tophat_tpu.parallel.mesh import make_mesh as jmake
    from tophat_tpu.parallel.shard_fm import build_sharded_fm as jbuild
    from tophat_tpu.parallel.shard_fm import make_sharded_align
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.ops.align import align_reads
    from tophat_tpu_torch.parallel import shard_fm
    from tophat_tpu_torch.parallel.mesh import make_mesh

    codes, reads, offsets = _two_contig_problem()
    n, L = codes.shape[0], reads.shape[1]
    rf, rr, lens = pad_reads(list(reads))
    w = (n + 3) // 4
    jstack, jstarts = jbuild(JGenome(codes=codes, offsets=offsets,
                                     names=["c1", "c2"]), 4, overlap=L)
    fn = make_sharded_align(jmake(2, 4, jax.devices()[:8]), owned_width=w,
                            max_mismatches=2, max_alignments=16)
    ref = [np.asarray(x) for x in fn(jstack, jstarts.astype(np.int64),
                                     offsets.astype(np.int32), rf, rr, lens)]

    mesh = make_mesh(2, 4, [CPU] * 8)
    genome = Genome(codes=codes, offsets=offsets, names=["c1", "c2"])
    subs, starts = shard_fm.build_sharded_fm(genome, 4, L,
                                             devices=mesh.devices[0])
    got = shard_fm.sharded_align(mesh, subs, starts, w, offsets, rf, rr, lens,
                                 max_mismatches=2, max_alignments=16)
    fields = ("pos", "strand", "mm", "valid", "n_hits", "truncated")
    for f, r in zip(fields, ref):
        np.testing.assert_array_equal(getattr(got, f).numpy(), r, f)

    one = align_reads(build_fm_index(genome, device="cpu"), rf, rr, lens,
                      offsets, max_mismatches=2, max_alignments=16)
    jone = jalign(jbuild_fm(JGenome(codes=codes, offsets=offsets,
                                    names=["c1", "c2"])), rf, rr, lens,
                  offsets.astype(np.int32), max_mismatches=2,
                  max_alignments=16)
    for f in ("pos", "strand", "valid", "n_hits"):
        np.testing.assert_array_equal(getattr(one, f).numpy(),
                                      np.asarray(getattr(jone, f)), f)
    pos, strand, valid = (getattr(got, f).numpy()
                          for f in ("pos", "strand", "valid"))
    opos, ostrand, ovalid = (getattr(one, f).numpy()
                             for f in ("pos", "strand", "valid"))
    for i in range(len(rf)):
        assert (set(zip(pos[i][valid[i]], strand[i][valid[i]]))
                == set(zip(opos[i][ovalid[i]], ostrand[i][ovalid[i]]))), i
    np.testing.assert_array_equal(got.n_hits.numpy(), one.n_hits.numpy())
    assert valid.any(1).mean() > 0.8


def _realign_n_case(R=22, L=32):
    """Reads planted across junction events, row 0 with 3 read Ns over 3
    genome Ns, plus random and zero-length rows."""
    from test_torch_realign import _events

    rng = np.random.default_rng(3)
    n = 3000
    genome = rng.integers(0, 4, n).astype(np.int8)
    genome[195:198] = 4
    ev = _events(4, n, E=24)
    ev["left"][0], ev["right"][0], ev["kind"][0] = 199, 400, 0
    ev["ins_len"][0], ev["valid"][0] = 0, True
    reads = rng.integers(0, 4, (R, L)).astype(np.int8)
    lengths = np.full(R, L, np.int32)
    t = 20
    reads[0] = np.concatenate([genome[199 - t + 1: 200],
                               genome[400: 400 + L - t]])
    assert (reads[0] == 4).sum() == 3
    for i in range(1, R, 2):
        e = int(rng.integers(1, len(ev["left"])))
        q = int(ev["ins_len"][e])
        t = int(rng.integers(2, L - 2 - q))
        lo = int(ev["left"][e]) - t + 1
        st = int(ev["left"][e]) + 1 if ev["kind"][e] == 2 \
            else int(ev["right"][e])
        reads[i] = np.concatenate([genome[lo: lo + t], ev["ins_seq"][e, :q],
                                   genome[st: st + L - t - q]])
    lengths[-2:] = 0
    return genome, reads, lengths, ev


def _no_jax_mesh(monkeypatch):
    """The JAX references run with no active JAX mesh: a JAX CLI run
    earlier in the same process (test_torch_multidevice's) leaves its mesh
    active, which sends JAX's one-device calls down its mesh path."""
    from tophat_tpu.parallel import auto as jax_auto

    monkeypatch.setattr(jax_auto, "_MESH", None)
    monkeypatch.setattr(jax_auto, "_GSHARD", None)


def test_realign_per_row_shard_matches_one_device_n_over_n(monkeypatch):
    """realign_events / realign_events_sparse on a 4-shard mesh (22 rows:
    two pad rows in the last shard) equal the port's and JAX's one-device
    runs, the read N over a genome N included (it matches). JAX's own mesh
    path (realign_chunk) counts it as a mismatch: the one exception to
    mesh equality in JAX, which the port does not carry over."""
    import jax.numpy as jnp
    from tophat_tpu.ops.events import realign_events as jdense
    from tophat_tpu.ops.events import realign_events_sparse as jsparse
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.ops.realign_kernel import realign_group_sparse

    _no_jax_mesh(monkeypatch)

    genome, reads, lengths, ev = _realign_n_case()
    g = torch.as_tensor(genome)
    one = events.realign_events(g, reads, lengths, ev, 2)
    one_s = events.realign_events_sparse(g, reads, lengths, ev, 2)
    jone = [np.asarray(x) for x in jdense(jnp.asarray(genome), reads,
                                          lengths, ev, 2)]
    jone_s = [np.asarray(x) for x in jsparse(jnp.asarray(genome), reads,
                                             lengths, ev, 2)]
    calls = []
    entry = events.realign_group_sparse
    events.realign_group_sparse = lambda *a: (
        calls.append(a[0].shape[0]), entry(*a))[1]
    try:
        with port_mesh(4):
            mesh = events.realign_events(g, reads, lengths, ev, 2)
            mesh_s = events.realign_events_sparse(g, reads, lengths, ev, 2)
    finally:
        events.realign_group_sparse = entry
    assert entry is realign_group_sparse
    for a, b, c in zip(mesh, one, jone):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for a, b, c in zip(mesh_s, one_s, jone_s):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    n_groups = len(np.unique(np.where(ev["kind"] == 2, ev["ins_len"], 0)))
    assert calls == [6] * (4 * n_groups)       # ceil(22 / 4) rows a shard
    assert mesh[2][0, 0] and mesh[1][0, 0] == 0 and len(mesh_s[0]) >= 8
    with jax_mesh(4):
        jmesh = [np.asarray(x) for x in jdense(np.asarray(genome), reads,
                                               lengths, ev, 2)]
    assert not jmesh[2][0, 0] and jmesh[1][0, 0] == 32767
    rest = np.ones_like(jmesh[2])
    rest[0, 0] = False
    np.testing.assert_array_equal(jmesh[2][rest], mesh[2][rest])


def test_sharded_pipeline_step_matches_jax(monkeypatch):
    """parallel/dist: the step on a 2-shard mesh against JAX's on 2
    devices (tests/test_parallel.py's problem, N-free): all 8 outputs
    equal, best_t where ok."""
    import __graft_entry__ as g

    _no_jax_mesh(monkeypatch)
    from tophat_tpu.parallel.dist import make_sharded_pipeline_step as jstep
    from tophat_tpu.parallel.mesh import make_mesh as jmake
    from tophat_tpu.parallel.mesh import reads_sharding, replicated
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.parallel.dist import make_sharded_pipeline_step
    from tophat_tpu_torch.parallel.mesh import make_mesh

    read_len, B = 48, 16
    genome, jfm, rf, rr, lens = g._toy_problem(
        n_genome=20_000, n_reads=B, read_len=read_len, junction_frac=0.5)
    offsets = genome.offsets.astype(np.int32)
    kw = dict(read_len=read_len, segment_length=16, max_mismatches=2,
              hits_per_seed=8, max_alignments=8, max_windows=256,
              max_events=64)
    jm = jmake(2, 1, jax.devices()[:2])
    rs, rep = reads_sharding(jm), replicated(jm)
    ref = [np.asarray(x) for x in jstep(jm, **kw)(
        jfm.device_put(rep), jax.device_put(offsets, rep),
        jax.device_put(rf, rs), jax.device_put(rr, rs),
        jax.device_put(lens, rs))]

    fm = build_fm_index(genome.codes, device="cpu")
    got = make_sharded_pipeline_step(make_mesh(2, 1, [CPU] * 2), **kw)(
        fm, offsets, torch.as_tensor(rf), torch.as_tensor(rr),
        torch.as_tensor(lens))
    names = ("aln_pos", "aln_valid", "aln_mm", "n_hits", "spl_mm", "spl_t",
             "spl_ok", "n_events")
    got = [x.numpy() if torch.is_tensor(x) else np.asarray(x) for x in got]
    for name, a, b in zip(names, got, ref):
        if name == "spl_t":
            a, b = a[ref[6]], b[ref[6]]
        np.testing.assert_array_equal(a, b, name)
    assert ref[6].any() and int(ref[7]) > 0


def _beam_problem(B=64, L=25):
    """tests/test_multidevice.py's beam genome (BEAM_MIN_N + 1024 bases)
    and rows with planted exact, 1-mismatch, same-half and split-pair
    2-mismatch placements."""
    from tophat_tpu_torch.pipeline.segment import BEAM_MIN_N

    rng = np.random.default_rng(31)
    N = BEAM_MIN_N + 1024
    codes = rng.integers(0, 4, N).astype(np.int8)
    rows = np.zeros((B, L), np.int8)
    for b in range(B):
        p = int(rng.integers(100, N - 100))
        seg = codes[p:p + L].copy()
        kind = b % 4
        if kind == 1:
            q = int(rng.integers(0, L))
            seg[q] = (seg[q] + 1) % 4
        elif kind == 2:
            for q in rng.choice(L // 2, 2, replace=False):
                seg[q] = (seg[q] + 1) % 4
        elif kind == 3:
            seg[int(rng.integers(0, L // 2))] += 1
            seg[int(rng.integers(L // 2, L))] += 2
            seg %= 4
        rows[b] = seg
    return codes, rows


def test_beam_and_align_rows_on_both_axes(monkeypatch):
    """beam_align_rows on an 8-shard reads axis and on a 4 x 2 mesh over the
    range-sharded index, and align_forward_rows (40-bp rows) over the same
    sub-indexes, equal the port's and JAX's one-device results;
    shard_fm.sharded_align_rows equals JAX's make_sharded_align_rows."""
    from tophat_tpu.index.fm import build_fm_index as jbuild_fm
    from tophat_tpu.ops.align import align_forward_rows as jrows
    from tophat_tpu.ops.beam import beam_align_rows as jbeam
    from tophat_tpu.parallel.mesh import make_mesh as jmake
    from tophat_tpu.parallel.shard_fm import make_sharded_align_rows
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.fm import build_fm_index, default_kmer_k
    from tophat_tpu_torch.ops.align import align_forward_rows
    from tophat_tpu_torch.ops.beam import beam_align_rows
    from tophat_tpu_torch.parallel import shard_fm

    codes, rows = _beam_problem()
    N = codes.shape[0]
    k = default_kmer_k(N)
    offsets = np.array([0, N], np.int32)
    lens = np.full(len(rows), rows.shape[1], np.int32)
    rng = np.random.default_rng(5)
    starts = rng.integers(0, N - 40, 48)
    rows40 = codes[starts[:, None] + np.arange(40)].astype(np.int8)
    rows40[::3, 7] = (rows40[::3, 7] + 1) % 4
    lens40 = np.full(48, 40, np.int32)
    bkw = dict(max_mismatches=2, max_hits=16)
    rkw = dict(max_mismatches=2, hits_per_seed=16, max_hits=16)

    jfm = jbuild_fm(codes, kmer_k=k)
    ref_b = [np.asarray(a) for a in jbeam(jfm, rows, lens, offsets, **bkw)]
    ref_r = [np.asarray(a) for a in jrows(jfm, rows40, lens40, offsets,
                                          **rkw)]
    fm = build_fm_index(codes, kmer_k=k, device="cpu")
    genome = Genome(codes=codes, offsets=np.array([0, N]), names=["chrM"])
    got = {"one": (beam_align_rows(fm, rows, lens, offsets, **bkw),
                   align_forward_rows(fm, rows40, lens40, offsets, **rkw))}
    with port_mesh(8) as auto:
        got["reads"] = (beam_align_rows(fm, rows, lens, offsets, **bkw),
                        align_forward_rows(fm, rows40, lens40, offsets,
                                           **rkw))
        monkeypatch.setenv("TOPHAT_TPU_GENOME_SHARDS", "2")
        auto.configure_genome_axis(fm, genome, 50)
        assert auto.genome_sharded(fm) and auto.active().shape == {
            "reads": 4, "genome": 2}
        got["genome"] = (beam_align_rows(fm, rows, lens, offsets, **bkw),
                         align_forward_rows(fm, rows40, lens40, offsets,
                                            **rkw))
        gs = auto._GSHARD
        mine = shard_fm.sharded_align_rows(
            auto.active(), gs["subs"], gs["starts"], gs["owned_width"],
            offsets, rows, lens, **rkw)
    names = ("pos", "mm", "valid", "n_hits", "truncated")
    for where, (b, r) in got.items():
        for nm, x, y in zip(names, b, ref_b):
            np.testing.assert_array_equal(x.numpy(), y, f"{where} beam {nm}")
        for nm, x, y in zip(names, r, ref_r):
            np.testing.assert_array_equal(x.numpy(), y, f"{where} rows {nm}")
    assert ref_b[2].any(1).all() and ref_r[2][:, 0].all()

    jm = jmake(4, 2, jax.devices()[:8])
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.parallel.shard_fm import build_sharded_fm as jbuild

    jstack, jstarts = jbuild(JGenome(codes=codes, offsets=np.array([0, N]),
                                     names=["chrM"]), 2, gs["overlap"],
                             kmer_k=k)
    fn = make_sharded_align_rows(jm, owned_width=gs["owned_width"], **rkw)
    ref_s = [np.asarray(a) for a in fn(jstack, jstarts.astype(np.int32),
                                       offsets, rows, lens)]
    for nm, x, y in zip(names, mine, ref_s):
        np.testing.assert_array_equal(x.numpy(), y, f"sharded rows {nm}")


@pytest.mark.parametrize("n_rep,shard", [(8, 0), (48, 6)])
def test_beam_reads_axis_keeps_the_batch_lane_cap(n_rep, shard,
                                                  monkeypatch):
    """Repeat rows make the beam's whole-batch lane cap bind: with 8 of
    them the first reads shard alone overflows a cap sized to its own
    rows; with 48 the batch cap drops the later rows, which a shard's own
    cap would keep. On an 8-shard reads axis the tables still equal the
    port's and JAX's one-device runs and JAX's 8-device mesh. Over a
    2-shard genome axis (4 x 2) each shard keeps its own cap, as JAX's
    does: the port equals JAX's range-sharded search there."""
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.index.fm import build_fm_index as jbuild_fm
    from tophat_tpu.ops.beam import beam_align_rows as jbeam
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.fm import build_fm_index, default_kmer_k
    from tophat_tpu_torch.ops.beam import _beam_core, beam_align_rows
    from tophat_tpu_torch.ops.beam import beam_plan
    from test_torch_gpu import _repeat_problem  # numpy only

    codes, rows = _repeat_problem(n_rep)
    N = codes.shape[0]
    k = default_kmer_k(N)
    offsets = np.array([0, N], np.int32)
    lens = np.full(len(rows), rows.shape[1], np.int32)
    bkw = dict(max_mismatches=2, max_hits=16)
    fm = build_fm_index(codes, kmer_k=k, device="cpu")
    one = beam_align_rows(fm, rows, lens, offsets, **bkw)
    with port_mesh(8) as auto:
        mesh = beam_align_rows(fm, rows, lens, offsets, **bkw)
        monkeypatch.setenv("TOPHAT_TPU_GENOME_SHARDS", "2")
        auto.configure_genome_axis(fm, Genome(
            codes=codes, offsets=offsets, names=["chrR"]), 50)
        gmesh = beam_align_rows(fm, rows, lens, offsets, **bkw)
    monkeypatch.delenv("TOPHAT_TPU_GENOME_SHARDS")
    jfm = jbuild_fm(codes, kmer_k=k)
    jone = jbeam(jfm, rows, lens, offsets, **bkw)
    with jax_mesh(8) as jauto:
        jmesh = jbeam(jfm, rows, lens, offsets, **bkw)
        monkeypatch.setenv("TOPHAT_TPU_GENOME_SHARDS", "2")
        jauto.configure_genome_axis(jfm, JGenome(
            codes=codes, offsets=offsets, names=["chrR"]), 50)
        jgmesh = jbeam(jfm, rows, lens, offsets, **bkw)
    names = ("pos", "mm", "valid", "n_hits", "truncated")
    for nm, a, b, c, d in zip(names, one, mesh, jone, jmesh):
        np.testing.assert_array_equal(b.numpy(), a.numpy(), f"mesh {nm}")
        np.testing.assert_array_equal(np.asarray(c), a.numpy(), f"jax {nm}")
        np.testing.assert_array_equal(np.asarray(d), a.numpy(),
                                      f"jax mesh {nm}")
    for nm, a, b in zip(names, gmesh, jgmesh):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      f"genome axis {nm}")
    assert one[4][:n_rep].all() and (one[3][:8] == 16).all()
    if n_rep == 48:
        assert (one[3][40:] == 0).all() and one[4][40:].all()
    # the same shard searched with a cap sized to its own rows
    sl = slice(8 * shard, 8 * shard + 8)
    own = _beam_core(fm, torch.as_tensor(rows[sl]),
                     torch.as_tensor(lens[sl]).long(),
                     torch.as_tensor(offsets).long(), max_hits=16,
                     **beam_plan(fm, rows.shape[1], lens, 2))
    assert not torch.equal(own[3], one[3][sl])
