"""Realign parity: the port's realign (its plain torch version, which the
CUDA kernel is held against on the card in test_torch_gpu.py) against the
JAX package's fused paths — realign_pallas in interpret mode and
realign_scan — and the event-table wrappers against realign_events /
realign_events_sparse. Exact equality of every output (best_t, mm, ok),
including rows that do not pass."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

MAX_MM = 2


def _case(seed, q, L=32, R=128, E=128):
    """Random genome with N runs; events including both genome ends and a
    right flank past the end; reads planted across events (some with a
    mismatch, some with Ns), random rows and zero-length rows."""
    rng = np.random.default_rng(seed)
    n = 4000
    genome = rng.integers(0, 4, n).astype(np.int8)
    genome[1000:1012] = 4
    genome[2500:2503] = 4
    lefts = rng.integers(100, 3000, E).astype(np.int32)
    lefts[:4] = [0, 5, n - 2, n - 1]
    lefts[4] = 1002                           # left flank inside the N run
    if q == 0:
        kinds = np.where(np.arange(E) % 5 == 0, 1, 0).astype(np.int8)
        rights = (lefts + rng.integers(60, 300, E)).astype(np.int32)
        rights[5] = n + 3                     # right flank past the end
        rights[6] = 2500                      # right flank starts on Ns
    else:
        kinds = np.full(E, 2, np.int8)
        rights = lefts + 1
    seqs = np.full((E, 8), -1, np.int8)
    seqs[:, :q] = rng.integers(0, 4, (E, q))
    reads = np.full((R, L), -1, np.int8)
    lengths = np.full(R, L, np.int32)
    for i in range(R):
        e = 4 + i % 3 if i < 12 else int(rng.integers(0, E))
        t = int(rng.integers(1, L - 1 - q))
        if i % 10 == 9:
            lengths[i] = 0                    # pow2 padding rows
            continue
        lo = lefts[e] - t + 1
        start = lefts[e] + 1 if q else rights[e]
        if lo < 0 or start + L > n:
            reads[i] = rng.integers(0, 5, L)
            continue
        read = np.concatenate([genome[lo: lefts[e] + 1], seqs[e, :q],
                               genome[start: start + (L - t - q)]])
        if i % 3 == 0:
            p = int(rng.integers(0, L))
            read[p] = (read[p] + 1) % 4
        if i % 7 == 0:
            lengths[i] = int(rng.integers(q + 1, L))
            read[lengths[i]:] = -1
        reads[i] = read
    return genome, reads, lengths, lefts, rights, kinds, seqs


def _port(genome, reads, lengths, lefts, rights, kinds, seqs, q, L):
    from tophat_tpu_torch.ops.realign_kernel import (prepare_targets,
                                                     realign_group)

    t = torch.as_tensor
    flank_l, comb = prepare_targets(t(genome), t(lefts), t(rights), t(kinds),
                                    t(seqs), q, L)
    out = realign_group(t(reads), t(lengths), flank_l, comb, q, MAX_MM)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("q", [0, 3])
def test_realign_plain_matches_pallas_and_scan(q):
    from tophat_tpu.ops.events import realign_scan
    from tophat_tpu.ops.pallas.realign_kernel import (prepare_inputs,
                                                      realign_pallas)

    L = 32
    genome, reads, lengths, lefts, rights, kinds, seqs = _case(5 + q, q, L)
    X, YL, YC = prepare_inputs(jnp.asarray(genome), reads, jnp.asarray(lefts),
                               jnp.asarray(rights), jnp.asarray(kinds), seqs,
                               q, L)
    ref_p = realign_pallas(X, YL, YC, jnp.asarray(lengths), L=L, q=q,
                           max_mm=MAX_MM, interpret=True)
    ref_s = realign_scan(X, YL, YC, jnp.asarray(lengths), L=L, q=q,
                         max_mm=MAX_MM)
    got = _port(genome, reads, lengths, lefts, rights, kinds, seqs, q, L)
    for name, a, b, c in zip(("best_t", "mm", "ok"), got, ref_p, ref_s):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
        np.testing.assert_array_equal(a, np.asarray(c), err_msg=name)
    ok = got[2]
    assert ok.sum() >= 64                     # planted reads really align
    assert not ok[lengths == 0].any()
    assert (got[0][lengths == 0] == 0).all()
    assert (got[1][lengths == 0] == 32767).all()


def _long_case(seed, q, L, R=40, E=24, far=256):
    """Rows wider than 256 positions: reads planted across events with
    splits at `far` or past it where L - 1 - q allows (every third row),
    anywhere else, or ending
    early (-1 past their length); random and zero-length rows; events at
    both genome ends and a right flank past the end."""
    rng = np.random.default_rng(seed)
    n = max(6000, 3 * L + 1000)
    genome = rng.integers(0, 4, n).astype(np.int8)
    genome[2000:2010] = 4
    lefts = rng.integers(L, n - 2 * L, E).astype(np.int32)
    lefts[:2] = [0, n - 1]
    if q == 0:
        kinds = np.zeros(E, np.int8)
        rights = (lefts + rng.integers(40, 400, E)).astype(np.int32)
        rights[2] = n + 5
    else:
        kinds = np.full(E, 2, np.int8)
        rights = lefts + 1
    seqs = np.full((E, 8), -1, np.int8)
    seqs[:, :q] = rng.integers(0, 4, (E, q))
    reads = np.full((R, L), -1, np.int8)
    lengths = np.full(R, L, np.int32)
    for i in range(R):
        if i % 8 == 7:
            lengths[i] = 0
            continue
        if i % 8 == 6:
            reads[i] = rng.integers(0, 5, L)
            continue
        e = int(rng.integers(3, E))
        t = (int(rng.integers(min(far, L - 1 - q), L - q)) if i % 3 == 0
             else int(rng.integers(1, L - 1 - q)))
        start = lefts[e] + 1 if q else rights[e]
        read = np.concatenate([genome[lefts[e] - t + 1: lefts[e] + 1],
                               seqs[e, :q],
                               genome[start: start + (L - t - q)]])
        if i % 4 == 1:
            read[int(rng.integers(0, L))] ^= 1
        if i % 5 == 2 and t + q + 1 < L:
            lengths[i] = int(rng.integers(t + q + 1, L))
            read[lengths[i]:] = -1
        reads[i] = read
    return genome, reads, lengths, lefts, rights, kinds, seqs


@pytest.mark.parametrize("L", [257, 300, 4097, 4500])
@pytest.mark.parametrize("q", [0, 3])
def test_realign_plain_matches_jax_on_wide_rows(q, L):
    """Rows of 257 and 300 positions (the kernel's resident shift-code
    path on the card) against realign_pallas (interpret mode) and
    realign_scan; rows of 4,097 and 4,500 positions (past the 4,096 the
    kernel's argmin once packed) against realign_scan alone, on 12
    events: interpret-mode realign_pallas walks a fori_loop of L steps
    per grid cell and takes minutes at those widths. Exact, with best
    splits at t >= 256 (which an 8-bit argmin packing loses), or t >=
    4,096 for the widest rows (a 12-bit one), wherever a split can reach
    them (all but L = 257 and 4,097 at q = 3)."""
    from tophat_tpu.ops.events import realign_scan
    from tophat_tpu.ops.pallas.realign_kernel import (prepare_inputs,
                                                      realign_pallas)

    far = 256 if L <= 300 else 4096
    genome, reads, lengths, lefts, rights, kinds, seqs = _long_case(
        L + q, q, L, E=24 if L <= 300 else 12, far=far)
    X, YL, YC = prepare_inputs(jnp.asarray(genome), reads, jnp.asarray(lefts),
                               jnp.asarray(rights), jnp.asarray(kinds), seqs,
                               q, L)
    refs = [realign_scan(X, YL, YC, jnp.asarray(lengths), L=L, q=q,
                         max_mm=MAX_MM)]
    if L <= 300:
        refs.append(realign_pallas(X, YL, YC, jnp.asarray(lengths), L=L, q=q,
                                   max_mm=MAX_MM, interpret=True))
    got = _port(genome, reads, lengths, lefts, rights, kinds, seqs, q, L)
    for ref in refs:
        for name, a, b in zip(("best_t", "mm", "ok"), got, ref):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    bt, _, ok = got
    assert (bt[ok] >= far).sum() >= (8 if L - 1 - q >= far else 0)
    assert ok.sum() >= 20 and not ok[lengths == 0].any()
    assert ok[(lengths > 0) & (lengths < L)].any()


def test_realign_n_vs_n_follows_the_fused_path():
    """A read carrying 3 Ns over 3 genome Ns: the fused path (8-channel
    one-hot, N matches N) gives mm 0; the conv reference realign_chunk
    (4 channels) gives 3. The port follows the fused path."""
    from tophat_tpu.ops.events import realign_chunk
    from tophat_tpu.ops.pallas.realign_kernel import (prepare_inputs,
                                                      realign_pallas)

    rng = np.random.default_rng(3)
    L, n = 32, 600
    genome = rng.integers(0, 4, n).astype(np.int8)
    genome[195:198] = 4
    left, right = 199, 400
    t = 20
    read = np.concatenate([genome[left - t + 1: left + 1],
                           genome[right: right + L - t]])
    assert (read == 4).sum() == 3
    reads = read[None].astype(np.int8)
    lengths = np.array([L], np.int32)
    ev = [np.array([left], np.int32), np.array([right], np.int32),
          np.zeros(1, np.int8)]
    seqs = np.full((1, 8), -1, np.int8)
    X, YL, YC = prepare_inputs(jnp.asarray(genome), reads,
                               *(jnp.asarray(a) for a in ev), seqs, 0, L)
    _, mm_fused, _ = realign_pallas(X, YL, YC, jnp.asarray(lengths), L=L,
                                    q=0, max_mm=MAX_MM, interpret=True)
    _, mm_conv, _ = realign_chunk(
        jnp.asarray(genome), jnp.asarray(reads), jnp.asarray(lengths),
        *(jnp.asarray(a) for a in ev), jnp.zeros(1, jnp.int8),
        jnp.asarray(seqs), jnp.ones(1, bool), max_mm=8)
    _, mm_port, ok_port = _port(genome, reads, lengths, *ev, seqs, 0, L)
    assert int(np.asarray(mm_fused)[0, 0]) == 0
    assert int(np.asarray(mm_conv)[0, 0]) == 3
    assert int(mm_port[0, 0]) == 0 and bool(ok_port[0, 0])


def _events(seed, n, E=40):
    """Mixed event table: junctions, deletions and insertions of length
    1..3, with inserted sequences and a few invalid events."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice([0, 1, 2], E).astype(np.int8)
    lefts = rng.integers(50, n - 400, E).astype(np.int32)
    rights = np.where(kinds == 2, lefts + 1,
                      lefts + rng.integers(5, 300, E)).astype(np.int32)
    ins_len = np.where(kinds == 2, rng.integers(1, 4, E), 0).astype(np.int8)
    ins_seq = np.full((E, 8), -1, np.int8)
    for i in np.nonzero(kinds == 2)[0]:
        ins_seq[i, :ins_len[i]] = rng.integers(0, 4, ins_len[i])
    valid = rng.random(E) < 0.9
    return dict(left=lefts, right=rights, kind=kinds, ins_len=ins_len,
                ins_seq=ins_seq, antisense=np.zeros(E, bool), valid=valid)


@pytest.mark.parametrize("R,E", [(96, 40), (83, 37)])
def test_realign_event_wrappers_match_jax(monkeypatch, R, E):
    """Dense and sparse event wrappers on CPU tensors against the JAX
    package's; the sparse one goes through realign_group_sparse once per
    q-group. (83, 37): R no multiple of 16, E no multiple of 8."""
    from tophat_tpu.ops.events import realign_events as jax_dense
    from tophat_tpu.ops.events import realign_events_sparse as jax_sparse
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.ops.events import (realign_events,
                                             realign_events_sparse)

    sparse_calls = []
    entry = events.realign_group_sparse
    monkeypatch.setattr(events, "realign_group_sparse", lambda *a: (
        sparse_calls.append(a[0].device.type), entry(*a))[1])
    rng = np.random.default_rng(9)
    n = 3000
    genome = rng.integers(0, 4, n).astype(np.int8)
    ev = _events(4, n, E)
    L = 25
    reads = rng.integers(0, 4, (R, L)).astype(np.int8)
    lengths = np.full(R, L, np.int32)
    for i in range(0, R, 2):                  # plant half the rows
        e = int(rng.integers(0, len(ev["left"])))
        q = int(ev["ins_len"][e])
        t = int(rng.integers(2, L - 2 - q))
        lo = int(ev["left"][e]) - t + 1
        st = int(ev["left"][e]) + 1 if ev["kind"][e] == 2 \
            else int(ev["right"][e])
        reads[i] = np.concatenate([genome[lo: lo + t],
                                   ev["ins_seq"][e, :q],
                                   genome[st: st + L - t - q]])
    lengths[-3:] = 0
    g = torch.as_tensor(genome)
    dense = realign_events(g, reads, lengths, ev, max_mm=MAX_MM)
    ref = jax_dense(jnp.asarray(genome), reads, lengths, ev, MAX_MM)
    for a, b in zip(dense, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    sparse = realign_events_sparse(g, reads, lengths, ev, max_mm=MAX_MM)
    ref_s = jax_sparse(jnp.asarray(genome), reads, lengths, ev, MAX_MM)
    for a, b in zip(sparse, ref_s):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(sparse[0]) >= R // 4
    assert sparse_calls == ["cpu"] * len(np.unique(ev["ins_len"]))
    assert not ev["valid"].all() and (lengths == 0).any()
