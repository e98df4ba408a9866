"""The port's durability against the JAX package's: the write-ahead log,
checkpoints, and crash recovery of the live index.

* **The WAL's byte format** is the reference's: a log written by either
  package scans in the other to the same records (seq, op, every array
  equal, dtypes included), with the same framing (record lengths, payload
  lengths, header fields). The payload is an ``np.savez`` archive, which
  stamps the time of writing, so two encodings of one record agree byte for
  byte only within a second; the test holds the parse, not the bytes.
* **Checkpoints** are interchangeable: a JAX ``LiveIndex.save`` (f32, int8,
  tiered, labeled) restores in the port to the same state (every array
  equal, the tombstone and label words as the same uint32 bits), and the
  port's save restores in JAX. A checkpoint and a WAL written by JAX
  restore and replay in the port to JAX's uninterrupted state, bit for bit
  (integer coordinates and the masked reference step, as in
  ``tests/test_torch_live.py``).
* The reference's chaos tests (``tests/test_fault.py``: torn tails at every
  cut, a bit flip, ``prune_through`` and a crash at its rename, crash
  recovery bit-identical for seeds 0-2, the WAL/checkpoint prune cycle, a
  failed insert never logged) and checkpoint tests (keep-k, atomicity,
  idempotence; ``tests/test_train_serve.py``) run on the port alone.
"""
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.live as JL
import repro.live.index as jlive_index
from repro.fault import WriteAheadLog as JWriteAheadLog
from repro.fault.wal import encode_record as jax_encode_record
from repro.train import CheckpointManager as JCheckpointManager
from repro_torch.core import BuildConfig, build_vamana, corpus_raw, pack_labels
from repro_torch.fault import WalRecord, WriteAheadLog
from repro_torch.fault.wal import encode_record
from repro_torch.live import LiveConfig, LiveIndex
from repro_torch.train import CheckpointManager
from test_torch_build import _masked_insert_batch_step
from test_torch_live import _state

D = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: more only spin,
    and under the parallel test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wal(tmp_path, name="wal.bin", cls=WriteAheadLog):
    return cls(str(tmp_path / name))


def _records(wal):
    """(seq, op, {name: (dtype, shape, values)}) of every durable record."""
    recs, _, _ = wal.scan()
    return [(r.seq, r.op, {k: (v.dtype.str, v.shape, v.tolist()) for k, v in r.arrays.items()})
            for r in recs]


def _framing(path):
    """(record length, payload length, seq, op code) of each record."""
    raw, off, out = open(path, "rb").read(), 0, []
    while off < len(raw):
        _, length, seq, op = struct.unpack_from("<IIQB", raw, off)
        out.append((17 + length, length, seq, op))
        off += 17 + length
    return out


def _write_stream(wal):
    rng = np.random.default_rng(0)
    wal.append(1, "insert", dict(ext_ids=np.arange(700, 703, dtype=np.int64),
                                 vecs=rng.standard_normal((3, D)).astype(np.float32),
                                 labels=np.asarray([[1], [2], [2**31 + 5]], np.uint32)))
    wal.append(2, "delete", dict(ext_ids=np.asarray([4, 700, 9999], np.int64)))
    wal.append(3, "consolidate")
    wal.append(4, "insert", dict(ext_ids=np.asarray([703], np.int64),
                                 vecs=np.full((1, D), -0.5, np.float32)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_byte_format_both_ways(tmp_path, writer):
    """A log written by one package scans in the other to the same records
    and framing; a record's encoding has the reference's length and header."""
    write_cls, read_cls = ((JWriteAheadLog, WriteAheadLog) if writer == "jax"
                           else (WriteAheadLog, JWriteAheadLog))
    with _wal(tmp_path, cls=write_cls) as w:
        _write_stream(w)
    theirs = _wal(tmp_path, cls=read_cls)
    ours = _wal(tmp_path, cls=write_cls)
    assert _records(theirs) == _records(ours)
    assert [r[:2] for r in _records(theirs)] == [(1, "insert"), (2, "delete"),
                                                 (3, "consolidate"), (4, "insert")]
    assert theirs.last_seq == 4 and [r.seq for r in theirs.replay(after_seq=2)] == [3, 4]
    framing = _framing(theirs.path)
    assert [f[2:] for f in framing] == [(1, 1), (2, 2), (3, 3), (4, 1)]
    arrays = dict(ext_ids=np.asarray([1, 2], np.int64))
    a, b = encode_record(7, "delete", arrays), jax_encode_record(7, "delete", arrays)
    assert len(a) == len(b) and a[4:17] == b[4:17]
    assert encode_record(9, "consolidate", {}) == jax_encode_record(9, "consolidate", {})
    assert isinstance(_wal(tmp_path).replay()[0], WalRecord)
    with pytest.raises(ValueError, match="unknown WAL op"):
        encode_record(1, "upsert", {})


# ---------------------------------------------------------------------------
# the reference's WAL tests (tests/test_fault.py), on the port
# ---------------------------------------------------------------------------

def test_wal_roundtrip_and_seq_filter(tmp_path):
    wal = _wal(tmp_path)
    vecs = np.arange(12, dtype=np.float32).reshape(3, 4)
    wal.append(1, "insert", dict(ext_ids=np.asarray([7, 8, 9]), vecs=vecs))
    wal.append(2, "delete", dict(ext_ids=np.asarray([8])))
    wal.append(3, "consolidate")
    records, durable, torn = wal.scan()
    assert not torn and durable > 0
    assert [(r.seq, r.op) for r in records] == [(1, "insert"), (2, "delete"), (3, "consolidate")]
    np.testing.assert_array_equal(records[0].arrays["vecs"], vecs)
    np.testing.assert_array_equal(records[1].arrays["ext_ids"], [8])
    assert records[2].arrays == {} and wal.last_seq == 3
    assert [r.seq for r in wal.replay(after_seq=1)] == [2, 3]
    assert [r.seq for r in wal.replay(after_seq=3)] == []


def test_wal_torn_tail_at_every_cut(tmp_path):
    wal = _wal(tmp_path)
    wal.append(1, "delete", dict(ext_ids=np.asarray([1])))
    wal.append(2, "delete", dict(ext_ids=np.asarray([2])))
    base = open(wal.path, "rb").read()
    rec3 = encode_record(3, "delete", dict(ext_ids=np.asarray([3])))
    wal.close()
    for cut in (1, 4, 13, len(rec3) // 2, len(rec3) - 1):
        with open(wal.path, "wb") as f:
            f.write(base + rec3[:cut])
        torn = _wal(tmp_path)
        records, durable, is_torn = torn.scan()
        assert is_torn and durable == len(base)
        assert [r.seq for r in records] == [1, 2], cut
        assert torn.truncate_torn_tail()
        torn.append(3, "delete", dict(ext_ids=np.asarray([3])))
        assert [r.seq for r in torn.replay()] == [1, 2, 3]
        torn.close()


def test_wal_bitflip_invalidates_record_as_unit(tmp_path):
    wal = _wal(tmp_path)
    n1 = wal.append(1, "consolidate")
    wal.append(2, "consolidate")
    wal.append(3, "consolidate")
    raw = bytearray(open(wal.path, "rb").read())
    raw[n1 + 8] ^= 0x40
    with open(wal.path, "wb") as f:
        f.write(raw)
    records, _, torn = wal.scan()
    assert torn and [r.seq for r in records] == [1]


def test_wal_prune_through_keeps_tail_atomically(tmp_path):
    wal = _wal(tmp_path)
    for s in range(1, 6):
        wal.append(s, "delete", dict(ext_ids=np.asarray([s])))
    assert wal.prune_through(3) == 3
    assert [r.seq for r in wal.replay()] == [4, 5]
    wal.append(6, "consolidate")
    assert wal.last_seq == 6


def test_wal_prune_crash_is_before_or_after_never_torn(tmp_path, monkeypatch):
    real_replace = os.replace
    wal = _wal(tmp_path)
    for s in range(1, 6):
        wal.append(s, "delete", dict(ext_ids=np.asarray([s])))

    def boom_before(src, dst):
        raise OSError("power cut before rename")

    monkeypatch.setattr(os, "replace", boom_before)
    with pytest.raises(OSError, match="power cut"):
        wal.prune_through(3)
    survivor = _wal(tmp_path)
    records, _, torn = survivor.scan()
    assert not torn and [r.seq for r in records] == [1, 2, 3, 4, 5]
    survivor.close()

    def boom_after(src, dst):
        real_replace(src, dst)
        raise OSError("power cut after rename")

    monkeypatch.setattr(os, "replace", boom_after)
    with pytest.raises(OSError, match="power cut"):
        _wal(tmp_path).prune_through(3)
    survivor = _wal(tmp_path)
    records, _, torn = survivor.scan()
    assert not torn and [r.seq for r in records] == [4, 5]
    survivor.close()
    monkeypatch.setattr(os, "replace", real_replace)
    final = _wal(tmp_path)
    assert final.prune_through(3) == 0
    final.append(6, "consolidate")
    assert [r.seq for r in final.replay()] == [4, 5, 6]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_atomicity_and_keep_k(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, {"a": torch.ones(3) * s, "b": [np.arange(2) + s, {"c": torch.tensor(s)}]})
    assert cm.completed_steps() == [3, 4]
    os.makedirs(str(tmp_path / "step_0000000099.tmp"))
    assert cm.latest_step() == 4
    state, step = cm.restore({"a": 0, "b": [0, {"c": 0}]}, device="cpu")
    assert step == 4 and float(state["a"][0]) == 4.0
    assert state["b"][0].tolist() == [4, 5] and int(state["b"][1]["c"]) == 4
    assert cm.manifest()["paths"] == ["a", "b.0", "b.1.c"]


def test_checkpoint_save_is_idempotent_and_durable(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    p = cm.save(1, {"a": np.arange(4)})
    assert cm.save(1, {"a": np.zeros(4)}) == p
    state, step = cm.restore({"a": np.zeros(4)}, device="cpu")
    assert step == 1 and state["a"].tolist() == [0, 1, 2, 3]
    assert not any(d.endswith(".tmp") for d in os.listdir(str(tmp_path)))


def test_checkpoint_restore_flat_devices_maps_and_words(tmp_path):
    """Leaves land on the device asked for; ``mmap`` leaves are
    copy-on-write maps; uint32 leaves come back as int32 holding the same
    bits; ``shardings`` with no leaf on a mesh gives plain tensors; no card,
    no restore."""
    cm = CheckpointManager(str(tmp_path))
    words = np.asarray([1, 2**31, 2**32 - 1], np.uint32)
    cm.save(5, {"w": words, "raw": np.ones((4, 3), np.float32)}, extra={"k": 1})
    flat, man = cm.restore_flat(mmap=("raw",), device="cpu")
    assert man["extra"] == {"k": 1} and man["step"] == 5
    assert flat["w"].dtype == torch.int32 and flat["w"].numpy().view(np.uint32).tolist() == \
        words.tolist()
    assert isinstance(flat["raw"], np.memmap)
    flat["raw"][0, 0] = 7.0                              # copy-on-write
    assert np.load(tmp_path / "step_0000000005" / "raw.npy")[0, 0] == 1.0
    # no leaf bound to a mesh: plain tensors (tests/test_torch_dist.py binds them)
    flat, _ = cm.restore_flat(shardings={}, device="cpu")
    assert flat["w"].numpy().view(np.uint32).tolist() == words.tolist()
    state, _ = cm.restore({"w": 0}, shardings={"w": None}, device="cpu")
    assert isinstance(state["w"], torch.Tensor) and not hasattr(state["w"], "placements")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cm.restore_flat()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).manifest()


def test_checkpoints_cross_packages(tmp_path):
    """A JAX CheckpointManager's step reads in the port, and the reverse."""
    JCheckpointManager(str(tmp_path / "j")).save(3, {"x": jnp.arange(5), "y": {"z": jnp.ones(2)}})
    state, step = CheckpointManager(str(tmp_path / "j")).restore({"x": 0, "y": {"z": 0}},
                                                                 device="cpu")
    assert step == 3 and state["x"].tolist() == list(range(5)) and state["y"]["z"].tolist() == [1, 1]
    CheckpointManager(str(tmp_path / "t")).save(4, {"x": torch.arange(3), "w": torch.ones(2)})
    state, step = JCheckpointManager(str(tmp_path / "t")).restore({"x": 0, "w": 0})
    assert step == 4 and np.asarray(state["x"]).tolist() == [0, 1, 2]


# ---------------------------------------------------------------------------
# the live index's checkpoints and WAL across the two packages
# ---------------------------------------------------------------------------

LCFG = dict(capacity=192, insert_batch=16)
BCFG = dict(max_degree=8, beam=16, insert_batch=32)


@pytest.fixture(scope="module")
def int_rig():
    """tests/test_fault.py's sizes (96 points of d=8, capacity 192) on
    integer coordinates, with the port's CPU Vamana graph (the masked
    reference's, row for row)."""
    pts = np.random.default_rng(1).integers(-8, 9, (96, D)).astype(np.float32)
    graph = build_vamana(pts, BuildConfig(**BCFG), device="cpu")
    return pts, graph.neighbors.numpy()


def _jax_live(int_rig, **kw):
    pts, nbrs = int_rig
    return JL.LiveIndex.create(jnp.asarray(pts), JL.LiveConfig(**LCFG), J.BuildConfig(**BCFG),
                               graph=J.Graph(jnp.asarray(nbrs)), **kw)


def _int_mutations(seed, n_ops=12):
    """test_fault.py's seeded mixed stream, on integer coordinates."""
    rng = np.random.default_rng(seed + 1000)
    ops = []
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.55:
            ops.append(("insert", rng.integers(-8, 9, (int(rng.integers(1, 5)), D))
                        .astype(np.float32)))
        elif roll < 0.9:
            ops.append(("delete", rng.integers(0, 120, size=int(rng.integers(1, 4)))
                        .astype(np.int64)))
        else:
            ops.append(("consolidate", None))
    return ops


def _apply(idx, op, arg):
    if op == "insert":
        idx.insert(arg)
    elif op == "delete":
        idx.delete(arg)
    else:
        idx.consolidate()


def _assert_same(got, want, wal_seq=True):
    """Every array of the two states equal; ``wal_seq=False`` leaves the
    WAL's sequence number out of the counters (a control runs without a
    log)."""
    sg, sw = _state(got), _state(want)
    assert sg.keys() == sw.keys()
    if not wal_seq:
        sg["counters"], sw["counters"] = sg["counters"][:3], sw["counters"][:3]
    for k in sw:
        np.testing.assert_array_equal(sg[k], sw[k], err_msg=k)


@pytest.mark.parametrize("kind", ["float32", "int8", "tiered", "labeled"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, int_rig, kind):
    """JAX's LiveIndex.save after a churn stream restores in the port to the
    same state, every array bit for bit (the metadata included: the port
    reads JAX's bytes); the port's save of it restores in JAX to the same
    state again; and the restored index keeps the host bookkeeping."""
    kw = dict(corpus_dtype="int8" if kind in ("int8", "tiered") else "float32",
              tier=kind == "tiered")
    if kind == "labeled":
        rng = np.random.default_rng(3)
        kw["labels"] = jnp.asarray(pack_labels([rng.choice(40, 2, replace=False)
                                                for _ in range(96)], 40))
    j = _jax_live(int_rig, **kw)
    for op, arg in _int_mutations(4):
        _apply(j, op, arg)
    j.delete(np.arange(10, 20))
    j.save(JCheckpointManager(str(tmp_path / "j")))
    t = LiveIndex.restore(CheckpointManager(str(tmp_path / "j")), device="cpu")
    _assert_same(t, j)
    assert t.stats() == j.stats() and t._slot_of == j._slot_of
    if kind == "tiered":
        assert t.points.is_tiered and not t.points.store.pinned
        assert t.points.cache.capacity == j.points.cache.capacity
    t.save(CheckpointManager(str(tmp_path / "t")))
    back = JL.LiveIndex.restore(JCheckpointManager(str(tmp_path / "t")))
    _assert_same(t, back)
    assert CheckpointManager(str(tmp_path / "t")).manifest()["extra"] == \
        JCheckpointManager(str(tmp_path / "j")).manifest()["extra"]


def test_jax_wal_and_checkpoint_replay_in_the_port(tmp_path, int_rig, monkeypatch):
    """JAX's victim (the masked step) logs a stream, checkpoints mid-way and
    crashes with a torn record; the port restores JAX's checkpoint and
    replays JAX's log to the state of JAX's uninterrupted index, bit for
    bit, then takes new appends on it."""
    monkeypatch.setattr(jlive_index, "insert_batch_step", _masked_insert_batch_step)
    victim = _jax_live(int_rig)
    victim.attach_wal(_wal(tmp_path, cls=JWriteAheadLog))
    cm = JCheckpointManager(str(tmp_path / "ck"))
    ops = _int_mutations(0)
    for i, (op, arg) in enumerate(ops):
        _apply(victim, op, arg)
        if i == len(ops) // 2:
            victim.save(cm)
    with open(str(tmp_path / "wal.bin"), "ab") as f:
        f.write(jax_encode_record(victim.wal_seq + 1, "consolidate", {})[:9])
    recovered = LiveIndex.restore(CheckpointManager(str(tmp_path / "ck")),
                                  wal=_wal(tmp_path), device="cpu")
    _assert_same(recovered, victim)
    recovered.insert(np.ones((1, D), np.float32))
    assert _wal(tmp_path, cls=JWriteAheadLog).last_seq == victim.wal_seq + 1


# ---------------------------------------------------------------------------
# the reference's crash-recovery tests (tests/test_fault.py), on the port
# ---------------------------------------------------------------------------

def _pts(seed, n=96):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, D)).astype(np.float32) * 3
    return (centers[rng.integers(0, 4, n)]
            + rng.standard_normal((n, D)).astype(np.float32) * 0.3)


def _mk_live(pts):
    return LiveIndex.create(pts, LiveConfig(**LCFG), BuildConfig(**BCFG), metric="l2",
                            device="cpu")


def _mutations(seed, n_ops=12):
    rng = np.random.default_rng(seed + 1000)
    ops = []
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.55:
            ops.append(("insert", rng.standard_normal((int(rng.integers(1, 5)), D))
                        .astype(np.float32)))
        elif roll < 0.9:
            ops.append(("delete", rng.integers(0, 120, size=int(rng.integers(1, 4)))
                        .astype(np.int64)))
        else:
            ops.append(("consolidate", None))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crash_recovery_bit_identical(tmp_path, seed):
    """A mutation stream with a checkpoint mid-way, a crash with a torn
    record: checkpoint + WAL restore to a state bit-identical to an
    uninterrupted control, which answers queries identically; a second
    crash cycle from there stays consistent."""
    from repro_torch.core import RangeConfig, SearchConfig
    pts = _pts(seed)
    ops = _mutations(seed)
    control, victim = _mk_live(pts), _mk_live(pts)
    victim.attach_wal(_wal(tmp_path))
    cm = CheckpointManager(str(tmp_path / "ck"))
    for i, (op, arg) in enumerate(ops):
        _apply(control, op, arg)
        _apply(victim, op, arg)
        if i == len(ops) // 2:
            victim.save(cm)
    seq_durable = victim.wal_seq
    with open(str(tmp_path / "wal.bin"), "ab") as f:
        f.write(encode_record(seq_durable + 1, "consolidate", {})[:9])
    recovered = LiveIndex.restore(cm, wal=_wal(tmp_path), device="cpu")
    _assert_same(recovered, control, wal_seq=False)
    assert recovered.wal_seq == seq_durable
    cfg = RangeConfig(search=SearchConfig(beam=16, max_beam=16, visit_cap=64),
                      mode="greedy", result_cap=128)
    qs = pts[:8] + 0.01
    ra, rb = control.range(qs, 2.0, cfg=cfg), recovered.range(qs, 2.0, cfg=cfg)
    assert torch.equal(ra.ids, rb.ids) and torch.equal(ra.dists, rb.dists)
    recovered.insert(np.ones((1, D), np.float32))
    control.insert(np.ones((1, D), np.float32))
    again = LiveIndex.restore(cm, wal=_wal(tmp_path), device="cpu")
    _assert_same(again, control, wal_seq=False)
    assert torch.equal(corpus_raw(again.points), corpus_raw(control.points))


def test_wal_checkpoint_prune_cycle(tmp_path):
    pts = _pts(7)
    ops = _mutations(7, n_ops=10)
    control, victim = _mk_live(pts), _mk_live(pts)
    wal = _wal(tmp_path)
    victim.attach_wal(wal)
    cm = CheckpointManager(str(tmp_path / "ck"))
    for op, arg in ops[:5]:
        _apply(control, op, arg)
        _apply(victim, op, arg)
    victim.save(cm)
    wal.prune_through(victim.wal_seq)
    for op, arg in ops[5:]:
        _apply(control, op, arg)
        _apply(victim, op, arg)
    recovered = LiveIndex.restore(cm, wal=_wal(tmp_path), device="cpu")
    _assert_same(recovered, control, wal_seq=False)
    _assert_same(recovered, victim)


def test_failed_insert_is_never_logged(tmp_path):
    idx = _mk_live(_pts(3))
    wal = _wal(tmp_path)
    idx.attach_wal(wal)
    with pytest.raises(ValueError, match="capacity"):
        idx.insert(np.zeros((200, D), np.float32))
    assert wal.last_seq == -1 and idx.wal_seq == 0 and idx.epoch == 0
    with pytest.raises(ValueError, match="already present"):
        idx.insert(np.zeros((1, D), np.float32), ext_ids=np.asarray([0], np.int64))
    assert wal.last_seq == -1
    assert idx.delete(np.asarray([5000])) == 0 and wal.last_seq == -1   # nothing to do
    assert idx.consolidate()["reclaimed"] == 0 and wal.last_seq == -1


def test_insert_internal_consolidation_is_not_logged(tmp_path):
    """An insert that needs tombstoned slots consolidates inside itself;
    only the insert is logged, and its replay reproduces the consolidation."""
    pts = _pts(5)
    cm = CheckpointManager(str(tmp_path / "ck"))
    idx = _mk_live(pts)
    idx.attach_wal(_wal(tmp_path))
    idx.save(cm)
    idx.delete(np.arange(60))
    idx.insert(np.random.default_rng(0).standard_normal((120, D)).astype(np.float32))
    assert [r.op for r in _wal(tmp_path).replay()] == ["delete", "insert"]
    assert idx.epoch == 3 and idx.live_count == 156
    _assert_same(LiveIndex.restore(cm, wal=_wal(tmp_path), device="cpu"), idx)
