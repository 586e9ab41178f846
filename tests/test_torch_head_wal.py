"""The head's mutation WAL in the port (``_private/wal.py``): the unit
cases of ``test_head_wal.py``, and the port's WAL files read by the
reference's reader and the other way round (the format is the
reference's).

The reference's kill -9 case starts its head through the CLI
(``python -m ray_tpu start --head``); its port is
``tests/test_torch_cli.py::test_mutations_survive_kill9``.
"""
from ray_tpu_torch._private.wal import HeadWAL
from torch_runtime import case_time_limit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def test_wal_roundtrip(tmp_path):
    w = HeadWAL(str(tmp_path))
    w.open_active()
    w.append({"op": "kv_put", "ns": "n", "key": "k", "value": b"v"})
    w.append({"op": "pg_remove", "pg_id": "ab" * 14})
    w.close()
    r = HeadWAL(str(tmp_path))
    recs = list(r.replay_from(0))
    assert [x["op"] for x in recs] == ["kv_put", "pg_remove"]
    assert recs[0]["value"] == b"v"


def test_wal_roll_and_drop(tmp_path):
    w = HeadWAL(str(tmp_path))
    w.open_active()
    w.append({"op": "a"})
    gen = w.roll()  # snapshot boundary
    w.append({"op": "b"})
    # replay from the snapshot's stamp sees only post-roll records
    assert [x["op"] for x in w.replay_from(gen)] == ["b"]
    w.drop_below(gen)
    assert w.existing_gens() == [gen]
    w.close()


def test_wal_torn_tail_tolerated(tmp_path):
    w = HeadWAL(str(tmp_path))
    w.open_active()
    w.append({"op": "good1"})
    w.append({"op": "good2"})
    w.close()
    path = w._path(w.gen)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-3])  # kill -9 mid-append: torn final frame
    recs = [x["op"] for x in HeadWAL(str(tmp_path)).replay_from(0)]
    assert recs == ["good1"]


def test_wal_crosses_packages(tmp_path):
    from ray_tpu._private.wal import HeadWAL as RefWAL

    recs = [{"op": "kv_put", "ns": "n", "key": "k", "value": b"v"},
            {"op": "actor_register", "name": "a", "n": 3}]
    for writer, reader, sub in ((HeadWAL, RefWAL, "p2r"),
                                (RefWAL, HeadWAL, "r2p")):
        d = str(tmp_path / sub)
        w = writer(d)
        w.open_active()
        for r in recs:
            w.append(r)
        w.close()
        assert list(reader(d).replay_from(0)) == recs
