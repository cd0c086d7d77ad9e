"""The port's copied host layers held against the JAX package across the
wire.

The port's dispatcher will talk to the JAX package's unmodified store,
gateway and workers, so these bytes are what users depend on: worker
messages in both framings, RESP commands, serialized payloads, task
records, a store session in both directions, the metrics exposition, and
the estimator's and quarantine book's answers after the same sequences.
"""

import importlib

import numpy as np
import pytest

import tpu_faas.core.columns as j_columns
import tpu_faas.core.task as j_task
import tpu_faas.obs.metrics as j_metrics
import tpu_faas.sched.estimator as j_est
import tpu_faas.sched.health as j_health
import tpu_faas.store.client as j_client
import tpu_faas.store.launch as j_launch
import tpu_faas.store.resp as j_resp
import tpu_faas.worker.messages as j_msg
import tpu_faas_torch.core.columns as t_columns
import tpu_faas_torch.core.task as t_task
import tpu_faas_torch.obs.metrics as t_metrics
import tpu_faas_torch.sched.estimator as t_est
import tpu_faas_torch.sched.health as t_health
import tpu_faas_torch.store.client as t_client
import tpu_faas_torch.store.launch as t_launch
import tpu_faas_torch.store.resp as t_resp
import tpu_faas_torch.worker.messages as t_msg

# the package exports a function named like the module
j_ser = importlib.import_module("tpu_faas.core.serialize")
t_ser = importlib.import_module("tpu_faas_torch.core.serialize")


def _square(x):
    return x * x


_PAYLOAD = j_ser.serialize(((41,), {"k": [1, 2.5, None]}))
_MESSAGES = [
    (j_msg.REGISTER, dict(num_processes=4, caps=list(j_msg.WORKER_CAPS))),
    (j_msg.REGISTER, dict(worker_id="w-7")),
    (j_msg.HEARTBEAT, {}),
    (j_msg.RECONNECT, dict(free_processes=2)),
    (j_msg.TASK, dict(task_id="t1", fn_payload=j_ser.serialize(_square),
                      param_payload=_PAYLOAD, timeout=2.5)),
    (j_msg.TASK, dict(task_id="t2", fn_digest="ab" * 32,
                      param_payload=_PAYLOAD, trace_id="0" * 32)),
    (j_msg.TASK_BATCH, dict(tasks=[dict(task_id="a", fn_payload="F",
                                        param_payload="P")] * 3)),
    (j_msg.RESULT, dict(task_id="t1", status="COMPLETED", result="UjE=",
                        elapsed=0.125, started_at=1.7e9, misfires=0)),
    (j_msg.RESULT_BATCH, dict(results=[dict(task_id="a", status="FAILED",
                                            result="x")], misfires=1)),
    (j_msg.CANCEL, dict(task_id="t1")),
    (j_msg.WAIT, dict(cancel_ids=["t3", "t4"])),
    (j_msg.BLOB_MISS, dict(digest="cd" * 32)),
    (j_msg.BLOB_FILL, dict(digest="cd" * 32, body="Qk9EWQ==")),
    (j_msg.DEREGISTER, {}),
]


@pytest.mark.parametrize("framing", ["encode", "encode_bin"])
@pytest.mark.parametrize("k", range(len(_MESSAGES)))
def test_worker_messages_are_byte_equal_and_cross_decode(framing, k):
    msg_type, data = _MESSAGES[k]
    t_raw = getattr(t_msg, framing)(msg_type, **data)
    j_raw = getattr(j_msg, framing)(msg_type, **data)
    assert t_raw == j_raw
    assert t_msg.decode(j_raw) == j_msg.decode(t_raw) == (msg_type, data)
    assert t_msg.is_binary(t_raw) == (framing == "encode_bin")
    assert t_msg.caps_of(data) == j_msg.caps_of(data)


def test_message_vocabulary_is_the_same():
    names = [n for n in dir(j_msg) if n.isupper()]
    assert names == [n for n in dir(t_msg) if n.isupper()]
    for n in names:
        assert getattr(t_msg, n) == getattr(j_msg, n), n


@pytest.mark.parametrize("parts", [
    ("PING",),
    ("HSET", "task:1", "status", "QUEUED", "fn_payload", "RjE="),
    ("HGETALL", b"raw\r\nbytes"),
    ("HINCRBY", "k", "f", -3),
    ("PUBLISH", "tasks", "é unicode"),
])
def test_resp_encode_command_is_byte_equal(parts):
    raw = t_resp.encode_command(*parts)
    assert raw == j_resp.encode_command(*parts)
    p, q = t_resp.RespParser(), j_resp.RespParser()
    p.feed(raw)
    q.feed(raw)
    assert p.pop() == q.pop()


@pytest.mark.parametrize("obj", [
    None, 7, "text", [1, (2, 3), {"a": b"bytes"}], ((41,), {}), _square,
    lambda x, y=2: x + y,
], ids=["none", "int", "str", "nested", "params", "function", "lambda"])
def test_serialize_in_one_package_deserialize_in_the_other(obj):
    t_wire, j_wire = t_ser.serialize(obj), j_ser.serialize(obj)
    assert t_wire == j_wire
    for back in (j_ser.deserialize(t_wire), t_ser.deserialize(j_wire)):
        if callable(obj):
            assert back(3) == obj(3)
        else:
            assert back == obj
    envelope = {"type": "x", "data": {"v": obj}}
    assert t_ser.serialize_wire(envelope) == j_ser.serialize_wire(envelope)


def test_task_records_are_the_same():
    for status in j_task.TaskStatus:
        t = t_task.Task("tid", t_task.TaskStatus(str(status)), "F", "P", "R")
        j = j_task.Task("tid", status, "F", "P", "R")
        assert t.to_fields() == j.to_fields()
        back = t_task.Task.from_fields("tid", j.to_fields())
        assert back.to_fields() == j.to_fields()
        assert t_task.TaskStatus(str(status)).is_terminal() == \
            status.is_terminal()
    field_names = [n for n in dir(j_task) if n.startswith("FIELD_")]
    assert field_names == [n for n in dir(t_task) if n.startswith("FIELD_")]
    for n in field_names:
        assert getattr(t_task, n) == getattr(j_task, n), n
    assert t_task.dep_done_field("p") == j_task.dep_done_field("p")
    assert t_task.claim_field_for(3) == j_task.claim_field_for(3)


def _flat(rng, k):
    f = j_task
    fields = [
        f.FIELD_FN, "F" * int(rng.integers(1, 40)),
        f.FIELD_PARAMS, "P" * int(rng.integers(1, 40)),
        f.FIELD_PRIORITY, str(int(rng.integers(-2**40, 2**40))),
        f.FIELD_COST, rng.choice(["1.5", "-3", "nan", "inf", "bogus", ""]),
        f.FIELD_TIMEOUT, rng.choice(["2.0", "0", "x"]),
        f.FIELD_SUBMITTED_AT, "1700000000.25",
        f.FIELD_DEADLINE, rng.choice(["1700000100", ""]),
        f.FIELD_FN_DIGEST, rng.choice(["", "ab" * 32]),
        f.FIELD_TRACE_ID, rng.choice(["", "1" * 32]),
        f.FIELD_TENANT, rng.choice(["", "acme"]),
        f.FIELD_SLO_CLASS, rng.choice(["", "interactive", "batch"]),
        f.FIELD_SPECULATIVE, rng.choice(["1", "0"]),
    ]
    if k % 2:
        fields = [x.encode() for x in fields]
    return fields


def test_task_columns_parse_the_same_records():
    rng = np.random.default_rng(0)
    arenas = [t_columns.TaskColumns(capacity=64),
              j_columns.TaskColumns(capacity=64)]
    rows = [[], []]
    for k in range(40):
        flat = _flat(rng, k)
        for a, out in zip(arenas, rows):
            out.append(a.intake_flat(f"t{k}", list(flat)))
    idx = np.asarray([r.row for r in rows[1]], np.int64)
    assert [r.row for r in rows[0]] == idx.tolist()
    for name in ("gather_sizes", "gather_priorities", "gather_deadlines"):
        np.testing.assert_array_equal(getattr(arenas[0], name)(idx),
                                      getattr(arenas[1], name)(idx))
    for tr, jr in zip(*rows):
        for blob in (False, True):
            for trace in (False, True):
                assert tr.task_message_kwargs(blob, trace) == \
                    jr.task_message_kwargs(blob, trace)
        assert tr.effective_class == jr.effective_class
        assert tr.size_estimate == jr.size_estimate


def _store_script(s, status) -> list:
    """One scripted session of store operations; returns every answer."""
    out = []
    sub = s.subscribe("tasks")
    try:
        s.hset("h1", {"a": "1", "b": "two"})
        out += [s.hgetall("h1"), s.hget("h1", "a"), s.hget("h1", "zz")]
        s.hdel("h1", "a")
        out.append(s.hgetall("h1"))
        s.create_task("t1", "F1", "P1")
        out += [sub.get_message(timeout=5.0), s.get_status("t1")]
        s.create_tasks([("t2", "F2", "P2"),
                        ("t3", "F3", "P3", {"priority": "5"})])
        out.append([sub.get_message(timeout=5.0) for _ in range(2)])
        out.append(s.hgetall_many(["t1", "t2", "t3", "nope"]))
        s.set_status("t2", status.RUNNING)
        out.append(s.get_status("t2"))
        out.append(s.finish_task("t2", status.COMPLETED, "R2"))
        out += [s.get_result("t2"), s.cancel_task("t3"), s.get_status("t3")]
        out += [s.hincrby("cnt", "x", 3), s.hincrby("cnt", "x", -1)]
        out += [s.put_blob("d1", "DATA"), s.put_blob("d1", "DATA"),
                s.get_blobs(["d1", "d2"])]
        out.append(s.create_tasks_if_absent([("t1", "F", "P"),
                                             ("t9", "F9", "P9")]))
        out.append(s.hmget("t9", ["fn_payload", "param_payload", "nope"]))
        s.delete("h1")
        out.append(sorted(k for k in s.keys() if not k.startswith("__")))
    finally:
        sub.close()
    # the records' own timestamps differ between runs
    return [_drop_stamps(x) for x in out]


def _drop_stamps(x):
    if isinstance(x, dict):
        return {k: v for k, v in x.items() if not k.endswith("_at")}
    if isinstance(x, list):
        return [_drop_stamps(v) for v in x]
    return x


def _session(client_mod, launch_mod, task_mod):
    handle = launch_mod.start_store_thread()
    try:
        store = client_mod.RespStore(port=handle.port)
        try:
            return _store_script(store, task_mod.TaskStatus)
        finally:
            store.close()
    finally:
        handle.stop()


def test_resp_store_sessions_answer_alike_in_both_directions():
    reference = _session(j_client, j_launch, j_task)
    port_client = _session(t_client, j_launch, t_task)
    port_server = _session(j_client, t_launch, j_task)
    assert port_client == reference
    assert port_server == reference
    # the session did what it says: announces came, statuses moved
    assert reference[4:7] == ["t1", "QUEUED", ["t2", "t3"]]
    assert reference[10:13] == [("COMPLETED", "R2"), "CANCELLED", "CANCELLED"]


def _observe(m):
    reg = m.MetricsRegistry()
    c = reg.counter("tpu_faas_things_total", "Things", ("kind",))
    g = reg.gauge("tpu_faas_level", "Level")
    h = reg.histogram("tpu_faas_latency_seconds", "Latency",
                      buckets=m.LATENCY_BUCKETS)
    c.labels(kind="a").inc()
    c.labels(kind='b"q\\').inc(2.5)
    g.set(-3.25)
    for v in (0.0001, 0.003, 0.2, 7.0, 1e9):
        h.observe(v)
    return m.render([reg])


def test_metrics_exposition_text_is_the_same():
    assert _observe(t_metrics) == _observe(j_metrics)


def test_estimator_predictions_are_equal_after_the_same_sequence():
    rng = np.random.default_rng(3)
    ests = [t_est.RuntimeEstimator(), j_est.RuntimeEstimator()]
    wids = [f"w{i}".encode() for i in range(6)]
    fns = [t_est.fn_digest(f"fn{i}") for i in range(4)]
    assert fns == [j_est.fn_digest(f"fn{i}") for i in range(4)]
    for _ in range(300):
        fn = fns[int(rng.integers(4))]
        w = wids[int(rng.integers(6))]
        pd = None if rng.random() < 0.5 else f"p{int(rng.integers(3))}"
        pb = None if pd is None else int(rng.integers(10, 10_000))
        elapsed = float(rng.choice([rng.uniform(0.01, 2.0), 0.0, np.nan]))
        for e in ests:
            e.observe(fn, elapsed, w, param_digest=pd, param_bytes=pb)
    for fn in fns + ["unseen"]:
        for pd, pb in ((None, None), ("p1", 500), ("p9", 50_000)):
            assert ests[0].size_for(fn, pd, pb) == ests[1].size_for(fn, pd, pb)
    for w in wids + [b"new"]:
        assert ests[0].speed_for(w) == ests[1].speed_for(w)
    assert ests[0].default_size() == ests[1].default_size()


def test_quarantine_place_cap_is_equal_after_the_same_sequence():
    rng = np.random.default_rng(4)
    t = [100.0]
    books = [
        mod.QuarantineBook(max_workers=12, release_streak=2,
                           canary_period_s=1.5, clock=lambda: t[0])
        for mod in (t_health, j_health)
    ]
    health = np.ones(12, np.float32)
    active = np.ones(12, bool)
    procs = rng.integers(1, 5, 12).astype(np.int32)
    for _ in range(60):
        t[0] += float(rng.uniform(0.1, 1.0))
        k = int(rng.integers(12))
        health[k] = np.float32(rng.choice([0.1, 0.3, 0.6, 0.9, 1.0]))
        active[int(rng.integers(12))] = rng.random() < 0.9
        events = [b.update(health, active, procs) for b in books]
        assert events[0] == events[1]
        np.testing.assert_array_equal(books[0].place_cap(),
                                      books[1].place_cap())
    assert books[0].stats() == books[1].stats()
    assert books[1].entered_total > 0
