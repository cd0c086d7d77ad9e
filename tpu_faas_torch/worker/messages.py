"""Wire envelope for dispatcher <-> worker ZMQ messages.

Same shape as the reference's vocabulary (SURVEY §2.3): every payload is a
dict ``{"type": ..., "data": {...}}`` run through the core serializer, so
arbitrary Python values (including results that are themselves serialized
strings) travel safely.

Message vocabulary:

worker -> dispatcher:
    REGISTER   data: worker_id (pull) | num_processes (push)
               [, caps: list[str] — protocol capabilities this worker
               understands: "blob" (digest-addressed TASK payloads +
               BLOB_MISS/BLOB_FILL resolution), "bin" (binary frames).
               Absent from reference-era workers, which therefore get the
               full inline-payload ASCII contract unchanged]
    RESULT     data: task_id, status, result [, elapsed: float — execution
               wall seconds measured in the pool child, feeding the
               dispatcher's runtime estimator; absent from reference-era
               workers and handled as such] [, started_at: float — epoch
               seconds the child began executing, measured at the source;
               with `elapsed` it gives the dispatcher's task timeline its
               exec_start/exec_end events (tpu_faas/obs/trace.py)]
               [, misfires: int — the pool's cumulative misfire-repair
               counter] [, no_task=True while draining
               (pull): the mandatory reply must be WAIT, never a new task]
    READY      (pull only) data: worker_id
    HEARTBEAT  (push hb) data: {}
    RECONNECT  (push hb) data: free_processes
    DEREGISTER (push) data: {} — graceful drain: stop assigning to me; my
               in-flight results still follow, then I exit

worker -> dispatcher (payload plane, "blob"-capable workers only):
    BLOB_MISS  data: digest [, worker_id — pull workers include it: their
               liveness is request-stamped, and a blob-fetch retry loop
               may be the only traffic they emit during an outage] — the
               worker holds tasks whose TASK message carried ``fn_digest``
               with no body and its payload cache missed; the dispatcher
               answers with BLOB_FILL. Push workers re-send on a timer
               while tasks stay parked (a FILL, like everything on this
               transport, can be lost); pull workers retry in place on
               their mandatory-reply socket.

dispatcher -> worker:
    TASK       data: task_id, fn_payload, param_payload [, timeout: float —
               execution budget the worker enforces in its pool child
               (SIGALRM); absent = unbounded, the reference contract]
               [, cancel_ids: list — pull only, see WAIT]
    WAIT       (pull only) [, cancel_ids: list — force-cancels for tasks
               THIS worker runs, piggy-backed on the mandatory reply
               because a REQ/REP worker cannot be pushed to; a saturated
               worker's keepalive transactions bound the delivery latency]
    RECONNECT  (push hb; request for the worker to re-announce itself)
    CANCEL     (push) data: task_id — force-cancel a dispatched task: the
               worker interrupts it mid-run (pool SIGUSR1, the externally
               triggered sibling of the timeout) or drops it pre-start,
               and ships a normal RESULT with status CANCELLED; a task
               that already finished just ships its real result. Best
               effort by design — reference-era workers ignore unknown
               message types and fields, and the record then converges
               via the ordinary result path.
    TASK (payload plane) may carry ``fn_digest`` INSTEAD of
               ``fn_payload`` when the worker registered the "blob"
               capability: the worker resolves the body from its payload
               cache, or parks the task and asks with BLOB_MISS.
    TASK (tracing) carries ``trace_id`` when the worker registered the
               "trace" capability (distributed trace context,
               tpu_faas/obs/tracectx.py); the worker stamps it into its
               logs and echoes it on the matching RESULT. Reference-era
               workers never receive the field.
    TASK_BATCH data: tasks: list — each element a full TASK ``data`` dict
               (task_id/fn_payload-or-fn_digest/param_payload/timeout/
               trace_id, exactly the per-task vocabulary above). ONE frame
               carries a whole tick's assignments for this worker, sent
               only to workers that advertised the "batch" capability and
               only by dispatchers with batching enabled (``--batch-max``
               >= 2) — everyone else keeps the per-task TASK contract
               byte for byte. Per-task semantics (blob resolution,
               parking, cancel, tracing) are element-wise identical to K
               separate TASK frames.
    RESULT_BATCH (worker -> dispatcher) data: results: list — each element
               a full RESULT ``data`` dict (task_id/status/result/elapsed/
               started_at/trace_id) — plus one top-level ``misfires``
               total. A worker switches to this form only after RECEIVING
               a TASK_BATCH (proof the dispatcher decodes it), the same
               asymmetric negotiation as binary framing; a K-result drain
               then costs one frame instead of K.
    BLOB_FILL  data: digest, data (the ASCII payload body) — answers a
               BLOB_MISS; ``missing=True`` (no data) when the blob is
               gone from the store too, telling the worker to FAIL the
               parked tasks instead of waiting forever.

result-blob plane ("rblob"-capable workers under ``--result-blobs``
dispatchers only; every field below is absent otherwise):
    TASK/TASK_BATCH elements may carry ``rblob_min`` (int, byte
               threshold): proof the dispatcher decodes digest-form
               results, and permission for THIS task's completed result to
               ship digest-only when it is at least that large (the
               dispatcher marks exactly the tasks whose results it knows
               to be graph-consumed). They may also carry parent results
               for graph children: ``dep_digests`` {parent_id: digest}
               for bodies the target worker's result cache should already
               hold (cache miss -> BLOB_MISS, exactly like fn blobs), and
               ``dep_results`` {parent_id: body} for cold targets (also
               the ``--dep-results`` store-mediated form). The worker
               exposes resolved parent bodies to the executing function
               via core/executor.py dep_results().
    RESULT/RESULT_BATCH elements may carry ``result_digest`` (sha256 hex)
               + ``result_size`` (int) INSTEAD of ``result``: the body
               stays in the worker's result cache under that digest, and
               the dispatcher records the digest-form terminal write. Only
               COMPLETED results ever ship digest-only — failures always
               carry their body (error payloads must stay materializable
               without the producing worker).
    BLOB_MISS  (dispatcher -> worker, the REVERSE direction) data: digest —
               asks the worker for a result body its cache holds; the
               worker answers with a BLOB_FILL (``missing=True`` when
               evicted). This is how a digest-only result is materialized
               into the store after the fact (lazy materialization for
               legacy readers, child-worker cache misses).

Framing: the reference contract is ASCII — base64(dill(message)) — and
stays the default. Peers that BOTH understand the "bin" capability switch
to raw binary frames (``_BIN_MAGIC`` + dill bytes, no base64: ~25% less
wire volume on every payload-carrying hop). Negotiation is asymmetric on
purpose: a worker advertises ``caps=["bin"]`` on its (always-ASCII)
REGISTER/RECONNECT, the dispatcher then frames everything to that worker
in binary, and the worker switches its own sends only after RECEIVING a
binary frame — proof the peer decodes them. ``decode`` sniffs the magic,
so mixed fleets (reference workers beside new ones) share one socket.
"""

from __future__ import annotations

import dill

from tpu_faas_torch.core.serialize import (
    deserialize,
    dumps_wire,
    serialize_wire,
)

REGISTER = "register"
DEREGISTER = "deregister"
RESULT = "result"
READY = "ready"
HEARTBEAT = "heartbeat"
RECONNECT = "reconnect"
TASK = "task"
TASK_BATCH = "task_batch"
RESULT_BATCH = "result_batch"
WAIT = "wait"
CANCEL = "cancel"
BLOB_MISS = "blob_miss"
BLOB_FILL = "blob_fill"

#: capability tokens carried in REGISTER/RECONNECT ``caps``
CAP_BLOB = "blob"
CAP_BIN = "bin"
#: distributed tracing: a trace-capable worker receives the task's
#: ``trace_id`` on TASK messages (stamped into its logs via log_ctx) and
#: echoes it on the matching RESULT. Capability-gated like blob/bin so
#: reference-era workers never see the field.
CAP_TRACE = "trace"
#: batched data plane: a batch-capable worker may receive TASK_BATCH
#: frames (one frame per worker per tick) and, once it has seen one,
#: coalesces its own result drain into RESULT_BATCH frames. Negotiated
#: like blob/bin/trace, and additionally gated dispatcher-side on
#: ``--batch-max`` — batching off means the per-task wire is untouched
#: even between capable peers.
CAP_BATCH = "batch"
#: result-blob plane: an rblob-capable worker keeps a byte-bounded RESULT
#: cache keyed by content digest and, for tasks whose TASK frame carried
#: ``rblob_min`` (the dispatcher's ``--result-blobs`` proof + threshold),
#: ships completed results >= that size as DIGEST-ONLY RESULT frames
#: (``result_digest``/``result_size``, no ``result`` body). It also
#: resolves parent-result digests on child TASK frames (``dep_digests``)
#: from that cache, and answers dispatcher->worker BLOB_MISS pulls from
#: it (the reverse of the function-blob flow — the dispatcher
#: materializes a body it never shipped). Negotiated like blob/bin/trace:
#: no rblob advertisement, or ``--result-blobs`` off, leaves every frame
#: byte-identical to the reference-era contract.
CAP_RESULT_BLOB = "rblob"
#: what a current-generation worker advertises
WORKER_CAPS = (CAP_BLOB, CAP_BIN, CAP_TRACE, CAP_BATCH, CAP_RESULT_BLOB)

#: binary-frame magic: never a valid first byte of the ASCII contract
#: (base64's alphabet is [A-Za-z0-9+/=]), so one-byte sniffing is exact
_BIN_MAGIC = b"\x00TF1"


def encode(msg_type: str, **data: object) -> bytes:
    """The reference ASCII contract: base64(pickle({type, data})).

    The envelope pickles through the C fast path when every leaf is a
    primitive (the whole documented vocabulary — payload bodies are
    already-serialized strings by the time they reach the envelope) and
    through dill otherwise; both are standard pickle streams, so every
    decoder — reference-era dill.loads included — reads them identically
    (core/serialize.dumps_wire)."""
    return serialize_wire({"type": msg_type, "data": data}).encode("ascii")


def encode_bin(msg_type: str, **data: object) -> bytes:
    """Binary frame: magic + raw pickle bytes — skips the ~33% base64
    inflation on internal hops. Send only to peers that negotiated
    CAP_BIN (see the module docstring). Same C-pickler envelope fast
    path as :func:`encode`."""
    return _BIN_MAGIC + dumps_wire({"type": msg_type, "data": data})


def encode_for(bin_capable: bool, msg_type: str, **data: object) -> bytes:
    """Frame for a specific peer: binary when negotiated, ASCII else."""
    if bin_capable:
        return encode_bin(msg_type, **data)
    return encode(msg_type, **data)


def is_binary(raw: bytes) -> bool:
    return raw.startswith(_BIN_MAGIC)


def decode(raw: bytes) -> tuple[str, dict]:
    """Decode either framing (magic-sniffed)."""
    if raw.startswith(_BIN_MAGIC):
        msg = dill.loads(raw[len(_BIN_MAGIC):])
    else:
        msg = deserialize(raw.decode("ascii"))
    if not isinstance(msg, dict) or "type" not in msg:
        raise ValueError(f"malformed worker message: {msg!r}")
    return msg["type"], msg.get("data", {})


def caps_of(data: dict) -> frozenset[str]:
    """The capability set a REGISTER/RECONNECT payload advertises;
    empty for reference-era workers (and anything malformed)."""
    raw = data.get("caps")
    if not isinstance(raw, (list, tuple)):
        return frozenset()
    return frozenset(c for c in raw if isinstance(c, str))
