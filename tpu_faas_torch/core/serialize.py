"""Object <-> string serialization for functions, params, results, and messages.

Capability contract (reference helper_functions.py:5-9): any Python object is
dill-pickled and base64-encoded into a plain ASCII string; the inverse decodes.
Everything on the wire — registered functions, call params, results, and every
ZMQ message body — travels as such strings. A deliberate consequence (reference
SURVEY §3.3): because payloads cross multiprocessing pipes as *strings*, lambdas
and closures survive the pool boundary even though the stdlib pickler used by
multiprocessing cannot pickle them directly.
"""

from __future__ import annotations

import base64
import pickle

import dill

#: leaf types the wire-envelope fast path accepts. Deliberately closed:
#: anything else (functions, arbitrary objects) must keep dill's
#: by-VALUE pickling — C-pickle would "succeed" on a module-level
#: function by REFERENCE, silently breaking the lambdas-survive-the-wire
#: capability contract above.
_WIRE_PRIMITIVES = (str, bytes, int, float, bool, type(None))


def _wire_safe(obj: object) -> bool:
    if isinstance(obj, _WIRE_PRIMITIVES):
        return True
    if isinstance(obj, (list, tuple)):
        return all(_wire_safe(x) for x in obj)
    if isinstance(obj, dict):
        return all(
            isinstance(k, _WIRE_PRIMITIVES) and _wire_safe(v)
            for k, v in obj.items()
        )
    return False


def dumps_wire(obj: object) -> bytes:
    """Pickle bytes for WIRE ENVELOPES ({type, data} message dicts whose
    payload leaves are already-serialized strings): the stdlib C pickler
    when every leaf is a primitive — two orders of magnitude faster than
    dill, which pins the pure-Python pickler — and dill for anything
    else. Either way the output is a standard pickle stream, so
    ``dill.loads`` (every decoder in the fleet, reference-era workers
    included) reads both identically. Profiled at the config-9 bench
    shape, per-frame dill encode was the single largest host cost of the
    serve loop; this fast path removes it without touching the contract.

    The primitive walk costs a few microseconds against the ~200us dill
    encode it replaces; the closed type set (see _WIRE_PRIMITIVES) is
    what keeps function payloads on dill's by-value semantics."""
    if _wire_safe(obj):
        return pickle.dumps(obj, protocol=4)
    return dill.dumps(obj, recurse=True)


def serialize(obj: object) -> str:
    """Serialize any Python object to an ASCII-safe string (dill -> base64)."""
    return base64.b64encode(dill.dumps(obj, recurse=True)).decode("ascii")


def serialize_wire(obj: object) -> str:
    """ASCII form of :func:`dumps_wire` — same base64 envelope as
    :func:`serialize`, decoded by the same :func:`deserialize`."""
    return base64.b64encode(dumps_wire(obj)).decode("ascii")


def deserialize(payload: str) -> object:
    """Inverse of :func:`serialize`.

    Raises whatever dill/base64 raise on malformed input; callers that need
    the catch-all FAILED semantics wrap this (see core.executor.execute_fn).
    """
    return dill.loads(base64.b64decode(payload.encode("ascii")))
