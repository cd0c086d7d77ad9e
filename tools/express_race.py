"""Attribute the express lane's inline count under load (ROADMAP C.12).

    python3 tools/express_race.py NAME [--tree DIR] [--no-hold]
                                       [--rounds 4] [--procs 6]
                                       [--spinners 8] [--threads 0]

Copies the checkout (or ``--tree DIR``, say a parent commit unpacked with
``git archive``) into ``chiprun_out/express_race/NAME/tree`` (a directory
``.gitignore`` lists) and adds a timeline log to the copy's
two packages: the client's submit, the gateway arming the long-poll
(``get_parked``), the result announce reaching the gateway, the path that
served the result (inline or store), and the dispatcher's store write of
the result. ``--no-hold`` runs the copy's tpu-push express twin without
its ``_hold_results_until_read`` setup. Then it runs the load recipe:
``--rounds`` rounds of ``--procs`` pytest processes, each running
``tests/test_express_lane.py::test_tpu_push_express_e2e_inline_delivery``
and its twin once, beside ``--spinners`` processes spinning in Python
(and ``--threads`` threads spinning inside each pytest process).

Prints, per case: the failed runs; the counted requests (the first five
of each run) served from the store; those whose result was written
before the gateway's first store read of the task; the median and 90th
percentile of the write's time after the submit returned; and the
store-served share in bins of that time. Equal shares in equal bins
mean the count follows the round trip's speed, the test's own race, not
a fault of one dispatcher. Writes ``timeline.json`` beside the copy.
Every number is a CPU measurement of the machine it runs on, not a device
metric. Nothing of the checkout outside ``chiprun_out/`` is modified.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CASES = tuple(f"tests/{f}::test_tpu_push_express_e2e_inline_delivery"
              for f in ("test_express_lane.py",
                        "test_torch_twin_express_lane.py"))
BINS = (0.0, 2.0, 4.0, 6.0, 10.0)  # ms after the submit returned

LOG = '''

def _tl(ev, tid, **kw):
    import json as _j, os as _o, time as _t
    p = _o.environ.get("TL_FILE")
    if p:
        with open(p, "a") as f:
            f.write(_j.dumps({"t": _t.time(), "ev": ev, "tid": tid,
                              "pkg": __name__, **kw}) + "\\n")
'''

#: (file in each package, [(anchor, replacement)])
PATCHES = (
    ("client/sdk.py", [(
        "        body = self._execute(function_id, payload)\n",
        "        _t0 = __import__('time').time()\n"
        "        body = self._execute(function_id, payload)\n"
        "        _tl('submit', body['task_id'], t_start=_t0)\n")]),
    ("gateway/app.py", [
        ("        if waiters is not None and wait_s > 0\n"
         "        else None\n    )\n",
         "        if waiters is not None and wait_s > 0\n"
         "        else None\n    )\n"
         "    _tl('get_parked', task_id, armed=waiter is not None)\n"),
        ("        task_id, status, result = decode_result_announce(payload)\n",
         "        task_id, status, result = decode_result_announce(payload)\n"
         "        _tl('announce_rx', task_id)\n"),
        ("    ctx.m_result_served.labels(source=source).inc()\n",
         "    ctx.m_result_served.labels(source=source).inc()\n"
         "    _tl('served', task_id, source=source)\n")]),
    ("store/client.py", [
        ("        cmds = self._finish_cmds(\n",
         "        _tl('finish_write', task_id)\n"
         "        cmds = self._finish_cmds(\n"),
        ("        if not items:\n            return\n"
         "        # digest-form items",
         "        if not items:\n            return\n"
         "        for _it in items:\n"
         "            _tl('finish_write', _it[0])\n"
         "        # digest-form items")]),
)
NO_HOLD = ('overrides={"_hold_results_until_read": _hold_results_until_read}',
           'overrides={"_hold_results_until_read": lambda d, g: d}')


def replace_once(path: Path, anchor: str, new: str) -> None:
    s = path.read_text()
    if s.count(anchor) != 1:
        raise SystemExit(f"{path}: the anchor {anchor!r} is not unique")
    path.write_text(s.replace(anchor, new))


def make_copy(src: Path, tree: Path, no_hold: bool) -> None:
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(src, tree, ignore=shutil.ignore_patterns(
        ".git", "chiprun_out", "__pycache__"))
    for rel, reps in PATCHES:
        for pkg in ("tpu_faas", "tpu_faas_torch"):
            path = tree / pkg / rel
            for anchor, new in reps:
                replace_once(path, anchor, new)
            path.write_text(path.read_text() + LOG)
    if no_hold:
        replace_once(tree / "tests/test_torch_twin_express_lane.py",
                     *NO_HOLD)
    (tree / "spin_threads.py").write_text(
        "import os, threading\n\n\ndef _spin():\n    while True:\n"
        "        pass\n\n\ndef pytest_configure(config):\n"
        "    for _ in range(int(os.environ.get('SPIN_THREADS', '0'))):\n"
        "        threading.Thread(target=_spin, daemon=True).start()\n")


def run_recipe(tree: Path, out: Path, args) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SPIN_THREADS=str(args.threads), PYTHONPATH=str(tree))
    for r in range(args.rounds):
        spinners = [subprocess.Popen([sys.executable, "-c",
                                      "while True: pass"])
                    for _ in range(args.spinners)]
        procs, t0 = [], time.time()
        try:
            for i in range(args.procs):
                tag = f"r{r}p{i}"
                with open(out / f"{tag}.log", "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "pytest", *CASES, "-q",
                         "-p", "no:cacheprovider", "-p", "no:randomly",
                         "-p", "spin_threads",
                         f"--junitxml={out}/{tag}.xml"],
                        cwd=tree, stdout=log, stderr=subprocess.STDOUT,
                        env=dict(env,
                                 TL_FILE=str(out / f"tl_{tag}.jsonl"))))
            for p in procs:
                p.wait()
        finally:
            for s in spinners:
                s.kill()
                s.wait()
        print(f"round {r}: {time.time() - t0:.1f} s", flush=True)


def read(out: Path) -> list[dict]:
    rows = []
    for x in sorted(glob.glob(f"{out}/r*p*.xml")):
        tag = Path(x).stem
        failed = {("twin" in tc.get("classname")):
                  tc.find("failure") is not None
                  or tc.find("error") is not None
                  for tc in ET.parse(x).getroot().iter("testcase")}
        tl = out / f"tl_{tag}.jsonl"
        ev = ([json.loads(line) for line in tl.open()] if tl.exists()
              else [])
        for twin in (False, True):
            mine = [e for e in ev
                    if e["pkg"].startswith("tpu_faas_torch.") == twin]
            for i, s in enumerate([e for e in mine
                                   if e["ev"] == "submit"][:5]):
                def at(name):
                    t = [e["t"] for e in mine
                         if e["ev"] == name and e["tid"] == s["tid"]]
                    return 1e3 * (t[0] - s["t"]) if t else None

                served = [e["source"] for e in mine
                          if e["ev"] == "served" and e["tid"] == s["tid"]]
                rows.append(dict(
                    run=tag, case="twin" if twin else "jax", i=i,
                    failed=failed.get(twin), park_ms=at("get_parked"),
                    write_ms=at("finish_write"),
                    served=served[0] if served else None))
    return rows


def report(rows: list[dict]) -> None:
    for case in ("jax", "twin"):
        rs = [r for r in rows if r["case"] == case]
        runs = {r["run"]: r["failed"] for r in rs}
        timed = sorted((r for r in rs if r["write_ms"] is not None),
                       key=lambda r: r["write_ms"])
        w = [r["write_ms"] for r in timed]
        early = [r for r in timed if r["park_ms"] is not None
                 and r["write_ms"] <= r["park_ms"]]
        bins = []
        for lo, hi in zip((-float("inf"),) + BINS, BINS + (float("inf"),)):
            b = [r for r in timed if lo <= r["write_ms"] < hi]
            bins.append(f"[{lo:g}, {hi:g}) ms "
                        f"{sum(r['served'] == 'store' for r in b)}/{len(b)}")
        print(json.dumps({
            "case": case, "runs": len(runs),
            "failed": sum(bool(f) for f in runs.values()),
            "counted": len(rs),
            "served_from_store": sum(r["served"] == "store" for r in rs),
            "written_before_park": len(early),
            "written_before_park_served_from_store": sum(
                r["served"] == "store" for r in early),
            "write_after_submit_ms": {
                "median": w[len(w) // 2] if w else None,
                "p90": w[int(0.9 * len(w))] if w else None},
            "store_served_by_write_ms": bins,
        }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name")
    ap.add_argument("--tree", type=Path, default=REPO)
    ap.add_argument("--no-hold", action="store_true")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--spinners", type=int, default=8)
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args()
    out = REPO / "chiprun_out" / "express_race" / args.name
    out.mkdir(parents=True, exist_ok=True)
    tree = out / "tree"
    make_copy(args.tree.resolve(), tree, args.no_hold)
    runs = out / "runs"
    shutil.rmtree(runs, ignore_errors=True)
    runs.mkdir()
    run_recipe(tree, runs, args)
    rows = read(runs)
    (out / "timeline.json").write_text(json.dumps(rows, indent=0))
    report(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
