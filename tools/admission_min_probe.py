"""Probe of B1's tenancy admission key with a block minimum (ROADMAP C.1).

The first design of the fair-order key keyed the priority pass by
``-eff_prio`` minus its block minimum. This script rebuilds that key on a
copy of ``tpu_faas_torch/csrc`` (written under the git-ignored
``tpu_faas_torch/csrc/build/admission_min_probe/``), with both passes
instrumented: each records, per eligible position, the key and the deficit
bits it read, and each thread its own minimum and the block minimum, into a
device buffer. It then runs the first 8 ticks of ``chip_smoke.py``'s
resident tenancy rank loop on that copy (every launch replayed through the
plain version and compared) and prints what the two passes saw in the last
launch. Needs a CUDA device:

    python3 tools/admission_min_probe.py
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_OLD = '''  for (int i = tid; i < n_elig; i += NT) {
    const int t = sc.tv[b1][i];
    const int g = tenant_row(tn, t);
    const int prio = D.use_priority ? st.prio[t] : 0;
    const int boost = tn.deficit[g] >= tn.starve_deficit ? tn.starve_boost : 0;
    k2[0][i] = int_key(wrap_sub(0, wrap_add(prio, boost)));
    v2[0][i] = t;
  }'''

_PASS = '''    const int t = sc.tv[b1][i];
    const int g = tenant_row(tn, t);
    const int prio = D.use_priority ? st.prio[t] : 0;
    const float dfc = tn.deficit[g];
    const int boost = dfc >= tn.starve_deficit ? tn.starve_boost : 0;
    const int key = wrap_sub(0, wrap_add(prio, boost));'''

_NEW = f'''  float mloc = __int_as_float(0x7f800000);
  for (int i = tid; i < n_elig; i += NT) {{
{_PASS}
    mloc = fminf(mloc, static_cast<float>(key));
    probe_buf[kPA + i] = key;
    probe_buf[kPT + i] = t;
    probe_buf[kPDA + i] = __float_as_int(dfc);
  }}
  probe_buf[kPThr + tid] = __float_as_int(mloc);
  const float mn = block_min(mloc, sm);
  probe_buf[kPMn + tid] = __float_as_int(mn);
  if (tid == 0) probe_buf[0] = n_elig;
  for (int i = tid; i < n_elig; i += NT) {{
{_PASS}
    probe_buf[kPB + i] = key;
    probe_buf[kPDB + i] = __float_as_int(dfc);
    k2[0][i] = static_cast<uint32_t>(wrap_sub(key, static_cast<int>(mn)));
    v2[0][i] = t;
  }}'''

_DECL = '''constexpr int kPThr = 16, kPMn = kPThr + 1024, kPA = kPMn + 1024;
constexpr int kPMax = 65536, kPT = kPA + kPMax, kPDA = kPT + kPMax;
constexpr int kPB = kPDA + kPMax, kPDB = kPB + kPMax, kPWords = kPDB + kPMax;
__device__ int probe_buf[kPWords];

// ---- phase 2b: tenancy admission'''

_READ = '''
extern "C" int probe_read(int* host, int n) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, probe_buf, n * sizeof(int)));
}
extern "C" int probe_words() { return kPWords; }
'''


def write_probe_sources(dst: pathlib.Path) -> None:
    src = ROOT / "tpu_faas_torch" / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    shutil.copy(src / "bid_top2.cuh", dst / "bid_top2.cuh")
    s = (src / "fused_tick.cu").read_text()
    assert s.count(_OLD) == 1, "the admission pass moved; update the probe"
    s = s.replace(_OLD, _NEW)
    s = s.replace("// ---- phase 2b: tenancy admission", _DECL, 1)
    (dst / "fused_tick.cu").write_text(s + _READ)


def report(buf: np.ndarray) -> None:
    n = int(buf[0])
    thr = buf[16:1040].view(np.float32)
    mn = buf[1040:2064].view(np.float32)
    o, m = 2064, 65536
    a, da = buf[o:o + n], buf[o + 2 * m:o + 2 * m + n]
    b, db = buf[o + 3 * m:o + 3 * m + n], buf[o + 4 * m:o + 4 * m + n]
    print(f"eligible positions {n}; block minimum as the threads read it "
          f"{sorted(set(mn.tolist()))}; thread minima "
          f"{sorted(set(thr.tolist()))}; key pass minimum "
          f"{b.min() if n else None}")
    diff = np.flatnonzero((a != b) | (da != db))
    print(f"positions where the two passes read differently: {len(diff)}")
    per = {}
    for i in range(n):
        per.setdefault(i % 1024, []).append(b[i])
    off = [k for k, v in per.items() if thr[k] != min(v)]
    print(f"threads whose own minimum differs from their keys' minimum: "
          f"{len(off)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("admission_min_probe: no CUDA device", file=sys.stderr)
        return 1
    from tpu_faas_torch import build

    build.CSRC = build.BUILD_DIR / "admission_min_probe"
    write_probe_sources(build.CSRC)
    build.BUILD_DIR = build.CSRC / "build"
    import chip_smoke
    from tpu_faas_torch.sched import fused_tick

    fused_tick.KERNEL.load()
    lib = ctypes.CDLL(str(build.library_path("fused_tick")))
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    try:
        chip_smoke.phase_resident(torch.device("cuda"), 8, 0,
                                  placement="rank", tenancy=True)
        print("the loop's 8 ticks passed every check on the probe kernel")
    except (AssertionError, SystemExit) as e:
        print(f"the loop failed: {e!r}"[:400])
    torch.cuda.synchronize()
    buf = np.zeros(lib.probe_words(), np.int32)
    assert lib.probe_read(buf.ctypes.data, len(buf)) == 0
    report(buf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
