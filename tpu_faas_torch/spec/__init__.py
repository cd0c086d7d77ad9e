"""Speculation plane on PyTorch (counterpart of ``tpu_faas.spec``).

- :mod:`tpu_faas_torch.spec.straggler` — straggler flags, the anti-affinity
  veto and the hedge fixup as torch ops: the batch tick runs them on its
  device, and the resident tick's plain version wherever its state lies. On
  the card the resident tick runs the same lane inside kernel B1
  (``csrc/fused_tick.cu``);
- :mod:`tpu_faas_torch.spec.policy` — the host-side hedge book and the
  opt-in knobs (a copy of the JAX module).
"""

from tpu_faas_torch.spec.policy import HedgeEntry, SpeculationPolicy
from tpu_faas_torch.spec.straggler import (
    DEFAULT_MIN_RUNTIME_S,
    HEDGE_FIXUP_K,
    anti_affinity_veto_impl,
    hedge_fixup_impl,
    straggler_flags_impl,
)

__all__ = [
    "DEFAULT_MIN_RUNTIME_S",
    "HEDGE_FIXUP_K",
    "HedgeEntry",
    "SpeculationPolicy",
    "anti_affinity_veto_impl",
    "hedge_fixup_impl",
    "straggler_flags_impl",
]
