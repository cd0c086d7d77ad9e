"""Configuration system.

The reference loads a config.ini at import time with a cwd-change side effect
and then hard-codes half the values anyway (reference task_dispatcher.py:14-21
vs :32, SURVEY §5.6). Here: one dataclass of defaults, overridable from an INI
file and from environment variables (``TPU_FAAS_<FIELD>``), loaded explicitly —
no import-time side effects, no dead keys.
"""

from __future__ import annotations

import configparser
import os
from dataclasses import dataclass, fields


@dataclass
class Config:
    # dispatcher bind address for worker sockets (reference config.ini:2)
    dispatcher_ip: str = "0.0.0.0"
    dispatcher_port: int = 5555
    # seconds of heartbeat silence before a push worker is purged
    # (reference config.ini:4 TIME_TO_EXPIRE=10)
    time_to_expire: float = 10.0
    # worker -> dispatcher heartbeat period (reference push_worker.py:8)
    heartbeat_period: float = 1.0
    # announce channel (reference config.ini:7)
    tasks_channel: str = "tasks"
    # task store endpoint
    store_url: str = "resp://127.0.0.1:6380"
    # REST gateway bind
    gateway_host: str = "127.0.0.1"
    gateway_port: int = 8000
    # pull-worker pacing delay seconds (reference pull_worker.py:131-132)
    pull_delay: float = 0.01
    # TPU scheduler tick period (s) and padded problem sizes
    tick_period: float = 0.005
    max_workers: int = 4096
    max_pending: int = 8192
    # JAX backend pin for the tpu-push dispatcher ("" = whatever JAX picks).
    # Needed because platform plugins rewrite JAX_PLATFORMS at import: e.g.
    # TPU_FAAS_PLATFORM=cpu + XLA_FLAGS=--xla_force_host_platform_device_
    # count=N runs a virtual CPU mesh on a dev box.
    platform: str = ""

    @classmethod
    def load(cls, ini_path: str | None = None, env: bool = True) -> "Config":
        cfg = cls()
        if ini_path and os.path.exists(ini_path):
            parser = configparser.ConfigParser()
            parser.read(ini_path)
            flat: dict[str, str] = {}
            for section in parser.sections():
                flat.update(parser.items(section))
            cfg._apply({k.lower(): v for k, v in flat.items()})
        if env:
            env_vals = {}
            for f in fields(cls):
                key = f"TPU_FAAS_{f.name.upper()}"
                if key in os.environ:
                    env_vals[f.name] = os.environ[key]
            cfg._apply(env_vals)
        return cfg

    def _apply(self, values: dict[str, str]) -> None:
        for f in fields(self):
            if f.name in values:
                raw = values[f.name]
                if f.type in ("int", int):
                    setattr(self, f.name, int(raw))
                elif f.type in ("float", float):
                    setattr(self, f.name, float(raw))
                else:
                    setattr(self, f.name, raw)


DEFAULT_CONFIG = Config()
