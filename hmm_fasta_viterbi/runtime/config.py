"""Engine configuration.

The reference hard-codes every path and constant (SURVEY.md §5 "config":
TIMES_TO_RUN, nu, the "NVIDIA" platform preference); here one dataclass
carries the engine knobs, loadable from JSON or environment variables
(prefix ``HFV_``), and is accepted by the scanner/pipeline constructors.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Literal


@dataclasses.dataclass
class EngineConfig:
    # compute: the MSV implementation (pipeline.resolve_msv_impl) and
    # the staged length bucket
    msv_impl: Literal["auto", "cuda", "xla"] = "auto"
    l_chunk: int = 256
    # data loading
    loader: Literal["auto", "native", "python"] = "auto"
    # mesh (multi-chip): use_mesh builds a (mesh_db x mesh_sp) device
    # mesh (parallel.mesh.make_scan_mesh) and the scanner shards every
    # staged batch over the db axis
    use_mesh: bool = False
    mesh_db: int | None = None  # None = all devices on the db axis
    mesh_sp: int = 1
    # search cascade thresholds (HMMER3 defaults)
    msv_p: float = 0.02
    viterbi_p: float = 1e-3
    forward_p: float = 1e-5

    @classmethod
    def from_json(cls, path) -> "EngineConfig":
        data = json.loads(pathlib.Path(path).read_text())
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**data)

    @classmethod
    def from_env(cls, env=os.environ) -> "EngineConfig":
        cfg = cls()
        for f in dataclasses.fields(cls):
            key = f"HFV_{f.name.upper()}"
            if key not in env:
                continue
            raw = env[key]
            if f.type in ("int", "int | None"):
                value = None if raw.lower() == "none" else int(raw)
            elif f.type == "float":
                value = float(raw)
            elif f.type == "bool":
                value = raw.lower() in ("1", "true", "yes", "on")
            else:
                value = raw
            setattr(cfg, f.name, value)
        return cfg

    def to_json(self, path) -> None:
        pathlib.Path(path).write_text(json.dumps(dataclasses.asdict(self), indent=1))
