"""repro_torch.run — the declarative experiment API of the port
(``repro.run``).

One :class:`RunSpec` describes a run (arch, mode, mesh, nested
subsystem sections); ``run_spec`` resolves it to config -> mesh ->
subsystem on a device; ``python -m repro_torch run`` is the CLI. The
launchers ``repro_torch.launch.train`` and ``repro_torch.launch.serve``
are shims over this package. Spec files under ``runs/`` resolve to the
reference's ``RunSpec.to_dict()`` exactly.
"""
from repro_torch.run.dispatch import build_mesh, resolve_config, run_spec
from repro_torch.run.overrides import (
    SpecError,
    apply_assignments,
    coerce_value,
    parse_assignment,
)
from repro_torch.run.spec import (
    MESHES,
    MODES,
    BenchSection,
    DryrunSection,
    FleetSection,
    KVCacheSpec,
    RunSpec,
    ServeSection,
    TrainerSection,
)
from repro_torch.run.specfile import load_spec_file

__all__ = [
    "MESHES",
    "MODES",
    "BenchSection",
    "DryrunSection",
    "FleetSection",
    "KVCacheSpec",
    "RunSpec",
    "ServeSection",
    "SpecError",
    "TrainerSection",
    "apply_assignments",
    "build_mesh",
    "coerce_value",
    "load_spec_file",
    "parse_assignment",
    "resolve_config",
    "run_spec",
]
