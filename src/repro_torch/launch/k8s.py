"""RunSpec -> Kubernetes manifests (deterministic, cluster-free; the
port's ``repro.launch.k8s``).

Renders the serving fleet a ``RunSpec`` describes (``fleet.n_replicas``
engine replicas behind the prefix-affinity router) into plain-dict k8s
objects and a hand-rolled YAML dump:

* a **ConfigMap** carrying the spec itself (canonical sorted-key JSON)
  so every pod runs exactly the committed experiment;
* one **Deployment per replica set** — ``replicas: n_replicas`` pods,
  each ``python -m repro_torch run --spec`` on the mounted spec, with
  one card (``nvidia.com/gpu: 1``: the port's engine refuses to run
  without one);
* a **router Service** fronting the replica pods on ``fleet.port``.

Everything is pure data: no kubernetes client, no cluster, no YAML
dependency — ``python -m repro_torch run --mode dryrun`` with a fleet section
writes the manifests and exits, and the golden-file test pins that two
renders of one spec are byte-identical. Dict insertion order is the
emission order, so determinism is structural, not sorted-after-the-fact.
The objects are the reference's but for the container's command and its
GPU limit.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, List

from repro_torch.run.spec import RunSpec

SPEC_MOUNT = "/etc/repro"
SPEC_FILE = "runspec.json"


def app_name(spec: RunSpec) -> str:
    """DNS-1123 app label for the fleet (``repro-serve-<arch>``)."""
    arch = re.sub(r"[^a-z0-9-]+", "-", spec.arch.lower()).strip("-")
    return f"repro-serve-{arch}"


# --------------------------------------------------------------------------- #
# manifest construction (pure dicts)
# --------------------------------------------------------------------------- #
def render_manifests(spec: RunSpec) -> List[Dict[str, Any]]:
    """The fleet's k8s objects, in apply order."""
    if spec.fleet.n_replicas < 1:
        raise ValueError(
            "k8s rendering needs fleet.n_replicas >= 1 "
            "(--set fleet.n_replicas=2)")
    name = app_name(spec)
    labels = {"app": name, "repro.dev/arch": spec.arch,
              "repro.dev/mode": "serve"}
    # Pods must re-run the committed spec, not re-render manifests: the
    # in-cluster copy serves (mode) on its own node (mesh/fleet are the
    # cluster's job — each pod is ONE replica).
    pod_spec = spec.to_dict()
    pod_spec["mode"] = "serve"
    # n_replicas=0: the Deployment's replica count IS the fan-out;
    # k8s_out is a render-time knob — keeping it would make the
    # manifest depend on where the renderer wrote its own output.
    pod_spec["fleet"] = {**pod_spec["fleet"], "n_replicas": 0,
                         "k8s_out": ""}
    spec_json = json.dumps(pod_spec, sort_keys=True,
                           separators=(",", ":"))

    configmap = {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {"name": f"{name}-spec", "labels": dict(labels)},
        "data": {SPEC_FILE: spec_json},
    }
    deployment = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name, "labels": dict(labels)},
        "spec": {
            "replicas": spec.fleet.n_replicas,
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {
                    "containers": [{
                        "name": "engine",
                        "image": spec.fleet.image,
                        "command": ["python", "-m", "repro_torch", "run",
                                    "--spec", f"{SPEC_MOUNT}/{SPEC_FILE}"],
                        "env": [
                            {"name": "PYTHONPATH", "value": "/app/src"},
                            {"name": "REPRO_REPLICA_NAME", "valueFrom": {
                                "fieldRef": {
                                    "fieldPath": "metadata.name"}}},
                        ],
                        "ports": [{"containerPort": spec.fleet.port,
                                   "name": "serve"}],
                        "resources": {"limits": {"nvidia.com/gpu": 1}},
                        "volumeMounts": [{"name": "spec",
                                          "mountPath": SPEC_MOUNT,
                                          "readOnly": True}],
                    }],
                    "volumes": [{"name": "spec", "configMap": {
                        "name": f"{name}-spec"}}],
                },
            },
        },
    }
    service = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": f"{name}-router", "labels": dict(labels)},
        "spec": {
            "selector": {"app": name},
            "ports": [{"name": "serve", "port": spec.fleet.port,
                       "targetPort": "serve"}],
        },
    }
    return [configmap, deployment, service]


# --------------------------------------------------------------------------- #
# YAML emission (no dependency; the small subset k8s objects need)
# --------------------------------------------------------------------------- #
def _scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, (int, float)):
        return repr(v)
    # json.dumps double-quotes and escapes — a strict subset of YAML
    # flow scalars, so arbitrary string content (the embedded spec JSON
    # included) round-trips without a block-scalar emitter.
    return json.dumps(v)


def _emit(obj: Any, indent: int) -> List[str]:
    pad = "  " * indent
    lines: List[str] = []
    if isinstance(obj, dict):
        if not obj:
            return [f"{pad}{{}}"]
        for k, v in obj.items():
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}{k}:")
                lines.extend(_emit(v, indent + 1))
            elif isinstance(v, dict):
                lines.append(f"{pad}{k}: {{}}")
            elif isinstance(v, list):
                lines.append(f"{pad}{k}: []")
            else:
                lines.append(f"{pad}{k}: {_scalar(v)}")
        return lines
    if isinstance(obj, list):
        if not obj:
            return [f"{pad}[]"]
        for item in obj:
            if isinstance(item, (dict, list)) and item:
                sub = _emit(item, indent + 1)
                head = sub[0].lstrip()
                lines.append(f"{pad}- {head}")
                lines.extend(sub[1:])
            else:
                lines.append(f"{pad}- {_scalar(item)}")
        return lines
    return [f"{pad}{_scalar(obj)}"]


def to_yaml(manifests: List[Dict[str, Any]]) -> str:
    """Multi-document YAML, one ``---`` separated doc per object."""
    docs = ["\n".join(_emit(m, 0)) for m in manifests]
    return "---\n" + "\n---\n".join(docs) + "\n"


def render(spec: RunSpec) -> str:
    return to_yaml(render_manifests(spec))


def write_manifests(spec: RunSpec, path: str) -> str:
    text = render(spec)
    with open(path, "w") as f:
        f.write(text)
    return text
