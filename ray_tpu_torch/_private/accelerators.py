"""GPU detection and the accelerator label resource.

The port's counterpart of ``ray_tpu/_private/accelerators.py``, whose
node advertises its TPU chips as ``TPU`` and an
``accelerator_type:TPU-{VERSION}`` label. Here every node advertises its
CUDA cards as ``GPU`` (reference: Ray's
``python/ray/_private/accelerators/nvidia_gpu.py``) and, when the model
is known, ``accelerator_type:{model}`` (for example
``accelerator_type:H100``) with the card count as its value.

Detection never imports torch or CUDA: a node is counted from
``CUDA_VISIBLE_DEVICES`` when it is set (an empty value means no card),
else from the ``/dev/nvidia<N>`` device files this process may open (a
container can list a card's file and refuse it: its device cgroup
answers ``EPERM``). The model comes from the ``Model:`` line of
``/proc/driver/nvidia/gpus/*/information``, or, where the driver's
procfs has no such files (as in such a container), from
``nvidia-smi --query-gpu=name``. Like the reference, the runtime pins
no card per worker: a task that holds ``GPU`` sees every visible card and
picks its device itself.

Gangs (the reference's ``:33-99``): a GPU gang is a set of hosts whose
cards train as one job, named ``{model}-{cards}`` (``"h100-16"``: 16
cards over two 8-card hosts). Host 0 of a gang advertises the anchor
``GPU-{gang}-head`` (the reference's ``TPU-{pod}-head``), so a
``ScalingConfig(topology=...)`` placement group lands on exactly one
gang. A host learns its gang from ``RT_GPU_TOPOLOGY`` and its index in
it from ``RT_GPU_WORKER_ID`` (the variables a provisioner sets; the
reference reads the TPU runtime's), and the cards per host from
``RT_GPU_CARDS_PER_HOST`` (default 8).
"""
from __future__ import annotations

import glob
import os
import re
import subprocess
from typing import Dict, Optional, Tuple

_DEV_RE = re.compile(r"^/dev/nvidia(\d+)$")


def _openable(path: str) -> bool:
    try:
        os.close(os.open(path, os.O_RDWR))
        return True
    except OSError:
        return False


def detect_num_gpus() -> int:
    """Visible CUDA cards on this host, without importing torch."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return len([c for c in env.split(",") if c.strip()])
    return len([p for p in glob.glob("/dev/nvidia*")
                if _DEV_RE.match(p) and _openable(p)])


def detect_gpu_model() -> Optional[str]:
    """The card's short model name (``"H100"`` for "NVIDIA H100 80GB
    HBM3"), from the driver's procfs or ``nvidia-smi``, or None where
    neither names one."""
    for path in sorted(glob.glob("/proc/driver/nvidia/gpus/*/information")):
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            continue
        m = re.search(r"^Model:\s*(.+)$", text, re.M)
        if m:
            return short_model_name(m.group(1))
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    names = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return short_model_name(names[0]) if names else None


def short_model_name(full: str) -> str:
    """'NVIDIA H100 80GB HBM3' → 'H100'; 'Tesla V100-SXM2-16GB' →
    'V100'. The first word after a vendor or family prefix, cut at its
    first dash."""
    words = [w for w in full.strip().split()
             if w.upper() not in ("NVIDIA", "TESLA", "GEFORCE", "QUADRO")]
    if not words:
        return full.strip()
    return words[0].split("-")[0]


#: Cards per host of a gang unless ``RT_GPU_CARDS_PER_HOST`` says
#: otherwise (an HGX/DGX board carries 8).
CARDS_PER_HOST = 8


def normalize_pod_type(raw: str) -> str:
    """'NVIDIA-H100-16' → 'h100-16'; already-short names pass through."""
    name = raw.strip().lower()
    return name[len("nvidia-"):] if name.startswith("nvidia-") else name


def parse_topology(topology: str) -> Tuple[str, int]:
    """'h100-16' → ('h100', 16). Raises ValueError on malformed input."""
    topology = normalize_pod_type(topology)
    model, _, cards = topology.partition("-")
    if not cards or not cards.isdigit():
        raise ValueError(
            f"malformed GPU topology {topology!r}; expected "
            "'<model>-<cards>' like 'h100-16'")
    return model, int(cards)


def cards_per_host() -> int:
    env = os.environ.get("RT_GPU_CARDS_PER_HOST")
    return int(env) if env else CARDS_PER_HOST


def num_hosts(topology: str) -> int:
    _, cards = parse_topology(topology)
    return max(1, cards // cards_per_host())


def detect_pod_type() -> Optional[str]:
    """The gang this host belongs to, e.g. 'h100-16' (None outside one)."""
    raw = os.environ.get("RT_GPU_TOPOLOGY")
    return normalize_pod_type(raw) if raw else None


def detect_worker_id() -> int:
    """This host's index within its gang (0 on a single host)."""
    return int(os.environ.get("RT_GPU_WORKER_ID", "0") or 0)


def head_resource_name(pod_type: str) -> str:
    return f"GPU-{normalize_pod_type(pod_type)}-head"


def gang_resources(num_gpus: float, model: Optional[str] = None,
                   pod_type: Optional[str] = None,
                   worker_id: Optional[int] = None) -> Dict[str, float]:
    """Extra node resources advertised alongside ``GPU: num_gpus``: the
    ``accelerator_type:{model}`` label, valued at the card count, and on
    host 0 of a gang the ``GPU-{gang}-head`` anchor. ``model`` defaults
    to the gang's (upper case) or to procfs detection; ``pod_type`` and
    ``worker_id`` to the environment (a gang host), and explicit values
    let a provisioner (the autoscaler's slice provider) mint the shape of
    a host it is about to launch."""
    if not num_gpus:
        return {}
    pod = normalize_pod_type(pod_type) if pod_type else detect_pod_type()
    if not model and pod:
        model = parse_topology(pod)[0].upper()
    model = model or detect_gpu_model()
    res: Dict[str, float] = {}
    if model:
        res[f"accelerator_type:{model}"] = float(num_gpus)
    if pod:
        parse_topology(pod)
        wid = detect_worker_id() if worker_id is None else worker_id
        if wid == 0:
            res[head_resource_name(pod)] = 1.0
    return res
