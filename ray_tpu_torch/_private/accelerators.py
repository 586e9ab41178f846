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
``nvidia-smi --query-gpu=name``. The
reference's slice-head anchor (``TPU-{pod}-head``) has no single-host GPU
counterpart; it waits for the autoscaler's slice. Like the reference,
the runtime pins no card per worker: a task that holds ``GPU`` sees every
visible card and picks its device itself.
"""
from __future__ import annotations

import glob
import os
import re
import subprocess
from typing import Dict, Optional

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


def gang_resources(num_gpus: float,
                   model: Optional[str] = None) -> Dict[str, float]:
    """Extra node resources advertised alongside ``GPU: num_gpus``: the
    ``accelerator_type:{model}`` label, valued at the card count.
    ``model`` defaults to procfs detection."""
    if not num_gpus:
        return {}
    model = model or detect_gpu_model()
    if not model:
        return {}
    return {f"accelerator_type:{model}": float(num_gpus)}
